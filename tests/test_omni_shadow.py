"""Omni (cube) shadow maps: face-matrix math, and occlusion end-to-end."""

import math

import jax.numpy as jnp
import numpy as np

from zenith.renderer.omni import omni_face_matrices, omni_reference_z


class TestFaceMath:
    def test_matrices_invert_face_uv_selection(self, rng):
        """Project a world point with the matrix of the face that
        cube_direction_to_face_uv selects — the NDC uv must equal the
        table's uv and the NDC z the analytic z(axis distance): the two
        sides of the shadow lookup agree by construction."""
        from zenith.ops.sampling import cube_direction_to_face_uv

        light = np.array([3.0, -2.0, 5.0])
        near, far = 0.3, 60.0
        vps = omni_face_matrices(light, near, far)
        dirs = rng.normal(size=(512, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        pts = light + dirs * rng.uniform(1.0, 50.0, (512, 1))
        face, uv = cube_direction_to_face_uv(jnp.asarray(pts - light))
        face, uv = np.asarray(face), np.asarray(uv)
        hom = np.concatenate([pts, np.ones((512, 1))], 1)
        for k in range(6):
            sel = face == k
            assert sel.any()  # every face exercised
            clip = hom[sel] @ vps[k].astype(np.float64).T
            ndc = clip[:, :3] / clip[:, 3:4]
            np.testing.assert_allclose(
                ndc[:, 0] * 0.5 + 0.5, uv[sel][:, 0], atol=1e-5
            )
            np.testing.assert_allclose(
                ndc[:, 1] * 0.5 + 0.5, uv[sel][:, 1], atol=1e-5
            )
            axis_d = np.abs(pts[sel] - light).max(axis=1)
            np.testing.assert_allclose(
                ndc[:, 2],
                np.asarray(omni_reference_z(jnp.asarray(axis_d), near, far)),
                atol=1e-5,
            )

    def test_reference_z_monotonic_in_range(self):
        d = jnp.linspace(0.4, 59.0, 64)
        z = np.asarray(omni_reference_z(d, 0.3, 60.0))
        assert np.all(np.diff(z) > 0)
        assert z[0] > 0.0 and z[-1] < 1.0


class TestSceneOmni:
    def _render(self, cast_shadows):
        from zenith.core.camera import Camera
        from zenith.core.mathtypes import Degree, Radians
        from zenith.renderer import (
            DeferredRenderer,
            PointLight,
            Scene,
            SceneObject,
        )
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import Format, PipelineCache, RhiCore, TextureDesc

        core = RhiCore()
        device = core.create_render_device()
        ground = SceneObject.quad(
            device, "ground", size=120.0, z=0.0,
            base_color=(0.7, 0.7, 0.7, 1.0),
        )
        blocker = SceneObject.cube(
            device, "blocker", size=10.0, z0=12.0,
            base_color=(0.6, 0.3, 0.3, 1.0),
        )
        light = PointLight(
            position=(0.0, 0.0, 40.0), color=(1.0, 1.0, 1.0),
            intensity=4000.0, radius=200.0, cast_shadows=cast_shadows,
            shadow_map_size=128,
        )
        scene = Scene(objects=[ground, blocker], sun=None,
                      point_lights=[light], ambient=(0.05, 0.05, 0.05))
        renderer = DeferredRenderer(scene, shadows=False)
        w, h = 256, 128
        camera = Camera(fov_y=Degree(45.0), aspect_ratio=w / h)
        camera.set_position(np.array([0.0, -90.0, 55.0], np.float32))
        camera.set_yaw_pitch(Radians(0.0), Radians(-math.atan2(50.0, 90.0)))
        builder = RenderGraphBuilder()
        out = builder.create(TextureDesc.color("out", w, h, Format.RGBA32F))
        builder.export(out)
        renderer.render_to(builder, out, camera, w, h)
        compiled = builder.build().compile(
            device, PipelineCache(), CompileOptions(tile_h=8)
        )
        compiled.execute(device)
        return np.asarray(compiled.value(out))

    def test_blocker_casts_shadow_rest_matches(self):
        lit = self._render(False)
        shadowed = self._render(True)
        assert np.isfinite(shadowed).all()
        diff = lit[..., :3].sum(-1) - shadowed[..., :3].sum(-1)
        # A real umbra exists under the blocker: some ground pixels lost
        # most of the point light's contribution...
        assert diff.max() > 0.5
        # ... while unoccluded pixels are (near-)identical between the
        # dense cube-PCF path and the tiled-kernel path — the two BRDF
        # implementations agree (kept in lock-step, ops/lighting.py).
        unoccluded = diff < 0.02
        assert unoccluded.mean() > 0.5
        np.testing.assert_allclose(
            lit[unoccluded], shadowed[unoccluded], atol=0.02
        )
