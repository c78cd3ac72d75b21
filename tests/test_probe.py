"""Reflection probes: face-camera orientation, device purity, scene use."""

import math

import jax
import numpy as np

from zenith.core.mathtypes import Radians
from zenith.renderer import (
    DeferredRenderer,
    Scene,
    SceneObject,
    capture_reflection_probe,
)
from zenith.renderer.probe import _ProbeCamera
from zenith.rhi import RhiCore


class TestFaceCameras:
    def test_projection_matches_cube_face_selection(self, rng):
        """A world point projected by face k's camera must land at the uv
        that cube_direction_to_face_uv assigns its direction — rendering
        and sampling agree (the probe's core invariant)."""
        import jax.numpy as jnp

        from zenith.ops.sampling import cube_direction_to_face_uv

        eye = np.array([2.0, -1.0, 3.0])
        dirs = rng.normal(size=(256, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        pts = eye + dirs * rng.uniform(1.0, 30.0, (256, 1))
        face, uv = cube_direction_to_face_uv(jnp.asarray(pts - eye))
        face, uv = np.asarray(face), np.asarray(uv)
        hom = np.concatenate([pts, np.ones((256, 1))], 1)
        for k in range(6):
            sel = face == k
            assert sel.any()
            cam = _ProbeCamera(k, eye)
            clip = hom[sel] @ cam.render_view_projection.astype(np.float64).T
            assert np.all(clip[:, 3] > 0)  # in front of the face camera
            ndc = clip[:, :2] / clip[:, 3:4]
            np.testing.assert_allclose(
                ndc[:, 0] * 0.5 + 0.5, uv[sel][:, 0], atol=2e-4
            )
            np.testing.assert_allclose(
                ndc[:, 1] * 0.5 + 0.5, uv[sel][:, 1], atol=2e-4
            )

    def test_inverse_consistency(self):
        cam = _ProbeCamera(3, (1.0, 2.0, 3.0))
        err = np.abs(
            cam.render_view_projection.astype(np.float64)
            @ cam.render_inv_view_projection
            - np.eye(4)
        ).max()
        assert err < 1e-3


class TestCapture:
    def test_colored_wall_lands_on_its_face(self):
        """A red wall at +X of the probe: the captured environment sampled
        toward +X must be red-dominant; toward -X (empty) it must be the
        background — proves face orientation end-to-end through the real
        rasterizer. The result stays device-resident (no host copy)."""
        import jax.numpy as jnp

        from zenith.ops.sampling import sample_cube

        core = RhiCore()
        device = core.create_render_device()
        wall = SceneObject.quad(
            device, "wall", size=60.0, z=0.0,
            base_color=(0.9, 0.05, 0.05, 1.0), emissive=(2.0, 0.1, 0.1),
        )
        # Stand the quad up facing -X, placed at +X of the probe.
        rot = np.array(
            [[0, 0, -1, 0], [0, 1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
            np.float32,
        )
        trans = np.eye(4, dtype=np.float32)
        trans[0, 3] = 25.0
        wall.model_matrix = (trans @ rot).astype(np.float32)
        scene = Scene(objects=[wall], sun=None, point_lights=[],
                      ambient=(0.6, 0.6, 0.6))
        env = capture_reflection_probe(
            device, scene, (0.0, 0.0, 0.0), size=32, num_mips=2, samples=16
        )
        assert isinstance(env.sh9, jax.Array)  # device-resident, no readback
        level0 = env.texture.mips[0]
        px = np.asarray(sample_cube(
            level0, jnp.asarray([[1.0, 0.0, 0.0]])
        ))[0]
        mx = np.asarray(sample_cube(
            level0, jnp.asarray([[-1.0, 0.0, 0.0]])
        ))[0]
        assert px[0] > 0.3 and px[0] > 3.0 * px[2], px  # red wall at +X
        assert mx[0] < 0.1, mx  # nothing at -X (dark background)


class TestSceneUse:
    def test_probe_lights_the_scene(self):
        """A probe-lit render differs from flat ambient and stays finite."""
        from zenith.core.camera import Camera
        from zenith.core.mathtypes import Degree
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import Format, PipelineCache, TextureDesc
        from zenith.renderer.scene import DirectionalLight

        core = RhiCore()
        device = core.create_render_device()
        ground = SceneObject.quad(device, "ground", size=120.0, z=0.0,
                                  base_color=(0.2, 0.5, 0.8, 1.0))
        ball = SceneObject.cube(device, "ball", size=8.0, z0=6.0,
                                base_color=(0.9, 0.9, 0.9, 1.0),
                                metallic=0.9, roughness=0.15)
        scene = Scene(objects=[ground, ball],
                      sun=DirectionalLight(cast_shadows=False),
                      point_lights=[], ambient=(0.1, 0.1, 0.1))

        def render():
            renderer = DeferredRenderer(scene, shadows=False)
            w, h = 128, 64
            camera = Camera(fov_y=Degree(40.0), aspect_ratio=w / h)
            camera.set_position(np.array([0.0, -50.0, 20.0], np.float32))
            camera.set_yaw_pitch(Radians(0.0),
                                 Radians(-math.atan2(15.0, 50.0)))
            builder = RenderGraphBuilder()
            out = builder.create(
                TextureDesc.color("out", w, h, Format.RGBA32F)
            )
            builder.export(out)
            renderer.render_to(builder, out, camera, w, h)
            compiled = builder.build().compile(
                device, PipelineCache(), CompileOptions(tile_h=8)
            )
            compiled.execute(device)
            return np.asarray(compiled.value(out))

        flat = render()
        scene.environment = capture_reflection_probe(
            device, scene, (0.0, 0.0, 10.0), size=32, num_mips=3, samples=16
        )
        lit = render()
        assert np.isfinite(lit).all()
        assert np.abs(lit - flat).max() > 0.02  # the probe changed shading
