"""Cascaded shadow maps: split math, frustum fit, layered PCF, full scene."""

import math
import os

import jax.numpy as jnp
import numpy as np

from zenith.core.camera import Camera
from zenith.core.mathtypes import Degree, Radians
from zenith.renderer.csm import (
    cascade_split_distances,
    fit_cascades,
)
from zenith.renderer.scene import DirectionalLight


def _camera():
    cam = Camera(fov_y=Degree(40.0), aspect_ratio=2.0)
    cam.set_position(np.array([30.0, -80.0, 20.0], np.float32))
    cam.set_yaw_pitch(Radians(0.4), Radians(-0.15))
    return cam


class TestSplits:
    def test_monotonic_between_uniform_and_log(self):
        near, far, n = 1.0, 400.0, 4
        s = cascade_split_distances(near, far, n, lam=0.7)
        assert s.shape == (4,)
        assert np.all(np.diff(s) > 0)
        assert abs(s[-1] - far) < 1e-3
        uni = cascade_split_distances(near, far, n, lam=0.0)
        log = cascade_split_distances(near, far, n, lam=1.0)
        # The mixed split sits between the two pure schemes.
        assert np.all(s[:-1] <= uni[:-1] + 1e-4)
        assert np.all(s[:-1] >= log[:-1] - 1e-4)
        np.testing.assert_allclose(
            log, near * (far / near) ** (np.arange(1, 5) / 4), rtol=1e-5
        )


class TestFit:
    def test_slice_corners_inside_each_cascade(self):
        """Every frustum-slice corner must land inside its cascade's NDC
        box ([-1,1]² xy, [0,1] z) — the definition of a correct fit."""
        from zenith.renderer.csm import _frustum_slice_corners

        sun = DirectionalLight(cascades=3)
        cam = _camera()
        vps, splits, noffs = fit_cascades(sun, cam, 3)
        assert vps.shape == (3, 4, 4) and splits.shape == (3,)
        assert noffs.shape == (3,) and np.all(noffs > 0)
        # Texel density increases toward the near cascade.
        assert noffs[0] < noffs[1] < noffs[2]
        d0 = 1.0
        for k in range(3):
            corners = _frustum_slice_corners(cam, d0, float(splits[k]))
            hom = np.concatenate([corners, np.ones((8, 1))], axis=1)
            clip = hom @ vps[k].astype(np.float64).T
            ndc = clip[:, :3] / clip[:, 3:4]
            assert np.all(np.abs(ndc[:, :2]) <= 1.0 + 1e-3), (k, ndc)
            assert np.all((ndc[:, 2] >= -1e-4) & (ndc[:, 2] <= 1.0 + 1e-4))
            d0 = float(splits[k])

    def test_texel_snap_stabilizes_translation(self):
        """Sliding the camera by a fraction of a texel must not change the
        light VP's sampled texel alignment: the window origin moves in
        whole-texel steps."""
        sun = DirectionalLight(cascades=2, shadow_map_size=512)
        cam = _camera()
        vps0, _, _ = fit_cascades(sun, cam, 2)
        # A sub-texel world nudge orthogonal-ish to the light.
        cam.set_position(cam.location + np.float32([0.008, 0.006, 0.0]))
        vps1, _, _ = fit_cascades(sun, cam, 2)
        # The projection either snapped to the SAME window (identical
        # matrix) or moved by an integer texel count: check by projecting a
        # fixed world point and comparing the fractional texel coordinate.
        p = np.array([5.0, 7.0, 0.0, 1.0])
        for k in range(2):
            a = p @ vps0[k].astype(np.float64).T
            b = p @ vps1[k].astype(np.float64).T
            fa = ((a[:2] / a[3] * 0.5 + 0.5) * 512) % 1.0
            fb = ((b[:2] / b[3] * 0.5 + 0.5) * 512) % 1.0
            np.testing.assert_allclose(fa, fb, atol=1e-3)


class TestLayeredPCF:
    def test_matches_single_layer_pcf(self, rng):
        from zenith.ops.sampling import (
            sample_shadow_pcf,
            sample_shadow_pcf_layered,
        )
        from zenith.renderer.forward import _SHADOW_SAMPLER

        depth0 = rng.uniform(0.2, 0.9, size=(32, 32)).astype(np.float32)
        depth1 = rng.uniform(0.2, 0.9, size=(32, 32)).astype(np.float32)
        layers = jnp.asarray(np.stack([depth0, depth1]))
        uv = rng.uniform(0.0, 1.0, size=(8, 8, 2)).astype(np.float32)
        ref = rng.uniform(0.1, 1.0, size=(8, 8)).astype(np.float32)
        for k, d in ((0, depth0), (1, depth1)):
            got = sample_shadow_pcf_layered(
                layers, jnp.full((8, 8), k, jnp.int32), jnp.asarray(uv),
                jnp.asarray(ref), _SHADOW_SAMPLER,
            )
            want = sample_shadow_pcf(
                jnp.asarray(d), jnp.asarray(uv), jnp.asarray(ref),
                _SHADOW_SAMPLER,
            )
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       atol=1e-6)

    def test_mixed_layer_selection(self):
        """layer index selects per PIXEL: half the screen reads the
        all-occluded layer, half the all-open layer."""
        from zenith.ops.sampling import sample_shadow_pcf_layered
        from zenith.renderer.forward import _SHADOW_SAMPLER

        occluded = np.zeros((16, 16), np.float32)  # depth 0 < any ref
        open_ = np.ones((16, 16), np.float32)
        layers = jnp.asarray(np.stack([occluded, open_]))
        k = jnp.asarray(
            np.repeat(np.array([[0], [1]], np.int32), 8, axis=0)
            .repeat(16, axis=1)
        )
        uv = jnp.full((16, 16, 2), 0.5, jnp.float32)
        ref = jnp.full((16, 16), 0.5, jnp.float32)
        lit = np.asarray(
            sample_shadow_pcf_layered(layers, k, uv, ref, _SHADOW_SAMPLER)
        )
        assert np.all(lit[:8] == 0.0)  # ref 0.5 > occluder 0 → shadowed
        assert np.all(lit[8:] == 1.0)  # ref 0.5 <= 1 → lit


class TestSceneCSM:
    def _render(self, cascades, retained_check=False, shadows=True):
        from zenith.core.camera import Camera
        from zenith.renderer import DeferredRenderer
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import Format, PipelineCache, RhiCore, TextureDesc
        from zenith.sandbox.scene import build_scene
        from zenith import asset

        asset.initialize()
        core = RhiCore()
        device = core.create_render_device()
        rng = np.random.default_rng(3)
        scene = build_scene(device, 0, rng, skybox=False)
        if cascades > 1:
            from dataclasses import replace

            scene.sun = replace(scene.sun, cascades=cascades)
        renderer = DeferredRenderer(scene, shadows=shadows)
        w, h = 256, 128
        camera = Camera(fov_y=Degree(35.0), aspect_ratio=w / h)
        camera.set_position(np.array([0.0, -170.0, 25.0], np.float32))
        camera.set_yaw_pitch(Radians(0.0), Radians(-math.atan2(20.0, 170.0)))
        builder = RenderGraphBuilder()
        out = builder.create(TextureDesc.color("out", w, h, Format.RGBA32F))
        builder.export(out)
        renderer.render_to(builder, out, camera, w, h)
        compiled = builder.build().compile(
            device, PipelineCache(), CompileOptions(tile_h=8)
        )
        compiled.execute(device)
        img = np.asarray(compiled.value(out))
        if retained_check:
            # Retained re-execute with frame_dynamics (the cascade fits)
            # must accept the signature and reproduce the frame exactly.
            compiled.execute(
                device, dynamics=renderer.frame_dynamics(camera)
            )
            np.testing.assert_array_equal(
                np.asarray(compiled.value(out)), img
            )
        return img

    def test_cascaded_scene_shadows_and_retained(self):
        img3 = self._render(3, retained_check=True)
        assert np.isfinite(img3).all()
        img1 = self._render(1)
        # Same scene, same lighting model: the images agree overall (the
        # shadow algorithm changed, not the scene) ...
        assert np.mean(np.abs(img3[..., :3] - img1[..., :3])) < 0.05
        # ... and the cascades actually DARKEN pixels vs no shadows at all
        # (a real shadow exists somewhere).
        img_ns = self._render(1, shadows=False)
        darkened = (img_ns[..., :3] - img3[..., :3]) > 0.05
        assert darkened.any()


class TestSnapInvariance:
    def test_fixed_point_texel_phase_invariant_under_camera_motion(self):
        """The bounding-sphere fit + per-axis texel snap: a fixed world
        point's FRACTIONAL texel coordinate must not change as the camera
        translates (this is what kills shadow-edge shimmer). Crossing snap
        lattice lines must shift sampling by WHOLE texels on BOTH axes."""
        sun = DirectionalLight(cascades=2, shadow_map_size=512)
        p = np.array([5.0, 7.0, 0.0, 1.0])
        fracs = []
        for step in range(6):
            cam = _camera()
            cam.set_position(
                cam.location + np.float32([2.37, 1.91, 0.0]) * step
            )
            vps, _, _ = fit_cascades(sun, cam, 2)
            a = p @ vps[1].astype(np.float64).T
            fracs.append(((a[:2] / a[3] * 0.5 + 0.5) * 512) % 1.0)
        for f in fracs[1:]:
            np.testing.assert_allclose(f, fracs[0], atol=2e-3)
