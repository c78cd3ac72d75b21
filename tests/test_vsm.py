"""Variance shadow maps: moment math, Chebyshev bounds, scene softness."""

import math

import jax.numpy as jnp
import numpy as np

from zenith.ops.vsm import depth_to_moments, sample_vsm


class TestMoments:
    def test_constant_depth_has_zero_variance_and_full_light(self):
        depth = np.full((32, 32), 0.5, np.float32)
        m = np.asarray(depth_to_moments(jnp.asarray(depth), taps=2))
        np.testing.assert_allclose(m[..., 0], 0.5, atol=1e-6)
        np.testing.assert_allclose(m[..., 1], 0.25, atol=1e-6)
        uv = jnp.full((4, 4, 2), 0.5, jnp.float32)
        # Receiver at the occluder depth: fully lit (d <= mu).
        lit = np.asarray(sample_vsm(
            jnp.asarray(m), uv, jnp.full((4, 4), 0.5, jnp.float32)
        ))
        np.testing.assert_allclose(lit, 1.0)
        # Receiver far behind a zero-variance occluder: fully shadowed.
        lit = np.asarray(sample_vsm(
            jnp.asarray(m), uv, jnp.full((4, 4), 0.9, jnp.float32)
        ))
        np.testing.assert_allclose(lit, 0.0, atol=1e-3)

    def test_blur_softens_an_edge(self):
        depth = np.ones((32, 32), np.float32)
        depth[:, :16] = 0.3  # occluder on the left half
        m = np.asarray(depth_to_moments(jnp.asarray(depth), taps=3))
        # The blurred mean ramps across the edge instead of stepping.
        ramp = m[16, 12:20, 0]
        assert np.all(np.diff(ramp) > 0)
        assert ramp[0] < 0.45 and ramp[-1] > 0.85

    def test_chebyshev_penumbra_between_zero_and_one(self):
        depth = np.ones((64, 64), np.float32)
        depth[:, :32] = 0.3
        m = depth_to_moments(jnp.asarray(depth), taps=4)
        us = np.linspace(0.4, 0.6, 33, dtype=np.float32)
        uv = jnp.asarray(np.stack(
            [us, np.full_like(us, 0.5)], -1
        ))
        lit = np.asarray(sample_vsm(
            m, uv, jnp.full((33,), 0.6, jnp.float32)
        ))
        assert lit.min() < 0.05 and lit.max() > 0.95
        assert ((lit > 0.05) & (lit < 0.95)).sum() >= 3  # a real penumbra


class TestSceneVSM:
    def _render(self, soft):
        from dataclasses import replace

        from zenith.core.camera import Camera
        from zenith.core.mathtypes import Degree, Radians
        from zenith.renderer import DeferredRenderer
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import Format, PipelineCache, RhiCore, TextureDesc
        from zenith.sandbox.scene import build_scene
        from zenith import asset

        asset.initialize()
        core = RhiCore()
        device = core.create_render_device()
        scene = build_scene(device, 0, np.random.default_rng(3), skybox=False)
        if soft:
            scene.sun = replace(scene.sun, soft_shadows=True, vsm_blur=4)
        renderer = DeferredRenderer(scene)
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
        return np.asarray(compiled.value(out))

    def test_soft_shadow_renders_and_widens_penumbra(self):
        hard = self._render(False)
        soft = self._render(True)
        assert np.isfinite(soft).all()
        # Same scene: images agree overall ...
        assert np.mean(np.abs(soft[..., :3] - hard[..., :3])) < 0.05
        # ... and the soft version has MORE intermediate-intensity shadow
        # pixels (a penumbra) where the hard version steps.
        def penumbra_count(img):
            lum = img[..., :3].sum(-1)
            lo, hi = np.percentile(lum, [10, 70])
            return ((lum > lo + 0.1 * (hi - lo))
                    & (lum < hi - 0.3 * (hi - lo))).sum()

        assert penumbra_count(soft) > penumbra_count(hard)
