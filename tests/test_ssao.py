"""Screen-space ambient occlusion (ops.ssao + deferred integration).

Unit tests drive the op on synthetic G-buffer planes with a simple
orthographic top-down projection (closed-form expectations: flat plane →
open, step edge → darkened contact); the e2e test checks the deferred
renderer's ambient term darkens at geometry contact and the SPMD path
matches single-device.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from zenith.ops.ssao import (
    hemisphere_kernel,
    ssao_blur,
    ssao_occlusion,
)

H, W = 64, 64
SPAN = 32.0  # world units covered by the viewport in x and y


def ortho_vp():
    """World (x, y, z) → NDC (x/SPAN*2, y/SPAN*2), w=1 — a top-down ortho
    camera over the [-SPAN/2, SPAN/2] square."""
    vp = np.zeros((4, 4), np.float32)
    vp[0, 0] = 2.0 / SPAN
    vp[1, 1] = 2.0 / SPAN
    vp[2, 2] = 0.0
    vp[2, 3] = 0.5
    vp[3, 3] = 1.0
    return vp


def plane_gbuffer(z_of_xy=None):
    """Synthetic top-down G-buffer: world x/y grids at pixel centers,
    z from the callback (default flat 0), +Z normals, depth 0.5."""
    xs = (np.arange(W) + 0.5) / W * SPAN - SPAN / 2
    ys = (np.arange(H) + 0.5) / H * SPAN - SPAN / 2
    gx, gy = np.meshgrid(xs, ys)
    gz = np.zeros_like(gx) if z_of_xy is None else z_of_xy(gx, gy)
    pos = np.stack([gx, gy, gz], -1).astype(np.float32)
    nrm = np.zeros_like(pos)
    nrm[..., 2] = 1.0
    depth = np.full((H, W), 0.5, np.float32)
    return jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(depth)


KERN = hemisphere_kernel(16)


class TestKernel:
    def test_hemisphere_and_radii(self):
        k = hemisphere_kernel(32)
        assert k.shape == (32, 3)
        assert (k[:, 2] > 0).all()  # +Z hemisphere
        r = np.linalg.norm(k, axis=-1)
        assert (r <= 1.0 + 1e-6).all() and (r >= 0.05).all()


class TestOcclusion:
    def test_flat_plane_is_open(self):
        pos, nrm, dep = plane_gbuffer()
        ao = np.asarray(
            ssao_occlusion(pos, nrm, dep, jnp.asarray(ortho_vp()), KERN,
                           radius=2.0)
        )
        # Taps on a flat plane have (q-x)·n ≈ 0 → no occlusion anywhere.
        assert ao.min() > 0.95, ao.min()

    def test_step_darkens_lower_side_near_wall(self):
        step_h = 3.0

        def z(gx, gy):
            return np.where(gx > 0.0, step_h, 0.0)

        pos, nrm, dep = plane_gbuffer(z)
        ao = np.asarray(
            ssao_occlusion(pos, nrm, dep, jnp.asarray(ortho_vp()), KERN,
                           radius=4.0)
        )
        edge = ao[:, W // 2 - 1].mean()   # low side, at the wall
        near = ao[:, W // 2 - 3].mean()   # low side, ~1.25 units out
        far = ao[:, 4].mean()             # low side, far from the step
        assert edge < far - 0.15, (edge, far)
        assert edge < near, (edge, near)  # monotone falloff from the wall
        # The RAISED side sees the low side only BELOW its tangent plane —
        # no occlusion there.
        assert ao[:, W - 4].mean() > 0.95

    def test_background_stays_open(self):
        pos, nrm, dep = plane_gbuffer()
        dep = dep.at[:, : W // 2].set(0.0)  # left half = background
        ao = np.asarray(
            ssao_occlusion(pos, nrm, dep, jnp.asarray(ortho_vp()), KERN,
                           radius=2.0)
        )
        np.testing.assert_allclose(ao[:, : W // 2], 1.0)

    def test_intensity_scales_darkening(self):
        def z(gx, gy):
            return np.where(gx > 0.0, 3.0, 0.0)

        pos, nrm, dep = plane_gbuffer(z)
        lo = np.asarray(ssao_occlusion(
            pos, nrm, dep, jnp.asarray(ortho_vp()), KERN, radius=4.0,
            intensity=0.5))
        hi = np.asarray(ssao_occlusion(
            pos, nrm, dep, jnp.asarray(ortho_vp()), KERN, radius=4.0,
            intensity=2.0))
        col = W // 2 - 1
        assert hi[:, col].mean() < lo[:, col].mean() - 0.05


class TestBlur:
    def test_smooths_within_constant_depth(self):
        rng = np.random.default_rng(0)
        ao = jnp.asarray(rng.uniform(0.4, 0.6, (H, W)).astype(np.float32))
        dep = jnp.full((H, W), 0.5, jnp.float32)
        out = np.asarray(ssao_blur(ao, dep, taps=4))
        assert out.std() < np.asarray(ao).std() * 0.5

    def test_does_not_bleed_across_depth_edges(self):
        ao = jnp.concatenate(
            [jnp.zeros((H, W // 2)), jnp.ones((H, W // 2))], axis=1
        ).astype(jnp.float32)
        dep = jnp.concatenate(
            [jnp.full((H, W // 2), 0.2), jnp.full((H, W // 2), 0.8)], axis=1
        ).astype(jnp.float32)
        out = np.asarray(ssao_blur(ao, dep, taps=4))
        # Pixels on the bright/deep side keep AO = 1 right up to the edge.
        np.testing.assert_allclose(out[:, W // 2], 1.0)
        np.testing.assert_allclose(out[:, W // 2 - 1], 0.0)


class TestDeferredSSAO:
    @pytest.fixture
    def device(self):
        from zenith.rhi import RhiCore

        return RhiCore().create_render_device()

    def _render(self, device, ssao, mesh=None, w=128, h=64):
        from zenith.core.camera import Camera
        from zenith.core.mathtypes import Degree, Radians
        from zenith.renderer import DeferredRenderer, SSAOOptions
        from zenith.renderer.scene import Scene, SceneObject
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import PipelineCache, TextureDesc

        scene = Scene(
            objects=[
                SceneObject.quad(device, "ground", size=120.0, z=0.0,
                                 base_color=(1.0, 1.0, 1.0, 1.0)),
                SceneObject.cube(device, "box", size=16.0, z0=0.0,
                                 base_color=(1.0, 1.0, 1.0, 1.0)),
            ],
            sun=None,
            ambient=(0.5, 0.5, 0.5),
        )
        renderer = DeferredRenderer(
            scene, shadows=False,
            ssao=SSAOOptions(radius=6.0, samples=16) if ssao else False,
        )
        cam = Camera(fov_y=Degree(45.0), aspect_ratio=w / h)
        cam.set_position(np.array([0.0, -55.0, 30.0], np.float32))
        cam.set_yaw_pitch(Radians(0.0), Radians(-0.42))
        builder = RenderGraphBuilder()
        out = builder.create(TextureDesc.color("out", w, h))
        builder.export(out)
        renderer.render_to(builder, out, cam, w, h)
        compiled = builder.build().compile(
            device, PipelineCache(), CompileOptions(tile_h=8, tile_w=128,
                                                    mesh=mesh),
        )
        compiled.execute(device)
        return np.asarray(compiled.value(out))

    def test_contact_darkening(self, device):
        plain = self._render(device, ssao=False)
        occluded = self._render(device, ssao=True)
        # The ambient-only scene: SSAO darkens the ground at the cube's
        # base. Find ground rows just below the cube silhouette.
        diff = plain[..., :3].sum(-1) - occluded[..., :3].sum(-1)
        assert diff.max() > 0.1, diff.max()
        # Open ground far from the cube is (near-)unchanged.
        corner = np.abs(diff[-4, 4])
        assert corner < 0.05, corner
        assert np.isfinite(occluded).all()

    def test_spmd_matches_single(self, device):
        import jax

        if len(jax.devices("cpu")) < 8:
            pytest.skip("needs 8 virtual cpu devices")
        from zenith.parallel import default_mesh

        single = self._render(device, ssao=True)
        sharded = self._render(device, ssao=True,
                               mesh=default_mesh(8, backend="cpu"))
        np.testing.assert_allclose(sharded, single, atol=2e-4)
