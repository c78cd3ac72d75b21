"""Screen-space reflections: march/hit math, gates, node SPMD, scene."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zenith.ops.ssr import ssr_reflect

W, H = 64, 64


def _ortho_pixel_vp(w, h):
    """World (x, y, ·) → pixel (x, y) under the op's NDC→pixel convention
    (same helper as tests/test_motion_blur.py)."""
    vp = np.zeros((4, 4), np.float32)
    vp[0, 0] = 2.0 / w
    vp[0, 3] = (2.0 * 0.5) / w - 1.0
    vp[1, 1] = 2.0 / h
    vp[1, 3] = (2.0 * 0.5) / h - 1.0
    vp[2, 2] = 1.0
    vp[3, 3] = 1.0
    return vp


def _params(strength=1.0, max_dist=60.0, thickness=4.0, max_rough=0.6):
    return jnp.asarray([strength, max_dist, thickness, max_rough],
                       jnp.float32)


def _mirror_wall_buffers():
    """The pinned test geometry: a floor height field (z = 0) with one
    'wall' plate (rows >= 56 at z = 40, facing -y, bright green) and ONE
    mirror pixel at (row 40, col 32) whose normal is the exact bisector
    of the camera direction and the direction to the wall point
    T = (32, 60, 40) — so its reflection ray marches straight at T.

    cam = (32, 0, 50). Along the ray the floor taps are never behind
    geometry (dist(cam, Q)² − dist(cam, S)² = (z−50)² − 2500 < 0 for the
    ray's z ∈ (0, 100)), and the wall taps go behind at its leading edge
    (row 56: gap ≈ 1.9 < thickness 4) — the march must bracket there and
    the bisection must land on the wall, fetching green.
    """
    cam = np.array([32.0, 0.0, 50.0], np.float32)
    pos = np.zeros((H, W, 3), np.float32)
    cols = np.arange(W, dtype=np.float32)[None, :]
    rows = np.arange(H, dtype=np.float32)[:, None]
    pos[..., 0] = cols
    pos[..., 1] = rows
    pos[56:, :, 2] = 40.0

    normal = np.zeros((H, W, 4), np.float32)
    normal[..., 2] = 1.0
    normal[56:, :, :3] = (0.0, -1.0, 0.0)
    normal[..., 3] = 1.0  # roughness 1 everywhere → SSR off by default

    p = np.array([32.0, 40.0, 0.0], np.float32)
    v = cam - p
    v /= np.linalg.norm(v)
    d = np.array([32.0, 60.0, 40.0], np.float32) - p
    d /= np.linalg.norm(d)
    n = v + d
    n /= np.linalg.norm(n)
    normal[40, 32, :3] = n
    normal[40, 32, 3] = 0.0  # the one smooth pixel

    albedo = np.zeros((H, W, 4), np.float32)
    albedo[..., :3] = 1.0
    albedo[40, 32, 3] = 1.0  # metallic → f0 = 1 → Fresnel = 1

    hdr = np.zeros((H, W, 4), np.float32)
    hdr[..., 3] = 1.0
    hdr[56:, :, 1] = 1.0  # the wall is green

    depth = np.full((H, W), 0.5, np.float32)
    return hdr, albedo, normal, pos, depth, cam


def _run(hdr, albedo, normal, pos, depth, cam, params=None, steps=16,
         refine=6):
    return np.asarray(ssr_reflect(
        jnp.asarray(hdr), jnp.asarray(albedo), jnp.asarray(normal),
        jnp.asarray(pos), jnp.asarray(depth), jnp.asarray(cam),
        jnp.asarray(_ortho_pixel_vp(W, H)),
        params if params is not None else _params(),
        steps=steps, refine=refine, jitter=False,
    ))


class TestReflect:
    def test_mirror_pixel_reflects_wall(self):
        """The pinned ray hits the wall: the mirror pixel gains green
        (≈ dist_fade × Fresnel = ~0.4 × 1), every other pixel — rough,
        so gated off — passes through exactly."""
        hdr, albedo, normal, pos, depth, cam = _mirror_wall_buffers()
        out = _run(hdr, albedo, normal, pos, depth, cam)
        gain = out[40, 32, 1] - hdr[40, 32, 1]
        assert 0.2 < gain < 0.6, gain
        mask = np.ones((H, W), bool)
        mask[40, 32] = False
        np.testing.assert_allclose(out[mask], hdr[mask], atol=1e-6)

    def test_zero_strength_identity(self):
        hdr, albedo, normal, pos, depth, cam = _mirror_wall_buffers()
        out = _run(hdr, albedo, normal, pos, depth, cam,
                   params=_params(strength=0.0))
        np.testing.assert_allclose(out, hdr, atol=1e-6)

    def test_rough_pixel_gated_off(self):
        """max_roughness below the pixel's roughness → no reflection even
        though the ray would hit."""
        hdr, albedo, normal, pos, depth, cam = _mirror_wall_buffers()
        normal = normal.copy()
        normal[40, 32, 3] = 0.7  # rougher than max_rough = 0.6
        out = _run(hdr, albedo, normal, pos, depth, cam)
        np.testing.assert_allclose(out, hdr, atol=1e-6)

    def test_background_pixels_unchanged(self):
        """depth == 0 (background) pixels never reflect."""
        hdr, albedo, normal, pos, depth, cam = _mirror_wall_buffers()
        depth = depth.copy()
        depth[40, 32] = 0.0
        out = _run(hdr, albedo, normal, pos, depth, cam)
        np.testing.assert_allclose(out, hdr, atol=1e-6)

    def test_backface_hit_rejected(self):
        """Flip the wall's normals toward +y (facing AWAY from the ray):
        the hit is rejected — no silhouette leak-through."""
        hdr, albedo, normal, pos, depth, cam = _mirror_wall_buffers()
        normal = normal.copy()
        normal[56:, :, :3] = (0.0, 1.0, 0.0)
        out = _run(hdr, albedo, normal, pos, depth, cam)
        np.testing.assert_allclose(out, hdr, atol=1e-6)

    def test_alpha_passthrough(self):
        hdr, albedo, normal, pos, depth, cam = _mirror_wall_buffers()
        hdr = hdr.copy()
        hdr[..., 3] = 0.37
        out = _run(hdr, albedo, normal, pos, depth, cam)
        np.testing.assert_allclose(out[..., 3], 0.37, atol=1e-6)

    def test_jitter_still_hits(self):
        """Phase dither moves the tap positions, not the geometry: the
        mirror pixel still lands on the wall (bisection refines to the
        same crossing)."""
        hdr, albedo, normal, pos, depth, cam = _mirror_wall_buffers()
        out = np.asarray(ssr_reflect(
            jnp.asarray(hdr), jnp.asarray(albedo), jnp.asarray(normal),
            jnp.asarray(pos), jnp.asarray(depth), jnp.asarray(cam),
            jnp.asarray(_ortho_pixel_vp(W, H)), _params(),
            steps=16, refine=6, jitter=True,
        ))
        assert out[40, 32, 1] - hdr[40, 32, 1] > 0.15


class _FakeCam:
    """render_to only reads these two camera attributes."""

    def __init__(self, vp, loc):
        self.render_view_projection = vp
        self.location = loc


class TestSPMD:
    def test_ssr_node_sharded_matches_single(self, cpu_devices):
        """The SSR node under CompileOptions(mesh): the march gathers run
        on the gathered full surfaces and the band slices back — output
        matches single-device exactly (the motion-blur/TAA pattern)."""
        from zenith.parallel.sharding import default_mesh
        from zenith.renderer.ssr import ScreenSpaceReflections
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import Format, PipelineCache, RhiCore, TextureDesc

        core = RhiCore()
        device = core.create_render_device()
        h2, w2 = 256, 128
        vp = np.zeros((4, 4), np.float32)
        vp[0, 0] = 2.0 / w2
        vp[0, 3] = 1.0 / w2 - 1.0
        vp[1, 1] = 2.0 / h2
        vp[1, 3] = 1.0 / h2 - 1.0
        vp[2, 2] = 1.0
        vp[3, 3] = 1.0
        cam_pos = np.array([64.0, 0.0, 80.0], np.float32)
        cam = _FakeCam(vp, cam_pos)

        def run(options):
            ssr = ScreenSpaceReflections(
                steps=24, refine=4, max_distance=400.0, thickness=8.0,
                max_roughness=0.6, jitter=True,
            )
            builder = RenderGraphBuilder()
            hdr = builder.create(TextureDesc.color("hdr", w2, h2))
            galb = builder.create(TextureDesc.color("galb", w2, h2))
            gnrm = builder.create(TextureDesc.color("gnrm", w2, h2))
            gpos = builder.create(TextureDesc.color("gpos", w2, h2))
            gdep = builder.create(TextureDesc.depth("gdep", w2, h2))
            out = builder.create(TextureDesc.color("ssr.out", w2, h2))

            gen = builder.add_lambda_node("gen")
            hdr_w = gen.write(hdr)
            a_w = gen.write(galb)
            n_w = gen.write(gnrm)
            p_w = gen.write(gpos)
            d_w = gen.write(gdep)

            def record_gen(ctx):
                bh = h2 // ctx.num_shards
                row0 = 0
                if ctx.sharded:
                    row0 = jax.lax.axis_index(ctx.shard_axis) * bh
                rows = (row0 + jnp.arange(bh, dtype=jnp.float32))[:, None]
                cols = jnp.arange(w2, dtype=jnp.float32)[None, :]
                rows2 = jnp.broadcast_to(rows, (bh, w2))
                cols2 = jnp.broadcast_to(cols, (bh, w2))
                wall = rows2 >= 224.0  # elevated green plate
                z = jnp.where(wall, 60.0, 0.0)
                ctx.set(p_w, jnp.stack(
                    [cols2, rows2, z, jnp.zeros_like(z)], -1
                ))
                # Mirror floor everywhere below the wall; the wall faces -y.
                nrm = jnp.where(
                    wall[..., None],
                    jnp.asarray([0.0, -1.0, 0.0], jnp.float32),
                    jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                )
                rough = jnp.where(wall, 1.0, 0.05)
                ctx.set(n_w, jnp.concatenate(
                    [nrm, rough[..., None]], -1
                ))
                alb = jnp.concatenate(
                    [jnp.full((bh, w2, 3), 0.9, jnp.float32),
                     jnp.full((bh, w2, 1), 1.0, jnp.float32)], -1
                )
                ctx.set(a_w, alb)
                green = jnp.where(wall, 1.0, 0.05)
                ctx.set(hdr_w, jnp.stack(
                    [jnp.full_like(green, 0.05), green,
                     jnp.full_like(green, 0.05), jnp.ones_like(green)], -1
                ))
                ctx.set(d_w, jnp.full((bh, w2), 0.5, jnp.float32))

            gen.execute(record_gen)
            ssr.render_to(builder, hdr, out, cam,
                          {"albedo": galb, "normal": gnrm,
                           "pos": gpos, "depth": gdep})
            builder.export(out)
            builder.export(hdr)
            compiled = builder.build().compile(
                device, PipelineCache(), options
            )
            compiled.execute(device)
            return np.asarray(compiled.value(out)), np.asarray(
                compiled.value(hdr)
            )

        img1, src1 = run(CompileOptions(tile_h=8, tile_w=128))
        mesh = default_mesh(8, backend="cpu")
        img8, _ = run(CompileOptions(tile_h=8, tile_w=128, mesh=mesh))
        # The mirror floor actually picked up reflections.
        assert np.abs(img1[..., :3] - src1[..., :3]).max() > 1e-3
        np.testing.assert_allclose(img8, img1, atol=1e-5)


class TestScene:
    def test_scene_ssr_one_program_and_finite(self):
        """Full deferred scene with --ssr: one frame program across frames
        (camera values ride dynamics — zero recompiles while orbiting),
        finite output."""
        from zenith.launch import launch
        from zenith.rendergraph.graph import (
            clear_frame_program_cache,
            frame_program_cache_size,
        )
        from zenith.sandbox.scene import SceneApp
        from zenith.window import Window

        clear_frame_program_cache()
        window = Window(width=128, height=64, title="t")
        launch(
            SceneApp,
            argv=["--", "--mode", "deferred", "--lights", "4", "--ssr"],
            window=window,
            max_frames=4,
        )
        assert frame_program_cache_size() == 1
        frame = np.asarray(window.last_frame)
        assert np.isfinite(frame.astype(np.float64)).all()
        assert frame[..., :3].std() > 1.0
