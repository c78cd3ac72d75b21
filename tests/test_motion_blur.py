"""Motion blur: velocity reprojection, streak taps, clamping, SPMD."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zenith.core.camera import Camera
from zenith.core.mathtypes import Degree, Radians
from zenith.renderer.motion_blur import MotionBlur, motion_blur_resolve

W, H = 64, 32


def _ortho_pixel_vp(w, h, dx=0.0, dy=0.0):
    """A view-projection that maps world (x, y, ·) to pixel
    (x + dx, y + dy) under the resolver's NDC→pixel convention
    (same helper as tests/test_taa.py)."""
    vp = np.zeros((4, 4), np.float32)
    vp[0, 0] = 2.0 / w
    vp[0, 3] = (2.0 * (dx + 0.5)) / w - 1.0
    vp[1, 1] = 2.0 / h
    vp[1, 3] = (2.0 * (dy + 0.5)) / h - 1.0
    vp[2, 2] = 1.0
    vp[3, 3] = 1.0
    return vp


def _grid_world(w, h):
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    return np.stack([xs, ys, np.zeros_like(xs)], axis=-1)


def _params(strength=1.0, max_radius=32.0):
    return jnp.asarray([strength, max_radius, 0.0, 0.0], jnp.float32)


def _resolve(cur, world, depth, vp, params, samples=8, jitter=False):
    return np.asarray(motion_blur_resolve(
        jnp.asarray(cur), jnp.asarray(world), jnp.asarray(depth),
        jnp.asarray(vp), params, samples, jitter,
    ))


class TestResolve:
    def test_static_camera_identity(self):
        """Zero motion (prev == current projection) → exact passthrough."""
        world = _grid_world(W, H)
        rng = np.random.default_rng(3)
        cur = rng.uniform(0, 2, (H, W, 4)).astype(np.float32)
        depth = np.full((H, W), 0.5, np.float32)
        out = _resolve(cur, world, depth, _ortho_pixel_vp(W, H), _params())
        np.testing.assert_allclose(out, cur, atol=1e-6)

    def test_zero_strength_identity(self):
        """strength = 0 → exact passthrough even under camera motion."""
        world = _grid_world(W, H)
        rng = np.random.default_rng(4)
        cur = rng.uniform(0, 2, (H, W, 4)).astype(np.float32)
        depth = np.full((H, W), 0.5, np.float32)
        out = _resolve(cur, world, depth, _ortho_pixel_vp(W, H, dx=7.0),
                       _params(strength=0.0))
        np.testing.assert_allclose(out, cur, atol=1e-6)

    def test_horizontal_streak_spread_and_energy(self):
        """Camera pan of 8 px: a bright column smears into 8 distinct
        columns (round-half-up taps — no half-to-even doubling), each
        carrying exactly 1/samples of the energy."""
        world = _grid_world(W, H)
        cur = np.zeros((H, W, 4), np.float32)
        cur[:, 20, :3] = 1.0
        cur[..., 3] = 1.0
        depth = np.full((H, W), 0.5, np.float32)
        # Previous frame: world x landed at pixel x+8 → velocity (-8, 0);
        # tap offsets floor(v·t + .5) for centered t = {-3..+4}.
        out = _resolve(cur, world, depth, _ortho_pixel_vp(W, H, dx=8.0),
                       _params(), samples=8)
        np.testing.assert_allclose(out[:, 16:24, :3], 0.125, atol=1e-6)
        mask = np.ones(W, bool)
        mask[16:24] = False
        np.testing.assert_allclose(out[:, mask, :3], 0.0, atol=1e-6)
        # Rows unaffected (velocity is pure x).
        assert np.ptp(out[:, 18, 0]) < 1e-6

    def test_max_radius_clamps_streak(self):
        """An 8-px velocity under max_radius=2 spreads at most ±1 px
        (clamped |v| = 2 → tap offsets within ±0.875)."""
        world = _grid_world(W, H)
        cur = np.zeros((H, W, 4), np.float32)
        cur[:, 20, :3] = 1.0
        depth = np.full((H, W), 0.5, np.float32)
        out = _resolve(cur, world, depth, _ortho_pixel_vp(W, H, dx=8.0),
                       _params(max_radius=2.0), samples=8)
        mask = np.ones(W, bool)
        mask[19:22] = False
        np.testing.assert_allclose(out[:, mask, :3], 0.0, atol=1e-6)
        np.testing.assert_allclose(out[:, 20, :3], 0.5, atol=1e-6)

    def test_background_zero_motion(self):
        """depth == 0 pixels ignore the reprojection entirely."""
        world = np.full((H, W, 3), 1e9, np.float32)
        rng = np.random.default_rng(5)
        cur = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)
        depth = np.zeros((H, W), np.float32)
        out = _resolve(cur, world, depth, _ortho_pixel_vp(W, H, dx=9.0),
                       _params())
        np.testing.assert_allclose(out, cur, atol=1e-6)

    def test_jitter_dithers_without_leaking_energy(self):
        """Per-pixel tap-phase jitter: identity still exact at zero
        velocity; under motion the output stays within the input's value
        range and the column-mean profile stays close to the unjittered
        resolve (noise, not bias)."""
        world = _grid_world(W, H)
        rng = np.random.default_rng(6)
        cur = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)
        depth = np.full((H, W), 0.5, np.float32)
        ident = _resolve(cur, world, depth, _ortho_pixel_vp(W, H),
                         _params(), jitter=True)
        np.testing.assert_allclose(ident, cur, atol=1e-6)
        vp = _ortho_pixel_vp(W, H, dx=8.0)
        uni = _resolve(cur, world, depth, vp, _params(), jitter=False)
        dith = _resolve(cur, world, depth, vp, _params(), jitter=True)
        assert not np.array_equal(uni, dith)  # the dither actually engages
        assert dith[..., :3].min() >= cur[..., :3].min() - 1e-6
        assert dith[..., :3].max() <= cur[..., :3].max() + 1e-6
        np.testing.assert_allclose(
            dith[:, 8:-8, :3].mean(axis=0), uni[:, 8:-8, :3].mean(axis=0),
            atol=0.05,
        )

    def test_alpha_passthrough(self):
        """The alpha plane rides through unblurred."""
        world = _grid_world(W, H)
        cur = np.zeros((H, W, 4), np.float32)
        cur[..., 3] = np.linspace(0, 1, W, dtype=np.float32)[None, :]
        depth = np.full((H, W), 0.5, np.float32)
        out = _resolve(cur, world, depth, _ortho_pixel_vp(W, H, dx=6.0),
                       _params())
        np.testing.assert_allclose(out[..., 3], cur[..., 3], atol=1e-6)


class TestObserver:
    def test_prev_vp_roll_idempotent(self):
        """frame_dynamics twice in one frame (update_dynamics + rebuild)
        must not double-roll; a camera change shifts prev by one frame."""
        cam = Camera(fov_y=Degree(35.0), aspect_ratio=2.0)
        cam.set_position(np.array([0.0, -10.0, 3.0], np.float32))
        mb = MotionBlur()
        vp0 = np.asarray(cam.render_view_projection_unjittered).copy()
        d1 = mb.frame_dynamics(cam)
        d2 = mb.frame_dynamics(cam)  # same frame, same camera
        np.testing.assert_array_equal(d1["mblur.prev_vp"], vp0)
        np.testing.assert_array_equal(d2["mblur.prev_vp"], vp0)
        cam.set_position(np.array([1.0, -10.0, 3.0], np.float32))
        d3 = mb.frame_dynamics(cam)
        np.testing.assert_array_equal(d3["mblur.prev_vp"], vp0)
        cam.set_position(np.array([2.0, -10.0, 3.0], np.float32))
        vp1 = np.asarray(cam.render_view_projection_unjittered)
        d4 = mb.frame_dynamics(cam)
        assert not np.array_equal(d4["mblur.prev_vp"], vp0)
        mb.reset()
        d5 = mb.frame_dynamics(cam)
        np.testing.assert_array_equal(d5["mblur.prev_vp"], vp1)


class TestSceneMotionBlur:
    def test_scene_motion_blur_one_program_and_finite(self):
        """Full deferred scene with --motion-blur: one frame program across
        frames (the prev-VP/params ride dynamics — zero recompiles while
        the camera orbits), finite output."""
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
            argv=["--", "--mode", "deferred", "--lights", "4",
                  "--motion-blur"],
            window=window,
            max_frames=4,
        )
        assert frame_program_cache_size() == 1
        frame = np.asarray(window.last_frame)
        assert np.isfinite(frame.astype(np.float64)).all()
        assert frame[..., :3].std() > 1.0


class TestSPMD:
    def test_motion_blur_node_sharded_matches_single(self, cpu_devices):
        """The motion-blur node under CompileOptions(mesh): streak gathers
        run on the gathered full surfaces and the band slices back —
        output matches single-device exactly."""
        from zenith.parallel.sharding import default_mesh
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import Format, PipelineCache, RhiCore, TextureDesc

        core = RhiCore()
        device = core.create_render_device()
        h2, w2 = 256, 128
        cam = Camera(fov_y=Degree(40.0), aspect_ratio=w2 / h2)
        cam.set_position(np.array([0.0, -40.0, 10.0], np.float32))
        cam.set_yaw_pitch(Radians(0.0), Radians(-0.2))

        def run(options):
            mb = MotionBlur(strength=1.0, max_radius=24.0)
            # Seed a one-frame camera move so there is real velocity.
            mb._observe_camera(cam)
            cam2 = Camera(fov_y=Degree(40.0), aspect_ratio=w2 / h2)
            cam2.set_position(np.array([3.0, -40.0, 10.0], np.float32))
            cam2.set_yaw_pitch(Radians(0.05), Radians(-0.2))
            mb._last_vp = np.asarray(
                cam.render_view_projection_unjittered, np.float32
            ).copy()
            mb._prev_vp = mb._last_vp

            builder = RenderGraphBuilder()
            hdr = builder.create(TextureDesc.color("hdr", w2, h2))
            gpos = builder.create(TextureDesc.color("gpos", w2, h2))
            gdep = builder.create(TextureDesc.depth("gdep", w2, h2))
            out = builder.create(TextureDesc.color("mb.out", w2, h2))

            gen = builder.add_lambda_node("gen")
            hdr_w = gen.write(hdr)
            p_w = gen.write(gpos)
            d_w = gen.write(gdep)

            def record_gen(ctx):
                bh = h2 // ctx.num_shards
                row0 = 0
                if ctx.sharded:
                    row0 = jax.lax.axis_index(ctx.shard_axis) * bh
                rows = row0 + jnp.arange(bh, dtype=jnp.float32)[:, None]
                cols = jnp.arange(w2, dtype=jnp.float32)[None, :]
                base = 0.3 + 0.5 * jnp.sin(rows * 0.11) * jnp.cos(cols * 0.07)
                img = jnp.stack(
                    [base, 1.0 - base, base * 0.5, jnp.ones_like(base)], -1
                )
                ctx.set(hdr_w, img)
                wx = (cols / w2 - 0.5) * 60.0
                wy = jnp.broadcast_to((rows / h2 - 0.5) * 30.0 + 10.0,
                                      (bh, w2))
                wpos = jnp.stack(
                    [jnp.broadcast_to(wx, (bh, w2)), wy,
                     jnp.zeros((bh, w2), jnp.float32),
                     jnp.zeros((bh, w2), jnp.float32)], -1
                )
                ctx.set(p_w, wpos)
                ctx.set(d_w, jnp.full((bh, w2), 0.5, jnp.float32))

            gen.execute(record_gen)
            mb.render_to(builder, hdr, out, cam2,
                         {"pos": gpos, "depth": gdep})
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
        # Real velocity → the blur actually moved energy around.
        assert np.abs(img1[..., :3] - src1[..., :3]).max() > 1e-3
        np.testing.assert_allclose(img8, img1, atol=1e-5)
