"""Temporal AA: jitter math, resolve reprojection, engine feedback loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zenith.core.camera import Camera
from zenith.core.mathtypes import Degree, Radians
from zenith.renderer.taa import (
    TemporalAA,
    jitter_sequence,
    taa_resolve,
)

W, H = 64, 32


def _ortho_pixel_vp(w, h, dx=0.0, dy=0.0):
    """A view-projection that maps world (x, y, ·) to pixel
    (x + dx, y + dy) under taa_resolve's NDC→pixel convention
    (sx = (ndc·0.5 + 0.5)·w − 0.5)."""
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


def _smooth_pattern(w, h):
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    r = 0.5 + 0.4 * np.sin(xs * 0.21)
    g = 0.5 + 0.4 * np.cos(ys * 0.17)
    b = 0.5 + 0.3 * np.sin((xs + ys) * 0.11)
    a = np.ones_like(r)
    return np.stack([r, g, b, a], axis=-1).astype(np.float32)


class TestJitter:
    def test_sequence_range_and_spread(self):
        seq = jitter_sequence(8)
        assert len(seq) == 8
        for ox, oy in seq:
            assert -0.5 <= ox < 0.5 and -0.5 <= oy < 0.5
        assert len({(round(a, 6), round(b, 6)) for a, b in seq}) == 8

    def test_camera_jitter_matrix(self):
        cam = Camera(fov_y=Degree(35.0), aspect_ratio=2.0)
        cam.set_position(np.array([3.0, -5.0, 2.0], np.float32))
        cam.set_yaw_pitch(Radians(0.3), Radians(-0.2))
        base = cam.render_view_projection_unjittered.copy()
        cam.set_jitter(0.002, -0.003)
        rvp = cam.render_view_projection
        assert not np.allclose(rvp, base)
        # Unjittered base unaffected; jitter is exactly a clip-space
        # translation: (rvp - base) rows 0/1 = jitter × row 3.
        np.testing.assert_allclose(
            cam.render_view_projection_unjittered, base
        )
        np.testing.assert_allclose(rvp[0] - base[0], 0.002 * base[3],
                                   atol=1e-6)
        np.testing.assert_allclose(rvp[1] - base[1], -0.003 * base[3],
                                   atol=1e-6)
        # The analytic inverse tracks the jitter.
        err = np.abs(
            rvp.astype(np.float64) @ cam.render_inv_view_projection
            - np.eye(4)
        ).max()
        assert err < 1e-4
        cam.set_jitter(0.0, 0.0)
        np.testing.assert_allclose(cam.render_view_projection, base)

    def test_jitter_camera_cycles(self):
        cam = Camera()
        taa = TemporalAA(sequence_length=4)
        mats = []
        for _ in range(4):
            taa.jitter_camera(cam, W, H)
            mats.append(cam.render_view_projection.copy())
        taa.jitter_camera(cam, W, H)  # wraps to seq[0]
        np.testing.assert_allclose(cam.render_view_projection, mats[0])


class TestResolve:
    def test_static_scene_identity(self):
        """history == current and exact reprojection → output == current."""
        world = _grid_world(W, H)
        cur = _smooth_pattern(W, H)
        depth = np.full((H, W), 0.5, np.float32)
        out = taa_resolve(
            jnp.asarray(cur), jnp.asarray(cur), jnp.asarray(world),
            jnp.asarray(depth), jnp.asarray(_ortho_pixel_vp(W, H)),
            jnp.float32(1.0),
        )
        np.testing.assert_allclose(np.asarray(out), cur, atol=1e-5)

    def test_first_frame_passthrough(self):
        """valid = 0 → garbage history is ignored entirely."""
        world = _grid_world(W, H)
        cur = _smooth_pattern(W, H)
        garbage = np.full((H, W, 4), 1e6, np.float32)
        depth = np.full((H, W), 0.5, np.float32)
        out = taa_resolve(
            jnp.asarray(cur), jnp.asarray(garbage), jnp.asarray(world),
            jnp.asarray(depth), jnp.asarray(_ortho_pixel_vp(W, H)),
            jnp.float32(0.0),
        )
        np.testing.assert_array_equal(np.asarray(out), cur)

    def test_reprojection_shift(self):
        """Camera moved by (dx, dy) pixels: the history (rendered from the
        previous camera) reprojects back onto the current frame."""
        dx, dy = 5, 3
        world = _grid_world(W, H)
        cur = _smooth_pattern(W, H)
        # Previous frame: world (x, y) landed at pixel (x+dx, y+dy), so the
        # history image is the pattern shifted by (dy, dx).
        history = np.roll(cur, (dy, dx), axis=(0, 1))
        depth = np.full((H, W), 0.5, np.float32)
        out = np.asarray(taa_resolve(
            jnp.asarray(cur), jnp.asarray(history), jnp.asarray(world),
            jnp.asarray(depth),
            jnp.asarray(_ortho_pixel_vp(W, H, dx=dx, dy=dy)),
            jnp.float32(1.0),
        ))
        # Interior pixels: reprojected history == current pattern → output
        # equals the pattern (the roll wraps at edges; stay inside).
        inner = np.s_[dy + 1:H - dy - 1, dx + 1:W - dx - 1]
        np.testing.assert_allclose(out[inner], cur[inner], atol=1e-4)

    def test_offscreen_reprojection_rejected(self):
        """A previous-VP that throws every pixel off screen → current frame
        passes through (no history stretch-in)."""
        world = _grid_world(W, H)
        cur = _smooth_pattern(W, H)
        history = np.zeros((H, W, 4), np.float32)
        depth = np.full((H, W), 0.5, np.float32)
        out = np.asarray(taa_resolve(
            jnp.asarray(cur), jnp.asarray(history), jnp.asarray(world),
            jnp.asarray(depth),
            jnp.asarray(_ortho_pixel_vp(W, H, dx=4 * W, dy=0)),
            jnp.float32(1.0),
        ))
        np.testing.assert_array_equal(out, cur)

    def test_clamp_rejects_stale_history(self):
        """History wildly outside the current 3x3 neighborhood is clamped
        into it — ghosting is bounded by the neighborhood range."""
        world = _grid_world(W, H)
        cur = np.full((H, W, 4), 0.5, np.float32)
        history = np.full((H, W, 4), 100.0, np.float32)
        depth = np.full((H, W), 0.5, np.float32)
        out = np.asarray(taa_resolve(
            jnp.asarray(cur), jnp.asarray(history), jnp.asarray(world),
            jnp.asarray(depth), jnp.asarray(_ortho_pixel_vp(W, H)),
            jnp.float32(1.0),
        ))
        np.testing.assert_allclose(out[..., :3], 0.5, atol=1e-5)

    def test_background_zero_motion(self):
        """depth == 0 pixels ignore the reprojection matrix (zero motion)."""
        world = np.full((H, W, 3), 1e9, np.float32)  # nonsense positions
        cur = _smooth_pattern(W, H)
        depth = np.zeros((H, W), np.float32)  # all background
        out = np.asarray(taa_resolve(
            jnp.asarray(cur), jnp.asarray(cur), jnp.asarray(world),
            jnp.asarray(depth), jnp.asarray(_ortho_pixel_vp(W, H)),
            jnp.float32(1.0),
        ))
        np.testing.assert_allclose(out, cur, atol=1e-5)


class TestEngineFeedback:
    def test_request_output_round_trip_rebuild_and_retained(self):
        """request_output → on_frame_outputs hands back the exported device
        value each frame, on the rebuild AND the retained path."""
        from zenith.app import RenderableApp
        from zenith.launch import launch
        from zenith.rhi import BufferDesc
        from zenith.window import Window

        got = []

        class App(RenderableApp):
            retained = False

            def __init__(self, args):
                super().__init__(args)
                self.frame = 0

            def tick(self, dt):
                self.frame += 1

            def update_dynamics(self):
                if not self.retained:
                    return None
                return {"t": np.float32(self.frame)}

            def on_frame_outputs(self, outputs):
                got.append(np.asarray(outputs["acc"]))

            def render(self, context):
                builder = context.builder()
                out = builder.import_resource(context.swapchain_texture())
                acc = builder.create(BufferDesc.storage("acc", (1,)))
                builder.set_dynamic("t", np.float32(self.frame))
                node = builder.add_lambda_node("fill")
                dst = node.write(out)
                accw = node.write(acc)

                def record(ctx):
                    t = ctx.dynamic("t")
                    ctx.set(dst, jnp.zeros_like(ctx.get(dst)))
                    ctx.set(accw, (t * 2.0)[None])

                node.execute(record)
                builder.export(acc)
                context.request_output("acc", acc)

        class AppRetained(App):
            retained = True

        for cls in (App, AppRetained):
            got.clear()
            window = Window(width=64, height=32, title="t")
            launch(cls, argv=[], window=window, max_frames=4)
            assert len(got) == 4, f"{cls.__name__}: {len(got)}"
            # tick() precedes the first render, so frames are 1-indexed.
            np.testing.assert_allclose(
                np.concatenate(got), [2.0, 4.0, 6.0, 8.0]
            )


class TestSceneTAA:
    def test_scene_taa_one_program_and_finite(self):
        """Full deferred scene with --taa: one frame program across frames
        (jitter + history + valid-flag flip cause zero recompiles), finite
        output, and the history feedback actually accumulates (consecutive
        frames differ less with TAA than without at the same orbit)."""
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
            argv=["--", "--mode", "deferred", "--lights", "4", "--taa"],
            window=window,
            max_frames=4,
        )
        assert frame_program_cache_size() == 1
        frame = np.asarray(window.last_frame)
        assert np.isfinite(frame.astype(np.float64)).all()
        assert frame[..., :3].std() > 1.0  # actually rendered something


class TestSPMD:
    def test_taa_node_sharded_matches_single(self, cpu_devices):
        """The TAA node under CompileOptions(mesh): reprojection gathers run
        on the gathered full surfaces and the band slices back — output
        matches single-device within fp tolerance."""
        import jax

        from zenith.parallel.sharding import default_mesh
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.renderer import TemporalAA
        from zenith.rhi import Format, PipelineCache, RhiCore, TextureDesc

        core = RhiCore()
        device = core.create_render_device()
        h2, w2 = 256, 128
        cam = Camera(fov_y=Degree(40.0), aspect_ratio=w2 / h2)
        cam.set_position(np.array([0.0, -40.0, 10.0], np.float32))
        cam.set_yaw_pitch(Radians(0.0), Radians(-0.2))
        history = np.random.default_rng(5).uniform(
            0, 1, (h2, w2, 4)
        ).astype(np.float32)

        def run(options, taa):
            builder = RenderGraphBuilder()
            hdr = builder.create(TextureDesc.color("hdr", w2, h2))
            gpos = builder.create(TextureDesc.color("gpos", w2, h2))
            gdep = builder.create(TextureDesc.depth("gdep", w2, h2))
            out = builder.create(TextureDesc.color("taa.out", w2, h2))

            gen = builder.add_lambda_node("gen")
            hdr_w = gen.write(hdr)
            p_w = gen.write(gpos)
            d_w = gen.write(gdep)

            def record_gen(ctx):
                import jax.numpy as jnp

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
                # A world plane at z=0 spanning the view.
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
            taa.feedback(jax.numpy.asarray(history))
            taa._hw = (h2, w2)  # seed so feedback survives render_to
            taa.render_to(builder, hdr, out, cam, w2, h2,
                          {"pos": gpos, "depth": gdep})
            compiled = builder.build().compile(
                device, PipelineCache(), options
            )
            compiled.execute(device)
            return np.asarray(compiled.value(out))

        img1 = run(CompileOptions(tile_h=8, tile_w=128), TemporalAA())
        mesh = default_mesh(8, backend="cpu")
        img8 = run(CompileOptions(tile_h=8, tile_w=128, mesh=mesh),
                   TemporalAA())
        assert img1[..., :3].std() > 0.01
        np.testing.assert_allclose(img8, img1, atol=1e-5)


class TestFeedbackRobustness:
    def test_unexported_requested_output_warns_not_crashes(self):
        """request_output on a resource that was never exported: the frame
        must complete, with a warning naming the missing export. (A handler
        attached directly to the engine logger — launch() reconfigures root
        handlers, and stderr fds belong to whichever test ran launch
        first.)"""
        import logging

        from zenith.app import RenderableApp
        from zenith.launch import launch
        from zenith.window import Window

        got = []

        class App(RenderableApp):
            def on_frame_outputs(self, outputs):
                got.append(outputs)

            def render(self, context):
                builder = context.builder()
                out = builder.import_resource(context.swapchain_texture())
                node = builder.add_lambda_node("fill")
                dst = node.write(out)

                def record(ctx):
                    ctx.set(dst, jnp.zeros_like(ctx.get(dst)))

                node.execute(record)
                from zenith.rhi import BufferDesc

                acc = builder.create(BufferDesc.storage("acc", (1,)))
                w = node  # unused
                context.request_output("acc", acc)  # NOT exported

        records = []

        class Capture(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        handler = Capture(level=logging.WARNING)
        eng_logger = logging.getLogger("zenith.engine")
        eng_logger.addHandler(handler)
        try:
            window = Window(width=64, height=32, title="t")
            loop = launch(App, argv=[], window=window, max_frames=2)
        finally:
            eng_logger.removeHandler(handler)
        assert loop.frames_rendered == 2
        assert got == []  # nothing delivered
        assert any(
            "request_output('acc')" in m and "builder.export" in m
            for m in records
        )


class TestBorderClamp:
    def test_neighborhood_clamp_does_not_wrap(self):
        """A bright stripe at the BOTTOM edge must not widen the clamp
        bounds of TOP-edge pixels (jnp.roll would wrap; the clamp uses
        edge-padded shifts)."""
        world = _grid_world(W, H)
        cur = np.full((H, W, 4), 0.2, np.float32)
        cur[-1, :, :3] = 5.0  # bright bottom row
        history = np.full((H, W, 4), 0.2, np.float32)
        history[0, :, :3] = 4.0  # stale bright history at the TOP row
        depth = np.full((H, W), 0.5, np.float32)
        out = np.asarray(taa_resolve(
            jnp.asarray(cur), jnp.asarray(history), jnp.asarray(world),
            jnp.asarray(depth), jnp.asarray(_ortho_pixel_vp(W, H)),
            jnp.float32(1.0),
        ))
        # Top row: local neighborhood is all 0.2 → the 4.0 history must be
        # clamped to 0.2 (a wrapping clamp would admit the bottom row's 5.0
        # and let the ghost through).
        np.testing.assert_allclose(out[0, :, :3], 0.2, atol=1e-4)
