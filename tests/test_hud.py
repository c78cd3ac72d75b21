"""HUD overlay (renderer.hud): host bitfont rasterization, the composite
node, no-recompile text updates, and SPMD banding."""

import numpy as np
import pytest

import jax.numpy as jnp

from zenith.renderer.hud import (
    GLYPH_H,
    GLYPH_W,
    HudOverlay,
    render_text_bitmap,
)

W, H = 128, 64


class TestBitfont:
    def test_known_glyph_pixels(self):
        bm = render_text_bitmap("I", max_chars=1, scale=1)
        assert bm.shape == (GLYPH_H, GLYPH_W)
        # 'I': top/bottom bars of 3 + 5 column pixels = 11 set pixels.
        assert bm.sum() == 11
        assert bm[1, 2] == 1.0  # the center column

    def test_scale_and_padding(self):
        bm = render_text_bitmap("AB", max_chars=4, scale=2)
        assert bm.shape == (GLYPH_H * 2, GLYPH_W * 2 * 4)
        # Chars beyond the text are blank.
        assert bm[:, GLYPH_W * 2 * 2:].sum() == 0
        # 2x scale quadruples the set-pixel area.
        bm1 = render_text_bitmap("AB", max_chars=4, scale=1)
        assert bm.sum() == 4 * bm1.sum()

    def test_lowercase_and_unknown(self):
        low = render_text_bitmap("abc", max_chars=3, scale=1)
        up = render_text_bitmap("ABC", max_chars=3, scale=1)
        np.testing.assert_array_equal(low, up)
        assert render_text_bitmap("~", max_chars=1, scale=1).sum() == 0

    def test_set_text_caches(self):
        hud = HudOverlay(max_chars=8)
        hud.set_text("FPS 60")
        a = hud._bitmap
        hud.set_text("FPS 60")
        assert hud._bitmap is a  # same object: rasterization skipped
        hud.set_text("FPS 61")
        assert hud._bitmap is not a


class TestGraph:
    def _compile_run(self, hud, options=None):
        from zenith.rendergraph import RenderGraphBuilder
        from zenith.rendergraph.graph import CompileOptions
        from zenith.rhi import PipelineCache, RhiCore, TextureDesc

        device = RhiCore().create_render_device()
        builder = RenderGraphBuilder()
        ldr = builder.create(TextureDesc.color("ldr", W, H))
        gen = builder.add_lambda_node("fill")
        dst = gen.write(ldr)

        def fill(ctx):
            bh = H // ctx.num_shards
            ctx.set(dst, jnp.full((bh, W, 4), 0.25, jnp.float32))

        gen.execute(fill)
        hud.render_to(builder, ldr)
        builder.export(ldr)
        compiled = builder.build().compile(
            device, PipelineCache(),
            options or CompileOptions(tile_h=8, tile_w=128),
        )
        compiled.execute(device)
        return np.asarray(compiled.value(ldr))

    def test_overlay_composites_in_corner_only(self):
        hud = HudOverlay(max_chars=8, scale=1, margin=8)
        hud.set_text("FPS 123")
        out = self._compile_run(hud)
        bh, bw = hud.bitmap_shape
        box = out[8:8 + bh, 8:8 + bw, :3]
        outside = out[8 + bh + 2:, :, :3]
        assert (box != 0.25).any()  # text + dimmed box
        np.testing.assert_allclose(outside, 0.25, atol=1e-6)
        assert np.all(out[..., 3] == out[0, 0, 3])  # alpha untouched
        # White text pixels are bright, the box backdrop is dimmed.
        assert box.max() > 0.9
        assert box.min() < 0.25 - 0.05

    def test_text_change_never_recompiles(self):
        from zenith.rendergraph.graph import (
            clear_frame_program_cache,
            frame_program_cache_size,
        )

        clear_frame_program_cache()
        hud = HudOverlay(max_chars=8, scale=1)
        hud.set_text("FRAME 1")
        a = self._compile_run(hud)
        hud.set_text("FRAME 2")
        b = self._compile_run(hud)
        assert frame_program_cache_size() == 1
        assert np.abs(a - b).max() > 0.0  # the text actually changed

    def test_scene_hud_one_program(self):
        """--hud on the sandbox: the FPS text updates every frame yet ONE
        frame program serves the run (the bitmap is a dynamic)."""
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
            argv=["--", "--mode", "deferred", "--lights", "4", "--hud"],
            window=window,
            max_frames=4,
        )
        assert frame_program_cache_size() == 1
        frame = np.asarray(window.last_frame)
        # The HUD box region differs from its neighborhood below.
        assert frame[8:20, 8:60, :3].std() > 1.0

    def test_spmd_matches_single_device(self, cpu_devices):
        """The overlay spans several 8-row bands (margin 8, height 16):
        the padded dynamic-slice composite must tile exactly."""
        from zenith.parallel.sharding import default_mesh
        from zenith.rendergraph.graph import CompileOptions

        def hud():
            h = HudOverlay(max_chars=10, scale=2, margin=8)
            h.set_text("SPMD 8X")
            return h

        img1 = self._compile_run(hud())
        mesh = default_mesh(8, backend="cpu")
        img8 = self._compile_run(
            hud(), CompileOptions(tile_h=8, tile_w=128, mesh=mesh)
        )
        np.testing.assert_allclose(img8, img1, atol=1e-6)


class TestOverflowIndicator:
    """In-band bin-overflow telemetry (ctx.frame_overflow → red HUD bar):
    zero host reads — the overflow scalar never leaves the device."""

    def _run(self, *, overflow: bool, indicator: bool = True,
             options=None):
        from zenith.rendergraph import RenderGraphBuilder
        from zenith.rendergraph.graph import CompileOptions
        from zenith.rhi import (
            Buffer,
            ColorAttachmentDesc,
            CullMode,
            GraphicShaderInput,
            PipelineCache,
            RasterizationState,
            RhiCore,
            TextureDesc,
            VertexLayout,
            attr,
        )
        from zenith.rhi.state import GraphicPipelineState

        device = RhiCore().create_render_device()
        builder = RenderGraphBuilder()
        ldr = builder.create(TextureDesc.color("ldr", W, H))

        # 300 coincident full-screen triangles; a tiny entry budget
        # cannot hold 300 entries x 8 tiles → bin overflow.
        tri = np.array(
            [[-3, -3, 0.5], [3, -3, 0.5], [0, 3, 0.5]], np.float32
        )
        vb = Buffer.from_numpy("ovf.vb", np.tile(tri, (300, 1)))
        ib = Buffer.from_numpy(
            "ovf.ib", np.arange(300 * 3, dtype=np.int32)
        )
        vbr = builder.import_resource(vb)
        ibr = builder.import_resource(ib)

        def vs(attrs, res):
            pos = attrs["position"]
            n = pos.shape[0]
            return {"position": jnp.concatenate(
                [pos, jnp.ones((n, 1), jnp.float32)], 1
            )}

        def fs(varyings, res, builtins):
            import jax.numpy as _j
            h, w = builtins.depth.shape
            return _j.full((h, w, 4), 0.25, _j.float32)

        from zenith.rhi import Shader

        vsd = Shader.vertex("ovf.vs", vs, inputs=[attr("position", 3)])
        fsd = Shader.fragment("ovf.fs", fs)
        node = builder.add_graphic_node("spam")
        vba, iba = node.read(vbr), node.read(ibr)
        rt = node.write(ldr)
        si = GraphicShaderInput(
            vsd, fsd, VertexLayout.from_fields(("position", 3))
        )
        state = GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE)
        )
        with node.pipeline(si, state) as binder:
            binder.push_color(
                rt, ColorAttachmentDesc(clear_value=(0.25, 0.25, 0.25, 1))
            )

        budget = 8 if overflow else 65536

        def record(ctx):
            ctx.draw_indexed(vba, iba, entry_budget=budget)

        node.execute(record)

        hud = HudOverlay(max_chars=8, scale=1, margin=8,
                         overflow_indicator=indicator)
        hud.set_text("FPS 1")
        hud.render_to(builder, ldr)
        builder.export(ldr)
        from zenith.rhi import PipelineCache as _PC

        compiled = builder.build().compile(
            device, _PC(),
            options or CompileOptions(tile_h=8, tile_w=128),
        )
        compiled.execute(device)
        img = np.asarray(compiled.value(ldr))
        bh, _bw = hud.bitmap_shape
        bar = img[8 + bh + 2:8 + bh + 2 + max(2, bh // 4), 8:, :3]
        return img, bar

    def test_overflow_draws_red_bar(self):
        img, bar = self._run(overflow=True)
        # Red warning pixels: strong R, suppressed G/B.
        red = (bar[..., 0] > 0.9) & (bar[..., 1] < 0.3)
        assert red.any()

    def test_no_overflow_no_bar(self):
        img, bar = self._run(overflow=False)
        np.testing.assert_allclose(bar, 0.25, atol=1e-6)

    def test_indicator_off_untouched_even_on_overflow(self):
        img, bar = self._run(overflow=True, indicator=False)
        np.testing.assert_allclose(bar, 0.25, atol=1e-6)

    def test_spmd_bar_shows_on_mesh(self, cpu_devices):
        """Under a row-band mesh the indicator reads the psum'd overflow
        total, so EVERY band composites a bar. (No bit-equality check: an
        overflowing draw DROPS records, and which records drop depends on
        the per-shard binning — the image itself legitimately differs.)"""
        from zenith.parallel.sharding import default_mesh
        from zenith.rendergraph.graph import CompileOptions

        mesh = default_mesh(8, backend="cpu")
        _img, bar = self._run(
            overflow=True,
            options=CompileOptions(tile_h=8, tile_w=128, mesh=mesh),
        )
        red = (bar[..., 0] > 0.9) & (bar[..., 1] < 0.3)
        assert red.any()
