"""RHI layer tests: formats, resources, pipeline cache keys, swapchain ring."""

import numpy as np
import pytest

from zenith import rhi
from zenith.rhi import (
    BindingError,
    Buffer,
    BufferDesc,
    ColorAttachmentDesc,
    Format,
    GraphicPipelineAttachments,
    GraphicPipelineDesc,
    GraphicPipelineState,
    GraphicShaderInput,
    PipelineCache,
    RhiCore,
    Shader,
    Swapchain,
    SwapchainConfig,
    Texture,
    TextureDesc,
    VertexLayout,
    uniform,
)


class TestFormats:
    def test_srgb_roundtrip(self):
        import jax.numpy as jnp

        x = jnp.linspace(0.0, 1.0, 64)
        y = rhi.srgb_to_linear(rhi.linear_to_srgb(x))
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-5)

    def test_encode_present_bgra_srgb(self):
        import jax.numpy as jnp

        # Pure red, linear 1.0 → sRGB 255 in the B8G8R8A8 'R' slot (index 2).
        img = jnp.zeros((2, 2, 4)).at[..., 0].set(1.0).at[..., 3].set(1.0)
        out = np.asarray(rhi.encode_present(img, Format.BGRA8_SRGB))
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out[0, 0], [0, 0, 255, 255])

    def test_encode_srgb_curve_midpoint(self):
        import jax.numpy as jnp

        # linear 0.5 → sRGB ≈ 0.7354 → 188 (matches Vulkan UNORM_SRGB tables).
        img = jnp.full((1, 1, 4), 0.5)
        out = np.asarray(rhi.encode_present(img, Format.RGBA8_SRGB))
        assert out[0, 0, 0] == 188
        assert out[0, 0, 3] == 128  # alpha stays linear

    def test_decode_stored_srgb(self):
        px = np.array([[[188, 188, 188, 128]]], dtype=np.uint8)
        lin = rhi.decode_stored(px, Format.RGBA8_SRGB)
        assert lin[0, 0, 0] == pytest.approx(0.5, abs=5e-3)
        assert lin[0, 0, 3] == pytest.approx(128 / 255)


class TestResources:
    def test_buffer_upload_roundtrip(self):
        data = np.arange(12, dtype=np.float32).reshape(3, 4)
        buf = Buffer.from_numpy("test", data)
        np.testing.assert_array_equal(buf.read_back(), data)
        assert buf.desc.shape == (3, 4)

    def test_texture_from_numpy_srgb_linearizes(self):
        px = np.full((4, 4, 4), 255, dtype=np.uint8)
        tex = Texture.from_numpy("white", px, Format.RGBA8_SRGB)
        np.testing.assert_allclose(tex.read_back(), 1.0, atol=1e-6)

    def test_texture_mip_chain(self):
        px = np.zeros((8, 8, 4), dtype=np.uint8)
        px[:4] = 255  # top half white
        tex = Texture.from_numpy("half", px, Format.RGBA8_UNORM, generate_mips=True)
        assert tex.desc.mip_levels == 4  # 8→4→2→1
        last = np.asarray(tex.mips[-1])
        assert last.shape == (1, 1, 4)
        np.testing.assert_allclose(last[0, 0, 0], 0.5, atol=1e-6)

    def test_desc_hashable_cache_key(self):
        d1 = TextureDesc.color("rt", 64, 64)
        d2 = TextureDesc.color("rt", 64, 64)
        assert d1 == d2 and hash(d1) == hash(d2)
        assert d1 != TextureDesc.color("rt", 64, 32)


class TestVertexLayout:
    def test_unpack(self):
        layout = VertexLayout.from_fields(("position", 3), ("color", 3))
        assert layout.stride_floats == 6
        arr = np.arange(12, dtype=np.float32).reshape(2, 6)
        fields = layout.unpack(arr)
        np.testing.assert_array_equal(fields["position"], arr[:, :3])
        np.testing.assert_array_equal(fields["color"], arr[:, 3:])


def _dummy_vs(attrs, res):
    return {"position": attrs["position"]}


def _dummy_fs(varyings, res, builtins):
    return None


class TestPipelineCache:
    def test_same_desc_hits(self):
        vs = Shader.vertex("vs", _dummy_vs)
        fs = Shader.fragment("fs", _dummy_fs)
        layout = VertexLayout.from_fields(("position", 4))
        desc = GraphicPipelineDesc(
            shader_input=GraphicShaderInput(vs, fs, layout),
            state=GraphicPipelineState(),
            attachments=GraphicPipelineAttachments(color_formats=(Format.RGBA32F,)),
            color_attachment_descs=(ColorAttachmentDesc(),),
        )
        cache = PipelineCache()
        p1 = cache.get_or_create(desc)
        p2 = cache.get_or_create(desc)
        assert p1 is p2
        assert cache.stats.hits == 1 and cache.stats.misses == 1
        assert len(cache) == 1

    def test_stage_validation(self):
        fs = Shader.fragment("fs", _dummy_fs)
        desc = GraphicPipelineDesc(
            shader_input=GraphicShaderInput(fs),  # fragment in vertex slot
            state=GraphicPipelineState(),
            attachments=GraphicPipelineAttachments(),
        )
        with pytest.raises(BindingError):
            PipelineCache().get_or_create(desc)

    def test_depth_test_requires_depth_format(self):
        vs = Shader.vertex("vs", _dummy_vs)
        from zenith.rhi import DepthStencilDesc

        desc = GraphicPipelineDesc(
            shader_input=GraphicShaderInput(vs),
            state=GraphicPipelineState(
                depth_stencil=DepthStencilDesc().reverse_z()
            ),
            attachments=GraphicPipelineAttachments(color_formats=(Format.RGBA32F,)),
        )
        with pytest.raises(ValueError):
            PipelineCache().get_or_create(desc)


class TestBindings:
    def test_reflection_merge_conflict(self):
        from zenith.rhi import texture2d

        vs = Shader.vertex("vs", _dummy_vs, bindings=[uniform("Thing")])
        fs = Shader.fragment("fs", _dummy_fs, bindings=[texture2d("Thing")])
        with pytest.raises(BindingError):
            GraphicShaderInput(vs, fs).merged_reflection()

    def test_bound_resources_checked(self):
        from zenith.rhi import BoundResources

        vs = Shader.vertex("vs", _dummy_vs, bindings=[uniform("Time")])
        res = BoundResources(vs.reflection, {"Time": 1.25})
        assert res["Time"] == 1.25
        assert res.Time == 1.25
        with pytest.raises(BindingError):
            _ = res["Nope"]


class TestDebugNames:
    def test_set_debug_name_overrides_desc_name(self):
        import numpy as np

        core = RhiCore()
        device = core.create_render_device()
        b = device.upload_buffer("vb", np.zeros((3, 8), np.float32))
        assert b.debug_name == "vb"
        assert device.set_debug_name(b, "hero.vertices") is b
        assert b.debug_name == "hero.vertices"

    def test_validate_warnings_carry_names(self, caplog, monkeypatch):
        import logging

        import numpy as np

        from zenith.rendergraph import RenderGraphBuilder
        from zenith.rhi import PipelineCache, TextureDesc

        monkeypatch.setenv("ZENITH_VALIDATE", "1")
        core = RhiCore()
        device = core.create_render_device()
        builder = RenderGraphBuilder()
        tex = builder.create(TextureDesc.color("my.orphan", 8, 8))
        node = builder.add_lambda_node("writer")
        dst = node.write(tex)
        node.execute(lambda ctx: ctx.set(
            dst, __import__("jax.numpy", fromlist=["x"]).zeros((8, 8, 4))
        ))
        with caplog.at_level(logging.WARNING):
            builder.build().compile(device, PipelineCache())
        assert any("my.orphan" in r.message for r in caplog.records)


class TestSwapchain:
    def test_ring_and_backpressure(self):
        import jax.numpy as jnp

        core = RhiCore()
        device = core.create_render_device()
        delivered = []
        sc = Swapchain(
            device,
            SwapchainConfig(width=8, height=4, num_images=3),
            on_present=lambda img, idx: delivered.append((idx, img)),
        )
        for frame in range(5):
            idx, tex = sc.acquire_next_image()
            assert idx == frame % 3
            rendered = jnp.full((4, 8, 4), frame / 10.0)
            sc.present(rendered)
        sc.flush()
        assert [i for i, _ in delivered] == [0, 1, 2, 3, 4]
        img0 = delivered[0][1]
        assert img0.shape == (4, 8, 4) and img0.dtype == np.uint8

    def test_pre_encoded_explicit_and_stale_slot_warning(self, caplog, monkeypatch):
        """ADVICE r2 #3: pre-encoding is explicit (pre_encoded=), dtype stays
        the inference fallback, and validate mode warns about the stale-slot
        LOAD trap once."""
        import logging

        import jax.numpy as jnp

        monkeypatch.setenv("ZENITH_VALIDATE", "1")
        core = RhiCore()
        device = core.create_render_device()
        delivered = []
        sc = Swapchain(
            device,
            SwapchainConfig(width=8, height=4, num_images=2),
            on_present=lambda img, idx: delivered.append(img),
        )
        sc.acquire_next_image()
        pre = jnp.zeros((4, 8, 4), jnp.uint8)
        with caplog.at_level(logging.WARNING):
            sc.present(pre)  # inferred pre-encoded → warns
            sc.acquire_next_image()
            sc.present(pre, pre_encoded=True)  # explicit → no second warning
        stale_warnings = [
            r for r in caplog.records if "LINEAR contents" in r.message
        ]
        assert len(stale_warnings) == 1
        sc.flush()
        # Pre-encoded frames pass through without a second encode.
        assert delivered[0].dtype == np.uint8
        # Forcing the encode on a uint8 image is possible.
        sc.acquire_next_image()
        sc.present(jnp.zeros((4, 8, 4), jnp.uint8), pre_encoded=False)
        sc.flush()

    def test_readback_interval_zero_never_copies(self):
        """readback_interval=0 = benchmark mode: the swapchain only fences —
        no frame is ever delivered to the sink."""
        import jax.numpy as jnp

        core = RhiCore()
        device = core.create_render_device()
        delivered = []
        sc = Swapchain(
            device,
            SwapchainConfig(width=8, height=4, num_images=2,
                            readback_interval=0),
            on_present=lambda img, idx: delivered.append(idx),
        )
        for frame in range(6):
            sc.acquire_next_image()
            sc.present(jnp.full((4, 8, 4), frame / 10.0))
        sc.flush()
        assert delivered == []
        assert sc._frame_counter == 6

    def test_resize_keeps_counter(self):
        core = RhiCore()
        device = core.create_render_device()
        sc = Swapchain(device, SwapchainConfig(width=8, height=4))
        import jax.numpy as jnp

        sc.acquire_next_image()
        sc.present(jnp.zeros((4, 8, 4)))
        sc.resize(16, 8)
        idx, tex = sc.acquire_next_image()
        assert idx == 0
        assert tex.width == 16 and tex.height == 8
        assert sc._frame_counter == 1
