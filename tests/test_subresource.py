"""Sub-resource views: render-to-mip, render-to-layer, buffer ranges —
the analog of the reference's cached per-subresource image views
(zenith-rhi/src/texture.rs:536-559) and BufferRange (buffer.rs:276-322)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zenith.rendergraph import CompileOptions, RenderGraphBuilder
from zenith.rhi import (
    BufferDesc,
    ColorAttachmentDesc,
    Format,
    GraphicShaderInput,
    PipelineCache,
    RhiCore,
    Shader,
    TextureDesc,
    attr,
)
from zenith.rhi.state import GraphicPipelineState, RasterizationState, CullMode, VertexLayout

LAYOUT = VertexLayout.from_fields(("position", 3), ("color", 3))


def _vs(attrs, res):
    p = attrs["position"]
    return {
        "position": jnp.concatenate(
            [p, jnp.ones((p.shape[0], 1), jnp.float32)], axis=1
        ),
        "color": attrs["color"],
    }


def _fs(varyings, res, builtins):
    c = varyings["color"]
    return jnp.concatenate([c, jnp.ones_like(c[..., :1])], axis=-1)


VS = Shader.vertex("sub.vs", _vs, inputs=[attr("position", 3), attr("color", 3)])
FS = Shader.fragment("sub.fs", _fs)

TRI_VB = np.array(
    [
        [-0.9, -0.9, 0.5, 1.0, 0.0, 0.0],
        [0.9, -0.9, 0.5, 1.0, 0.0, 0.0],
        [0.0, 0.9, 0.5, 1.0, 0.0, 0.0],
    ],
    np.float32,
)
TRI_IB = np.array([0, 1, 2], np.int32)


def _device():
    core = RhiCore()
    return core.create_render_device()


def _full_screen_state():
    return GraphicPipelineState(
        rasterization=RasterizationState(cull_mode=CullMode.NONE)
    )


class TestRenderToMip:
    def test_graphic_node_renders_into_mip1(self):
        device = _device()
        pcache = PipelineCache()
        builder = RenderGraphBuilder()
        tex = builder.create(TextureDesc(
            "mips", 256, 128, Format.RGBA32F, mip_levels=3
        ))
        builder.export(tex)
        vb = device.upload_buffer("vb", TRI_VB)
        ib = device.upload_buffer("ib", TRI_IB)
        vbh, ibh = builder.import_resource(vb), builder.import_resource(ib)

        node = builder.add_graphic_node("to_mip1")
        vba, iba = node.read(vbh), node.read(ibh)
        rt = node.write(tex, mip=1)  # 128x64 surface
        with node.pipeline(
            GraphicShaderInput(VS, FS, LAYOUT), _full_screen_state()
        ) as binder:
            binder.push_color(rt, ColorAttachmentDesc(clear_value=(0, 0, 1, 1)))

        node.execute(lambda ctx: ctx.draw_indexed(vba, iba, {}))
        compiled = builder.build().compile(
            device, pcache, CompileOptions(tile_h=8, tile_w=128)
        )
        compiled.execute(device)
        chain = compiled.value(tex)
        assert isinstance(chain, tuple) and len(chain) == 3
        m0, m1, m2 = [np.asarray(m) for m in chain]
        assert m0.shape == (128, 256, 4)
        assert m1.shape == (64, 128, 4)
        assert m2.shape == (32, 64, 4)
        # Mip 1 holds the render (red triangle on blue clear); others zero.
        assert m1[32, 64, 0] == pytest.approx(1.0)  # center: triangle
        assert m1[2, 2, 2] == pytest.approx(1.0)  # corner: blue clear
        assert m0.max() == 0.0 and m2.max() == 0.0

    def test_lambda_mip_read_write_roundtrip(self):
        device = _device()
        builder = RenderGraphBuilder()
        tex = builder.create(TextureDesc(
            "mips", 64, 64, Format.RGBA32F, mip_levels=2
        ))
        builder.export(tex)
        node = builder.add_lambda_node("fill")
        w0 = node.write(tex, mip=0)
        w1 = node.write(tex, mip=1)

        def record(ctx):
            ctx.set(w0, jnp.full((64, 64, 4), 0.25, jnp.float32))
            ctx.set(w1, jnp.full((32, 32, 4), 0.5, jnp.float32))

        node.execute(record)

        node2 = builder.add_lambda_node("check")
        r1 = node2.read(tex, mip=1)
        out = builder.create(TextureDesc.color("out", 32, 32))
        builder.export(out)
        dst = node2.write(out)
        node2.execute(lambda ctx: ctx.set(dst, ctx.get(r1) * 2.0))

        compiled = builder.build().compile(device, PipelineCache())
        compiled.execute(device)
        assert np.asarray(compiled.value(out))[0, 0, 0] == pytest.approx(1.0)


class TestRenderToLayer:
    def test_cube_face_render_and_sample(self):
        """Render a triangle into ONE face of a cube map, then cube-sample
        a direction hitting that face — the rendered (not procedural-only)
        cube-map path (reference texture.rs:94-105 cube views)."""
        device = _device()
        pcache = PipelineCache()
        builder = RenderGraphBuilder()
        cube = builder.create(TextureDesc.new_cube("cube", 64, Format.RGBA32F))
        builder.export(cube)
        vb = device.upload_buffer("vb", TRI_VB)
        ib = device.upload_buffer("ib", TRI_IB)
        vbh, ibh = builder.import_resource(vb), builder.import_resource(ib)

        # Face 2 == +Y in the (+X,-X,+Y,-Y,+Z,-Z) layer order.
        node = builder.add_graphic_node("to_face")
        vba, iba = node.read(vbh), node.read(ibh)
        rt = node.write(cube, layer=2)
        with node.pipeline(
            GraphicShaderInput(VS, FS, LAYOUT), _full_screen_state()
        ) as binder:
            binder.push_color(rt, ColorAttachmentDesc(clear_value=(0, 1, 0, 1)))
        node.execute(lambda ctx: ctx.draw_indexed(vba, iba, {}))

        out = builder.create(TextureDesc.color("sample.out", 8, 8))
        builder.export(out)
        node2 = builder.add_lambda_node("sample")
        cube_in = node2.read(cube)
        dst = node2.write(out)

        def record_sample(ctx):
            from zenith.ops.sampling import sample_cube

            dirs = jnp.broadcast_to(
                jnp.asarray([0.0, 1.0, 0.0]), (8, 8, 3)
            )  # +Y: face 2 center
            ctx.set(dst, sample_cube(ctx.get(cube_in), dirs))

        node2.execute(record_sample)
        compiled = builder.build().compile(
            device, pcache, CompileOptions(tile_h=8, tile_w=128)
        )
        compiled.execute(device)
        cube_val = np.asarray(compiled.value(cube))
        assert cube_val.shape == (6, 64, 64, 4)
        # Only face 2 written; center of face shows the red triangle.
        assert cube_val[2, 32, 32, 0] == pytest.approx(1.0)
        assert cube_val[0].max() == 0.0 and cube_val[5].max() == 0.0
        sampled = np.asarray(compiled.value(out))
        assert sampled[4, 4, 0] == pytest.approx(1.0, abs=1e-3)

    def test_layer_depth_attachment(self):
        """Shadow-cascade shape: depth-only render into one layer of a
        2D-array depth texture."""
        from zenith.rhi.state import CompareOp, DepthStencilDesc

        device = _device()
        builder = RenderGraphBuilder()
        cascades = builder.create(TextureDesc.new_2d_array(
            "cascades", 128, 32, 2, Format.D32F
        ))
        builder.export(cascades)
        vb = device.upload_buffer("vb", TRI_VB)
        ib = device.upload_buffer("ib", TRI_IB)
        vbh, ibh = builder.import_resource(vb), builder.import_resource(ib)
        node = builder.add_graphic_node("cascade1")
        vba, iba = node.read(vbh), node.read(ibh)
        ds = node.write(cascades, layer=1)
        with node.pipeline(
            GraphicShaderInput(VS, None, LAYOUT), _full_screen_state()
        ) as binder:
            binder.set_depth(ds, DepthStencilDesc(
                depth_test_enable=True, depth_write_enable=True,
                depth_compare_op=CompareOp.GREATER, depth_clear_value=0.0,
            ))
        node.execute(lambda ctx: ctx.draw_indexed(vba, iba, {}))
        compiled = builder.build().compile(
            device, PipelineCache(), CompileOptions(tile_h=8, tile_w=128)
        )
        compiled.execute(device)
        val = np.asarray(compiled.value(cascades))
        assert val.shape == (2, 32, 128, 1)
        assert val[1].max() == pytest.approx(0.5)  # triangle depth
        assert val[0].max() == 0.0  # untouched cascade


class TestBufferRange:
    def test_lambda_buffer_range_read_write(self):
        device = _device()
        builder = RenderGraphBuilder()
        buf = builder.create(BufferDesc("ranges", (16,), "float32"))
        builder.export(buf)
        node = builder.add_lambda_node("fill")
        head = node.write(buf, brange=(0, 4))
        tail = node.write(buf, brange=(12, 4))

        def record(ctx):
            ctx.set(head, jnp.full((4,), 1.0, jnp.float32))
            ctx.set(tail, jnp.full((4,), 2.0, jnp.float32))

        node.execute(record)
        node2 = builder.add_lambda_node("read")
        mid = node2.read(buf, brange=(2, 12))
        out = builder.create(BufferDesc("out", (12,), "float32"))
        builder.export(out)
        dst = node2.write(out)
        node2.execute(lambda ctx: ctx.set(dst, ctx.get(mid)))
        compiled = builder.build().compile(device, PipelineCache())
        compiled.execute(device)
        val = np.asarray(compiled.value(out))
        np.testing.assert_allclose(val[:2], [1.0, 1.0])
        np.testing.assert_allclose(val[2:10], 0.0)
        np.testing.assert_allclose(val[10:], [2.0, 2.0])


class TestBloomMipChain:
    def test_bloom_via_mips_runs_and_matches_single_node_shape(self):
        from zenith.renderer import PostProcess
        from zenith.rendergraph import RenderGraphBuilder

        device = _device()
        h, w = 64, 128
        hdr_np = np.zeros((h, w, 4), np.float32)
        hdr_np[20:30, 40:60, :3] = 5.0  # bright blob
        hdr_np[..., 3] = 1.0

        def run(post):
            builder = RenderGraphBuilder()
            hdr = builder.create(TextureDesc.color("hdr", w, h))
            out = builder.create(TextureDesc.color("ldr", w, h))
            builder.export(out)
            node = builder.add_lambda_node("seed")
            dst = node.write(hdr)
            node.execute(lambda ctx: ctx.set(dst, jnp.asarray(hdr_np)))
            post.render_to(builder, hdr, out)
            compiled = builder.build().compile(device, PipelineCache())
            compiled.execute(device)
            return np.asarray(compiled.value(out))

        mips = run(PostProcess(bloom_mips=3))
        single = run(PostProcess())
        assert mips.shape == single.shape == (h, w, 4)
        # Both produce a tonemapped image with bloom spill outside the blob.
        assert mips[25, 70, 0] > 0.0  # spill right of the blob
        assert 0.0 <= mips.min() and mips.max() <= 1.0
        # The blob itself is bright in both.
        assert mips[25, 50, 0] > 0.9 and single[25, 50, 0] > 0.9

    def test_bloom_mips_odd_dimensions(self):
        """1080p-style mip walks hit odd heights (1080→540→270→135→67);
        the upsample accumulate must edge-pad, not crash on a broadcast
        mismatch (round-3 review finding)."""
        from zenith.renderer import PostProcess

        device = _device()
        h, w = 68, 136  # chain: 68→34→17→8 (17 odd)
        builder = RenderGraphBuilder()
        hdr = builder.create(TextureDesc.color("hdr", w, h))
        out = builder.create(TextureDesc.color("ldr", w, h))
        builder.export(out)
        node = builder.add_lambda_node("seed")
        dst = node.write(hdr)
        node.execute(
            lambda ctx: ctx.set(dst, jnp.full((h, w, 4), 3.0, jnp.float32))
        )
        PostProcess(bloom_mips=3).render_to(builder, hdr, out)
        compiled = builder.build().compile(device, PipelineCache())
        compiled.execute(device)
        img = np.asarray(compiled.value(out))
        assert img.shape == (h, w, 4)
        assert np.isfinite(img).all()

    def test_mip_chain_structure_caches(self):
        from zenith.rendergraph.graph import frame_program_cache_size

        from zenith.renderer import PostProcess

        device = _device()
        post = PostProcess(bloom_mips=2)
        h, w = 32, 64

        def build():
            builder = RenderGraphBuilder()
            hdr = builder.create(TextureDesc.color("hdr", w, h))
            out = builder.create(TextureDesc.color("ldr", w, h))
            builder.export(out)
            node = builder.add_lambda_node("seed")
            dst = node.write(hdr)
            node.execute(
                lambda ctx: ctx.set(dst, jnp.ones((h, w, 4), jnp.float32))
            )
            post.render_to(builder, hdr, out)
            return builder.build()

        pcache = PipelineCache()
        c1 = build().compile(device, pcache)
        n = frame_program_cache_size()
        c2 = build().compile(device, pcache)
        assert frame_program_cache_size() == n  # structure hit
        assert c2._fn is c1._fn


class TestMipPlusLayer:
    """Combined mip+layer sub-views and mip chains on layered/3D managed
    textures (round-4 lift of the r3 exclusions, VERDICT weak #8; the
    reference's per-subresource views allow any (mip, layer) pair,
    texture.rs:536-559)."""

    def test_layered_mip_chain_materializes(self):
        """A managed 2D-array texture with mips holds per-level (L, H, W, C)
        arrays — layers never shrink across the chain (Vulkan image spec)."""
        device = _device()
        builder = RenderGraphBuilder()
        tex = builder.create(TextureDesc(
            "lmips", 64, 32, Format.RGBA32F, mip_levels=3, array_layers=4
        ))
        builder.export(tex)
        node = builder.add_lambda_node("touch")
        w = node.write(tex, mip=0, layer=0)
        node.execute(lambda ctx: ctx.set(
            w, jnp.ones((32, 64, 4), jnp.float32)
        ))
        compiled = builder.build().compile(device, PipelineCache())
        compiled.execute(device)
        chain = compiled.value(tex)
        assert isinstance(chain, tuple) and len(chain) == 3
        shapes = [tuple(np.asarray(m).shape) for m in chain]
        assert shapes == [(4, 32, 64, 4), (4, 16, 32, 4), (4, 8, 16, 4)]

    def test_3d_mip_chain_materializes(self):
        """3D mips halve every extent including depth (VkImageType 3D)."""
        device = _device()
        builder = RenderGraphBuilder()
        tex = builder.create(TextureDesc(
            "vmips", 32, 16, Format.RGBA32F, mip_levels=2, depth=8
        ))
        builder.export(tex)
        node = builder.add_lambda_node("fill")
        w1 = node.write(tex, mip=1)
        node.execute(lambda ctx: ctx.set(
            w1, jnp.full((4, 8, 16, 4), 0.5, jnp.float32)
        ))
        compiled = builder.build().compile(device, PipelineCache())
        compiled.execute(device)
        chain = compiled.value(tex)
        m0, m1 = [np.asarray(m) for m in chain]
        assert m0.shape == (8, 16, 32, 4) and m0.max() == 0.0
        assert m1.shape == (4, 8, 16, 4) and m1.min() == pytest.approx(0.5)

    def test_lambda_mip_layer_roundtrip(self):
        """ctx.set/get with BOTH mip and layer touch exactly that
        sub-surface."""
        device = _device()
        builder = RenderGraphBuilder()
        tex = builder.create(TextureDesc(
            "ml", 32, 32, Format.RGBA32F, mip_levels=2, array_layers=3
        ))
        builder.export(tex)
        node = builder.add_lambda_node("fill")
        w = node.write(tex, mip=1, layer=2)
        node.execute(lambda ctx: ctx.set(
            w, jnp.full((16, 16, 4), 2.0, jnp.float32)
        ))
        node2 = builder.add_lambda_node("read")
        r = node2.read(tex, mip=1, layer=2)
        out = builder.create(TextureDesc.color("out", 16, 16))
        builder.export(out)
        dst = node2.write(out)
        node2.execute(lambda ctx: ctx.set(dst, ctx.get(r) * 0.5))
        compiled = builder.build().compile(device, PipelineCache())
        compiled.execute(device)
        chain = compiled.value(tex)
        m1 = np.asarray(chain[1])
        assert m1[2].min() == pytest.approx(2.0)  # written layer
        assert m1[0].max() == 0.0 and m1[1].max() == 0.0  # untouched
        assert np.asarray(chain[0]).max() == 0.0  # untouched level
        assert np.asarray(compiled.value(out))[0, 0, 0] == pytest.approx(1.0)

    def test_graphic_node_renders_into_mip_layer(self):
        """Render-to-(mip=1, layer=1) of a layered mip texture — e.g. a
        filtered-importance-sampled environment chain, one face+roughness
        level per pass."""
        device = _device()
        builder = RenderGraphBuilder()
        tex = builder.create(TextureDesc(
            "env", 256, 128, Format.RGBA32F, mip_levels=2, array_layers=2
        ))
        builder.export(tex)
        vb = device.upload_buffer("vb", TRI_VB)
        ib = device.upload_buffer("ib", TRI_IB)
        vbh, ibh = builder.import_resource(vb), builder.import_resource(ib)
        node = builder.add_graphic_node("to_mip1_layer1")
        vba, iba = node.read(vbh), node.read(ibh)
        rt = node.write(tex, mip=1, layer=1)  # 128x64 surface
        with node.pipeline(
            GraphicShaderInput(VS, FS, LAYOUT), _full_screen_state()
        ) as binder:
            binder.push_color(rt, ColorAttachmentDesc(clear_value=(0, 0, 1, 1)))
        node.execute(lambda ctx: ctx.draw_indexed(vba, iba, {}))
        compiled = builder.build().compile(
            device, PipelineCache(), CompileOptions(tile_h=8, tile_w=128)
        )
        compiled.execute(device)
        chain = compiled.value(tex)
        m0, m1 = [np.asarray(m) for m in chain]
        assert m0.shape == (2, 128, 256, 4) and m0.max() == 0.0
        assert m1.shape == (2, 64, 128, 4)
        assert m1[0].max() == 0.0  # untouched layer of the same level
        assert m1[1, 32, 64, 0] == pytest.approx(1.0)  # triangle center
        assert m1[1, 2, 2, 2] == pytest.approx(1.0)  # blue clear corner
