"""Translucency end-to-end: the reference's ColorAttachmentDesc.translucent()
preset (pipeline.rs:404-412) through a real two-node graph — opaque scene,
then a blended overlay draw with depth-test-on/write-off (the standard
translucent pass)."""

import numpy as np
import pytest

import jax.numpy as jnp

from zenith.rendergraph import CompileOptions, RenderGraphBuilder
from zenith.rhi import (
    BlendFactor,
    Buffer,
    ColorAttachmentDesc,
    CompareOp,
    CullMode,
    Format,
    GraphicShaderInput,
    PipelineCache,
    RasterizationState,
    RhiCore,
    Shader,
    Texture,
    TextureDesc,
    VertexLayout,
)
from zenith.rhi.state import DepthStencilDesc, GraphicPipelineState

W, H = 128, 32
OPTS = CompileOptions(tile_h=8, tile_w=128)


def _vs(attrs, res):
    p = attrs["position"]
    return {
        "position": jnp.concatenate([p, jnp.ones((p.shape[0], 1), jnp.float32)], 1),
        "rgba": attrs["rgba"],
    }


def _fs(varyings, res, builtins):
    return varyings["rgba"]


LAYOUT = VertexLayout.from_fields(("position", 3), ("rgba", 4))
VS = Shader.vertex("b.vs", _vs)
FS = Shader.fragment("b.fs", _fs)


def tri_buf(z, rgba, scale=0.5, dx=0.0):
    return np.array(
        [
            [dx, -scale, z, *rgba],
            [dx + scale, scale, z, *rgba],
            [dx - scale, scale, z, *rgba],
        ],
        np.float32,
    )


def test_src_alpha_blend_over_opaque():
    device = RhiCore().create_render_device()
    opaque = Buffer.from_numpy("opq", tri_buf(0.5, (1.0, 0.0, 0.0, 1.0), 0.7))
    glass = Buffer.from_numpy("gls", tri_buf(0.8, (0.0, 0.0, 1.0, 0.5), 0.4))
    # offset left so part of it sticks out from behind the opaque tri
    behind = Buffer.from_numpy("bhd", tri_buf(0.2, (0.0, 1.0, 0.0, 0.5), 0.3, dx=-0.75))
    ib = Buffer.from_numpy("ib", np.array([0, 1, 2], np.int32))

    builder = RenderGraphBuilder()
    opq_r, gls_r, bhd_r, ib_r = (
        builder.import_resource(b) for b in (opaque, glass, behind, ib)
    )
    color = builder.create(TextureDesc.color("rt", W, H))
    depth = builder.create(TextureDesc.depth("ds", W, H))
    builder.export(color)

    state_opaque = GraphicPipelineState(
        rasterization=RasterizationState(cull_mode=CullMode.NONE)
    )

    node = builder.add_graphic_node("opaque")
    oa, ia = node.read(opq_r), node.read(ib_r)
    rt = node.write(color)
    ds = node.write(depth)
    with node.pipeline(GraphicShaderInput(VS, FS, LAYOUT), state_opaque) as b:
        b.push_color(rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
        b.set_depth(ds, DepthStencilDesc().reverse_z())
    node.execute(lambda ctx, oa=oa, ia=ia: ctx.draw_indexed(oa, ia, bin_capacity=8))

    # Translucent pass: test on, write OFF (standard), src-alpha blend.
    # Reference preset (translucent(), pipeline.rs:404-412) uses
    # DST_ALPHA for dst color; with dst alpha = 1 that's additive-over.
    node2 = builder.add_graphic_node("translucent")
    ga, ia2, ba = node2.read(gls_r), node2.read(ib_r), node2.read(bhd_r)
    rt2 = node2.write(color)
    ds2 = node2.write(depth)
    trans_state = GraphicPipelineState(
        rasterization=RasterizationState(cull_mode=CullMode.NONE),
        depth_stencil=DepthStencilDesc(
            depth_test_enable=True,
            depth_write_enable=False,
            depth_compare_op=CompareOp.GREATER,
            depth_load_op=__import__("zenith.rhi.state", fromlist=["LoadOp"]).LoadOp.LOAD,
        ),
    )
    with node2.pipeline(GraphicShaderInput(VS, FS, LAYOUT), trans_state) as b:
        b.push_color(rt2, ColorAttachmentDesc().translucent().load_input())
        b.set_depth(ds2, trans_state.depth_stencil)

    def record2(ctx):
        # In front of the opaque tri (z=0.8 > 0.5): blends over it.
        ctx.draw_indexed(ga, ia2, bin_capacity=8)
        # Behind it (z=0.2 < 0.5): depth-tested away where occluded.
        ctx.draw_indexed(ba, ia2, bin_capacity=8)

    node2.execute(record2)

    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    img = np.asarray(compiled.value(color))

    center = img[H // 2, W // 2]
    # Glass (blue, a=0.5) over red opaque with SRC_ALPHA/DST_ALPHA blending:
    # rgb = 0.5·blue + 1.0·red  → (1, 0, 0.5).
    np.testing.assert_allclose(center[:3], [1.0, 0.0, 0.5], atol=1e-5)
    # The green tri behind the opaque one must NOT bleed through its center.
    assert center[1] == pytest.approx(0.0, abs=1e-5)
    # But outside the opaque tri's footprint (where only background exists),
    # the green tri IS visible (depth clear 0.0 < 0.2).
    lower = img[4, W // 2]  # the small behind-tri's upper tip region
    # (just assert green contributed somewhere)
    assert (img[..., 1] > 0.05).any()
