"""Sequential raster parts (ops/draw.py _bin_parts/_raster_parts): a draw
whose sort payload would exceed the device working-set cap splits into
sequential contiguous record ranges with (z, stencil, color) threaded
through — the result must be BIT-EQUAL to the unsplit render (submission
order is preserved because parts are contiguous ranges; the reference's
fixed-function model has no analogous seam at all, pipeline.rs:228-287).

The cap is monkeypatched tiny so a ~100-triangle scene splits into 4+
parts; every fixed-function combination that rides _raster_parts is
A/B'd: opaque depth-write, stencil, MSAA, and the batched blend kernel.
The memory effect of the split (each part's multi-GB payload transient
instead of concurrent — the 8.4M-tri terrain OOM) is only observable on
hardware; what is testable is that splitting never changes the image.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from zenith.ops import draw as draw_mod
from zenith.rendergraph import CompileOptions, RenderGraphBuilder
from zenith.rhi import (
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
    TextureDesc,
    VertexLayout,
)
from zenith.rhi.state import (
    DepthStencilDesc,
    GraphicPipelineState,
    LoadOp,
    MultisampleState,
    StencilOp,
    StencilOpState,
)

W, H = 128, 64
OPTS = CompileOptions(tile_h=8, tile_w=128)


def _vs(attrs, res):
    p = attrs["position"]
    return {
        "position": jnp.concatenate(
            [p, jnp.ones((p.shape[0], 1), jnp.float32)], 1
        ),
        "rgba": attrs["rgba"],
    }


def _fs(varyings, res, builtins):
    return varyings["rgba"]


LAYOUT = VertexLayout.from_fields(("position", 3), ("rgba", 4))
VS = Shader.vertex("p.vs", _vs)
FS = Shader.fragment("p.fs", _fs)


def _tri_soup(n: int, seed: int = 7, alpha: float = 1.0) -> np.ndarray:
    """n random overlapping triangles with varied depths (position3+rgba4)."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-0.9, 0.9, (n, 2))
    verts = []
    for i in range(n):
        ang = rng.uniform(0, 2 * np.pi, 3)
        rad = rng.uniform(0.15, 0.5, 3)
        z = rng.uniform(0.05, 0.95)
        rgba = (*rng.uniform(0.1, 1.0, 3), alpha)
        for a, r in zip(ang, rad):
            verts.append(
                [center[i, 0] + r * np.cos(a), center[i, 1] + r * np.sin(a),
                 z, *rgba]
            )
    return np.asarray(verts, np.float32)


def _render(state: GraphicPipelineState, n_tris: int = 96, alpha: float = 1.0,
            batch: bool = False):
    device = RhiCore().create_render_device()
    vb = Buffer.from_numpy("soup", _tri_soup(n_tris, alpha=alpha))
    ib = Buffer.from_numpy("ib", np.arange(3 * n_tris, dtype=np.int32))

    builder = RenderGraphBuilder()
    vb_r, ib_r = builder.import_resource(vb), builder.import_resource(ib)
    # MSAA is pipeline state; attachments stay 1x descs (the graph keeps
    # per-sample planes internally and resolves at the node boundary).
    color = builder.create(TextureDesc.color("rt", W, H))
    depth = builder.create(TextureDesc.depth("ds", W, H))
    with_stencil = state.depth_stencil.stencil_test_enable
    sten = (
        builder.create(TextureDesc.stencil("st", W, H))
        if with_stencil else None
    )
    builder.export(color)
    builder.export(depth)

    node = builder.add_graphic_node("soup")
    va, ia = node.read(vb_r), node.read(ib_r)
    rt, ds = node.write(color), node.write(depth)
    sa = node.write(sten) if with_stencil else None
    with node.pipeline(GraphicShaderInput(VS, FS, LAYOUT), state) as b:
        b.push_color(rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1))
                     if alpha >= 1.0
                     else ColorAttachmentDesc(
                         clear_value=(0, 0, 0, 1)).translucent())
        b.set_depth(ds, state.depth_stencil)
        if with_stencil:
            b.set_stencil(sa)
    if batch:
        node.execute(
            lambda ctx, va=va, ia=ia: ctx.draw_indexed_batch([(va, ia, {})])
        )
    else:
        node.execute(lambda ctx, va=va, ia=ia: ctx.draw_indexed(va, ia))

    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    return {
        "color": np.asarray(compiled.value(color)),
        "depth": np.asarray(compiled.value(depth)),
    }


def _ab(monkeypatch, state, **kw):
    full = _render(state, **kw)
    # Tiny cap → a 96-tri (288-record) draw splits into 5+ parts.
    monkeypatch.setattr(draw_mod, "MAX_RECORDS_PER_RASTER", 64)
    split = _render(state, **kw)
    monkeypatch.undo()
    assert set(full) == set(split)
    for k in full:
        np.testing.assert_array_equal(
            full[k], split[k], err_msg=f"output {k} differs under split"
        )


def test_opaque_split_bit_equal(monkeypatch):
    _ab(
        monkeypatch,
        GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE),
            depth_stencil=DepthStencilDesc().reverse_z(),
        ),
    )


def test_batch_path_split_bit_equal(monkeypatch):
    _ab(
        monkeypatch,
        GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE),
            depth_stencil=DepthStencilDesc().reverse_z(),
        ),
        batch=True,
    )


def test_stencil_split_bit_equal(monkeypatch):
    sten = StencilOpState(
        fail_op=StencilOp.KEEP,
        pass_op=StencilOp.INCREMENT_AND_CLAMP,
        depth_fail_op=StencilOp.KEEP,
        compare_op=CompareOp.ALWAYS,
    )
    _ab(
        monkeypatch,
        GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE),
            depth_stencil=DepthStencilDesc(
                depth_test_enable=True,
                depth_write_enable=True,
                depth_compare_op=CompareOp.GREATER,
                stencil_test_enable=True,
                stencil_front=sten,
                stencil_back=sten,
            ),
        ),
    )


def test_msaa_split_bit_equal(monkeypatch):
    _ab(
        monkeypatch,
        GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE),
            depth_stencil=DepthStencilDesc().reverse_z(),
            multisample=MultisampleState(samples=4, sample_shading=True),
        ),
        n_tris=48,
    )


def test_blend_batch_split_bit_equal(monkeypatch):
    """The batched BLEND kernel threads (z, color) through sequential
    parts — submission-order blending must survive the split."""
    _ab(
        monkeypatch,
        GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE),
            depth_stencil=DepthStencilDesc(
                depth_test_enable=True,
                depth_write_enable=False,
                depth_compare_op=CompareOp.GREATER,
                depth_load_op=LoadOp.LOAD,
            ),
        ),
        alpha=0.5,
        batch=True,
        n_tris=48,
    )


def test_prim_level_split_bit_equal(monkeypatch):
    """Geometry-level parts (ops/draw.py _geo_specs): a huge triangle draw
    splits at the PRIM level so t-proportional geometry buffers stay
    bounded — result must be bit-equal to the unsplit render."""
    state = GraphicPipelineState(
        rasterization=RasterizationState(cull_mode=CullMode.NONE),
        depth_stencil=DepthStencilDesc().reverse_z(),
    )
    full = _render(state)
    monkeypatch.setattr(draw_mod, "MAX_PRIMS_PER_PART", 16)
    split = _render(state)
    monkeypatch.undo()
    for k in full:
        np.testing.assert_array_equal(
            full[k], split[k], err_msg=f"output {k} differs under prim split"
        )


def test_prim_split_batch_and_blend(monkeypatch):
    """Prim-level parts through the batched and blend-kernel paths."""
    opaque = GraphicPipelineState(
        rasterization=RasterizationState(cull_mode=CullMode.NONE),
        depth_stencil=DepthStencilDesc().reverse_z(),
    )
    blend = GraphicPipelineState(
        rasterization=RasterizationState(cull_mode=CullMode.NONE),
        depth_stencil=DepthStencilDesc(
            depth_test_enable=True,
            depth_write_enable=False,
            depth_compare_op=CompareOp.GREATER,
            depth_load_op=LoadOp.LOAD,
        ),
    )
    for state, kw in ((opaque, dict(batch=True)),
                      (blend, dict(alpha=0.5, batch=True, n_tris=48))):
        full = _render(state, **kw)
        monkeypatch.setattr(draw_mod, "MAX_PRIMS_PER_PART", 16)
        split = _render(state, **kw)
        monkeypatch.undo()
        for k in full:
            np.testing.assert_array_equal(full[k], split[k])
