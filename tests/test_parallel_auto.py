"""Automatic SPMD work decomposition (VERDICT r4 next #3):
``CompileOptions(parallel="auto")`` picks sort-first vs sort-last PER NODE
at compile time from the node's band hint — screen-row occupancy spans the
renderers project from object AABBs (GraphicNodeBuilder.set_band_hint).
A terrain-like scene whose triangles cluster into one band takes sort-last
(every device rasterizes a triangle shard); a uniform scene stays banded
sort-first (no composite traffic). Both modes render bit-equal to the
single-chip program, so the choice is purely a performance decision — the
tests assert the CHOICE (graph.parallel_modes) and the EQUALITY."""

import numpy as np
import pytest

import jax.numpy as jnp

from zenith.parallel import default_mesh
from zenith.rendergraph import CompileOptions, RenderGraphBuilder
from zenith.rendergraph.graph import (
    AUTO_SL_MIN_TRIS,
    _auto_prefers_sort_last,
    clear_frame_program_cache,
)
from zenith.rhi import (
    ColorAttachmentDesc,
    CullMode,
    Format,
    GraphicPipelineAttachments,
    GraphicPipelineDesc,
    GraphicShaderInput,
    PipelineCache,
    RasterizationState,
    Shader,
    TextureDesc,
    VertexLayout,
)
from zenith.rhi.state import DepthStencilDesc, GraphicPipelineState

W, H = 128, 64  # 8 devices x 8-row bands

BIG = AUTO_SL_MIN_TRIS  # a load large enough to clear the minimum


class TestBandOccupancyHeuristic:
    """Unit coverage of the compile-time decision function."""

    def test_clustered_load_prefers_sort_last(self):
        # Everything in the top eighth of the screen: one band holds the
        # whole load — 8x the uniform share.
        assert _auto_prefers_sort_last([(BIG, 0.0, 0.125)], 8)

    def test_uniform_load_stays_sort_first(self):
        assert not _auto_prefers_sort_last([(BIG, 0.0, 1.0)], 8)

    def test_small_load_stays_sort_first_even_clustered(self):
        # Below the minimum the composite's O(H*W) cross-device traffic dominates any
        # imbalance win.
        assert not _auto_prefers_sort_last(
            [(AUTO_SL_MIN_TRIS - 1, 0.0, 0.125)], 8
        )

    def test_no_hint_or_single_shard(self):
        assert not _auto_prefers_sort_last(None, 8)
        assert not _auto_prefers_sort_last([], 8)
        assert not _auto_prefers_sort_last([(BIG, 0.0, 0.125)], 1)

    def test_mixed_draws_aggregate(self):
        # A clustered heavy draw plus a light full-extent draw still
        # clusters; many uniform draws do not.
        assert _auto_prefers_sort_last(
            [(BIG, 0.4, 0.5), (BIG // 16, 0.0, 1.0)], 8
        )
        assert not _auto_prefers_sort_last(
            [(BIG // 4, 0.0, 1.0)] * 8, 8
        )

    def test_out_of_range_spans_clamp(self):
        # Off-screen extents clamp into [0, 1] rather than skewing bands.
        assert _auto_prefers_sort_last([(BIG, -3.0, 0.125)], 8)
        assert not _auto_prefers_sort_last([(BIG, -3.0, 3.0)], 8)


def _vs(attrs, res):
    p = attrs["position"]
    return {
        "position": jnp.concatenate(
            [p, jnp.ones((p.shape[0], 1), jnp.float32)], 1
        ),
        "color": attrs["color"],
    }


def _fs(varyings, res, builtins):
    c = varyings["color"]
    return jnp.concatenate([c, jnp.ones_like(c[..., :1])], -1)


LAYOUT = VertexLayout.from_fields(("position", 3), ("color", 3))
VS = Shader.vertex("auto.vs", _vs)
FS = Shader.fragment("auto.fs", _fs)


def _tri_vb(rng, nv, y_range=(-1.0, 1.0)):
    pos = rng.uniform(-1.0, 1.0, size=(nv, 2)).astype(np.float32)
    pos[:, 1] = rng.uniform(y_range[0], y_range[1], size=nv)
    zz = rng.uniform(0.1, 0.9, size=(nv, 1)).astype(np.float32)
    col = rng.uniform(0, 1, size=(nv, 3)).astype(np.float32)
    return np.concatenate([pos, zz.reshape(-1, 1), col], axis=1).astype(
        np.float32
    )


def _render(device, options, record, hint=None):
    """One opaque node; returns (color, depth, graph) — graph for
    parallel_modes inspection."""
    clear_frame_program_cache()
    builder = RenderGraphBuilder()
    color = builder.create(TextureDesc.color("rt", W, H))
    depth = builder.create(TextureDesc.depth("ds", W, H))
    builder.export(color)
    builder.export(depth)

    node = builder.add_graphic_node("scene")
    rt = node.write(color)
    ds = node.write(depth)
    with node.pipeline(
        GraphicShaderInput(VS, FS, LAYOUT),
        GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE),
            depth_stencil=DepthStencilDesc().reverse_z(),
        ),
    ) as binder:
        binder.push_color(rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
        binder.set_depth(ds, DepthStencilDesc().reverse_z())
    if hint is not None:
        node.set_band_hint(hint)
    node.execute(record)

    graph = builder.build()
    compiled = graph.compile(device, PipelineCache(), options)
    compiled.execute(device)
    return (
        np.asarray(compiled.value(color)),
        np.asarray(compiled.value(depth)),
        graph,
    )


def _assert_images_match(a, b, tol=1e-3, frac=0.002):
    diff = np.abs(a - b).max(axis=-1) if a.ndim == 3 else np.abs(a - b)
    assert (diff > tol).mean() <= frac, (
        f"{(diff > tol).mean():.4%} pixels differ (max {diff.max()})"
    )


class TestAutoModeGraph:
    def test_clustered_hint_takes_sort_last_and_matches_single(
        self, cpu_devices, rng
    ):
        # Terrain-like: all geometry inside the TOP band (y in [-1,-0.75]
        # NDC = top rows after the viewport flip).
        vb = _tri_vb(rng, 48, y_range=(-1.0, -0.75))
        ib = rng.integers(0, 48, size=(30, 3)).astype(np.int32)

        def record(ctx):
            ctx.draw_indexed(jnp.asarray(vb), jnp.asarray(ib))

        img1, z1, _ = _render(None, CompileOptions(tile_h=8), record)
        mesh = default_mesh(8, backend="cpu")
        img8, z8, graph = _render(
            None,
            CompileOptions(tile_h=8, mesh=mesh, parallel="auto"),
            record,
            hint=[(BIG, 0.0, 0.125)],
        )
        assert graph.parallel_modes == {"scene": "sort_last"}
        assert img1[..., :3].std() > 0.01
        _assert_images_match(img8, img1)
        _assert_images_match(z8, z1, tol=1e-5)

    def test_uniform_hint_stays_sort_first_and_matches_single(
        self, cpu_devices, rng
    ):
        vb = _tri_vb(rng, 48)
        ib = rng.integers(0, 48, size=(30, 3)).astype(np.int32)

        def record(ctx):
            ctx.draw_indexed(jnp.asarray(vb), jnp.asarray(ib))

        img1, z1, _ = _render(None, CompileOptions(tile_h=8), record)
        mesh = default_mesh(8, backend="cpu")
        img8, z8, graph = _render(
            None,
            CompileOptions(tile_h=8, mesh=mesh, parallel="auto"),
            record,
            hint=[(BIG, 0.0, 1.0)],
        )
        assert graph.parallel_modes == {"scene": "sort_first"}
        _assert_images_match(img8, img1)
        _assert_images_match(z8, z1, tol=1e-5)

    def test_hintless_node_stays_banded(self, cpu_devices, rng):
        vb = _tri_vb(rng, 12)
        ib = np.arange(12, dtype=np.int32).reshape(-1, 3)

        def record(ctx):
            ctx.draw_indexed(jnp.asarray(vb), jnp.asarray(ib))

        mesh = default_mesh(8, backend="cpu")
        _, _, graph = _render(
            None, CompileOptions(tile_h=8, mesh=mesh, parallel="auto"),
            record,
        )
        assert graph.parallel_modes == {"scene": "sort_first"}

    def test_lazy_hint_callable_resolves_at_compile(self, cpu_devices, rng):
        vb = _tri_vb(rng, 12, y_range=(-1.0, -0.75))
        ib = np.arange(12, dtype=np.int32).reshape(-1, 3)
        calls = []

        def lazy_hint():
            calls.append(1)
            return [(BIG, 0.0, 0.125)]

        def record(ctx):
            ctx.draw_indexed(jnp.asarray(vb), jnp.asarray(ib))

        mesh = default_mesh(8, backend="cpu")
        _, _, graph = _render(
            None, CompileOptions(tile_h=8, mesh=mesh, parallel="auto"),
            record, hint=lazy_hint,
        )
        assert calls, "lazy band hint was never evaluated in auto mode"
        assert graph.parallel_modes == {"scene": "sort_last"}

    def test_hint_never_affects_single_chip(self, cpu_devices, rng):
        # Hints are performance metadata: without a mesh they must not
        # re-key or change the program.
        vb = _tri_vb(rng, 12)
        ib = np.arange(12, dtype=np.int32).reshape(-1, 3)

        def record(ctx):
            ctx.draw_indexed(jnp.asarray(vb), jnp.asarray(ib))

        a, _, _ = _render(None, CompileOptions(tile_h=8), record)
        b, _, _ = _render(None, CompileOptions(tile_h=8), record,
                          hint=[(BIG, 0.0, 0.125)])
        np.testing.assert_array_equal(a, b)
