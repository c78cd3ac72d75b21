"""The draw call: full programmable+fixed-function pipeline for one draw.

Composes the rasterizer stages into the software analog of
``vkCmdDrawIndexed`` (the reference records this through CommandEncoder,
command.rs:92-249; here one ``draw`` traces the whole pipeline into the
frame program):

    vertex fetch (VertexLayout.unpack)
    → vertex shader (user fn, dense over vertices)
    → near clip + triangle setup (ops.geometry)
    → tile binning (ops.binning)
    → forward-interpolating raster kernel (ops.raster, Pallas)
    → gather-free varying finalize (ops.shade)
    → fragment shader (user fn, dense over pixels)
    → blend/output merger (ops.blend)

Design note: attributes are interpolated *inside* the raster kernel as
attr·(1/w) planes (classic perspective-correct forward interpolation) rather
than via a visibility buffer + per-pixel gathers, so shading is purely
elementwise. Fragment shading still runs exactly once per pixel. Chained draws thread (color, depth) through; everything
fuses into one XLA program per render-graph compile.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp

from zenith.ops import blend as blend_ops
from zenith.ops import geometry, shade
from zenith.ops.binning import TileGrid, bin_segmented, default_entry_budget
from zenith.ops.raster import raster_segmented
from zenith.core import log
from zenith.core import validate as _validate
from zenith.rhi.pipeline import GraphicPipeline
from zenith.rhi.shader import BindingError, BoundResources

logger = log.get(__name__)
from zenith.rhi.state import (
    ColorAttachmentDesc,
    CullMode,
    InputAssemblyState,
    PolygonMode,
    PrimitiveTopology,
)

# Default per-tile candidate capacity; renderers override per scene.
DEFAULT_BIN_CAPACITY = 256

# Per-draw working-set caps for multi-M-triangle draws. One binning
# materializes sort payloads of (budget, 16 + D) floats several times over;
# past the record cap a single draw splits into SEQUENTIAL bin+raster parts
# inside the same program — (z, stencil, color) thread through, attribute
# planes merge by part coverage, so the result is bit-equal to one pass
# (submission order is preserved: parts are contiguous record ranges) while
# XLA sequences the parts' temporaries instead of coexisting them. Geometry
# buffers (clip payload, corner gathers) are built before binning, so huge
# triangle draws also split at the PRIM level. None derives each cap from
# the default device's memory (_draw_caps); tests set small values.
MAX_RECORDS_PER_RASTER: "Optional[int]" = None
MAX_PRIMS_PER_PART: "Optional[int]" = None

# One binning part may take this share of the device's memory.
_PART_MEMORY_SHARE = 4


def _record_bytes(d_total: int) -> int:
    """Device bytes one record costs through setup + binning: its rows
    (rast16 | corner data, ~2 entries per record, gathered and sorted),
    the shade16/aabb columns and the (tile, record) sort keys."""
    return 4 * (2 * 2 * d_total + 16 + 4) + 8 * 3 * 4


def _row_width(flat_vary) -> int:
    """Columns of a binned row: rast16 plus 3 corners of (A varyings,
    front·iw, iw)."""
    return 16 + 3 * (flat_vary.shape[1] + 2)


def _draw_caps(d_total: int) -> "tuple[Optional[int], Optional[int]]":
    """(records per raster part, prims per geometry part) for a draw with
    ``d_total`` row columns: the module overrides when set, otherwise a
    share of the default device's ``bytes_limit``. A device that reports
    no limit (the CPU backend) gets no cap."""
    rec_cap, prim_cap = MAX_RECORDS_PER_RASTER, MAX_PRIMS_PER_PART
    if rec_cap is None or prim_cap is None:
        from zenith.ops.runtime import default_device

        stats = default_device().memory_stats() or {}
        limit = stats.get("bytes_limit")
        derived = (
            limit // (_PART_MEMORY_SHARE * _record_bytes(d_total))
            if limit else None
        )
        if rec_cap is None:
            rec_cap = derived
        if prim_cap is None and derived is not None:
            prim_cap = derived // 3  # each prim clips into ≤ 2 records
    return rec_cap, prim_cap


def _geo_specs(prim_kind, clip, prims, flat_vary, grid, rast_state,
               viewport, depth_bias, point_sizes=None):
    """Deferred geometry-part builders for one draw: a list of
    ``(est_records, build)`` where ``build(dep)`` runs _setup_records on
    the part's prim slice (tied to ``dep`` through an optimization
    barrier when given, sequencing this part's geometry after the
    previous part's binning). Only triangle draws split — the other
    kinds (lines, points, wireframe) never reach millions of prims."""

    def make_build(pr):
        def build(dep):
            p = pr
            if dep is not None:
                p, _ = jax.lax.optimization_barrier((p, dep))
            return _setup_records(prim_kind, clip, p, flat_vary, grid,
                                  rast_state, viewport, depth_bias,
                                  point_sizes=point_sizes)
        return build

    t = prims.shape[0]
    est_factor = 6 if prim_kind == "wire_line" else 2
    _, prim_cap = _draw_caps(_row_width(flat_vary))
    if prim_kind != "tri" or prim_cap is None or t <= prim_cap:
        return [(est_factor * t, make_build(prims))]
    k = -(-t // prim_cap)
    step = -(-t // k)
    return [
        (2 * (min(t, s + step) - s), make_build(prims[s:s + step]))
        for s in range(0, t, step)
    ]


def _bin_spec_parts(specs, grid, entry_budget=None, budget_scale=1):
    """Bin a submission-ordered list of geometry-part specs.

    Adjacent parts coalesce into groups of ≤ MAX_RECORDS_PER_RASTER
    estimated records — every ordinary scene coalesces to ONE group, so
    its compiled program is unchanged. Each group's geometry materializes
    lazily, chained behind the previous group's binning; inside a group
    the record-level splitter (_bin_parts) applies the device-derived
    cap. Returns _BinParts over all groups' parts."""
    total_est = sum(e for e, _ in specs) or 1
    scale = max(int(budget_scale), 1)
    total_budget = (
        int(entry_budget) if entry_budget is not None
        else sum(default_entry_budget(e, grid.num_tiles) for e, _ in specs)
    ) * scale
    # Grouping uses the narrowest row's (loosest) cap; _bin_parts applies
    # each group's own.
    rec_cap, _ = _draw_caps(16 + 3 * 2)

    groups = []
    cur, cur_est = [], 0
    for e, build in specs:
        if cur and rec_cap is not None and cur_est + e > rec_cap:
            groups.append((cur_est, cur))
            cur, cur_est = [], 0
        cur.append(build)
        cur_est += e
    if cur:
        groups.append((cur_est, cur))

    all_parts = []
    dep = None
    for g_est, builds in groups:
        rec_list, corner_list = [], []
        for i, b in enumerate(builds):
            r, c = b(dep if i == 0 else None)
            rec_list.append(r)
            corner_list.append(c)
        if len(rec_list) == 1:
            records, corner = rec_list[0], corner_list[0]
        else:
            records = geometry.TriangleRecords(
                rast16=jnp.concatenate([r.rast16 for r in rec_list]),
                shade16=jnp.concatenate([r.shade16 for r in rec_list]),
                tri_id=jnp.concatenate([r.tri_id for r in rec_list]),
                valid=jnp.concatenate([r.valid for r in rec_list]),
                aabb=jnp.concatenate([r.aabb for r in rec_list]),
            )
            corner = jnp.concatenate(corner_list)
        # Proportional share of the draw/batch budget; a single group gets
        # exactly the old value (bit-identical program for every scene
        # that doesn't split). Explicitly small budgets stay small — tests
        # rely on forced overflow being counted, never floored away.
        g_budget = max(int(round(total_budget * g_est / total_est)), 1)
        bp = _bin_parts(records, corner, grid, entry_budget=g_budget)
        all_parts.extend(bp.parts)
        dep = bp.parts[-1].overflow
    return _BinParts(all_parts)


class _BinParts:
    """1..K sequential binning units for one draw (see _bin_parts)."""

    def __init__(self, parts: list):
        self.parts = parts

    @property
    def overflow(self):
        total = self.parts[0].overflow
        for p in self.parts[1:]:
            total = total + p.overflow
        return total


def _bin_parts(records, corner_data, grid, entry_budget=None,
               budget_scale=1) -> _BinParts:
    """Bin a draw's records, splitting into sequential parts when a single
    raster would exceed the working-set cap (_draw_caps)."""
    r = records.rast16.shape[0]
    corner_flat_cols = (
        corner_data.reshape(r, -1).shape[1] if r else 0
    )
    rec_cap, _ = _draw_caps(16 + corner_flat_cols)
    scale = max(int(budget_scale), 1)
    budget = (
        int(entry_budget) if entry_budget is not None
        else default_entry_budget(r, grid.num_tiles)
    ) * scale
    k = 1 if rec_cap is None else -(-max(r, 1) // rec_cap)
    if k <= 1:
        return _BinParts([
            bin_segmented(records, corner_data, grid,
                          entry_budget=entry_budget,
                          budget_scale=budget_scale)
        ])
    step = -(-r // k)
    parts = []
    dep = None
    for s in range(0, r, step):
        e = min(r, s + step)
        rast = records.rast16[s:e]
        if dep is not None:
            # The parts are data-independent, so without an explicit edge
            # XLA may schedule their multi-GB sort payloads CONCURRENTLY
            # and the split would not bound peak memory. Tie this part's
            # input to the previous part's overflow scalar: the binnings
            # sequence, each sort payload is transient, and peak drops to
            # ~one part's working set.
            rast, _ = jax.lax.optimization_barrier((rast, dep))
        rec = geometry.TriangleRecords(
            rast16=rast,
            shade16=records.shade16[s:e],
            tri_id=records.tri_id[s:e],
            valid=records.valid[s:e],
            aabb=records.aabb[s:e],
        )
        sub = max(-(-budget // k), default_entry_budget(e - s, grid.num_tiles))
        b = bin_segmented(rec, corner_data[s:e], grid, entry_budget=sub)
        parts.append(b)
        dep = b.overflow
    return _BinParts(parts)


def _raster_parts(bin_parts: _BinParts, grid, init_z, *, init_stencil=None,
                  stencil_front=None, stencil_back=None, z_bound=None,
                  **kw):
    """raster_segmented over a _BinParts: parts run sequentially with the
    depth (and stencil) plane THREADED through — identical semantics to one
    pass over the concatenated records (parts are contiguous record ranges,
    so submission order is preserved). Attribute planes merge by part
    coverage: a later part's fragment only passes the threaded depth test
    where an in-order single pass would also have accepted it."""
    z = init_z
    sten = init_stencil
    acc = None
    for bins in bin_parts.parts:
        if stencil_front is not None:
            z, acc_i, sten = raster_segmented(
                bins, grid, z, init_stencil=sten,
                stencil_front=stencil_front, stencil_back=stencil_back,
                **kw,
            )
        else:
            z, acc_i = raster_segmented(bins, grid, z, z_bound=z_bound,
                                        **kw)
        if acc is None:
            acc = acc_i
        else:
            acc = jnp.where((acc_i[-1] > 0.0)[None], acc_i, acc)
    if stencil_front is not None:
        return z, acc, sten
    return z, acc


class _CheckedAttrs(dict):
    """Vertex-attribute dict with a named error on a missing key — a shader
    touching an attribute the layout doesn't provide must not die with a raw
    KeyError mid-trace (the declared-inputs path catches this at pipeline
    build; this is the safety net for undeclared shaders)."""

    def __init__(self, data, shader_name: str):
        super().__init__(data)
        self._shader_name = shader_name

    def __missing__(self, key):
        raise BindingError(
            f"vertex shader {self._shader_name!r} reads attribute {key!r} "
            f"which the vertex layout / instance data does not provide "
            f"(available: {sorted(k for k in self)}). Declare the shader's "
            f"inputs (Shader.vertex(..., inputs=[attr(...)])) to catch this "
            f"at pipeline build time."
        )


# Unused-binding diagnostics (validate mode): warn once per (shader, name).
_UNUSED_WARNED: "set[tuple[int, str]]" = set()


def _warn_unused_bindings(shader, res: BoundResources) -> None:
    """Declared-but-never-read binding warning — the diagnostic half of the
    reference's name+type-checked binder (descriptor.rs:298-456). Runs after
    the shader function traced; ``res.accessed`` is what it actually read."""
    if not _validate.enabled():
        return
    for name in shader.reflection.binding_names():
        if name in res.accessed:
            continue
        k = (id(shader), name)
        if k not in _UNUSED_WARNED:
            _UNUSED_WARNED.add(k)
            logger.warning(
                "[validate] shader %r declares binding '%s' but never read "
                "it this draw — drop the declaration or use the resource",
                shader.name, name,
            )


def _check_instance_inputs(pipeline, instance_data, instance_count) -> None:
    """Draw-time validation of per_instance vertex inputs (pipeline build
    cannot see instance_data; Vulkan validates instance-rate bindings at
    draw record time too)."""
    declared = pipeline.vertex_shader.vertex_inputs
    if declared is None:
        return
    inst_names = {d.name for d in declared if d.per_instance}
    if not inst_names:
        return
    # instance_index is a builtin (gl_InstanceIndex) — always provided.
    got = set(instance_data or ()) | {"instance_index"}
    missing = inst_names - got
    if missing:
        raise BindingError(
            f"vertex shader {pipeline.vertex_shader.name!r} declares "
            f"per-instance inputs {sorted(missing)} but the draw's "
            f"instance_data provides {sorted(got)}"
        )


class PerDraw(tuple):
    """Marker for a fragment-shader resource whose value differs per draw in
    a batched draw (one element per draw). Fragment shaders select with
    ``builtins.draw_id``; plain tuples stay what they always were (mip
    chains)."""


def assemble_triangles(index_buffer, ia: "InputAssemblyState"):
    """Primitive assembly: index buffer → (T, 3) triangle list
    (reference InputAssemblyState, pipeline.rs:483-506).

    TRIANGLE_STRIP decodes per the Vulkan rule — triangle i is
    (v_i, v_{i+1}, v_{i+2}), with the first two corners swapped for odd i so
    winding stays consistent. With ``primitive_restart``, the restart index
    (all-ones) splits strips: triangles touching it collapse to degenerate
    (0,0,0) — zero-area, culled by setup — and the odd/even parity restarts
    at each cut, as a new strip would.
    """
    if ia.topology == PrimitiveTopology.TRIANGLE_LIST:
        return index_buffer.reshape(-1, 3)

    flat = index_buffer.reshape(-1).astype(jnp.int32)
    n = flat.shape[0]
    assert n >= 3, f"triangle strip needs >= 3 indices, got {n}"
    i0, i1, i2 = flat[:-2], flat[1:-1], flat[2:]
    pos = jnp.arange(n - 2, dtype=jnp.int32)

    if ia.primitive_restart:
        # Restart index is 0xFFFFFFFF == -1 as int32.
        restart = jnp.int32(-1)
        is_restart = flat == restart
        # Segment start for each strip position: 1 + position of the most
        # recent restart at-or-before it (cummax; -1 when none yet).
        seg_start = (
            jax.lax.cummax(
                jnp.where(is_restart, jnp.arange(n, dtype=jnp.int32), -1)
            )
            + 1
        )
        parity = (pos - seg_start[: n - 2]) & 1
        bad = is_restart[:-2] | is_restart[1:-1] | is_restart[2:]
    else:
        parity = pos & 1
        bad = jnp.zeros((n - 2,), bool)

    odd = parity == 1
    a = jnp.where(odd, i1, i0)
    b = jnp.where(odd, i0, i1)
    tris = jnp.stack([a, b, i2], axis=1)
    return jnp.where(bad[:, None], 0, tris)



def assemble_lines(index_buffer, ia: "InputAssemblyState"):
    """Index buffer → (L, 2) segment list for the line topologies.

    LINE_STRIP decodes segment i = (v_i, v_{i+1}); with ``primitive_restart``
    segments touching the restart index collapse to (0, 0) — zero screen
    length, dropped by line setup — which splits strips exactly where a new
    strip would begin."""
    flat = index_buffer.reshape(-1).astype(jnp.int32)
    if ia.topology == PrimitiveTopology.LINE_LIST:
        n = flat.shape[0]
        assert n % 2 == 0, f"line list needs an even index count, got {n}"
        return flat.reshape(-1, 2)
    n = flat.shape[0]
    assert n >= 2, f"line strip needs >= 2 indices, got {n}"
    segs = jnp.stack([flat[:-1], flat[1:]], axis=1)
    if ia.primitive_restart:
        bad = (flat[:-1] == -1) | (flat[1:] == -1)
        segs = jnp.where(bad[:, None], 0, segs)
    return segs


def _assemble_primitives(index_buffer, ia: "InputAssemblyState",
                         polygon_mode: "PolygonMode"):
    """Primitive assembly dispatch → (kind, (P, K) primitive indices).

    kind ∈ {'tri', 'line', 'point', 'wire_line', 'wire_point'} — the wire_*
    kinds are triangle topologies under a LINE/POINT polygon mode, kept as
    (T, 3) so the setup stage can cull by the polygon's facing before
    decomposing edges/vertices (Vulkan 27.7.1)."""
    topo = ia.topology
    if topo in (PrimitiveTopology.LINE_LIST, PrimitiveTopology.LINE_STRIP):
        return "line", assemble_lines(index_buffer, ia)
    if topo == PrimitiveTopology.POINT_LIST:
        return "point", index_buffer.reshape(-1, 1).astype(jnp.int32)
    tris = assemble_triangles(index_buffer, ia)
    if polygon_mode == PolygonMode.LINE:
        return "wire_line", tris
    if polygon_mode == PolygonMode.POINT:
        return "wire_point", tris
    return "tri", tris


def _setup_records(kind, clip, prims, flat_vary, grid, rast_state, viewport,
                   depth_bias, point_sizes=None):
    """Primitive setup dispatch → (TriangleRecords, corner_data), shared by
    the single-draw and batched paths. Triangles go straight to
    setup_with_attrs; lines/points expand to screen-space quads riding the
    same records format (so binning/raster/shade are topology-blind)."""
    dc = rast_state.depth_clamp
    if kind == "tri":
        return geometry.setup_with_attrs(
            clip, prims, flat_vary, grid.width, grid.height,
            cull_mode=rast_state.cull_mode, front_face=rast_state.front_face,
            viewport=viewport, depth_bias=depth_bias, depth_clamp=dc,
        )
    if kind in ("wire_line", "wire_point"):
        front, degen = geometry.triangle_facing(
            clip, prims, rast_state.front_face
        )
        keep = ~degen
        if rast_state.cull_mode == CullMode.BACK:
            keep = keep & front
        elif rast_state.cull_mode == CullMode.FRONT:
            keep = keep & ~front
        if kind == "wire_line":
            segs = jnp.concatenate(
                [prims[:, (0, 1)], prims[:, (1, 2)], prims[:, (2, 0)]]
            )
            seg_valid = jnp.concatenate([keep, keep, keep])
            return geometry.setup_lines_with_attrs(
                clip, segs, flat_vary, grid.width, grid.height,
                line_width=rast_state.line_width, viewport=viewport,
                depth_clamp=dc, seg_valid=seg_valid,
            )
        return geometry.setup_points_with_attrs(
            clip, prims.reshape(-1), flat_vary, grid.width, grid.height,
            point_sizes=point_sizes, viewport=viewport, depth_clamp=dc,
            pt_valid=jnp.repeat(keep, 3),
        )
    if kind == "line":
        return geometry.setup_lines_with_attrs(
            clip, prims, flat_vary, grid.width, grid.height,
            line_width=rast_state.line_width, viewport=viewport,
            depth_clamp=dc,
        )
    assert kind == "point", kind
    return geometry.setup_points_with_attrs(
        clip, prims.reshape(-1), flat_vary, grid.width, grid.height,
        point_sizes=point_sizes, viewport=viewport, depth_clamp=dc,
    )


def _pop_point_sizes(vs_out) -> "Optional[jnp.ndarray]":
    """Extract the PointSize builtin from the vertex-stage outputs (vertex
    shaders emit ``point_size`` alongside ``position``; Vulkan's
    gl_PointSize). Always popped so it never becomes a varying."""
    ps = vs_out.pop("point_size", None)
    if ps is None:
        return None
    return jnp.asarray(ps, jnp.float32).reshape(-1)


def _normalize_frag_out(frag_out) -> list:
    """Fragment-stage output → ordered list of attachment images (single
    array, list/tuple in attachment order, or dict sorted by key for MRT).
    One definition shared by the single-sample, per-pixel-MSAA and batch
    paths — they must never diverge on MRT ordering."""
    if isinstance(frag_out, (list, tuple)):
        return list(frag_out)
    if isinstance(frag_out, dict):
        return [frag_out[k] for k in sorted(frag_out)]
    return [frag_out]


@dataclass
class DrawStats:
    """Per-draw counters folded into frame stats (binning overflow is the
    analog of the reference's perf-hazard warnings, graph.rs:383-385),
    plus the updated stencil plane when the pipeline enables stencil."""

    bin_overflow: Any = None  # traced scalar
    stencil: Any = None  # (H, W) i32 or None


def draw_indexed(
    colors: "Sequence[jnp.ndarray]",  # current color attachment contents
    depth: Optional[jnp.ndarray],  # current depth contents or None
    pipeline: GraphicPipeline,
    vertex_buffer: jnp.ndarray,  # (Nv, stride) f32
    index_buffer: jnp.ndarray,  # (T, 3) or (3T,) int
    resources: "Dict[str, Any]",
    grid: TileGrid,
    bin_capacity: int = DEFAULT_BIN_CAPACITY,
    interpret: Optional[bool] = None,
    viewport: "Optional[tuple]" = None,  # (x0, y0, full_w, full_h) for SPMD shards
    entry_budget: Optional[int] = None,  # tile×record pair budget (see binning)
    stencil: Optional[jnp.ndarray] = None,  # current (H, W) i32 stencil plane
    instance_count: int = 1,
    instance_data: "Optional[Dict[str, Any]]" = None,  # name → (I, C) arrays
    budget_scale: int = 1,
) -> "tuple[list[jnp.ndarray], Optional[jnp.ndarray], DrawStats]":
    """Trace one indexed draw; returns (colors', depth', stats); when the
    pipeline enables the stencil test, ``stats.stencil`` carries the updated
    plane (pass ``stencil=`` the current one).

    ``instance_count`` > 1 is the vkCmdDrawIndexed instanceCount analog
    (reference command.rs:166): the vertex stage runs vmapped over
    instances, which see ``instance_data`` rows as extra attrs (the
    instance-rate vertex attributes of Vulkan) plus ``instance_index``
    (gl_InstanceIndex). Records concatenate in instance order, matching
    Vulkan's primitive ordering within an instanced draw.
    """
    state = pipeline.desc.state
    rast_state = state.rasterization
    ds = state.depth_stencil

    # -- vertex stage --------------------------------------------------------
    layout = pipeline.vertex_layout
    if layout is not None:
        attrs = layout.unpack(vertex_buffer)
    else:
        attrs = {"position": vertex_buffer}
    attrs = _CheckedAttrs(attrs, pipeline.vertex_shader.name)
    vs_res = BoundResources(pipeline.vertex_shader.reflection, resources)
    prim_kind, indices = _assemble_primitives(
        index_buffer, state.input_assembly, rast_state.polygon_mode
    )

    if instance_count > 1 or instance_data:
        _check_instance_inputs(pipeline, instance_data, instance_count)
        nv = vertex_buffer.shape[0]
        inst = {
            k: jnp.asarray(v, jnp.float32).reshape(instance_count, -1)
            for k, v in (instance_data or {}).items()
        }
        idx_f = jnp.arange(instance_count, dtype=jnp.float32)[:, None]

        def one_instance(inst_vals, iidx):
            a = _CheckedAttrs(attrs, pipeline.vertex_shader.name)
            for k, v in inst_vals.items():
                a[k] = jnp.broadcast_to(v[None, :], (nv, v.shape[-1]))
            a["instance_index"] = jnp.broadcast_to(iidx[None, :], (nv, 1))
            out = dict(pipeline.vertex_shader.fn(a, vs_res))
            return out.pop("position"), out

        clips, vs_outs = jax.vmap(one_instance)(inst, idx_f)  # (I, Nv, ...)
        clip = clips.reshape(instance_count * nv, 4)
        vs_out = {
            k: v.reshape(instance_count * nv, -1) for k, v in vs_outs.items()
        }
        # Index buffer tiled per instance with a vertex offset of i·Nv.
        offs = (jnp.arange(instance_count, dtype=jnp.int32) * nv)[:, None, None]
        indices = (indices[None, :, :] + offs).reshape(-1, indices.shape[1])
    else:
        vs_out = dict(pipeline.vertex_shader.fn(attrs, vs_res))
        clip = vs_out.pop("position")
    point_sizes = _pop_point_sizes(vs_out)
    _warn_unused_bindings(pipeline.vertex_shader, vs_res)
    assert clip.ndim == 2 and clip.shape[1] == 4, (
        f"vertex shader must return clip-space 'position' (N, 4), got {clip.shape}"
    )

    # -- primitive assembly + setup (fused with attribute gathering) ----------
    attr_layout = [(name, int(v.shape[-1]) if v.ndim > 1 else 1)
                   for name, v in vs_out.items()]
    if vs_out:
        flat_vary = jnp.concatenate(
            [v.reshape(v.shape[0], -1).astype(jnp.float32) for v in vs_out.values()],
            axis=1,
        )
    else:
        flat_vary = jnp.zeros((clip.shape[0], 0), jnp.float32)
    depth_bias = None
    if rast_state.depth_bias_enable:
        depth_bias = (rast_state.depth_bias_constant, rast_state.depth_bias_slope)
    specs = _geo_specs(
        prim_kind, clip, indices, flat_vary, grid, rast_state, viewport,
        depth_bias, point_sizes=point_sizes,
    )
    attr_layout.append(("__front", 1))

    # -- binning + raster ------------------------------------------------------
    # bin_capacity is interpreted as a per-draw entry budget multiplier for
    # the segmented binner (legacy callers pass per-tile caps; the budget is
    # never less than 4×records, so those remain valid hints).
    bins = _bin_spec_parts(specs, grid, entry_budget=entry_budget,
                           budget_scale=budget_scale)

    samples = state.multisample.samples
    if samples > 1:
        new_colors, new_depth, stencil_out = _raster_shade_msaa(
            colors, depth, pipeline, resources, bins, grid, attr_layout,
            samples, interpret, stencil=stencil,
        )
        return new_colors, new_depth, DrawStats(
            bin_overflow=bins.overflow, stencil=stencil_out
        )

    if depth is not None:
        init_z = depth
    else:
        init_z = jnp.zeros((grid.height, grid.width), jnp.float32)

    stencil_out = None
    if ds.stencil_test_enable:
        init_s = (
            stencil
            if stencil is not None
            else jnp.full((grid.height, grid.width),
                          ds.stencil_clear_value & 0xFF, jnp.int32)
        )
        z_out, acc, stencil_out = _raster_parts(
            bins,
            grid,
            init_z,
            depth_test=ds.depth_test_enable,
            depth_write=ds.depth_write_enable,
            compare_op=ds.depth_compare_op,
            depth_clamp=rast_state.depth_clamp,
            init_stencil=init_s,
            stencil_front=ds.stencil_front,
            stencil_back=ds.stencil_back,
            interpret=interpret,
        )
    else:
        z_out, acc = _raster_parts(
            bins,
            grid,
            init_z,
            depth_test=ds.depth_test_enable,
            depth_write=ds.depth_write_enable,
            compare_op=ds.depth_compare_op,
            depth_clamp=rast_state.depth_clamp,
            interpret=interpret,
        )

    new_colors = _shade_and_blend(
        colors, z_out, acc, attr_layout, pipeline, resources
    )
    new_depth = z_out if depth is not None else None
    return new_colors, new_depth, DrawStats(
        bin_overflow=bins.overflow, stencil=stencil_out
    )


def _shade_and_blend(colors, z_out, acc, attr_layout, pipeline, resources):
    """Varying finalize → fragment shader → output merger for one sample."""
    state = pipeline.desc.state
    varyings, mask, builtins = shade.finalize_attrs(z_out, acc, attr_layout)
    fs = pipeline.fragment_shader
    new_colors = list(colors)
    if fs is not None:
        fs_res = BoundResources(fs.reflection, resources)
        frag_out = fs.fn(varyings, fs_res, builtins)
        _warn_unused_bindings(fs, fs_res)
        frag_list = _normalize_frag_out(frag_out)
        descs = pipeline.desc.color_attachment_descs or tuple(
            None for _ in new_colors
        )
        assert len(frag_list) == len(new_colors), (
            f"fragment shader wrote {len(frag_list)} outputs for "
            f"{len(new_colors)} color attachments"
        )
        for i, (dst, src) in enumerate(zip(new_colors, frag_list)):
            desc = descs[i] if descs[i] is not None else ColorAttachmentDesc()
            new_colors[i] = blend_ops.apply_color_output(
                dst, src, mask, desc, state.color_blend.blend_constants
            )
    return new_colors


# Vulkan standard sample locations (spec 25.3).
SAMPLE_POSITIONS = {
    1: ((0.5, 0.5),),
    2: ((0.75, 0.75), (0.25, 0.25)),
    4: ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875)),
    8: (
        (0.5625, 0.3125), (0.4375, 0.6875), (0.8125, 0.5625),
        (0.3125, 0.1875), (0.1875, 0.8125), (0.0625, 0.4375),
        (0.6875, 0.9375), (0.9375, 0.0625),
    ),
}


def _raster_shade_msaa(colors, depth, pipeline, resources, bins, grid,
                       attr_layout, samples, interpret, stencil=None):
    """Multisampling: one shared binning, one raster per Vulkan standard
    sample position, per-sample shading + blending.

    Attachment convention inside an MSAA draw chain: colors are
    (S, H, W, C), depth is (S, H, W), and (when the pipeline enables the
    stencil test) stencil is (S, H, W) i32 — the graph prologue broadcasts
    clears/loads and the epilogue resolves (color: average; depth/stencil:
    sample 0, Vulkan's default resolve mode). Shading runs per sample —
    supersampling-grade quality (the architecture shades resolved winners,
    so a shade-once-per-pixel MSAA would mis-blend silhouette samples).
    """
    state = pipeline.desc.state
    ds = state.depth_stencil
    rast_state = state.rasterization
    offsets = SAMPLE_POSITIONS.get(samples)
    assert offsets is not None, f"unsupported sample count {samples}"
    with_stencil = ds.stencil_test_enable

    if not state.multisample.sample_shading:
        return _raster_shade_msaa_per_pixel(
            colors, depth, pipeline, resources, bins, grid, attr_layout,
            samples, offsets, interpret, stencil=stencil,
        )

    out_colors = [[] for _ in colors]
    out_z = []
    out_s = []
    for s, off in enumerate(offsets):
        if depth is not None:
            init_z = depth[s]
        else:
            init_z = jnp.zeros((grid.height, grid.width), jnp.float32)
        if with_stencil:
            if stencil is not None:
                init_s = stencil[s]
            else:
                init_s = jnp.full((grid.height, grid.width),
                                  ds.stencil_clear_value & 0xFF, jnp.int32)
            z_s, acc_s, sten_s = _raster_parts(
                bins, grid, init_z,
                depth_test=ds.depth_test_enable,
                depth_write=ds.depth_write_enable,
                compare_op=ds.depth_compare_op,
                depth_clamp=rast_state.depth_clamp,
                init_stencil=init_s,
                stencil_front=ds.stencil_front,
                stencil_back=ds.stencil_back,
                sample_offset=off,
                interpret=interpret,
            )
            out_s.append(sten_s)
        else:
            z_s, acc_s = _raster_parts(
                bins, grid, init_z,
                depth_test=ds.depth_test_enable,
                depth_write=ds.depth_write_enable,
                compare_op=ds.depth_compare_op,
                depth_clamp=rast_state.depth_clamp,
                sample_offset=off,
                interpret=interpret,
            )
        sample_colors = [c[s] for c in colors]
        shaded = _shade_and_blend(
            sample_colors, z_s, acc_s, attr_layout, pipeline, resources
        )
        for i, c in enumerate(shaded):
            out_colors[i].append(c)
        out_z.append(z_s)

    new_colors = [jnp.stack(cs) for cs in out_colors]
    new_depth = jnp.stack(out_z) if depth is not None else None
    new_stencil = jnp.stack(out_s) if with_stencil else None
    return new_colors, new_depth, new_stencil


def _raster_shade_msaa_per_pixel(colors, depth, pipeline, resources, bins,
                                 grid, attr_layout, samples, offsets,
                                 interpret, stencil=None):
    """Shade-ONCE-per-pixel MSAA (vk sampleShadingEnable=False — the GPU
    default cost model): one raster per sample position resolves per-sample
    visibility/depth (+stencil), one additional raster at the pixel CENTER
    resolves the shaded surface's attributes, the fragment shader runs once
    per pixel, and the result broadcasts into each covered sample through
    that sample's own blend. Shading cost at 4x/8x ≈ the 1x render.

    Quality contract (vs the supersampled sample_shading=True path): pixels
    fully covered by one surface are bit-equal to the 1x render; silhouette
    samples whose winner differs from the center winner receive the center
    surface's color (the standard non-centroid MSAA artifact); samples
    covered where the CENTER is not keep their previous contents (thin-
    feature undercoverage — GPUs extrapolate the attribute plane instead,
    which a resolved-attribute architecture cannot)."""
    state = pipeline.desc.state
    ds = state.depth_stencil
    rast_state = state.rasterization
    with_stencil = ds.stencil_test_enable

    zs, accs, stens = [], [], []
    for s, off in enumerate(offsets):
        init_z = (
            depth[s] if depth is not None
            else jnp.zeros((grid.height, grid.width), jnp.float32)
        )
        common = dict(
            depth_test=ds.depth_test_enable,
            depth_write=ds.depth_write_enable,
            compare_op=ds.depth_compare_op,
            depth_clamp=rast_state.depth_clamp,
            sample_offset=off,
            interpret=interpret,
        )
        if with_stencil:
            init_s = (
                stencil[s] if stencil is not None
                else jnp.full((grid.height, grid.width),
                              ds.stencil_clear_value & 0xFF, jnp.int32)
            )
            z_s, acc_s, st_s = _raster_parts(
                bins, grid, init_z,
                init_stencil=init_s,
                stencil_front=ds.stencil_front,
                stencil_back=ds.stencil_back,
                **common,
            )
            stens.append(st_s)
        else:
            z_s, acc_s = _raster_parts(bins, grid, init_z, **common)
        zs.append(z_s)
        accs.append(acc_s)

    # Center raster: resolves WHICH surface shades each pixel + its attrs.
    # The center plane is not persisted across draws, so its depth seed is
    # reconstructed compare-aware from the per-sample planes: for GREATER/
    # GEQ the per-pixel max is the standing winner (reverse-Z), for LESS/
    # LEQ the min; other compares fall back to sample 0. Residual
    # divergence (steep gradients where the true center z of the previous
    # winner differs from its best sample; stencil evaluated per sample
    # but not at center) is part of the documented shade-once contract.
    if depth is not None:
        from zenith.rhi.state import CompareOp as _CO

        if ds.depth_compare_op in (_CO.GREATER, _CO.GREATER_OR_EQUAL):
            init_zc = jnp.max(depth, axis=0)
        elif ds.depth_compare_op in (_CO.LESS, _CO.LESS_OR_EQUAL):
            init_zc = jnp.min(depth, axis=0)
        else:
            init_zc = depth[0]
    else:
        init_zc = jnp.zeros((grid.height, grid.width), jnp.float32)
    z_c, acc_c = _raster_parts(
        bins, grid, init_zc,
        depth_test=ds.depth_test_enable,
        depth_write=ds.depth_write_enable,
        compare_op=ds.depth_compare_op,
        depth_clamp=rast_state.depth_clamp,
        sample_offset=(0.5, 0.5),
        interpret=interpret,
    )

    varyings, center_mask, builtins = shade.finalize_attrs(
        z_c, acc_c, attr_layout
    )
    fs = pipeline.fragment_shader
    out_colors = [[c[s] for s in range(samples)] for c in colors]
    if fs is not None:
        fs_res = BoundResources(fs.reflection, resources)
        frag_out = fs.fn(varyings, fs_res, builtins)
        _warn_unused_bindings(fs, fs_res)
        frag_list = _normalize_frag_out(frag_out)
        descs = pipeline.desc.color_attachment_descs or tuple(
            None for _ in colors
        )
        assert len(frag_list) == len(colors)
        for s in range(samples):
            covered_s = accs[s][-1] > 0.0
            mask_s = covered_s & center_mask
            for i, src in enumerate(frag_list):
                desc = descs[i] if descs[i] is not None else ColorAttachmentDesc()
                out_colors[i][s] = blend_ops.apply_color_output(
                    out_colors[i][s], src, mask_s, desc,
                    state.color_blend.blend_constants,
                )

    new_colors = [jnp.stack(cs) for cs in out_colors]
    new_depth = jnp.stack(zs) if depth is not None else None
    new_stencil = jnp.stack(stens) if with_stencil else None
    return new_colors, new_depth, new_stencil


def draw_indexed_batch(
    colors: "Sequence[jnp.ndarray]",
    depth: Optional[jnp.ndarray],
    pipeline: GraphicPipeline,
    draws: "Sequence[tuple]",  # (vb, ib, resources[, inst]) per draw
    grid: TileGrid,
    per_draw_uniforms: "Sequence[str]" = (),
    interpret: Optional[bool] = None,
    viewport: "Optional[tuple]" = None,
    entry_budget: Optional[int] = None,
    stencil: Optional[jnp.ndarray] = None,
    budget_scale: int = 1,
    peel_layers: Optional[int] = None,
) -> "tuple[list[jnp.ndarray], Optional[jnp.ndarray], DrawStats]":
    """Trace N draws through ONE binning + raster + fragment + blend pass.

    The reference records one vkCmdDrawIndexed per object; its GPU
    rasterizes them back-to-back with zero per-draw fixed cost. Here each
    draw previously paid a full segmented raster plus a full-screen shade +
    blend; batching restores the hardware behavior: per-draw vertex stages,
    records concatenated in submission order (binning's (tile, record) sort
    preserves cross-draw ordering), then one raster, one fragment pass, one
    output merge.

    Per-draw fragment uniforms (``per_draw_uniforms`` names) are handed to
    the fragment shader as dense (H, W, C) planes under the same binding
    names (write shaders with shape-generic indexing, e.g.
    ``res["BaseColor"][..., :3]``). They are NOT interpolated through the
    raster kernel: only a single ``__draw_id`` channel rides the records,
    and each uniform plane is reconstructed per pixel from the (N, C)
    per-draw table by draw-id selection — constant-per-draw values need no
    perspective division, and keeping them out of the records cuts the
    raster/binning payload by 3 floats per corner per channel. Fragment
    bindings that differ across draws and are not listed become tuples.

    Blending across overlapping draws is ORDER-dependent; batching resolves
    one depth winner per pixel, so blend_enable with multiple draws needs
    either the in-order blend-kernel path (kernel-safe fragment shader) or
    DEPTH PEELING (``peel_layers=K``): K winner-resolve passes, each bounded
    by the previous layer's depth, shaded at FULL fragment rate (texture
    sampling allowed) and composited back-to-front — exact for ≤K
    overlapping translucent fragments per pixel; deeper fragments are
    dropped and counted into ``DrawStats.bin_overflow``.
    """
    state = pipeline.desc.state
    rast_state = state.rasterization
    ds = state.depth_stencil
    n_draws = len(draws)
    assert n_draws >= 1

    blend_enabled = any(
        desc.blend_enable
        for desc in pipeline.desc.color_attachment_descs or ()
    )
    peel = peel_layers is not None
    if peel:
        from zenith.rhi.state import CompareOp as _CO

        assert blend_enabled, "peel_layers requires a blending pipeline"
        assert len(colors) == 1, "depth peel: exactly one color attachment"
        assert not ds.stencil_test_enable, (
            "depth peel: stencil unsupported (use the in-order blend-kernel "
            "path for stencil + blending)"
        )
        assert ds.depth_test_enable and ds.depth_compare_op in (
            _CO.GREATER, _CO.GREATER_OR_EQUAL, _CO.LESS, _CO.LESS_OR_EQUAL
        ), (
            "depth peel needs an ordering depth test (GREATER/GEQ/LESS/"
            "LEQ) — peeling resolves layers by depth, not submission order"
        )
        assert int(peel_layers) >= 1
    if blend_enabled and not peel:
        # Order-dependent blending cannot ride the winner-resolve kernel
        # (one fragment per pixel); it takes the per-tile in-order blend
        # kernel instead — fragment shader inlined per record, blend
        # equation applied in submission order. A SINGLE blended draw with
        # a non-kernel-safe shader keeps the winner-resolve + dense
        # shade+blend path (correct unless its own geometry self-overlaps;
        # the kernel path handles even that when the shader is safe).
        fs = pipeline.fragment_shader
        kernel_ok = fs is not None and fs.kernel_safe
        if kernel_ok:
            assert len(colors) == 1, (
                "blend batch: exactly one color attachment"
            )
            return _draw_batch_blend(
                colors, depth, pipeline, draws, grid,
                interpret=interpret, viewport=viewport,
                entry_budget=entry_budget, budget_scale=budget_scale,
                stencil=stencil,
            )
        if n_draws > 1:
            raise ValueError(
                "draw_indexed_batch with blending across multiple draws "
                "needs a KERNEL-SAFE fragment shader (Shader.fragment(..., "
                "kernel_safe=True): pure elementwise jnp, no texture "
                "sampling) — the blend runs per fragment in submission "
                "order inside the raster kernel — or peel_layers=K for "
                "depth-peeled full-fragment-rate translucency (texture "
                "sampling allowed; exact for ≤K layers). Alternatively "
                "submit blended draws individually (one full-screen "
                "shade+blend per draw)."
            )

    layout = pipeline.vertex_layout
    depth_bias = None
    if rast_state.depth_bias_enable:
        depth_bias = (rast_state.depth_bias_constant, rast_state.depth_bias_slope)

    # Per-draw uniform routing flips with draw count. Small batches
    # reconstruct each uniform plane from the (N, C) table by a draw-id
    # where-chain (keeps the records slim at a handful of draws). The chain is O(N) full-screen selects, so at
    # many draws the uniforms instead ride the RECORDS as constant varying
    # columns (a constant interpolates to itself; the blend path always
    # does this) — cost then scales with records, not N·H·W.
    uniforms_in_records = n_draws > 8 and bool(per_draw_uniforms)

    all_specs = []
    attr_layout = None
    for di, draw in enumerate(draws):
        vb, ib, res = draw[0], draw[1], draw[2]
        inst = draw[3] if len(draw) > 3 else None
        attrs = _CheckedAttrs(
            layout.unpack(vb) if layout is not None else {"position": vb},
            pipeline.vertex_shader.name,
        )
        vs_res = BoundResources(pipeline.vertex_shader.reflection, res)
        prim_kind, prims = _assemble_primitives(
            ib, state.input_assembly, rast_state.polygon_mode
        )
        if inst:
            # Per-draw instancing (vkCmdDrawIndexed instanceCount): the
            # vertex stage runs vmapped over instances; records concatenate
            # in instance order, matching Vulkan's primitive ordering.
            icount = int(inst.get("instance_count", 1))
            idata = inst.get("instance_data") or {}
            _check_instance_inputs(pipeline, idata, icount)
            nv0 = vb.shape[0]
            inst_arrs = {
                k: jnp.asarray(v, jnp.float32).reshape(icount, -1)
                for k, v in idata.items()
            }
            idx_f = jnp.arange(icount, dtype=jnp.float32)[:, None]

            def one_instance(inst_vals, iidx, attrs=attrs, vs_res=vs_res,
                             nv0=nv0):
                a = _CheckedAttrs(attrs, pipeline.vertex_shader.name)
                for k, v in inst_vals.items():
                    a[k] = jnp.broadcast_to(v[None, :], (nv0, v.shape[-1]))
                a["instance_index"] = jnp.broadcast_to(
                    iidx[None, :], (nv0, 1)
                )
                out = dict(pipeline.vertex_shader.fn(a, vs_res))
                return out.pop("position"), out

            clips, vs_outs = jax.vmap(one_instance)(inst_arrs, idx_f)
            clip = clips.reshape(icount * nv0, 4)
            vs_out = {
                k: v.reshape(icount * nv0, -1) for k, v in vs_outs.items()
            }
            offs = (
                jnp.arange(icount, dtype=jnp.int32) * nv0
            )[:, None, None]
            prims = (prims[None, :, :] + offs).reshape(-1, prims.shape[1])
        else:
            vs_out = dict(pipeline.vertex_shader.fn(attrs, vs_res))
            clip = vs_out.pop("position")
        _warn_unused_bindings(pipeline.vertex_shader, vs_res)
        point_sizes = _pop_point_sizes(vs_out)
        nv = clip.shape[0]

        this_layout = [(name, int(v.shape[-1]) if v.ndim > 1 else 1)
                       for name, v in vs_out.items()]
        vary_cols = [v.reshape(nv, -1).astype(jnp.float32)
                     for v in vs_out.values()]
        this_layout.append(("__draw_id", 1))
        vary_cols.append(jnp.full((nv, 1), float(di), jnp.float32))
        if uniforms_in_records:
            for uname in per_draw_uniforms:
                uval = jnp.asarray(res[uname], jnp.float32).reshape(-1)
                this_layout.append((f"__u_{uname}", int(uval.shape[0])))
                vary_cols.append(jnp.broadcast_to(
                    uval[None, :], (nv, uval.shape[0])
                ))

        if attr_layout is None:
            attr_layout = this_layout
        else:
            assert attr_layout == this_layout, (
                f"draw {di}: varying layout {this_layout} differs from "
                f"draw 0's {attr_layout} — batched draws share one pipeline"
            )
        flat_vary = (
            jnp.concatenate(vary_cols, axis=1)
            if vary_cols
            else jnp.zeros((nv, 0), jnp.float32)
        )
        all_specs.extend(_geo_specs(
            prim_kind, clip, prims, flat_vary, grid, rast_state, viewport,
            depth_bias, point_sizes=point_sizes,
        ))
    attr_layout.append(("__front", 1))

    bins = _bin_spec_parts(
        all_specs, grid, entry_budget=entry_budget,
        budget_scale=budget_scale,
    )

    def raster_one(init_z, init_stencil_or_none, sample_offset=(0.5, 0.5)):
        """One raster pass at one sample position → (z, acc, stencil|None)."""
        if ds.stencil_test_enable:
            init_s = (
                init_stencil_or_none if init_stencil_or_none is not None
                else jnp.full((grid.height, grid.width),
                              ds.stencil_clear_value & 0xFF, jnp.int32)
            )
            return _raster_parts(
                bins, grid, init_z,
                depth_test=ds.depth_test_enable,
                depth_write=ds.depth_write_enable,
                compare_op=ds.depth_compare_op,
                depth_clamp=rast_state.depth_clamp,
                init_stencil=init_s, stencil_front=ds.stencil_front,
                stencil_back=ds.stencil_back,
                sample_offset=sample_offset, interpret=interpret,
            )
        z_out, acc = _raster_parts(
            bins, grid, init_z,
            depth_test=ds.depth_test_enable, depth_write=ds.depth_write_enable,
            compare_op=ds.depth_compare_op, depth_clamp=rast_state.depth_clamp,
            sample_offset=sample_offset, interpret=interpret,
        )
        return z_out, acc, None

    def shade_sample(z_out, acc, sample_colors):
        """Finalize varyings + run the fragment shader + output merge for
        one resolved visibility plane (one sample, or the 1x render)."""
        varyings, mask, builtins = shade.finalize_attrs(
            z_out, acc, attr_layout
        )
        draw_id = varyings.pop("__draw_id", None)

        fs = pipeline.fragment_shader
        new_cols = list(sample_colors)
        if fs is None:
            return new_cols
        # Per-draw uniform planes + resource tuples for everything else.
        fs_resources: Dict[str, Any] = {}
        if uniforms_in_records:
            for uname in per_draw_uniforms:
                fs_resources[uname] = varyings.pop(f"__u_{uname}")
        for name in fs.reflection.binding_names():
            if name in fs_resources:
                continue
            if name in per_draw_uniforms and not uniforms_in_records:
                # (N, C) per-draw table → (H, W, C) plane by draw-id
                # selection (N is small and static; a where-chain avoids a
                # per-pixel gather).
                table = [
                    jnp.asarray(d[2][name], jnp.float32).reshape(-1)
                    for d in draws
                ]
                widths = {int(t.shape[0]) for t in table}
                assert len(widths) == 1, (
                    f"per-draw uniform '{name}': draws disagree on width "
                    f"({sorted(widths)}) — all draws in a batch must bind "
                    f"the same-shaped value"
                )
                plane = jnp.broadcast_to(
                    table[0][None, None, :],
                    draw_id.shape[:2] + (table[0].shape[0],),
                )
                for i in range(1, n_draws):
                    sel = (jnp.abs(draw_id[..., 0] - i) < 0.5)[..., None]
                    plane = jnp.where(sel, table[i][None, None, :], plane)
                fs_resources[name] = plane
            else:
                vals = [d[2].get(name) for d in draws]
                if all(v is vals[0] for v in vals):
                    fs_resources[name] = vals[0]
                else:
                    fs_resources[name] = PerDraw(vals)
        fs_res = BoundResources(fs.reflection, fs_resources)
        if draw_id is not None:
            from dataclasses import replace as _dc_replace

            builtins = _dc_replace(builtins, draw_id=draw_id[..., 0])
        frag_out = fs.fn(varyings, fs_res, builtins)
        _warn_unused_bindings(fs, fs_res)
        frag_list = _normalize_frag_out(frag_out)
        descs = pipeline.desc.color_attachment_descs or tuple(
            None for _ in new_cols
        )
        assert len(frag_list) == len(new_cols)
        for i, (dst, src) in enumerate(zip(new_cols, frag_list)):
            desc = descs[i] if descs[i] is not None else ColorAttachmentDesc()
            new_cols[i] = blend_ops.apply_color_output(
                dst, src, mask, desc, state.color_blend.blend_constants
            )
        return new_cols

    samples = state.multisample.samples
    if peel:
        # DEPTH PEELING (Everitt 2001): K bounded winner-resolve
        # passes over ONE shared binning — peel k rejects fragments at or
        # before peel k-1's depth, so each pass resolves the next-nearest
        # layer. Every layer shades DENSELY at full fragment rate (texture
        # sampling, derivatives — anything a dense FS can do), then the
        # layers composite back-to-front through the pipeline's blend
        # equation. Exact for ≤K overlapping translucent fragments per
        # pixel; a final bounded probe pass counts dropped deeper fragments
        # into DrawStats.bin_overflow (the same dropped-work channel the
        # binner uses). Reference parity: pipeline.rs:337-412 translucent()
        # composes freely with sampling shaders — this is the
        # fragment-rate-correct path the in-order blend kernel (vertex-rate
        # textures) cannot provide.
        k_layers = int(peel_layers)

        def peel_chain(init_z_s, dst, off):
            layers = []
            bound = None
            for _k in range(k_layers):
                z_k, acc_k = _raster_parts(
                    bins, grid, init_z_s,
                    depth_test=True, depth_write=True,
                    compare_op=ds.depth_compare_op,
                    depth_clamp=rast_state.depth_clamp,
                    sample_offset=off, interpret=interpret,
                    z_bound=bound,
                )
                layers.append((z_k, acc_k))
                bound = z_k
            # Overflow probe: one more bounded pass — any surviving
            # fragment is a dropped (K+1)-th layer.
            _, acc_over = _raster_parts(
                bins, grid, init_z_s,
                depth_test=True, depth_write=False,
                compare_op=ds.depth_compare_op,
                depth_clamp=rast_state.depth_clamp,
                sample_offset=off, interpret=interpret,
                z_bound=bound,
            )
            over = jnp.sum((acc_over[-1] > 0.0).astype(jnp.int32))
            for z_k, acc_k in reversed(layers):
                dst = shade_sample(z_k, acc_k, [dst])[0]
            return dst, layers[0][0], over

        if samples > 1:
            offsets = SAMPLE_POSITIONS.get(samples)
            assert offsets is not None, f"unsupported sample count {samples}"
            out_c, out_zs = [], []
            over_total = jnp.int32(0)
            for s, off in enumerate(offsets):
                init_z_s = (
                    depth[s] if depth is not None
                    else jnp.zeros((grid.height, grid.width), jnp.float32)
                )
                c_s, z_s, over = peel_chain(init_z_s, colors[0][s], off)
                out_c.append(c_s)
                out_zs.append(z_s)
                over_total = over_total + over
            new_depth = None
            if depth is not None:
                new_depth = (
                    jnp.stack(out_zs) if ds.depth_write_enable else depth
                )
            return [jnp.stack(out_c)], new_depth, DrawStats(
                bin_overflow=bins.overflow + over_total
            )

        init_z = depth if depth is not None else jnp.zeros(
            (grid.height, grid.width), jnp.float32
        )
        c_out, z_out, over = peel_chain(init_z, colors[0], (0.5, 0.5))
        new_depth = None
        if depth is not None:
            new_depth = z_out if ds.depth_write_enable else depth
        return [c_out], new_depth, DrawStats(
            bin_overflow=bins.overflow + over
        )

    if samples > 1:
        # Batched MSAA: one shared binning, one raster + shade per Vulkan
        # standard sample position — the same supersampled contract as
        # single-draw MSAA (draw chain convention: colors (S, H, W, C),
        # depth/stencil (S, H, W)). The shade-once-per-pixel mode
        # (sample_shading=False) applies per-sample shading here too: its
        # center-seed machinery is winner-based and the batch path shades
        # from resolved winners per sample anyway.
        offsets = SAMPLE_POSITIONS.get(samples)
        assert offsets is not None, f"unsupported sample count {samples}"
        out_colors = [[] for _ in colors]
        out_z: list = []
        out_s: list = []
        for s, off in enumerate(offsets):
            init_z_s = (
                depth[s] if depth is not None
                else jnp.zeros((grid.height, grid.width), jnp.float32)
            )
            init_s_s = stencil[s] if stencil is not None else None
            z_s, acc_s, st_s = raster_one(init_z_s, init_s_s, off)
            shaded = shade_sample(z_s, acc_s, [c[s] for c in colors])
            for i, c in enumerate(shaded):
                out_colors[i].append(c)
            out_z.append(z_s)
            if st_s is not None:
                out_s.append(st_s)
        new_colors = [jnp.stack(cs) for cs in out_colors]
        new_depth = jnp.stack(out_z) if depth is not None else None
        stencil_out = jnp.stack(out_s) if out_s else None
        return new_colors, new_depth, DrawStats(
            bin_overflow=bins.overflow, stencil=stencil_out
        )

    init_z = depth if depth is not None else jnp.zeros(
        (grid.height, grid.width), jnp.float32
    )
    z_out, acc, stencil_out = raster_one(init_z, stencil)
    new_colors = shade_sample(z_out, acc, colors)
    new_depth = z_out if depth is not None else None
    return new_colors, new_depth, DrawStats(
        bin_overflow=bins.overflow, stencil=stencil_out
    )


def _draw_batch_blend(
    colors, depth, pipeline, draws, grid,
    interpret=None, viewport=None, entry_budget=None, budget_scale=1,
    stencil=None,
):
    """Order-correct transparency for batched draws: one binning over every
    draw's records (submission order preserved by the (tile, record) sort),
    then the per-tile in-order blend kernel (raster.raster_segmented_blend)
    which shades + blends each covered fragment in order.

    Uniform bindings ride as CONSTANT varying columns (same value at all
    three corners interpolates to itself), so per-draw uniforms need no
    draw-id select and the kernel needs no side-band uniform plumbing. The
    fragment shader must be kernel-safe (elementwise jnp only) — texture
    content can still reach it by sampling in the VERTEX stage (dense XLA,
    vertices not pixels) and interpolating the sampled color, the
    vertex-rate texturing path the textured-glass pipeline uses.

    A draw may be ``(vb, ib, res)`` or ``(vb, ib, res, inst)`` with
    ``inst = {"instance_count": I, "instance_data": {name: (I, C)}}`` —
    the vkCmdDrawIndexed instanceCount analog for blended draws (records
    concatenate in instance order inside the draw, matching Vulkan's
    primitive ordering)."""
    from zenith.ops.raster import raster_segmented_blend
    from zenith.rhi.shader import FragmentBuiltins

    state = pipeline.desc.state
    rast_state = state.rasterization
    ds = state.depth_stencil
    fs = pipeline.fragment_shader
    layout = pipeline.vertex_layout
    n_draws = len(draws)
    depth_bias = None
    if rast_state.depth_bias_enable:
        depth_bias = (rast_state.depth_bias_constant, rast_state.depth_bias_slope)

    uniform_names = tuple(fs.reflection.binding_names())

    all_specs = []
    attr_layout = None
    for di, draw in enumerate(draws):
        vb, ib, res = draw[0], draw[1], draw[2]
        inst = draw[3] if len(draw) > 3 else None
        attrs = _CheckedAttrs(
            layout.unpack(vb) if layout is not None else {"position": vb},
            pipeline.vertex_shader.name,
        )
        vs_res = BoundResources(pipeline.vertex_shader.reflection, res)
        prim_kind, prims = _assemble_primitives(
            ib, state.input_assembly, rast_state.polygon_mode
        )
        if inst:
            icount = int(inst.get("instance_count", 1))
            idata = inst.get("instance_data") or {}
            _check_instance_inputs(pipeline, idata, icount)
            nv0 = vb.shape[0]
            inst_arrs = {
                k: jnp.asarray(v, jnp.float32).reshape(icount, -1)
                for k, v in idata.items()
            }
            idx_f = jnp.arange(icount, dtype=jnp.float32)[:, None]

            def one_instance(inst_vals, iidx, attrs=attrs, vs_res=vs_res,
                             nv0=nv0):
                a = _CheckedAttrs(attrs, pipeline.vertex_shader.name)
                for k, v in inst_vals.items():
                    a[k] = jnp.broadcast_to(v[None, :], (nv0, v.shape[-1]))
                a["instance_index"] = jnp.broadcast_to(
                    iidx[None, :], (nv0, 1)
                )
                out = dict(pipeline.vertex_shader.fn(a, vs_res))
                return out.pop("position"), out

            clips, vs_outs = jax.vmap(one_instance)(inst_arrs, idx_f)
            clip = clips.reshape(icount * nv0, 4)
            vs_out = {
                k: v.reshape(icount * nv0, -1) for k, v in vs_outs.items()
            }
            offs = (
                jnp.arange(icount, dtype=jnp.int32) * nv0
            )[:, None, None]
            prims = (prims[None, :, :] + offs).reshape(-1, prims.shape[1])
        else:
            vs_out = dict(pipeline.vertex_shader.fn(attrs, vs_res))
            clip = vs_out.pop("position")
        point_sizes = _pop_point_sizes(vs_out)
        nv = clip.shape[0]

        this_layout = [(name, int(v.shape[-1]) if v.ndim > 1 else 1)
                       for name, v in vs_out.items()]
        vary_cols = [v.reshape(nv, -1).astype(jnp.float32)
                     for v in vs_out.values()]
        this_layout.append(("__draw_id", 1))
        vary_cols.append(jnp.full((nv, 1), float(di), jnp.float32))
        # Uniforms as constant per-vertex columns (see docstring).
        for uname in uniform_names:
            if uname not in res:
                raise BindingError(
                    f"blend batch draw {di}: fragment binding '{uname}' "
                    f"not provided"
                )
            uval = jnp.asarray(res[uname], jnp.float32).reshape(-1)
            this_layout.append((f"__u_{uname}", int(uval.shape[0])))
            vary_cols.append(jnp.broadcast_to(
                uval[None, :], (nv, uval.shape[0])
            ))

        if attr_layout is None:
            attr_layout = this_layout
        else:
            assert attr_layout == this_layout, (
                f"blend batch draw {di}: varying/uniform layout differs "
                f"from draw 0's — batched draws share one pipeline"
            )
        flat_vary = jnp.concatenate(vary_cols, axis=1)
        all_specs.extend(_geo_specs(
            prim_kind, clip, prims, flat_vary, grid, rast_state, viewport,
            depth_bias, point_sizes=point_sizes,
        ))
    attr_layout.append(("__front", 1))

    bins = _bin_spec_parts(
        all_specs, grid, entry_budget=entry_budget,
        budget_scale=budget_scale,
    )

    def blend_parts(init_z_p, init_c_p, init_s_p=None, sample_offset=(0.5, 0.5)):
        """raster_segmented_blend threading (z, color[, stencil]) through
        the sequential bin parts — the in-order blend carries its state in
        the planes, so parts compose exactly (contiguous record ranges
        preserve submission order)."""
        z_p, c_p, s_p = init_z_p, init_c_p, init_s_p
        for b in bins.parts:
            if s_p is not None:
                z_p, c_p, s_p = raster_segmented_blend(
                    b, grid, z_p, c_p, shade_blend,
                    depth_test=ds.depth_test_enable,
                    depth_write=ds.depth_write_enable,
                    compare_op=ds.depth_compare_op,
                    depth_clamp=rast_state.depth_clamp,
                    sample_offset=sample_offset, interpret=interpret,
                    init_stencil=s_p, stencil_front=ds.stencil_front,
                    stencil_back=ds.stencil_back,
                )
            else:
                z_p, c_p = raster_segmented_blend(
                    b, grid, z_p, c_p, shade_blend,
                    depth_test=ds.depth_test_enable,
                    depth_write=ds.depth_write_enable,
                    compare_op=ds.depth_compare_op,
                    depth_clamp=rast_state.depth_clamp,
                    sample_offset=sample_offset, interpret=interpret,
                )
        return z_p, c_p, s_p

    cdesc = (pipeline.desc.color_attachment_descs or
             (ColorAttachmentDesc(),))[0]
    constants = state.color_blend.blend_constants
    full_res = (grid.width, grid.height)
    layout_final = list(attr_layout)

    def shade_blend(planes, passed, x, y, zpx, c_planes):
        iw = planes[-1]
        ok = iw > 0.0
        inv = jnp.where(ok, 1.0 / jnp.where(ok, iw, 1.0), 0.0)
        varyings = {}
        res_vals = {}
        front = None
        draw_id = None
        off = 0
        for name, ch in layout_final:
            img = jnp.stack([planes[off + k] * inv for k in range(ch)],
                            axis=-1)
            if name == "__front":
                front = img[..., 0] > 0.5
            elif name == "__draw_id":
                draw_id = img[..., 0]
            elif name.startswith("__u_"):
                res_vals[name[4:]] = img
            else:
                varyings[name] = img
            off += ch
        builtins = FragmentBuiltins(
            frag_coord=jnp.stack([x, y], axis=-1),
            depth=zpx,
            front_facing=front if front is not None else passed,
            resolution=full_res,
            draw_id=draw_id,
        )
        src = fs.fn(varyings, BoundResources(fs.reflection, res_vals),
                    builtins)
        dst = jnp.stack(c_planes, axis=-1)
        out = blend_ops.blend_colors(dst, src, cdesc, constants)
        # Per-channel 2-D select: Mosaic cannot insert a minor dim on the
        # bool coverage mask (apply_color_output's mask[..., None]).
        return tuple(
            jnp.where(passed, out[..., k], c_planes[k]) for k in range(4)
        )

    with_stencil = ds.stencil_test_enable

    def default_stencil():
        return jnp.full((grid.height, grid.width),
                        ds.stencil_clear_value & 0xFF, jnp.int32)

    samples = state.multisample.samples
    if samples > 1:
        # MSAA through the blend kernel: one shared binning, one in-order
        # blend pass per Vulkan standard sample position (the fragment
        # shader is inlined per record, so shading is inherently per
        # sample — supersampled quality for both sample_shading modes).
        offsets = SAMPLE_POSITIONS.get(samples)
        assert offsets is not None, f"unsupported sample count {samples}"
        out_z, out_c, out_s = [], [], []
        for s, off in enumerate(offsets):
            init_z_s = (
                depth[s] if depth is not None
                else jnp.zeros((grid.height, grid.width), jnp.float32)
            )
            if with_stencil:
                init_s_s = (
                    stencil[s] if stencil is not None else default_stencil()
                )
                z_s, c_s, st_s = blend_parts(
                    init_z_s, colors[0][s], init_s_s, sample_offset=off
                )
                out_s.append(st_s)
            else:
                z_s, c_s, _ = blend_parts(
                    init_z_s, colors[0][s], sample_offset=off
                )
            out_z.append(z_s)
            out_c.append(c_s)
        new_depth = jnp.stack(out_z) if depth is not None else None
        return (
            [jnp.stack(out_c)], new_depth,
            DrawStats(bin_overflow=bins.overflow,
                      stencil=jnp.stack(out_s) if out_s else None),
        )

    init_z = depth if depth is not None else jnp.zeros(
        (grid.height, grid.width), jnp.float32
    )
    if with_stencil:
        init_s = stencil if stencil is not None else default_stencil()
        z_out, color, stencil_out = blend_parts(init_z, colors[0], init_s)
        new_depth = z_out if depth is not None else None
        return [color], new_depth, DrawStats(
            bin_overflow=bins.overflow, stencil=stencil_out
        )
    z_out, color, _ = blend_parts(init_z, colors[0])
    new_depth = z_out if depth is not None else None
    return [color], new_depth, DrawStats(bin_overflow=bins.overflow)
