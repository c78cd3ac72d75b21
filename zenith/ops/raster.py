"""The fine rasterizer: one Pallas kernel over per-tile segments.

The hardware rasterizer + early-Z + output merger of the Vulkan pipeline,
as a software rasterizer in the style of Laine & Karras (HPG 2011): binning
(ops.binning) sorts (tile, record) entries into per-tile segments in
submission order; here ONE program owns one screen tile, walks its segment
in order, and keeps depth, the optional stencil plane and the attribute (or
color) planes in registers. Triangles are processed strictly in submission
order, so depth-compare ties, depth-write-off overdraw, stencil ops and
blending resolve exactly as a GPU's output merger would.

Attributes are interpolated in-kernel as attr·(1/w) planes plus the 1/w
plane (perspective-correct forward interpolation); shading runs afterwards
as a dense per-pixel pass (ops.shade), except for in-order blending, whose
fragment shader + blend equation run per fragment inside the kernel.

One kernel body serves every variant through static flags: stencil, depth
peel bound, and in-order blend. ``raster_segmented_xla`` is the same walk
written in plain ``lax``, vectorized over tiles: the reference for the
compiled kernel and its timing opponent.

The kernel compiles through Triton on the GPU and runs in the Pallas
interpreter on the CPU (ops.runtime).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from zenith.ops.binning import TileGrid
from zenith.ops.runtime import TRITON, pallas_interpret, triton_params
from zenith.rhi.state import CompareOp

# Warps per tile program (Triton). Tiles are small, and the per-entry loop
# is latency-bound on its scalar row loads, so few warps per program let
# more programs share an SM.
NUM_WARPS = 2


def _compare_fn(op: CompareOp) -> Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]:
    return {
        CompareOp.NEVER: lambda new, cur: jnp.zeros_like(new, dtype=bool),
        CompareOp.LESS: lambda new, cur: new < cur,
        CompareOp.EQUAL: lambda new, cur: new == cur,
        CompareOp.LESS_OR_EQUAL: lambda new, cur: new <= cur,
        CompareOp.GREATER: lambda new, cur: new > cur,
        CompareOp.NOT_EQUAL: lambda new, cur: new != cur,
        CompareOp.GREATER_OR_EQUAL: lambda new, cur: new >= cur,
        CompareOp.ALWAYS: lambda new, cur: jnp.ones_like(new, dtype=bool),
    }[op]


def _stencil_apply(op, s: jnp.ndarray, reference: int) -> jnp.ndarray:
    """One VkStencilOp over an int32 stencil plane (8-bit semantics)."""
    from zenith.rhi.state import StencilOp

    if op == StencilOp.KEEP:
        return s
    if op == StencilOp.ZERO:
        return jnp.zeros_like(s)
    if op == StencilOp.REPLACE:
        return jnp.full_like(s, reference & 0xFF)
    if op == StencilOp.INCREMENT_AND_CLAMP:
        return jnp.minimum(s + 1, 255)
    if op == StencilOp.DECREMENT_AND_CLAMP:
        return jnp.maximum(s - 1, 0)
    if op == StencilOp.INVERT:
        return ~s & 0xFF
    if op == StencilOp.INCREMENT_AND_WRAP:
        return (s + 1) & 0xFF
    if op == StencilOp.DECREMENT_AND_WRAP:
        return (s - 1) & 0xFF
    raise ValueError(op)


def _stencil_face_update(face, cov, spass, dpass, s):
    """Post-test stencil write for one face state (Vulkan 27.19):
    sfail → fail_op, depth-fail → depth_fail_op, pass → pass_op, each
    masked by write_mask."""
    ref = face.reference
    out = s
    out = jnp.where(cov & ~spass, _stencil_apply(face.fail_op, s, ref), out)
    out = jnp.where(spass & ~dpass,
                    _stencil_apply(face.depth_fail_op, s, ref), out)
    out = jnp.where(dpass, _stencil_apply(face.pass_op, s, ref), out)
    wmask = face.write_mask & 0xFF
    if wmask == 0xFF:
        return out
    return (s & ~wmask) | (out & wmask)


def _stencil_test(face, cov, sten):
    ref_m = (face.reference & face.compare_mask) & 0xFF
    s_m = sten & (face.compare_mask & 0xFF)
    return cov & _compare_fn(face.compare_op)(jnp.full_like(s_m, ref_m), s_m)


class _Variant:
    """Static configuration of one raster variant."""

    def __init__(self, num_attrs, compare, depth_write, depth_clamp,
                 bound_compare=None, stencil=None, shade_blend=None):
        self.num_attrs = num_attrs
        self.compare = compare
        self.depth_write = depth_write
        self.depth_clamp = depth_clamp
        self.bound_compare = bound_compare  # depth-peel bound test
        self.stencil = stencil  # (front, back) StencilOpState
        self.shade_blend = shade_blend  # in-order blend: 4 color planes

    @property
    def a_n(self) -> int:
        return self.num_attrs + 1  # +1 for the 1/w plane

    @property
    def num_planes(self) -> int:
        return 4 if self.shade_blend is not None else self.a_n


def _fragment(v: _Variant, col, x, y, bound, carry):
    """Process one entry (record) against a tile's carried state.

    ``col(c)`` reads column c of the entry's merged row: a scalar in the
    kernel, a per-tile (T, 1, 1) column in the XLA reference. ``carry`` is
    (z, stencil or None, planes)."""
    z, sten, planes = carry
    a_n = v.a_n
    e01 = col(0) * x + col(1) * y + col(2)
    e12 = col(3) * x + col(4) * y + col(5)
    e20 = col(6) * x + col(7) * y + col(8)
    # Top-left fill rule: boundary pixels belong to top/left edges.
    cov = (
        ((e01 > 0.0) | ((e01 == 0.0) & (col(9) > 0.0)))
        & ((e12 > 0.0) | ((e12 == 0.0) & (col(10) > 0.0)))
        & ((e20 > 0.0) | ((e20 == 0.0) & (col(11) > 0.0)))
    )
    inv_det = col(12)
    w0 = e12 * inv_det
    w1 = e20 * inv_det
    w2 = e01 * inv_det
    zpx = w0 * col(13) + w1 * col(14) + w2 * col(15)
    # Per-pixel near/far clip (z outside [0,1] discarded — the geometric
    # near clip guarantees finite coords, this finishes it); with
    # depth_clamp the fragment z clamps instead (27.7.3).
    if v.depth_clamp:
        zpx = jnp.clip(zpx, 0.0, 1.0)
    else:
        cov &= (zpx >= 0.0) & (zpx <= 1.0)
    if v.bound_compare is not None:
        cov &= v.bound_compare(zpx, bound)  # strictly behind the last peel

    # Per-fragment order (Vulkan 27.18-27.19): coverage → stencil test →
    # depth test; stencil ops fire on their outcomes.
    if v.stencil is not None:
        front, back = v.stencil
        if front == back:
            spass = _stencil_test(front, cov, sten)
            passed = spass & v.compare(zpx, z)
            sten = _stencil_face_update(front, cov, spass, passed, sten)
        else:
            # Facing rides the second-to-last attr channel (front·iw at
            # corner 0; iw > 0 always).
            is_front = col(16 + a_n - 2) > 0.0
            spass_f = _stencil_test(front, cov, sten)
            spass_b = _stencil_test(back, cov, sten)
            spass = jnp.where(is_front, spass_f, spass_b)
            passed = spass & v.compare(zpx, z)
            sten = jnp.where(
                is_front,
                _stencil_face_update(front, cov, spass_f, passed, sten),
                _stencil_face_update(back, cov, spass_b, passed, sten),
            )
    else:
        passed = cov & v.compare(zpx, z)
    if v.depth_write:
        z = jnp.where(passed, zpx, z)

    attrs = [
        w0 * col(16 + a) + w1 * col(16 + a_n + a) + w2 * col(16 + 2 * a_n + a)
        for a in range(a_n)
    ]
    if v.shade_blend is not None:
        # Fragment shader + blend equation, in order (KERNEL-SAFE contract:
        # ops.draw's shade_blend is pure elementwise jnp, no gathers).
        planes = tuple(v.shade_blend(attrs, passed, x, y, zpx, tuple(planes)))
    else:
        planes = tuple(jnp.where(passed, p, q) for p, q in zip(attrs, planes))
    return z, sten, planes


def _raster_kernel(start_ref, count_ref, rows_ref, *refs, v: _Variant,
                   tile_h: int, tile_w: int, tiles_x: int,
                   sample_offset: "tuple[float, float]"):
    """One program per screen tile: walk the tile's segment in order."""
    refs = list(refs)
    initz_ref = refs.pop(0)
    bound_ref = refs.pop(0) if v.bound_compare is not None else None
    initc_ref = refs.pop(0) if v.shade_blend is not None else None
    inits_ref = refs.pop(0) if v.stencil is not None else None
    z_ref, planes_ref = refs.pop(0), refs.pop(0)
    s_ref = refs.pop(0) if v.stencil is not None else None

    ty = pl.program_id(0)
    tx = pl.program_id(1)
    tile = ty * tiles_x + tx
    start = start_ref[tile]
    count = count_ref[tile]

    col_i = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
    row_i = jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
    x = (tx * tile_w + col_i).astype(jnp.float32) + sample_offset[0]
    y = (ty * tile_h + row_i).astype(jnp.float32) + sample_offset[1]
    bound = bound_ref[:, :] if bound_ref is not None else None

    if initc_ref is not None:
        planes = tuple(initc_ref[c] for c in range(4))
    else:
        planes = tuple(
            jnp.zeros((tile_h, tile_w), jnp.float32) for _ in range(v.a_n)
        )
    sten = inits_ref[:, :] if inits_ref is not None else None

    def body(i, carry):
        e = start + i
        return _fragment(v, lambda c: rows_ref[e, c], x, y, bound, carry)

    z, sten, planes = jax.lax.fori_loop(
        0, count, body, (initz_ref[:, :], sten, planes)
    )
    z_ref[:, :] = z
    for c, p in enumerate(planes):
        planes_ref[c] = p
    if s_ref is not None:
        s_ref[:, :] = sten


def _variant(bins, depth_test, depth_write, compare_op, depth_clamp,
             stencil_front=None, stencil_back=None, z_bound=None,
             shade_blend=None) -> _Variant:
    d = bins.rows.shape[-1] - 16
    assert d % 3 == 0, f"row width {d + 16} is not 16 + 3·(A+1)"
    effective_compare = compare_op if depth_test else CompareOp.ALWAYS
    bound_compare = None
    if z_bound is not None:
        assert stencil_front is None, "depth peeling cannot combine with stencil"
        assert depth_test, "depth peeling requires the depth test"
        if compare_op in (CompareOp.GREATER, CompareOp.GREATER_OR_EQUAL):
            bound_compare = _compare_fn(CompareOp.LESS)
        elif compare_op in (CompareOp.LESS, CompareOp.LESS_OR_EQUAL):
            bound_compare = _compare_fn(CompareOp.GREATER)
        else:
            raise ValueError(
                f"depth peeling needs an ordering depth compare "
                f"(GREATER/GEQ/LESS/LEQ), got {compare_op}"
            )
    stencil = None
    if stencil_front is not None:
        stencil = (stencil_front, stencil_back or stencil_front)
    return _Variant(
        num_attrs=d // 3 - 1,
        compare=_compare_fn(effective_compare),
        depth_write=depth_write and depth_test,
        depth_clamp=depth_clamp,
        bound_compare=bound_compare,
        stencil=stencil,
        shade_blend=shade_blend,
    )


def _pad_planes(a, hp, wp):
    h, w = a.shape[-2:]
    if (hp, wp) == (h, w):
        return a
    pad = [(0, 0)] * (a.ndim - 2) + [(0, hp - h), (0, wp - w)]
    return jnp.pad(a, pad)


def _seeds(v, grid, init_z, init_color, init_stencil, z_bound):
    """Tile-padded (z, [bound], [color (4, H, W)], [stencil]) inputs."""
    hp, wp = grid.tiles_y * grid.tile_h, grid.tiles_x * grid.tile_w
    seeds = [_pad_planes(init_z.astype(jnp.float32), hp, wp)]
    if v.bound_compare is not None:
        seeds.append(_pad_planes(z_bound.astype(jnp.float32), hp, wp))
    if v.shade_blend is not None:
        c = jnp.moveaxis(init_color.astype(jnp.float32), -1, 0)
        seeds.append(_pad_planes(c, hp, wp))
    if v.stencil is not None:
        if init_stencil is None:
            init_stencil = jnp.zeros(init_z.shape, jnp.int32)
        seeds.append(_pad_planes(init_stencil.astype(jnp.int32), hp, wp))
    return seeds


def _outputs(v, grid, z, planes, sten):
    """Crop the padded outputs back to the surface, in the public order."""
    h, w = grid.height, grid.width
    z, planes = z[:h, :w], planes[:, :h, :w]
    if v.shade_blend is not None:
        planes = jnp.moveaxis(planes, 0, -1)  # (H, W, 4) color
    if v.stencil is not None:
        return z, planes, sten[:h, :w]
    return z, planes


def _raster_call(v: _Variant, bins, grid: TileGrid, seeds,
                 sample_offset, interpret):
    th, tw = grid.tile_h, grid.tile_w
    hp, wp = grid.tiles_y * th, grid.tiles_x * tw
    t = grid.num_tiles
    whole = lambda a: pl.BlockSpec(a.shape, lambda i, j: (0,) * a.ndim)
    tile2 = pl.BlockSpec((th, tw), lambda i, j: (i, j))
    tile3 = lambda n: pl.BlockSpec((n, th, tw), lambda i, j: (0, i, j))
    seed_specs = [tile2 if s.ndim == 2 else tile3(s.shape[0]) for s in seeds]
    out_specs = [tile2, tile3(v.num_planes)]
    out_shape = [
        jax.ShapeDtypeStruct((hp, wp), jnp.float32),
        jax.ShapeDtypeStruct((v.num_planes, hp, wp), jnp.float32),
    ]
    if v.stencil is not None:
        out_specs.append(tile2)
        out_shape.append(jax.ShapeDtypeStruct((hp, wp), jnp.int32))
    kernel = functools.partial(
        _raster_kernel, v=v, tile_h=th, tile_w=tw, tiles_x=grid.tiles_x,
        sample_offset=sample_offset,
    )
    assert bins.tile_start.shape == (t,), "bins were binned for another grid"
    outs = pl.pallas_call(
        kernel,
        grid=(grid.tiles_y, grid.tiles_x),
        in_specs=[whole(bins.tile_start), whole(bins.tile_count),
                  whole(bins.rows), *seed_specs],
        out_specs=out_specs,
        out_shape=out_shape,
        backend=TRITON,
        compiler_params=triton_params(num_warps=NUM_WARPS),
        interpret=interpret,
        name="zenith_raster",
    )(bins.tile_start, bins.tile_count, bins.rows, *seeds)
    return outs[0], outs[1], (outs[2] if v.stencil is not None else None)


def _raster_xla(v: _Variant, bins, grid: TileGrid, seeds, sample_offset):
    """The kernel's walk in plain lax: every tile steps through entry i of
    its segment at once, for as many steps as the busiest tile needs."""
    th, tw = grid.tile_h, grid.tile_w
    ty_n, tx_n = grid.tiles_y, grid.tiles_x
    t = grid.num_tiles

    def to_tiles(a):  # (..., hp, wp) → (T, ..., th, tw)
        lead = a.shape[:-2]
        a = a.reshape(lead + (ty_n, th, tx_n, tw))
        a = jnp.moveaxis(a, (-4, -2), (0, 1)).reshape((t,) + lead + (th, tw))
        return a

    def from_tiles(a):  # (T, ..., th, tw) → (..., hp, wp)
        lead = a.shape[1:-2]
        a = a.reshape((ty_n, tx_n) + lead + (th, tw))
        a = jnp.moveaxis(a, (0, 1), (-4, -2))
        return a.reshape(lead + (ty_n * th, tx_n * tw))

    seeds = list(seeds)
    z0 = to_tiles(seeds.pop(0))
    bound = to_tiles(seeds.pop(0)) if v.bound_compare is not None else None
    if v.shade_blend is not None:
        c0 = to_tiles(seeds.pop(0))
        planes = tuple(c0[:, c] for c in range(4))
    else:
        planes = tuple(jnp.zeros((t, th, tw), jnp.float32) for _ in range(v.a_n))
    sten = to_tiles(seeds.pop(0)) if v.stencil is not None else None

    tiles = jnp.arange(t, dtype=jnp.int32)
    ty = (tiles // tx_n)[:, None, None]
    tx = (tiles % tx_n)[:, None, None]
    x = (tx * tw + jnp.arange(tw, dtype=jnp.int32)[None, None, :]).astype(
        jnp.float32) + sample_offset[0]
    y = (ty * th + jnp.arange(th, dtype=jnp.int32)[None, :, None]).astype(
        jnp.float32) + sample_offset[1]
    x = jnp.broadcast_to(x, (t, th, tw))
    y = jnp.broadcast_to(y, (t, th, tw))
    n_rows = bins.rows.shape[0]

    def body(i, carry):
        live = (i < bins.tile_count)[:, None, None]
        rows = jnp.take(
            bins.rows, jnp.clip(bins.tile_start + i, 0, n_rows - 1), axis=0
        )
        z, s, p = _fragment(
            v, lambda c: rows[:, c][:, None, None], x, y, bound, carry
        )
        z_old, s_old, p_old = carry
        z = jnp.where(live, z, z_old)
        if s is not None:
            s = jnp.where(live, s, s_old)
        p = tuple(jnp.where(live, a, b) for a, b in zip(p, p_old))
        return z, s, p

    steps = jnp.max(bins.tile_count)
    z, sten, planes = jax.lax.fori_loop(0, steps, body, (z0, sten, planes))
    planes = jnp.stack([from_tiles(p) for p in planes])
    return from_tiles(z), planes, (from_tiles(sten) if sten is not None else None)


def raster_segmented(
    bins,  # SegmentedBins
    grid: TileGrid,
    init_z: jnp.ndarray,
    depth_test: bool = True,
    depth_write: bool = True,
    compare_op: CompareOp = CompareOp.GREATER,
    depth_clamp: bool = False,
    init_stencil: Optional[jnp.ndarray] = None,  # (H, W) i32
    stencil_front=None,  # StencilOpState when stencil test enabled
    stencil_back=None,
    sample_offset: "tuple[float, float]" = (0.5, 0.5),
    interpret: Optional[bool] = None,
    z_bound: Optional[jnp.ndarray] = None,  # (H, W) depth-peel bound plane
) -> "tuple[jnp.ndarray, jnp.ndarray] | tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]":
    """Segmented-binning raster pass → (z (H, W), acc (A+1, H, W)), plus
    the updated stencil plane when ``stencil_front`` is given.

    acc[:A] are attr·(1/w) planes and acc[A] is the interpolated 1/w —
    divide in the shading pass for perspective-correct varyings; acc[A] > 0
    is the coverage mask.

    ``z_bound`` switches on DEPTH PEELING: fragments not strictly behind
    the bound plane (the previous peel's resolved depth) are rejected, so
    the pass resolves the next-nearest layer. Requires an ordering depth
    compare (GREATER/GEQ or LESS/LEQ) with the depth test enabled; cannot
    combine with stencil. Fragments exactly AT the bound are rejected —
    coplanar equal-depth fragments collapse into one peel (the classic
    depth-peeling tie limitation)."""
    if interpret is None:
        interpret = pallas_interpret()
    v = _variant(bins, depth_test, depth_write, compare_op, depth_clamp,
                 stencil_front, stencil_back, z_bound)
    seeds = _seeds(v, grid, init_z, None, init_stencil, z_bound)
    return _outputs(v, grid, *_raster_call(v, bins, grid, seeds,
                                           sample_offset, interpret))


def raster_segmented_blend(
    bins,  # SegmentedBins
    grid: TileGrid,
    init_z: jnp.ndarray,  # (H, W)
    init_color: jnp.ndarray,  # (H, W, 4)
    shade_blend: Callable,
    depth_test: bool = True,
    depth_write: bool = False,
    compare_op: CompareOp = CompareOp.GREATER,
    depth_clamp: bool = False,
    sample_offset: "tuple[float, float]" = (0.5, 0.5),
    interpret: Optional[bool] = None,
    init_stencil: Optional[jnp.ndarray] = None,  # (H, W) i32
    stencil_front=None,  # StencilOpState when stencil test enabled
    stencil_back=None,
) -> "tuple[jnp.ndarray, jnp.ndarray] | tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]":
    """ORDER-CORRECT blending raster pass → (z (H, W), color (H, W, 4)),
    plus the updated stencil plane when ``stencil_front`` is given.

    Every covered, test-passing fragment runs the inlined fragment shader
    and blend equation against the tile's carried color, in submission
    order — the Vulkan output merger executed per fragment. This is what
    lets batched draws blend across overlapping draws in order.

    ``shade_blend(attr_planes, passed, x, y, zpx, c_planes)`` is provided
    by ops.draw: it finalizes varyings (divide by the interpolated 1/w),
    evaluates the fragment shader (KERNEL-SAFE contract: pure elementwise
    jnp — no texture sampling/gathers), applies the blend equation, and
    returns the new 4 color planes."""
    if interpret is None:
        interpret = pallas_interpret()
    v = _variant(bins, depth_test, depth_write, compare_op, depth_clamp,
                 stencil_front, stencil_back, shade_blend=shade_blend)
    seeds = _seeds(v, grid, init_z, init_color, init_stencil, None)
    return _outputs(v, grid, *_raster_call(v, bins, grid, seeds,
                                           sample_offset, interpret))


def raster_segmented_xla(
    bins,
    grid: TileGrid,
    init_z: jnp.ndarray,
    depth_test: bool = True,
    depth_write: bool = True,
    compare_op: CompareOp = CompareOp.GREATER,
    depth_clamp: bool = False,
    init_stencil: Optional[jnp.ndarray] = None,
    stencil_front=None,
    stencil_back=None,
    sample_offset: "tuple[float, float]" = (0.5, 0.5),
    z_bound: Optional[jnp.ndarray] = None,
    init_color: Optional[jnp.ndarray] = None,
    shade_blend: Optional[Callable] = None,
):
    """Plain-XLA reference for raster_segmented (and, given ``init_color``
    and ``shade_blend``, for raster_segmented_blend): same arguments, same
    outputs."""
    v = _variant(bins, depth_test, depth_write, compare_op, depth_clamp,
                 stencil_front, stencil_back, z_bound, shade_blend)
    seeds = _seeds(v, grid, init_z, init_color, init_stencil, z_bound)
    return _outputs(v, grid, *_raster_xla(v, bins, grid, seeds, sample_offset))
