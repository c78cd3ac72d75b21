"""Sort-first SPMD rendering: framebuffer row bands over a device mesh.

Each device in a 1-D mesh axis ("rows") owns an H/n-row band of the
framebuffer. Inside shard_map, the device derives its band origin from
``jax.lax.axis_index`` and rasterizes with a shifted viewport
(ops.geometry.setup_triangles(viewport=...)); vertex transform + triangle
setup are replicated — they are a tiny fraction of frame cost — and binning
naturally drops triangles outside the band. No collectives are needed during
rendering; the sharded framebuffer can stay sharded (sharded host readback)
or be gathered for presentation.

This is the renderer analog of data parallelism over the spatial dimension
(the "sp" of an ML stack); a future sort-last path (triangles sharded,
z-buffers merged with pmax-style depth compositing) would be the "tp" analog.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from zenith.ops.binning import TileGrid
from zenith.ops.draw import draw_indexed
from zenith.ops import blend as blend_ops
from zenith.rhi.pipeline import GraphicPipeline


def default_mesh(n_devices: Optional[int] = None, axis: str = "rows",
                 backend: Optional[str] = None) -> Mesh:
    devices = jax.devices(backend) if backend else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis,))


def row_sharding(mesh: Mesh, axis: str = "rows") -> NamedSharding:
    """Sharding for (H, W, C) framebuffers: rows split across the mesh."""
    return NamedSharding(mesh, P(axis))


def make_sort_last_frame(
    mesh: Mesh,
    pipeline: GraphicPipeline,
    width: int,
    height: int,
    clear_color: "tuple" = (0.0, 0.0, 0.0, 1.0),
    depth_clear: float = 0.0,
    tile_h: int = 8,
    tile_w: int = 128,
    axis: str = "rows",
    interpret: "Optional[bool]" = None,
) -> Callable[..., Any]:
    """Sort-LAST SPMD rendering: TRIANGLES sharded across the mesh, each
    device rasterizing its subset at full resolution, composited by a
    depth-winner reduction — the complement of the sort-first row-band path
    (SURVEY §2.9/§5.7: this is the "tp" axis next to row-banding's "sp").

    Compositing: all_gather the per-device (z, color) planes and take the
    depth-argmax per pixel. Triangles shard CONTIGUOUSLY, so equal-z ties
    resolve toward the lowest device rank = earliest submission — the same
    first-wins rule the GREATER depth compare gives sequential draws.
    Requires an opaque pipeline (depth test+write GREATER; no blending):
    depth compositing cannot reproduce order-dependent blends.

    Returns ``step(vertex_buffer, index_buffer, resources) -> (color, depth)``
    with full (H, W, …) results replicated on every device. The index
    buffer's triangle count must divide by the mesh size.
    """
    n = mesh.shape[axis]
    grid = TileGrid(width=width, height=height, tile_h=tile_h, tile_w=tile_w)
    ds = pipeline.desc.state.depth_stencil
    assert ds.depth_test_enable and ds.depth_write_enable, (
        "sort-last compositing needs depth test+write (opaque geometry)"
    )
    for desc in pipeline.desc.color_attachment_descs or ():
        assert not desc.blend_enable, (
            "sort-last compositing cannot reproduce order-dependent blending"
        )

    def shard_body(vb, ib, resources):
        # ib arrives as this device's contiguous (T/n, 3) triangle slice.
        colors = [blend_ops.clear_color(height, width, clear_color)]
        depth = blend_ops.clear_depth(height, width, depth_clear)
        colors, depth, _stats = draw_indexed(
            colors, depth, pipeline, vb, ib, resources, grid,
            interpret=interpret,
        )
        return composite_depth(colors[0], depth, axis)

    sharded = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(axis), P()),  # triangles sharded; rest replicated
        out_specs=(P(), P()),  # composited planes replicated
        check_vma=False,
    )
    return jax.jit(sharded)


def composite_depth_all_gather(color, depth, axis_name: str):
    """Reference (non-scalable) depth compositor: all_gather every device's
    full-resolution (z, color) planes and take the depth-argmax —
    O(n·H·W) interconnect traffic per device. Kept as the oracle the binary-swap
    compositor is tested bit-equal against."""
    z_all = jax.lax.all_gather(depth, axis_name)  # (n, H, W)
    c_all = jax.lax.all_gather(color, axis_name)  # (n, H, W, 4)
    winner = jnp.argmax(z_all, axis=0)  # first max → earliest device
    z_out = jnp.max(z_all, axis=0)
    c_out = jnp.take_along_axis(c_all, winner[None, ..., None], axis=0)[0]
    return c_out, z_out


def composite_depth(color, depth, axis_name: str):
    """Scalable sort-last depth compositing: BINARY SWAP (recursive
    halving) + tiled reassembly.

    log2(n) rounds; in round k every device pairs with ``rank ^ d``
    (d = n/2, n/4, …, 1), keeps the half of its current region selected by
    that rank bit, sends the other half to its partner (one ppermute of
    (rows/2, W) planes), and depth-composites what it receives. After the
    rounds device r holds the fully-composited rows of piece r, and one
    tiled all_gather reassembles the frame. Per-device traffic:
    Σ_k H·W/2^k ≈ 2·H·W plus the H·W gather — O(H·W), vs the all_gather
    reference's O(n·H·W).

    Tie-breaking matches the reference compositor exactly: on equal z the
    LOWER device rank wins (triangles shard contiguously, so that is
    earliest-submission — the first-wins rule of sequential GREATER
    draws). The lexicographic (z, -rank) max is associative, so the
    pairwise tournament is exact, not approximate. Requires n a power of
    two and H divisible by n; other configurations fall back to the
    all_gather reference.
    """
    n = jax.lax.axis_size(axis_name)
    h = depth.shape[0]
    if n == 1:
        return color, depth
    if n & (n - 1) != 0 or h % n != 0:
        return composite_depth_all_gather(color, depth, axis_name)

    rank = jax.lax.axis_index(axis_name)
    z = depth
    c = color
    # Origin-rank plane: pairwise "lower-rank-side wins ties" is NOT
    # associative once a value from a higher rank survives a round on a
    # lower-rank device — the lexicographic (z, -origin_rank) max IS, so
    # each fragment carries the rank that produced it.
    rk = jnp.full(z.shape, rank, jnp.int32)
    d = n // 2
    while d >= 1:
        half = z.shape[0] // 2
        bit0 = (rank & d) == 0  # traced scalar bool: am I the lower rank?
        # Lower rank keeps the TOP half, sends the bottom (and vice versa).
        z_send = jnp.where(bit0, z[half:], z[:half])
        c_send = jnp.where(bit0, c[half:], c[:half])
        r_send = jnp.where(bit0, rk[half:], rk[:half])
        perm = [(i, i ^ d) for i in range(n)]
        z_recv = jax.lax.ppermute(z_send, axis_name, perm)
        c_recv = jax.lax.ppermute(c_send, axis_name, perm)
        r_recv = jax.lax.ppermute(r_send, axis_name, perm)
        z_mine = jnp.where(bit0, z[:half], z[half:])
        c_mine = jnp.where(bit0, c[:half], c[half:])
        r_mine = jnp.where(bit0, rk[:half], rk[half:])
        take_recv = (z_recv > z_mine) | ((z_recv == z_mine) & (r_recv < r_mine))
        z = jnp.where(take_recv, z_recv, z_mine)
        c = jnp.where(take_recv[..., None], c_recv, c_mine)
        rk = jnp.where(take_recv, r_recv, r_mine)
        d //= 2
    # Device r now holds piece r (rank bits MSB→LSB selected top/bottom):
    # a tiled gather reassembles rows in order.
    z_out = jax.lax.all_gather(z, axis_name, axis=0, tiled=True)
    c_out = jax.lax.all_gather(c, axis_name, axis=0, tiled=True)
    return c_out, z_out


# Background value of the submission-order plane: larger than any draw
# sequence number, so undrawn pixels lose every tie against drawn ones and
# resolve among themselves to the (identical) loaded contents of rank 0.
ORDER_BACKGROUND = _np_int32_max = 2**31 - 1


def composite_depth_planes(
    planes: "list",
    depth,
    order,
    axis_name: str,
    band_output: bool = False,
):
    """Binary-swap sort-last compositing of N attachment planes sharing ONE
    depth plane — the engine-graph generalization of ``composite_depth``.

    Per pixel the winner is the device with max z; equal z resolves to the
    lowest ``order`` (a per-pixel int32 submission-order plane the draw
    context stamps per draw call — lower = earlier, ``ORDER_BACKGROUND``
    for undrawn pixels), and equal (z, order) to the lowest device rank
    (contiguous triangle shards make that earliest-submission — the
    first-wins rule of sequential GREATER draws). The lexicographic
    (z, -order, -rank) max is associative, so the pairwise binary-swap
    tournament is exact.

    With ``band_output`` each device keeps its contiguous row piece r —
    exactly the row-band layout of the graph's sort-first path, so the
    result feeds banded downstream nodes with ZERO extra reassembly
    traffic. Otherwise full surfaces are all_gathered on every device.
    Non-power-of-two meshes or heights that don't divide fall back to an
    all_gather composite (same winner rule).
    """
    n = jax.lax.axis_size(axis_name)
    h = depth.shape[0]
    rank = jax.lax.axis_index(axis_name)
    if n == 1:
        return planes, depth, order
    if n & (n - 1) != 0 or h % n != 0:
        # all_gather fallback: same lexicographic winner, O(n·H·W) traffic.
        z_all = jax.lax.all_gather(depth, axis_name)  # (n, H, W)
        o_all = jax.lax.all_gather(order, axis_name)  # (n, H, W)
        # Winner rank per pixel: lexicographic (z desc, order asc, rank asc)
        # — scan ranks in order, keeping the incumbent on ties.
        z_w, o_w, r_w = z_all[0], o_all[0], jnp.zeros(z_all[0].shape, jnp.int32)
        for r in range(1, n):
            take = (z_all[r] > z_w) | ((z_all[r] == z_w) & (o_all[r] < o_w))
            z_w = jnp.where(take, z_all[r], z_w)
            o_w = jnp.where(take, o_all[r], o_w)
            r_w = jnp.where(take, jnp.int32(r), r_w)
        out_planes = []
        for p in planes:
            p_all = jax.lax.all_gather(p, axis_name)
            sel = r_w.reshape(r_w.shape + (1,) * (p_all.ndim - 1 - r_w.ndim))
            out_planes.append(
                jnp.take_along_axis(p_all, sel[None], axis=0)[0]
            )
        if band_output:
            piece = h // n if h % n == 0 else None
            if piece is None:
                return out_planes, z_w, o_w  # can't band: keep replicated
            s = rank * piece
            out_planes = [
                jax.lax.dynamic_slice_in_dim(p, s, piece, 0)
                for p in out_planes
            ]
            z_w = jax.lax.dynamic_slice_in_dim(z_w, s, piece, 0)
            o_w = jax.lax.dynamic_slice_in_dim(o_w, s, piece, 0)
        return out_planes, z_w, o_w

    z, o = depth, order
    ps = list(planes)
    rk = jnp.full(z.shape, rank, jnp.int32)
    d = n // 2
    while d >= 1:
        half = z.shape[0] // 2
        bit0 = (rank & d) == 0  # traced scalar bool: am I the lower rank?
        perm = [(i, i ^ d) for i in range(n)]

        def swap_half(a):
            send = jnp.where(bit0, a[half:], a[:half])
            mine = jnp.where(bit0, a[:half], a[half:])
            return jax.lax.ppermute(send, axis_name, perm), mine

        z_recv, z_mine = swap_half(z)
        o_recv, o_mine = swap_half(o)
        r_recv, r_mine = swap_half(rk)
        take = (z_recv > z_mine) | (
            (z_recv == z_mine)
            & ((o_recv < o_mine) | ((o_recv == o_mine) & (r_recv < r_mine)))
        )
        z = jnp.where(take, z_recv, z_mine)
        o = jnp.where(take, o_recv, o_mine)
        rk = jnp.where(take, r_recv, r_mine)
        new_ps = []
        for p in ps:
            p_recv, p_mine = swap_half(p)
            t = take.reshape(take.shape + (1,) * (p.ndim - take.ndim))
            new_ps.append(jnp.where(t, p_recv, p_mine))
        ps = new_ps
        d //= 2
    if band_output:
        # Device r holds contiguous piece r (rank bits MSB→LSB selected
        # top/bottom each round) — already the row-band layout.
        return ps, z, o
    ps = [jax.lax.all_gather(p, axis_name, axis=0, tiled=True) for p in ps]
    z = jax.lax.all_gather(z, axis_name, axis=0, tiled=True)
    o = jax.lax.all_gather(o, axis_name, axis=0, tiled=True)
    return ps, z, o


def make_row_sharded_frame(
    mesh: Mesh,
    pipeline: GraphicPipeline,
    width: int,
    height: int,
    clear_color: "tuple" = (0.0, 0.0, 0.0, 1.0),
    depth_clear: float = 0.0,
    use_depth: bool = True,
    tile_h: int = 8,
    tile_w: int = 128,
    bin_capacity: int = 64,
    axis: str = "rows",
    interpret: "Optional[bool]" = None,
) -> Callable[..., Any]:
    """Build a jitted multi-chip frame step.

    Returns ``step(vertex_buffer, index_buffer, resources) -> (color, depth)``
    where color is (H, W, 4) sharded in row bands over ``mesh[axis]`` and
    depth is (H, W) likewise (or None). H must divide by the mesh size ×
    tile_h.
    """
    n = mesh.shape[axis]
    assert height % n == 0, f"height {height} must divide across {n} devices"
    shard_h = height // n
    assert shard_h % tile_h == 0, (
        f"shard height {shard_h} must be a multiple of tile_h {tile_h}"
    )
    grid = TileGrid(width=width, height=shard_h, tile_h=tile_h, tile_w=tile_w)

    def shard_body(vb, ib, resources):
        row = jax.lax.axis_index(axis)
        y0 = row * shard_h
        colors = [blend_ops.clear_color(shard_h, width, clear_color)]
        depth = blend_ops.clear_depth(shard_h, width, depth_clear) if use_depth else None
        colors, depth, _stats = draw_indexed(
            colors,
            depth,
            pipeline,
            vb,
            ib,
            resources,
            grid,
            bin_capacity=bin_capacity,
            interpret=interpret,
            viewport=(0, y0, width, height),
        )
        if use_depth:
            return colors[0], depth
        return colors[0], jnp.zeros((shard_h, width), jnp.float32)

    sharded = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P()),  # geometry + resources replicated
        out_specs=(P(axis), P(axis)),  # framebuffer row bands
        check_vma=False,
    )
    return jax.jit(sharded)


def halo_exchange_rows(band: "jnp.ndarray", axis_name: str, halo: int):
    """Ring halo exchange over row bands: returns ``band`` extended with
    ``halo`` rows from the neighbor above and below (wrapping at the ends —
    matching the periodic semantics of jnp.roll-based filters, so a banded
    filter reproduces the single-device result bit-for-bit).

    Communication: two ppermute rings of (halo, W, C) each — the minimal
    traffic for a cross-band stencil (vs all_gathering the full surface).
    """
    n = jax.lax.axis_size(axis_name)
    if n == 1:
        return band
    tail = band[-halo:]  # rows this device must send DOWN (to i+1)
    head = band[:halo]  # rows this device must send UP (to i-1)
    perm_down = [(i, (i + 1) % n) for i in range(n)]
    perm_up = [(i, (i - 1) % n) for i in range(n)]
    upper = jax.lax.ppermute(tail, axis_name, perm_down)  # from i-1's tail
    lower = jax.lax.ppermute(head, axis_name, perm_up)  # from i+1's head
    return jnp.concatenate([upper, band, lower], axis=0)
