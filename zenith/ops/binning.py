"""Tile binning: triangle records → per-tile candidate segments.

The software rasterizer's coarse stage (cf. Laine & Karras, "High-
Performance Software Rasterization on GPUs", HPG 2011). Every record's
screen AABB expands into (tile, record) entries; one global sort by
(tile, record order) groups them per tile while keeping submission order
inside each tile, which Vulkan's primitive-order depth-EQUAL and blending
semantics need. The raster kernel (ops.raster) then walks each tile's
segment in order, one program per tile. Overflow past the entry budget
is counted and reported, never silently ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from zenith.ops.geometry import TriangleRecords
from zenith.ops.runtime import cdiv


@dataclass(frozen=True)
class TileGrid:
    """Static tiling configuration (part of the jit cache key)."""

    width: int
    height: int
    tile_h: int = 16
    tile_w: int = 16

    @property
    def tiles_x(self) -> int:
        return cdiv(self.width, self.tile_w)

    @property
    def tiles_y(self) -> int:
        return cdiv(self.height, self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


class SegmentedBins(NamedTuple):
    """Per-tile variable-length candidate segments for the segmented
    raster kernel (no per-tile capacity cap).

    Produced by ``bin_segmented``: entries (tile, record) are sorted once
    globally by (tile, record order), the lexicographic two-key sort of a
    GPU coarse rasterizer, and the record rows are gathered in that order.
    Tile ``t`` owns rows ``[tile_start[t], tile_start[t] + tile_count[t])``;
    the raster kernel runs one program per tile over its own segment.
    """

    tile_start: jnp.ndarray  # (T,) i32 — first row of each tile's segment
    tile_count: jnp.ndarray  # (T,) i32 — rows in each tile's segment
    rows: jnp.ndarray  # (E, 16 + D) f32 — rast16 | corner data, entry order
    overflow: jnp.ndarray  # () i32 — entries dropped (budget/span caps)


def default_entry_budget(num_records: int, num_tiles: int) -> int:
    """Entries a draw of ``num_records`` may bin: 4 per record (a mesh
    triangle touches 1-3 small tiles; min 8192) plus two full-screen
    records' worth (a screen-filling quad touches every tile)."""
    return max(4 * num_records, 8192) + 2 * num_tiles


def bin_segmented(
    records: TriangleRecords,
    corner_data: jnp.ndarray,  # (R, 3·(A+1)) flat, from the geometry stage
    grid: TileGrid,
    span_cap: int = 4,
    mid_tiers: "tuple[tuple[int, int], ...]" = (
        (4096, 16), (4096, 64), (1024, 256), (256, 1024)),
    huge_cap: int = 64,
    entry_budget: "int | None" = None,
    budget_scale: int = 1,
) -> SegmentedBins:
    """Exact, uncapped-per-tile binning, in span tiers.

    - records spanning ≤ span_cap tiles (the overwhelming majority: a
      typical mesh triangle covers 1-2 tiles) emit static per-record
      entries at width span_cap;
    - for each ``(cap, width)`` of ``mid_tiers``, up to cap records whose
      span exceeds the previous tier's width and is ≤ width are COMPACTED
      before a width-wide expansion — paying wide expansion only
      for records that need it (a flat wide expansion for every record
      would make the sort input mostly padding);
    - up to huge_cap larger records (full-screen floors, skyboxes) take a
      dense per-tile mask path;
    - all tiers merge in one lexicographic (tile, record) sort, preserving
      submission order within every tile (Vulkan primitive-order semantics).

    ``entry_budget`` bounds total (tile, record) pairs per draw (default
    ``default_entry_budget``); overflow — including mid/huge tier drops —
    is counted, never silently ignored.
    """
    r = records.rast16.shape[0]
    t = grid.num_tiles
    tiles_x = grid.tiles_x
    rast16 = records.rast16
    valid = records.valid
    corner_flat = corner_data.reshape(r, -1)

    if entry_budget is None:
        # Overflow is counted — callers raise the budget when it fires (the
        # engine grows budget_scale adaptively on overflow, like a
        # pipeline-cache miss).
        entry_budget = default_entry_budget(r, t)
    entry_budget = int(entry_budget) * max(int(budget_scale), 1)

    xmin, ymin, xmax, ymax = (records.aabb[:, i] for i in range(4))
    tx0 = jnp.clip(jnp.floor(xmin / grid.tile_w), 0, grid.tiles_x - 1).astype(jnp.int32)
    tx1 = jnp.clip(jnp.floor(xmax / grid.tile_w), 0, grid.tiles_x - 1).astype(jnp.int32)
    ty0 = jnp.clip(jnp.floor(ymin / grid.tile_h), 0, grid.tiles_y - 1).astype(jnp.int32)
    ty1 = jnp.clip(jnp.floor(ymax / grid.tile_h), 0, grid.tiles_y - 1).astype(jnp.int32)
    sx = tx1 - tx0 + 1
    sy = ty1 - ty0 + 1
    span = sx * sy

    small = valid & (span <= span_cap)
    huge = valid & (span > (mid_tiers[-1][1] if mid_tiers else span_cap))

    def expand(tx0_, ty0_, sx_, span_, live, width):
        """(K, width) tile/valid expansion of per-record tile rectangles."""
        jj = jnp.arange(width, dtype=jnp.int32)[None, :]
        dy = jj // sx_[:, None]
        ty_e = ty0_[:, None] + dy
        tx_e = tx0_[:, None] + (jj - dy * sx_[:, None])
        tile_e = ty_e * tiles_x + tx_e
        ev = live[:, None] & (jj < span_[:, None])
        return tile_e, ev

    # Tier 1: every record, narrow width.
    tile_small, ev_small = expand(tx0, ty0, sx, span, small, span_cap)
    rec_small = jnp.broadcast_to(
        jnp.arange(r, dtype=jnp.int32)[:, None], (r, span_cap)
    )

    # Middle tiers: compact each tier's records (the first cap of them, in
    # record order), then expand wide.
    tiles_parts = [jnp.where(ev_small, tile_small, t).reshape(-1)]
    recs_parts = [rec_small.reshape(-1)]
    dropped = jnp.int32(0)
    lo = span_cap
    for cap, width in mid_tiers:
        tier = valid & (span > lo) & (span <= width)
        lo = width
        k = min(cap, r)
        (midx,) = jnp.nonzero(tier, size=k, fill_value=0)
        mvalid = jnp.arange(k) < tier.sum()
        dropped += jnp.maximum(tier.sum() - k, 0)
        tile_mid, ev_mid = expand(
            jnp.take(tx0, midx), jnp.take(ty0, midx), jnp.take(sx, midx),
            jnp.take(span, midx), mvalid, width,
        )
        tiles_parts.append(jnp.where(ev_mid, tile_mid, t).reshape(-1))
        recs_parts.append(jnp.broadcast_to(
            midx.astype(jnp.int32)[:, None], (k, width)).reshape(-1))

    # Huge records → dense per-tile mask over the first huge_cap of them.
    k = min(huge_cap, r)
    (hidx,) = jnp.nonzero(huge, size=k, fill_value=0)
    hvalid = jnp.arange(k) < huge.sum()
    dropped += jnp.maximum(huge.sum() - k, 0)
    t_ids = jnp.arange(t, dtype=jnp.int32)
    t_ty = t_ids // tiles_x
    t_tx = t_ids % tiles_x
    hmask = (
        hvalid[:, None]
        & (t_tx[None, :] >= jnp.take(tx0, hidx)[:, None])
        & (t_tx[None, :] <= jnp.take(tx1, hidx)[:, None])
        & (t_ty[None, :] >= jnp.take(ty0, hidx)[:, None])
        & (t_ty[None, :] <= jnp.take(ty1, hidx)[:, None])
    )  # (H, T)
    tile_huge = jnp.broadcast_to(t_ids[None, :], hmask.shape)
    rec_huge = jnp.broadcast_to(hidx[:, None].astype(jnp.int32), hmask.shape)

    # Merge + lexicographic (tile, record) sort. Invalid entries get tile = t
    # (sorts to the end; the two-key int32 sort avoids 64-bit keys).
    tiles_parts.append(jnp.where(hmask, tile_huge, t).reshape(-1))
    recs_parts.append(rec_huge.reshape(-1))
    tiles_all = jnp.concatenate(tiles_parts)
    recs_all = jnp.concatenate(recs_parts)
    tiles_sorted, recs_sorted = jax.lax.sort(
        (tiles_all, recs_all), num_keys=2
    )
    total_entries = (tiles_sorted < t).sum()

    # Per-tile segments over the first entry_budget sorted entries; entries
    # past the budget are dropped and counted. Tiles with no candidates get
    # an empty segment, and the kernel writes their init content.
    seg_off = jnp.searchsorted(tiles_sorted, jnp.arange(t + 1, dtype=jnp.int32))
    seg_off = jnp.minimum(seg_off, entry_budget).astype(jnp.int32)
    budget_overflow = jnp.maximum(total_entries - entry_budget, 0)

    # One merged (rast16 | corner-data) row per entry, so the kernel reads
    # each entry's scalars from one row.
    n_rows = max(min(entry_budget, recs_sorted.shape[0]), 1)
    merged = jnp.concatenate([rast16, corner_flat], axis=1)
    rows = jnp.take(merged, recs_sorted[:n_rows], axis=0)

    overflow = dropped + budget_overflow
    return SegmentedBins(
        seg_off[:-1],
        seg_off[1:] - seg_off[:-1],
        rows,
        overflow.astype(jnp.int32),
    )
