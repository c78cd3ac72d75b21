"""Texture atlas: N per-draw textures → ONE texture + per-draw UV transforms.

The scalable per-draw-texture path for batched draws (multi-draw). A GPU
binds a descriptor per draw; batching N draws into one rasterization pass
here means every fragment must resolve its draw's texture. Sampling each
texture densely and selecting by draw id is O(N·H·W) (the round-2 design —
fine at 2 textures, collapses at tens). Packing into an atlas makes it
O(H·W): fragments sample ONCE at ``uv' = offset[draw] + uv·scale[draw]``,
with the (N, 4) transform table riding the existing per-draw-uniform
where-chain (4 floats, not a texture sample).

Trade-offs (vs a GPU 2D-array texture, texture.rs:107-114): a per-pixel
layer index into an (N, H, W, C) array lowers to a per-pixel gather, while
the atlas is a plain 2D sample. In-atlas REPEAT wrapping is not available (UVs outside
[0, 1] clamp into the cell); CLAMP_TO_EDGE semantics are preserved by the
half-texel inset plus GUTTER texels: each input sits inset in its pow2
cell with its edges replicated outward, so mip-level-``k`` bilinear taps
stay inside the input's own (replicated) content while the gutter is
>= ``0.5 * 2^k`` level-0 texels wide. By default the gutter uses only the
slack already present in the pow2 cell (zero memory cost; inputs that
exactly fill their cell keep the level-0-only half-texel guarantee);
pass ``gutter=G`` to grow cells for a guaranteed G-texel ring. LOD is
clamped to the atlas mip count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from zenith.rhi.formats import Format
from zenith.rhi.resource import Texture, TextureDesc, TextureUsage


@dataclass
class TextureAtlas:
    """A packed atlas + per-input UV transforms.

    ``transforms[i] = (su, sv, ou, ov)``: an input-space uv maps to atlas
    space as ``uv_atlas = (ou + u·su, ov + v·sv)``.
    """

    texture: Texture
    transforms: np.ndarray  # (N, 4) float32

    def transform(self, i: int) -> np.ndarray:
        return self.transforms[i]


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def build_atlas(
    name: str,
    textures: "Sequence[Optional[Texture]]",
    fallback: "Tuple[float, ...]" = (1.0, 1.0, 1.0, 1.0),
    mip_levels: "Optional[int]" = None,
    gutter: "Optional[int]" = None,
) -> TextureAtlas:
    """Pack ``textures`` into a uniform pow2 grid atlas.

    - ``None`` entries become a 1×1 ``fallback``-colored cell (the bindless
      white-texture trick: mixed textured/plain draw batches share one
      pipeline and one binding).
    - Inputs smaller than the cell are edge-replicated to fill it, so
    bilinear taps near the input's edge read replicated texels (CLAMP
    semantics), and mips of the padded cell stay self-contained.
    - Each input is placed inset by a GUTTER ring of edge-replicated
      texels, so bilinear taps at coarse mips read the input's own clamped
      content instead of the neighbor cell (protected through level
      ``log2(2·g + 1)``). ``gutter=None`` (default) spends only the slack
      the pow2 cell already has (up to 8 texels, zero memory growth);
      ``gutter=G`` sizes cells for a guaranteed G-texel ring on every
      input.
    - ``mip_levels=None`` auto-picks: full chain down to 4×4 cells.

    Returns device-resident linear float data (inputs are already linear
    float on device — Texture.from_numpy decoded them at upload).
    """
    import jax.numpy as jnp

    n = len(textures)
    assert n >= 1, "atlas needs at least one slot"
    max_w = max((t.desc.width if t else 1) for t in textures)
    max_h = max((t.desc.height if t else 1) for t in textures)
    if gutter is None:
        cell_w, cell_h = _next_pow2(max_w), _next_pow2(max_h)
        g_target = 8
    else:
        assert gutter >= 0
        cell_w = _next_pow2(max_w + 2 * gutter)
        cell_h = _next_pow2(max_h + 2 * gutter)
        g_target = gutter
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    aw, ah = cols * cell_w, rows * cell_h
    channels = 4

    sheet = np.zeros((ah, aw, channels), np.float32)
    transforms = np.zeros((n, 4), np.float32)
    for i, tex in enumerate(textures):
        r, c = divmod(i, cols)
        y0, x0 = r * cell_h, c * cell_w
        if tex is None:
            cell = np.broadcast_to(
                np.asarray(fallback, np.float32)[:channels], (1, 1, channels)
            )
            w_i = h_i = 1
        else:
            # host_linear(), NOT np.asarray(tex.array): no device readback
            # before the first frame (see main_loop's readback policy).
            cell = np.asarray(tex.host_linear(), np.float32)
            if cell.ndim == 2:
                cell = cell[..., None]
            if cell.shape[-1] < channels:
                pad = np.ones(cell.shape[:-1] + (channels - cell.shape[-1],),
                              np.float32)
                cell = np.concatenate([cell, pad], axis=-1)
            h_i, w_i = cell.shape[0], cell.shape[1]
        # Place the input inset by the gutter (what the cell's slack
        # allows, up to g_target) and edge-replicate on all four sides.
        g_x = min(g_target, (cell_w - w_i) // 2)
        g_y = min(g_target, (cell_h - h_i) // 2)
        padded = np.pad(
            cell,
            ((g_y, cell_h - h_i - g_y), (g_x, cell_w - w_i - g_x), (0, 0)),
            mode="edge",
        )
        sheet[y0:y0 + cell_h, x0:x0 + cell_w] = padded
        # Half-texel inset keeps bilinear taps inside the input's texels
        # (CLAMP_TO_EDGE semantics; no cross-cell bleeding at level 0);
        # the gutter ring extends the guarantee to coarse mips.
        transforms[i] = (
            max(w_i - 1, 1) / aw,
            max(h_i - 1, 1) / ah,
            (x0 + g_x + 0.5) / aw,
            (y0 + g_y + 0.5) / ah,
        )

    if mip_levels is None:
        mip_levels = max(1, min(cell_w, cell_h).bit_length() - 2)
    mips = [jnp.asarray(sheet)]
    cur = sheet
    for _ in range(mip_levels - 1):
        h, w = cur.shape[0] // 2, cur.shape[1] // 2
        if h < 1 or w < 1:
            break
        cur = cur[: h * 2, : w * 2].reshape(h, 2, w, 2, channels).mean(
            axis=(1, 3)
        )
        mips.append(jnp.asarray(cur))

    desc = TextureDesc(
        name, aw, ah, Format.RGBA32F, TextureUsage.SAMPLED,
        mip_levels=len(mips),
    )
    texture = Texture(desc, mips[0], mips=mips if len(mips) > 1 else None)
    return TextureAtlas(texture=texture, transforms=transforms)
