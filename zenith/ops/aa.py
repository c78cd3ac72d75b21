"""Post-process anti-aliasing (FXAA-class), gather-free.

The deferred pipeline can't MSAA its G-buffer economically (every plane
would multiply by the sample count), so like every production deferred
renderer it wants a post AA step on the tonemapped LDR image. Classic
FXAA samples along the per-pixel edge direction at fractional offsets —
per-pixel bilinear GATHERS, the one primitive this framework keeps off
the frame path (PERF.md: XLA duplicates gathers across fusions).

This is the gather-free reformulation: the edge direction is QUANTIZED to the
four roll-reachable axes (horizontal, vertical, two diagonals), so every
tap is a `jnp.roll` — pure shifted adds that XLA fuses into the
surrounding elementwise work. Per pixel:

1. luma contrast gate (absolute + relative threshold, like FXAA),
2. gradient from the 4-neighborhood → edge direction bin,
3. blend toward the two neighbors ALONG the edge (perpendicular to the
   gradient) — this is what smooths shallow/curved edges, and it is
   exactly neutral on perfectly straight edges (their along-edge
   neighbors equal the center, so straight edges are not blurred),
4. FXAA's SUBPIXEL term: a lowpass blend toward the 4-neighborhood
   average weighted by |lumaAvg − lumaCenter|² / range² — this is what
   softens staircase corners (including 45° stairs, where the
   directional term is neutral by symmetry).

Cost: ~12 rolls + elementwise — fully fusable, zero gathers.
"""

from __future__ import annotations

import jax.numpy as jnp

_LUMA = (0.299, 0.587, 0.114)  # FXAA's perceptual luma weights


def post_aa(
    rgb: jnp.ndarray,  # (H, W, C>=3) tonemapped LDR, linear values in [0,1]
    threshold: float = 0.0625,
    rel_threshold: float = 0.125,
    strength: float = 1.0,
) -> jnp.ndarray:
    """Anti-alias the LDR image; returns the same shape (alpha untouched)."""
    c = rgb[..., :3]
    l = (
        c[..., 0] * _LUMA[0] + c[..., 1] * _LUMA[1] + c[..., 2] * _LUMA[2]
    )

    def sh(img, dy, dx):
        out = img
        if dy:
            out = jnp.roll(out, dy, axis=0)
        if dx:
            out = jnp.roll(out, dx, axis=1)
        return out

    l_up, l_dn = sh(l, 1, 0), sh(l, -1, 0)
    l_lf, l_rt = sh(l, 0, 1), sh(l, 0, -1)
    lmin = jnp.minimum(jnp.minimum(jnp.minimum(l_up, l_dn),
                                   jnp.minimum(l_lf, l_rt)), l)
    lmax = jnp.maximum(jnp.maximum(jnp.maximum(l_up, l_dn),
                                   jnp.maximum(l_lf, l_rt)), l)
    rng = lmax - lmin
    active = rng >= jnp.maximum(threshold, rel_threshold * lmax)

    # Gradient of luma; the edge runs perpendicular to it.
    gx = l_rt - l_lf
    gy = l_dn - l_up
    ax, ay = jnp.abs(gx), jnp.abs(gy)
    # Direction bins: gradient mostly vertical → horizontal edge → blend
    # left/right; mostly horizontal → blend up/down; else the diagonal
    # whose orientation sign(gx·gy) selects.
    horiz_edge = ay >= 2.0 * ax
    vert_edge = ax >= 2.0 * ay
    diag_main = gx * gy > 0  # gradient along +x+y → edge along +x-y

    c_up, c_dn = sh(c, 1, 0), sh(c, -1, 0)
    c_lf, c_rt = sh(c, 0, 1), sh(c, 0, -1)
    c_ul, c_dr = sh(c, 1, 1), sh(c, -1, -1)
    c_ur, c_dl = sh(c, 1, -1), sh(c, -1, 1)

    along_h = 0.5 * (c_lf + c_rt)
    along_v = 0.5 * (c_up + c_dn)
    # Edge along +x-y ⇒ neighbors are up-right and down-left.
    along_d1 = 0.5 * (c_ur + c_dl)
    along_d2 = 0.5 * (c_ul + c_dr)

    he = horiz_edge[..., None]
    ve = vert_edge[..., None]
    dm = diag_main[..., None]
    along = jnp.where(
        he, along_h,
        jnp.where(ve, along_v, jnp.where(dm, along_d1, along_d2)),
    )

    # Directional term: fixed modest pull toward the along-edge mean
    # (neutral on straight edges by construction).
    d = 0.25 * strength
    directional = c * (1.0 - d) + along * d

    # Subpixel term: how far the center departs from its 4-neighborhood
    # average, relative to the local range — squared, like FXAA's
    # subpixel quality curve.
    l_avg = 0.25 * (l_up + l_dn + l_lf + l_rt)
    lowpass = 0.25 * (c_up + c_dn + c_lf + c_rt)
    subpix = jnp.clip(jnp.abs(l_avg - l) / jnp.maximum(rng, 1e-6), 0.0, 1.0)
    s = (strength * 0.75 * subpix * subpix)[..., None]

    smoothed = directional * (1.0 - s) + lowpass * s
    out = jnp.where(active[..., None], smoothed, c)
    if rgb.shape[-1] > 3:
        return jnp.concatenate([out, rgb[..., 3:]], axis=-1)
    return out
