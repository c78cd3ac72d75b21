"""Screen-space contact shadows for the sun.

Shadow maps miss small-scale contact occlusion: their finite resolution
and depth bias open a light leak exactly where geometry meets the ground.
The standard fix (UE's "contact shadows", also in Unity HDRP) is a SHORT
screen-space ray march from each shaded pixel toward the light, testing
the G-buffer depth for occluders over ~1-2 world units — crisp contact
darkening that composites multiplicatively with the shadow-map factor.

Same design as the SSR march (ops/ssr.py) — one packed
(H·W, 4) world-position+depth tap plane (one 4-channel ``jnp.take`` per
step), per-pixel phase dither from the SSAO coordinate hash (elementwise,
zero gathers; the noise resolves under TAA or stays sub-visible at the
default short range), linear steps (the range is short — quadratic
spacing buys nothing). Budget: ``steps`` gathers per pixel (8 default),
well under SSAO's 12+blur.

The knobs are baked trace constants read from ``DirectionalLight``
(changing them recompiles — consistent with every other sun field).
No reference counterpart (zenith has no shadows at all).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Self-intersection guard (world units, camera-radial): the marched point
# must be this far behind the tapped surface before it counts as occluded.
_HIT_BIAS = 0.08


def contact_shadow_factor(
    world_pos: jnp.ndarray,  # (H, W, 3) this band's G-buffer positions
    depth: jnp.ndarray,  # (H, W) this band's reverse-Z depth (0 = bg)
    tap_pos: jnp.ndarray,  # (Hf, Wf, 3) FULL-surface positions (tap plane)
    tap_depth: jnp.ndarray,  # (Hf, Wf) FULL-surface depth
    sun_dir: jnp.ndarray,  # (3,) unit, TOWARD the sun
    cam_pos: jnp.ndarray,  # (3,) camera world position
    view_proj: jnp.ndarray,  # (4, 4)
    strength: float = 1.0,
    max_dist: float = 2.0,
    thickness: float = 0.6,
    steps: int = 8,
    row0=0,
) -> jnp.ndarray:
    """(H, W) visibility in [1-strength, 1]: 1 = lit, lower = contact-
    occluded. Under SPMD pass the band's planes as ``world_pos``/``depth``
    and the gathered full surface as the tap planes (``row0`` = the band's
    first global row, for the dither hash)."""
    h, w = depth.shape
    hf, wf = tap_depth.shape
    covered = depth > 0.0

    from zenith.ops.ssao import _pixel_hash_angle

    phase = _pixel_hash_angle(h, w, row0) * (0.5 / np.pi)  # [0, 1)

    from zenith.ops.screentrace import (
        pack_tap_plane,
        project_to_screen,
        tap_radial_gap,
    )

    flat_pd = pack_tap_plane(tap_pos, tap_depth)

    occluded = jnp.zeros((h, w), bool)
    for i in range(steps):
        # (i + phase)/steps spans [0, max_dist) exactly — the phase IS the
        # in-step offset (adding another 0.5 would both start late and
        # overshoot max_dist by up to half a step).
        t = max_dist * (i + phase) / steps
        q = world_pos + sun_dir * t[..., None]
        _, _, inside, idx = project_to_screen(q, view_proj, hf, wf)
        s_dep, gap = tap_radial_gap(flat_pd, idx, q, cam_pos, (h, w))
        occluded = occluded | (
            inside & (s_dep > 0.0)
            & (gap > _HIT_BIAS) & (gap < thickness)
        )

    return jnp.where(occluded & covered, 1.0 - strength, 1.0)
