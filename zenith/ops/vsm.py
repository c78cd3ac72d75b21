"""Variance shadow maps: prefilterable soft shadows.

Classic PCF sharpens with map resolution but can't be blurred (the
compare is nonlinear); VSM stores the depth DISTRIBUTION's first two
moments, which blur linearly — so a soft penumbra is just a gaussian over
the moment planes, and that blur is pure rolls (zero gathers).
The lookup stays one bilinear fetch (4 gathers, same as the 2x2 PCF) and
the visibility is Chebyshev's inequality:

    p_max = sigma² / (sigma² + (d - mu)²)       for d > mu, else 1

Light bleeding (the classic VSM artifact behind overlapping occluders) is
clamped by rescaling p_max below ``bleed_reduction`` to zero.

The moments are derived from the ordinary shadow DEPTH map inside the
lighting node per frame — no extra render pass, no extra graph resource,
and under SPMD meshes the (already gathered) full map feeds it directly.
"""

from __future__ import annotations

import jax.numpy as jnp


def depth_to_moments(depth: jnp.ndarray, taps: int = 3) -> jnp.ndarray:
    """(S, S) regular-z shadow depth → (S, S, 2) gaussian-blurred moments
    (E[z], E[z²]). ``taps`` is the blur radius per axis (binomial weights
    via repeated box passes — shifted adds only)."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    m = jnp.stack([depth, depth * depth], axis=-1)
    # Separable blur: `taps` box passes per axis ≈ gaussian of sigma
    # ~sqrt(taps/2) texels (Central Limit), all jnp.roll shifts — run on
    # an EDGE-PADDED copy and crop: raw rolls wrap circularly, smearing
    # moments from one shadow-map border onto the opposite one (the same
    # roll-wrap class of bug TAA's neighborhood clamp had).
    pad = taps + 1  # blur reach is `taps` texels; +1 keeps wrapped values
    m = jnp.pad(m, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    for axis in (0, 1):
        for _ in range(taps):
            m = (
                m
                + jnp.roll(m, 1, axis=axis)
                + jnp.roll(m, -1, axis=axis)
            ) / 3.0
    return m[pad:-pad, pad:-pad]


def sample_vsm(
    moments: jnp.ndarray,  # (S, S, 2) blurred moments
    uv: jnp.ndarray,  # (..., 2)
    ref_z: jnp.ndarray,  # (...,) receiver depth (regular z)
    min_variance: float = 2e-5,
    bleed_reduction: float = 0.4,
) -> jnp.ndarray:
    """Chebyshev visibility in [0, 1] — one bilinear moment fetch."""
    from zenith.ops.sampling import sample_2d
    from zenith.rhi.sampler import AddressMode, SamplerConfig

    samp = SamplerConfig(
        address_mode_u=AddressMode.CLAMP_TO_EDGE,
        address_mode_v=AddressMode.CLAMP_TO_EDGE,
    )
    m = sample_2d(moments, uv, samp)
    mu = m[..., 0]
    var = jnp.maximum(m[..., 1] - mu * mu, min_variance)
    d = ref_z - mu
    p_max = var / (var + d * d)
    # Light-bleeding reduction: everything below the floor is shadow.
    p_max = jnp.clip(
        (p_max - bleed_reduction) / (1.0 - bleed_reduction), 0.0, 1.0
    )
    return jnp.where(ref_z <= mu, 1.0, p_max)
