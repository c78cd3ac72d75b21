"""Volumetric sun scattering: height fog + shadow-marched light shafts.

The reference has no volumetrics (its only renderer is the triangle
demo); this is the single-scattering post stage every production
deferred pipeline carries:

- ONE mechanism for both effects: march K steps from the camera toward
  each pixel's surface (or ``max_dist`` for sky pixels), accumulating
  Beer-Lambert transmittance through an exponential HEIGHT-fog density
  and in-scattering the sun where the SHADOW MAP says the step point is
  lit — occluded segments produce the dark bands that read as god rays.
- Gather budget: K nearest shadow-map fetches per pixel (no PCF — fog
  integration is its own low-pass filter) and ZERO screen-plane gathers:
  everything else is elementwise on the G-buffer, so under SPMD meshes
  only the (small) shadow map is gathered full; the screen math stays
  on the local band. Steps are phase-dithered per pixel with the SSAO
  coordinate hash; TAA resolves the dither.
- Henyey-Greenstein phase (anisotropy ``g``) brightens shafts toward
  the sun; an isotropic ambient in-scatter term keeps shadowed fog from
  going pitch black.

All tuning rides one packed (8,) dynamic — density/height/anisotropy
are live-tweakable with zero recompiles.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def volumetric_sun(
    hdr: jnp.ndarray,  # (H, W, 4) lit scene color
    world_pos: jnp.ndarray,  # (H, W, 3) G-buffer world positions
    depth: jnp.ndarray,  # (H, W) reverse-Z depth (0 = background)
    cam_pos: jnp.ndarray,  # (3,) camera world position
    view_dirs: jnp.ndarray,  # (H, W, 3) per-pixel UNIT view ray (cam → pixel)
    sun_dir: jnp.ndarray,  # (3,) unit direction TOWARD the sun
    sun_color: jnp.ndarray,  # (3,) sun radiance
    params: jnp.ndarray,  # (8,) see _pack_params
    shadow_map: "jnp.ndarray | None" = None,  # (Hs, Ws) reverse-Z light depth
    light_vp: "jnp.ndarray | None" = None,  # (4, 4) sun view-projection
    shadow_bias: "jnp.ndarray | float" = 0.0,
    steps: int = 16,
    jitter: bool = True,
    row0: "jnp.ndarray | int" = 0,  # global first row (SPMD band offset)
) -> jnp.ndarray:
    """One volumetric resolve. Returns (H, W, 4); alpha passes through.

    Without a shadow map (or sun), visibility is 1 everywhere — pure
    analytic height fog, zero gathers.
    """
    h, w = depth.shape
    rgb = hdr[..., :3]
    density = params[0]
    h0 = params[1]
    inv_hfall = 1.0 / jnp.maximum(params[2], 1e-3)
    g = jnp.clip(params[3], -0.95, 0.95)
    max_dist = jnp.maximum(params[4], 1e-3)
    sun_boost = params[5]
    ambient = params[6]

    covered = depth > 0.0
    surf_d = jnp.linalg.norm(world_pos - cam_pos, axis=-1)
    t_end = jnp.where(covered, jnp.minimum(surf_d, max_dist), max_dist)

    if jitter:
        from zenith.ops.ssao import _pixel_hash_angle

        phase = _pixel_hash_angle(h, w, row0) * (0.5 / np.pi)  # [0, 1)
    else:
        phase = jnp.full((h, w), 0.5, jnp.float32)

    # Henyey-Greenstein toward the sun (4π folded into sun_boost).
    cos_t = jnp.sum(view_dirs * sun_dir, axis=-1)
    g2 = g * g
    hg = (1.0 - g2) / jnp.maximum(
        (1.0 + g2 - 2.0 * g * cos_t) ** 1.5, 1e-4
    )

    if shadow_map is not None and light_vp is not None:
        hs, ws = shadow_map.shape
        flat_sm = shadow_map.reshape(-1)

    dt = t_end / steps  # (H, W) per-pixel step length
    trans = jnp.ones((h, w), jnp.float32)
    inscatter = jnp.zeros((h, w, 3), jnp.float32)
    for k in range(steps):
        t = (k + phase) * dt
        q = cam_pos + view_dirs * t[..., None]
        rho = density * jnp.exp(
            -jnp.maximum(q[..., 2] - h0, 0.0) * inv_hfall
        )
        if shadow_map is not None and light_vp is not None:
            clip = (
                jnp.concatenate([q, jnp.ones_like(q[..., :1])], axis=-1)
                @ light_vp.T
            )
            cw = jnp.maximum(clip[..., 3], 1e-6)
            u = clip[..., 0] / cw * 0.5 + 0.5
            v = clip[..., 1] / cw * 0.5 + 0.5
            inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
            ix = jnp.clip((u * ws).astype(jnp.int32), 0, ws - 1)
            iy = jnp.clip((v * hs).astype(jnp.int32), 0, hs - 1)
            d = jnp.take(flat_sm, (iy * ws + ix).reshape(-1), axis=0).reshape(
                h, w
            )
            lit = jnp.where(
                inside, (clip[..., 2] - shadow_bias >= d), True
            ).astype(jnp.float32)
        else:
            lit = 1.0
        a = rho * dt  # optical depth of this segment
        seg_t = jnp.exp(-a)
        # Energy-conserving segment in-scatter: (1 − e^{−ρΔt}) of the
        # segment's incident light scatters toward the eye.
        scat = (1.0 - seg_t) * trans
        inscatter = inscatter + scat[..., None] * (
            (lit * hg * sun_boost)[..., None] * sun_color
            + ambient * sun_color
        )
        trans = trans * seg_t

    out_rgb = rgb * trans[..., None] + inscatter
    return jnp.concatenate([out_rgb, hdr[..., 3:4]], axis=-1)
