"""Screen-space reflections over the deferred G-buffer.

The reference has no SSR (its only renderer is the triangle demo); this
is the standard deferred-pipeline companion to SSAO/IBL, designed
around a small gather budget:

- The ray march samples a SINGLE pre-packed (H·W, 4) world-position +
  depth plane: one 4-channel ``jnp.take`` per step instead of separate
  position and depth fetches. World-space hit testing (compare radial
  camera distances of the ray point and the tapped surface point) avoids
  any depth linearization of the reverse-Z buffer — the G-buffer already
  holds exact world positions, so use them.
- Steps are QUADRATICALLY spaced (fine near the surface, coarse far) and
  phase-dithered per pixel with the SSAO coordinate hash (elementwise,
  zero gathers) — banding from the coarse march trades for noise that
  TAA resolves, the standard trick.
- A short bisection refinement (``refine`` iterations, one gather each)
  sharpens the hit point: march precision costs gathers linearly, but
  bisection buys 2^refine effective precision for refine gathers.
- The hit color is one bilinear HDR fetch; one nearest normal fetch
  gates hits on back-facing surfaces (a ray cannot "hit" geometry seen
  from behind — rejects silhouette leaks).
- Total gather budget per pixel: steps + refine + 4 (bilinear color)
  + 1 (normal) — 21 at the 12/4 defaults, comparable to SSAO's 12-tap
  kernel + blur.

Mirror-ish reflections only: glossy SSR would need a filtered color
pyramid (roughness → mip). Instead, roughness FADES the effect out by
``max_roughness`` and the IBL/sky specular underneath remains — so rough
surfaces keep their prefiltered environment response and smooth surfaces
gain true screen-space detail on top. Misses (ray leaves the screen, or
exits the march without intersecting) contribute nothing, again leaving
the environment term — the standard SSR fallback chain.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Fixed trace-time constants (a change recompiles — they are quality
# knobs, not per-frame values): world-space hit bias rejecting
# self-intersection at the ray origin, and the screen-edge fade band as
# a fraction of the viewport.
_HIT_BIAS = 0.05
_EDGE_BAND = 0.08


def ssr_reflect(
    hdr: jnp.ndarray,  # (H, W, 4) lit scene color (pre-TAA)
    albedo_metal: jnp.ndarray,  # (H, W, 4) G-buffer albedo + metallic
    normal_rough: jnp.ndarray,  # (H, W, 4) G-buffer normal + roughness
    world_pos: jnp.ndarray,  # (H, W, 3) G-buffer world positions
    depth: jnp.ndarray,  # (H, W) reverse-Z depth (0 = background)
    cam_pos: jnp.ndarray,  # (3,) camera world position
    view_proj: jnp.ndarray,  # (4, 4) camera view-projection
    params: jnp.ndarray,  # (4,): strength, max_distance, thickness, max_rough
    steps: int = 12,
    refine: int = 4,
    jitter: bool = True,
) -> jnp.ndarray:
    """One SSR resolve: reflect → march → refine → fetch → Fresnel-weighted
    add. Returns (H, W, 4); alpha passes through.

    All fetch surfaces are the FULL screen (under SPMD the renderer node
    passes gathered full planes and slices the band from the result —
    reflections land anywhere on screen, the motion-blur/TAA pattern).
    """
    h, w = depth.shape
    rgb = hdr[..., :3]
    strength = params[0]
    max_dist = jnp.maximum(params[1], 1e-3)
    thickness = jnp.maximum(params[2], 1e-3)
    max_rough = jnp.maximum(params[3], 1e-3)

    albedo = albedo_metal[..., :3]
    metallic = albedo_metal[..., 3:4]
    n = normal_rough[..., :3]
    roughness = normal_rough[..., 3:4]
    covered = depth > 0.0

    to_cam = cam_pos - world_pos
    v = to_cam / jnp.maximum(
        jnp.linalg.norm(to_cam, axis=-1, keepdims=True), 1e-8
    )
    ndv = jnp.maximum(jnp.sum(n * v, axis=-1, keepdims=True), 1e-4)
    r = 2.0 * ndv * n - v  # unit: mirror of the view vector about n

    # Roughness gate decides up front whether any marching output is
    # used; pixels past the cutoff still compute (dense SIMD — no
    # divergence to save), their weight is zero.
    rough_fade = jnp.clip(1.0 - roughness[..., 0] / max_rough, 0.0, 1.0)

    if jitter:
        from zenith.ops.ssao import _pixel_hash_angle

        phase = _pixel_hash_angle(h, w) * (0.5 / np.pi)  # [0, 1)
    else:
        phase = jnp.full((h, w), 0.5, jnp.float32)

    # One packed tap plane: (H·W, 4) = world position ++ depth.
    from zenith.ops.screentrace import (
        pack_tap_plane,
        project_to_screen,
        tap_radial_gap,
    )

    flat_pd = pack_tap_plane(world_pos, depth)
    flat_rgb = rgb.reshape(-1, 3)
    flat_n = n.reshape(-1, 3)

    def project(q):
        """World point → (sx, sy pixel-center coords, inside, tap index)."""
        return project_to_screen(q, view_proj, h, w)

    def march_state(q):
        """Gathered surface comparison at the ray point ``q``: whether
        the ray is behind visible geometry there, and by how much."""
        sx, sy, inside, idx = project(q)
        s_dep, gap = tap_radial_gap(flat_pd, idx, q, cam_pos, (h, w))
        behind = inside & (s_dep > 0.0) & (gap > _HIT_BIAS)
        return behind, gap, (sx, sy, inside)

    # -- coarse march: first step whose ray point falls behind geometry
    # within ``thickness`` becomes the hit bracket [t_lo, t_hi].
    found = jnp.zeros((h, w), bool)
    t_lo = jnp.zeros((h, w), jnp.float32)
    t_hi = jnp.zeros((h, w), jnp.float32)
    prev_t = jnp.zeros((h, w), jnp.float32)
    for i in range(steps):
        t = max_dist * ((i + phase) / steps) ** 2
        behind, gap, _ = march_state(world_pos + r * t[..., None])
        hit = behind & (gap < thickness)
        new = hit & (~found)
        t_lo = jnp.where(new, prev_t, t_lo)
        t_hi = jnp.where(new, t, t_hi)
        found = found | hit
        prev_t = t

    # -- bisection refinement inside the bracket (no thickness test: the
    # bracket already straddles the surface, refine only the crossing).
    for _ in range(refine):
        tm = 0.5 * (t_lo + t_hi)
        behind, _, _ = march_state(world_pos + r * tm[..., None])
        t_hi = jnp.where(behind, tm, t_hi)
        t_lo = jnp.where(behind, t_lo, tm)

    # -- final fetch at the refined hit.
    q = world_pos + r * t_hi[..., None]
    sx, sy, inside, idx_near = project(q)
    n_hit = jnp.take(flat_n, idx_near, axis=0).reshape(h, w, 3)
    facing = jnp.sum(n_hit * r, axis=-1) < 0.0  # hit surface faces the ray

    x0 = jnp.clip(jnp.floor(sx).astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(jnp.floor(sy).astype(jnp.int32), 0, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    fx = jnp.clip(sx - x0.astype(jnp.float32), 0.0, 1.0)[..., None]
    fy = jnp.clip(sy - y0.astype(jnp.float32), 0.0, 1.0)[..., None]

    def fetch(iy, ix):
        return jnp.take(flat_rgb, (iy * w + ix).reshape(-1), axis=0).reshape(
            h, w, 3
        )

    c00, c01 = fetch(y0, x0), fetch(y0, x1)
    c10, c11 = fetch(y1, x0), fetch(y1, x1)
    refl = (
        (c00 * (1 - fx) + c01 * fx) * (1 - fy)
        + (c10 * (1 - fx) + c11 * fx) * fy
    )

    # -- weights: Fresnel (Schlick over the surface's own F0) times the
    # scalar fade chain (hit validity, roughness, screen edge, march
    # distance).
    f0 = 0.04 * (1.0 - metallic) + albedo * metallic
    fresnel = f0 + (1.0 - f0) * (1.0 - ndv) ** 5

    u = (sx + 0.5) / w
    vv = (sy + 0.5) / h
    edge = (
        jnp.clip(jnp.minimum(u, 1.0 - u) / _EDGE_BAND, 0.0, 1.0)
        * jnp.clip(jnp.minimum(vv, 1.0 - vv) / _EDGE_BAND, 0.0, 1.0)
    )
    dist_fade = jnp.clip(1.0 - t_hi / max_dist, 0.0, 1.0)
    weight = (
        jnp.where(found & inside & facing & covered, 1.0, 0.0)
        * rough_fade
        * edge
        * dist_fade
        * strength
    )[..., None]

    out_rgb = rgb + refl * fresnel * weight
    return jnp.concatenate([out_rgb, hdr[..., 3:4]], axis=-1)
