"""Screen-space ambient occlusion over the deferred G-buffer.

The reference has no AO (its only renderer is the triangle demo); this is
the standard deferred-pipeline companion, designed gather-lean:

- The occlusion integrand is the Alchemy-AO estimator (McGuire et al.):
  for a neighbor surface point q seen from pixel surface x with normal n,
  occlusion ∝ max(0, (q−x)·n − β|q−x|) / (|q−x|² + ε). It needs exactly
  the two planes the G-buffer already has (world position + normal) — no
  depth linearization, no reconstruction chain, robust falloff built in.
- Taps sample the WORLD-POSITION plane with ONE nearest-texel gather per
  tap (not a 4-tap bilinear): SSAO noise is blurred away anyway.
- The per-pixel kernel rotation is a hash of the integer pixel coords
  (pure elementwise math) rather than the classic tiled noise TEXTURE —
  removes a gather per tap.
- The blur is separable and roll-based (shifted adds, zero gathers, like
  the bloom chain), made edge-aware by a hard depth-difference gate so AO
  cannot bleed across silhouettes.

Pipeline: ``ssao_occlusion`` (K taps) → ``ssao_blur`` → the lighting
resolve multiplies its AMBIENT terms (flat ambient or IBL diffuse +
specular) by the AO factor. Direct sun/point light is deliberately not
occluded — SSAO approximates ambient visibility; shadow maps handle
direct-light visibility.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def hemisphere_kernel(samples: int, seed: int = 11) -> np.ndarray:
    """(K, 3) tangent-space sample offsets in the +Z hemisphere, scaled to
    cluster toward the origin (closer occluders matter more)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(samples, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.12  # keep off the tangent plane
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    # Accelerating radius: sample i sits at lerp(0.1, 1, (i/K)^2).
    t = (np.arange(samples) + 0.5) / samples
    scale = 0.1 + 0.9 * t * t
    return (v * scale[:, None]).astype(np.float32)


def _pixel_hash_bits(h: int, w: int, row0=0, seed=None) -> jnp.ndarray:
    """(H, W) uint32 integer-coordinate hash, low 16 bits uniform — THE
    shared screen-space dither source (SSAO/SSR/contact/volumetric marches,
    film grain). ``row0`` offsets to GLOBAL rows so SPMD bands hash
    identically to single-chip; ``seed`` (traced ok) remixes per frame."""
    ys = (jnp.asarray(row0, jnp.uint32) + jnp.arange(h, dtype=jnp.uint32))[:, None]
    xs = jnp.arange(w, dtype=jnp.uint32)[None, :]
    n = ys * jnp.uint32(374761393) + xs * jnp.uint32(668265263)
    if seed is not None:
        n = n + jnp.asarray(seed, jnp.uint32) * jnp.uint32(2654435761)
    n = (n ^ (n >> jnp.uint32(13))) * jnp.uint32(1274126177)
    n = n ^ (n >> jnp.uint32(16))
    return n & jnp.uint32(0xFFFF)


def _pixel_hash_angle(h: int, w: int, row0=0) -> jnp.ndarray:
    """(H, W) per-pixel rotation angle from the coordinate hash
    (elementwise — replaces the classic 4x4 noise texture)."""
    return _pixel_hash_bits(h, w, row0).astype(jnp.float32) * (
        2.0 * np.pi / 65536.0
    )


def ssao_occlusion(
    world_pos: jnp.ndarray,  # (H, W, 3) G-buffer world positions
    normal: jnp.ndarray,  # (H, W, 3) world normals (unit)
    depth: jnp.ndarray,  # (H, W) reverse-Z depth (0 = background)
    view_proj: jnp.ndarray,  # (4, 4) camera view-projection
    kernel: np.ndarray,  # (K, 3) hemisphere_kernel output
    radius: float = 4.0,
    bias: float = 0.04,
    intensity: float = 1.0,
    tap_pos: "jnp.ndarray | None" = None,  # full-surface planes for taps
    tap_depth: "jnp.ndarray | None" = None,  # (SPMD: center = local band,
    row0: "jnp.ndarray | int" = 0,  # taps = get_full; row0 = band offset)
) -> jnp.ndarray:
    """Raw (noisy) AO factor in [0, 1] — 1 = fully open. Background pixels
    (depth == 0) stay 1. ``radius``/``bias`` are world-space.

    Under an SPMD mesh the center planes are the device's row band while
    taps land anywhere on screen: pass the gathered full surfaces as
    ``tap_pos``/``tap_depth`` and the band's global first row as ``row0``
    (the renderer wires this from the node's shard context)."""
    if tap_pos is None:
        tap_pos = world_pos
    if tap_depth is None:
        tap_depth = depth
    h, w = depth.shape
    full_h = tap_depth.shape[0]
    n = normal
    # Per-pixel tangent frame, rotated by the coordinate hash.
    ang = _pixel_hash_angle(h, w, row0)
    helper = jnp.where(
        jnp.abs(n[..., 2:3]) < 0.95,
        jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
        jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
    )
    t = jnp.cross(helper, n)
    t = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-8)
    b = jnp.cross(n, t)
    ca, sa = jnp.cos(ang)[..., None], jnp.sin(ang)[..., None]
    t_r = t * ca + b * sa
    b_r = -t * sa + b * ca

    flat_pos = tap_pos.reshape(-1, 3)
    flat_depth = tap_depth.reshape(-1)
    eps = 0.01 * radius * radius
    occ = jnp.zeros((h, w), jnp.float32)
    valid = jnp.zeros((h, w), jnp.float32)
    for k in range(kernel.shape[0]):
        off = (
            t_r * kernel[k, 0] + b_r * kernel[k, 1] + n * kernel[k, 2]
        ) * radius
        p = world_pos + off
        # Project the hemisphere point to place the tap on screen.
        clip = (
            jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)
            @ view_proj.T
        )
        cw = jnp.maximum(clip[..., 3], 1e-6)
        sx = (clip[..., 0] / cw * 0.5 + 0.5) * w
        sy = (clip[..., 1] / cw * 0.5 + 0.5) * full_h  # GLOBAL screen row
        ix = jnp.clip(sx.astype(jnp.int32), 0, w - 1)
        iy = jnp.clip(sy.astype(jnp.int32), 0, full_h - 1)
        onscreen = (
            (sx >= 0) & (sx < w) & (sy >= 0) & (sy < full_h)
            & (clip[..., 3] > 0)
        )
        # ONE nearest-texel gather per tap (see module docstring).
        tap = jnp.take(flat_pos, (iy * w + ix).reshape(-1), axis=0).reshape(
            h, w, 3
        )
        tdep = jnp.take(
            flat_depth, (iy * w + ix).reshape(-1), axis=0
        ).reshape(h, w)
        covered = tdep > 0.0
        # Alchemy estimator on the actual surface point under the tap.
        v = tap - world_pos
        vv = jnp.sum(v * v, axis=-1)
        vn = jnp.sum(v * n, axis=-1)
        contrib = jnp.maximum(vn - bias, 0.0) / (vv + eps)
        # The estimator has unit 1/length; normalize by the kernel radius
        # so ``intensity`` is dimensionless across scenes.
        contrib = contrib * radius
        occ = occ + jnp.where(onscreen & covered, contrib, 0.0)
        valid = valid + jnp.where(onscreen, 1.0, 0.0)
    ao = 1.0 - intensity * occ / jnp.maximum(valid, 1.0)
    ao = jnp.clip(ao, 0.0, 1.0)
    return jnp.where(depth > 0.0, ao, 1.0)


def ssao_blur(
    ao: jnp.ndarray,  # (H, W)
    depth: jnp.ndarray,  # (H, W) reverse-Z (edge guide)
    taps: int = 4,
    depth_tol: float = 5e-4,
) -> jnp.ndarray:
    """Separable depth-gated blur — shifted adds only (no gathers). A
    neighbor contributes only when its reverse-Z depth is within
    ``depth_tol`` of the center (AO must not bleed across silhouettes)."""

    def pass_axis(x, axis):
        acc = x
        wacc = jnp.ones_like(x)
        for d in range(1, taps + 1):
            for s in (-d, d):
                nd = jnp.roll(depth, s, axis=axis)
                na = jnp.roll(x, s, axis=axis)
                wgt = jnp.where(jnp.abs(nd - depth) < depth_tol, 1.0, 0.0)
                acc = acc + na * wgt
                wacc = wacc + wgt
        return acc / wacc

    return pass_axis(pass_axis(ao, axis=1), axis=0)
