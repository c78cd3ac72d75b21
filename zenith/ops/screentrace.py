"""Shared screen-space ray-march primitives (SSR + contact shadows).

Both marches step a world-space ray, project each step point through the
camera view-projection, and compare camera-radial distances against ONE
packed (H·W, 4) world-position+depth tap plane — one 4-channel
``jnp.take`` per step instead of separate position and depth fetches
(one gather per step). Centralized here
so the projection convention (pixel-center −0.5 offset, the ``cw > 1e-4``
behind-camera guard) and the radial-gap compare stay in lockstep between
ops/ssr.py and ops/contact.py.

No reference counterpart: zenith has no screen-space passes at all (its
only renderer is the triangle demo, zenith-renderer/src/triangle.rs).
"""

from __future__ import annotations

import jax.numpy as jnp


def pack_tap_plane(pos: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
    """(Hf, Wf, 3) world positions ++ (Hf, Wf) depth → (Hf·Wf, 4)."""
    return jnp.concatenate([pos, depth[..., None]], axis=-1).reshape(-1, 4)


def project_to_screen(q: jnp.ndarray, view_proj: jnp.ndarray,
                      h: int, w: int):
    """World points (..., 3) → pixel-center float coords, validity, and
    the nearest flat tap index into an (h, w) surface.

    Returns ``(sx, sy, inside, idx)``: ``inside`` is False behind the
    camera (clip w ≤ 1e-4) or outside the viewport; ``idx`` is clamped
    so gathers stay in range even for invalid lanes (dense SIMD — the
    caller masks with ``inside``)."""
    clip = (
        jnp.concatenate([q, jnp.ones_like(q[..., :1])], axis=-1)
        @ view_proj.T
    )
    cw = clip[..., 3]
    ok = cw > 1e-4
    cwc = jnp.maximum(cw, 1e-4)
    sx = (clip[..., 0] / cwc * 0.5 + 0.5) * w - 0.5
    sy = (clip[..., 1] / cwc * 0.5 + 0.5) * h - 0.5
    inside = ok & (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    ix = jnp.clip(jnp.floor(sx + 0.5).astype(jnp.int32), 0, w - 1)
    iy = jnp.clip(jnp.floor(sy + 0.5).astype(jnp.int32), 0, h - 1)
    return sx, sy, inside, (iy * w + ix).reshape(-1)


def tap_radial_gap(flat_pd: jnp.ndarray, idx: jnp.ndarray,
                   q: jnp.ndarray, cam_pos: jnp.ndarray,
                   shape: "tuple[int, int]"):
    """Nearest tap of the packed plane: returns ``(s_dep, gap)`` where
    ``gap`` is how far (camera-radially, world units) the ray point ``q``
    sits BEHIND the tapped visible surface — positive = occluded side."""
    h, w = shape
    tap = jnp.take(flat_pd, idx, axis=0).reshape(h, w, 4)
    s_pos, s_dep = tap[..., :3], tap[..., 3]
    dq = jnp.linalg.norm(q - cam_pos, axis=-1)
    ds = jnp.linalg.norm(s_pos - cam_pos, axis=-1)
    return s_dep, dq - ds
