"""Deferred decals — projected surface details (bullet holes, stains,
painted markings) applied to the G-buffer between the geometry and
lighting passes.

The classic GPU implementation rasterizes a box per decal and samples the
depth buffer to reconstruct the receiving surface. Under XLA the G-buffer
already holds dense world positions, so a decal is pure elementwise math
over planes — exactly what XLA fuses for free when fused into the
frame program:

    local  = world_to_decal(world_pos)        # one 3x4 transform
    inside = all(|local| <= 0.5)              # unit-box clip
    fade   = clamp(dot(n, -proj_dir)/t, 0, 1) # reject steep surfaces
    albedo = mix(albedo, decal_rgb, a*fade*inside)

No geometry, no extra rasterization, no stencil volume tricks: one fused
lambda node ("decals") reads g.pos + g.normal and rewrites g.albedo
before the lighting resolve, so decals receive full PBR lighting and
shadows like any other surface detail. The reference renderer has no
decal system (zenith-renderer only ships TriangleRenderer) — this is
engine-parity breadth on top of the deferred pipeline.

Decal transforms ride per-frame dynamics (a stacked (D, 3, 4) array), so
moving/animating a decal never recompiles the frame program; adding or
removing one changes trace structure and recompiles, like draw-list
changes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax.numpy as jnp
import numpy as np


@dataclass
class Decal:
    """One projected decal box.

    ``forward`` is the projection direction (INTO the receiving surface —
    the default (0, 0, -1) projects down onto z-up ground); ``up`` picks
    the V axis of the decal image. ``size`` = (width, height, depth) full
    extents in world units: width along U, height along V, depth along
    the projection axis (how far above/below the surface the decal
    reaches). ``texture`` is an RGBA Texture whose alpha masks the blend;
    without one the decal is a solid ``color`` with a soft rounded-box
    falloff. ``color`` multiplies the texture (alpha scales opacity).
    ``normal_fade`` is the cos-angle threshold below which surfaces facing
    away from the projection stop receiving the decal (0 disables).
    """

    name: str
    position: "tuple" = (0.0, 0.0, 0.0)
    size: "tuple" = (4.0, 4.0, 2.0)
    forward: "tuple" = (0.0, 0.0, -1.0)
    up: "tuple" = (0.0, 1.0, 0.0)
    texture: "Optional[object]" = None  # rhi Texture (RGBA)
    color: "tuple" = (1.0, 1.0, 1.0, 1.0)
    normal_fade: float = 0.35

    def world_to_decal(self) -> np.ndarray:
        """(3, 4) matrix mapping world points into normalized decal-local
        coords: the unit box [-0.5, 0.5]^3 covers the decal volume."""
        f = np.asarray(self.forward, np.float64)
        f = f / max(np.linalg.norm(f), 1e-12)
        u = np.asarray(self.up, np.float64)
        u = u - f * float(u @ f)
        n = np.linalg.norm(u)
        if n < 1e-6:  # up ∥ forward: pick any perpendicular
            u = np.array([1.0, 0.0, 0.0]) if abs(f[0]) < 0.9 \
                else np.array([0.0, 1.0, 0.0])
            u = u - f * float(u @ f)
            n = np.linalg.norm(u)
        u = u / n
        # Camera-style frame looking along the projection: U (image right)
        # = forward × up, so the default down-projection with up=+y reads
        # U=+x, V=+y.
        r = np.cross(f, u)
        rot = np.stack([r, u, f])  # rows = decal axes
        scale = 1.0 / np.maximum(np.asarray(self.size, np.float64), 1e-12)
        m = rot * scale[:, None]
        t = -m @ np.asarray(self.position, np.float64)
        return np.concatenate([m, t[:, None]], axis=1).astype(np.float32)


def stacked_decal_mats(decals: "list[Decal]") -> np.ndarray:
    """(D, 3, 4) world→decal transforms — the per-frame dynamic."""
    return np.stack([d.world_to_decal() for d in decals])


def stacked_decal_colors(decals: "list[Decal]") -> np.ndarray:
    """(D, 4) tint colors — per-frame dynamic (alpha = opacity)."""
    return np.stack([np.asarray(d.color, np.float32) for d in decals])


def apply_decal(albedo_rgb, world_pos, normal, mat, color, tex,
                normal_fade: float):
    """Blend ONE decal into the albedo plane (all inputs dense (H, W, C)
    except ``mat`` (3, 4), ``color`` (4,), ``tex`` an (H, W, 4) texture
    array / mip tuple or None). Pure elementwise + one texture sample."""
    hom = jnp.concatenate(
        [world_pos, jnp.ones_like(world_pos[..., :1])], axis=-1
    )
    local = hom @ mat.T  # (H, W, 3) in the unit box when inside
    inside = jnp.all(jnp.abs(local) <= 0.5, axis=-1)

    if tex is not None:
        from zenith.ops.sampling import sample_texture
        from zenith.rhi.sampler import SamplerConfig

        uv = jnp.stack(
            [local[..., 0] + 0.5, 0.5 - local[..., 1]], axis=-1
        )
        # Clamp: outside pixels still flow through the sampler (dense
        # plane) but their contribution is masked by `inside`.
        uv = jnp.clip(uv, 0.0, 1.0)
        texel = sample_texture(tex, uv, SamplerConfig.linear())
        rgb = texel[..., :3] * color[:3]
        a = texel[..., 3] * color[3]
    else:
        # Procedural solid decal: soft rounded-box falloff so untextured
        # decals don't land as hard-edged rectangles.
        edge = 1.0 - jnp.max(jnp.abs(local[..., :2]) * 2.0, axis=-1)
        rgb = jnp.broadcast_to(color[:3], albedo_rgb.shape)
        a = jnp.clip(edge * 4.0, 0.0, 1.0) * color[3]

    if normal_fade > 0.0:
        # mat row 2 = forward axis scaled by 1/depth; renormalize to get
        # the projection direction without carrying a second uniform.
        fwd = mat[2, :3] / jnp.maximum(
            jnp.linalg.norm(mat[2, :3]), 1e-12
        )
        align = jnp.sum(normal * (-fwd), axis=-1)
        a = a * jnp.clip(align / normal_fade, 0.0, 1.0)

    a = jnp.where(inside, a, 0.0)[..., None]
    return albedo_rgb * (1.0 - a) + rgb * a
