"""Tiled deferred point-light accumulation (Pallas, Triton route).

The dense form evaluates the full Cook-Torrance BRDF for EVERY light at
EVERY pixel (``accumulate_point_lights_dense``, a loop over L lights of
(H, W) math), yet each light's inverse-square window confines it to a small
screen region.

The kernel is the classic tiled-deferred culling pass: one program per
(TH, TW) screen tile computes the tile's world-space AABB from the G-buffer
position plane (covered pixels only), then walks the light list, guarding
each light's BRDF evaluation behind a scalar sphere-vs-AABB test. A culled
light is a uniform branch for the whole program.

Matches renderer.deferred._ggx_brdf + its distance window; the deferred
lighting node uses it for the point-light sum and keeps
sun/ambient/emissive/shadow as dense elementwise jnp.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from zenith.ops.runtime import TRITON, cdiv, pallas_interpret, triton_params


def _ggx_point_light(nx, ny, nz, vx, vy, vz, lx, ly, lz,
                     ar, ag, ab, metallic, roughness):
    """Cook-Torrance GGX for one light direction, component planes.
    Mirrors renderer.deferred._ggx_brdf (kept in lock-step by tests)."""
    hx, hy, hz = lx + vx, ly + vy, lz + vz
    hn = jax.lax.rsqrt(jnp.maximum(hx * hx + hy * hy + hz * hz, 1e-16))
    hx, hy, hz = hx * hn, hy * hn, hz * hn

    ndl = jnp.maximum(nx * lx + ny * ly + nz * lz, 0.0)
    ndv = jnp.maximum(nx * vx + ny * vy + nz * vz, 1e-4)
    ndh = jnp.maximum(nx * hx + ny * hy + nz * hz, 0.0)
    vdh = jnp.maximum(vx * hx + vy * hy + vz * hz, 0.0)

    a = jnp.maximum(roughness * roughness, 1e-3)
    a2 = a * a
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    d = a2 / jnp.maximum(np.pi * denom * denom, 1e-8)

    k = (roughness + 1.0) * (roughness + 1.0) / 8.0
    g = (ndv / (ndv * (1 - k) + k)) * (ndl / jnp.maximum(ndl * (1 - k) + k, 1e-8))

    f0r = 0.04 * (1.0 - metallic) + ar * metallic
    f0g = 0.04 * (1.0 - metallic) + ag * metallic
    f0b = 0.04 * (1.0 - metallic) + ab * metallic
    fres = jnp.power(1.0 - vdh, 5.0)
    fr = f0r + (1.0 - f0r) * fres
    fg = f0g + (1.0 - f0g) * fres
    fb = f0b + (1.0 - f0b) * fres

    spec_s = d * g / jnp.maximum(4.0 * ndv * ndl, 1e-4)
    inv_pi = 1.0 / np.pi
    out_r = ((1.0 - fr) * (1.0 - metallic) * ar * inv_pi + spec_s * fr) * ndl
    out_g = ((1.0 - fg) * (1.0 - metallic) * ag * inv_pi + spec_s * fg) * ndl
    out_b = ((1.0 - fb) * (1.0 - metallic) * ab * inv_pi + spec_s * fb) * ndl
    return out_r, out_g, out_b


def _light_contrib(lights, li, wx, wy, wz, nx, ny, nz, vx, vy, vz,
                   ar, ag, ab, metal, rough):
    """One point/spot light's (r, g, b) radiance planes. ``lights(li, c)``
    reads column c of light li's packed row."""
    px, py, pz = lights(li, 0), lights(li, 1), lights(li, 2)
    radius = lights(li, 3)
    tx, ty, tz = px - wx, py - wy, pz - wz
    d2 = jnp.maximum(tx * tx + ty * ty + tz * tz, 1e-8)
    dist = jnp.sqrt(d2)
    inv = 1.0 / dist
    lxp, lyp, lzp = tx * inv, ty * inv, tz * inv
    att = 1.0 / jnp.maximum(d2, 1e-8)
    q = dist / radius
    q2 = q * q
    win = jnp.clip(1.0 - q2 * q2, 0.0, 1.0)
    win = win * win
    br, bg, bb = _ggx_point_light(
        nx, ny, nz, vx, vy, vz, lxp, lyp, lzp, ar, ag, ab, metal, rough,
    )
    # Spot cone falloff (smooth inner→outer edge); point lights carry
    # spot = 0 → factor 1.
    cosang = -(lxp * lights(li, 8) + lyp * lights(li, 9) + lzp * lights(li, 10))
    t = jnp.clip((cosang - lights(li, 11)) * lights(li, 12), 0.0, 1.0)
    cone = 1.0 + lights(li, 7) * (t * t - 1.0)
    w = att * win * cone
    return br * lights(li, 4) * w, bg * lights(li, 5) * w, bb * lights(li, 6) * w


def _tiled_lights_kernel(
    lights_ref,  # (L, 16): px py pz radius cr cg cb spot
    #                       dx dy dz cos_outer inv_cone pad pad pad
    cam_ref,  # (8,): camera xyz, pad
    am_ref,  # (4, TH, TW) albedo+metallic
    nr_ref,  # (4, TH, TW) normal+roughness
    pe_ref,  # (4, TH, TW) world pos + emissive
    d_ref,  # (TH, TW) depth (coverage: > 0)
    out_ref,  # (4, TH, TW) rgb + pad accumulated
    *,
    num_lights: int,
):
    wx = pe_ref[0]
    wy = pe_ref[1]
    wz = pe_ref[2]
    covered = d_ref[:, :] > 0.0

    # Tile world AABB over covered pixels (background pixels would drag the
    # box to the origin and defeat the cull).
    big = 3.0e38
    wminx = jnp.min(jnp.where(covered, wx, big))
    wmaxx = jnp.max(jnp.where(covered, wx, -big))
    wminy = jnp.min(jnp.where(covered, wy, big))
    wmaxy = jnp.max(jnp.where(covered, wy, -big))
    wminz = jnp.min(jnp.where(covered, wz, big))
    wmaxz = jnp.max(jnp.where(covered, wz, -big))
    any_cov = jnp.max(covered.astype(jnp.int32)) > 0

    nx, ny, nz = nr_ref[0], nr_ref[1], nr_ref[2]
    rough = nr_ref[3]
    ar, ag, ab = am_ref[0], am_ref[1], am_ref[2]
    metal = am_ref[3]

    vx, vy, vz = cam_ref[0] - wx, cam_ref[1] - wy, cam_ref[2] - wz
    vn = jax.lax.rsqrt(jnp.maximum(vx * vx + vy * vy + vz * vz, 1e-16))
    vx, vy, vz = vx * vn, vy * vn, vz * vn
    lights = lambda li, c: lights_ref[li, c]

    def one_light(li, acc):
        px, py, pz = lights(li, 0), lights(li, 1), lights(li, 2)
        radius = lights(li, 3)
        # Scalar sphere-vs-AABB: squared distance from the light to the box.
        ddx = jnp.maximum(jnp.maximum(wminx - px, px - wmaxx), 0.0)
        ddy = jnp.maximum(jnp.maximum(wminy - py, py - wmaxy), 0.0)
        ddz = jnp.maximum(jnp.maximum(wminz - pz, pz - wmaxz), 0.0)
        hit = (ddx * ddx + ddy * ddy + ddz * ddz <= radius * radius) & any_cov

        def add(acc):
            r, g, b = _light_contrib(
                lights, li, wx, wy, wz, nx, ny, nz, vx, vy, vz,
                ar, ag, ab, metal, rough,
            )
            return acc[0] + r, acc[1] + g, acc[2] + b

        return jax.lax.cond(hit, add, lambda acc: acc, acc)

    zero = jnp.zeros(wx.shape, jnp.float32)
    r, g, b = jax.lax.fori_loop(0, num_lights, one_light, (zero, zero, zero))
    # Uncovered pixels carry undefined G-buffer data — mask them.
    out_ref[0] = jnp.where(covered, r, 0.0)
    out_ref[1] = jnp.where(covered, g, 0.0)
    out_ref[2] = jnp.where(covered, b, 0.0)
    out_ref[3] = zero


def _pack_lights(light_pos, light_color, light_radius, spot_params):
    """(L, 16) rows: px py pz radius cr cg cb spot dx dy dz cos_outer
    inv_cone pad pad pad. ``spot_params`` rows are (dir3, cos_inner,
    cos_outer); a zero direction marks a point light."""
    l = light_pos.shape[0]
    if spot_params is None:
        is_spot = jnp.zeros((l, 1), jnp.float32)
        spot_cols = jnp.zeros((l, 8), jnp.float32)
    else:
        sp = spot_params.astype(jnp.float32)
        d = sp[:, :3]
        is_spot = (jnp.linalg.norm(d, axis=1) > 1e-6).astype(jnp.float32)[:, None]
        cos_inner = sp[:, 3:4]
        cos_outer = sp[:, 4:5]
        inv_cone = 1.0 / jnp.maximum(cos_inner - cos_outer, 1e-4)
        spot_cols = jnp.concatenate(
            [d, cos_outer, inv_cone, jnp.zeros((l, 3), jnp.float32)], axis=1
        )
    return jnp.concatenate(
        [
            light_pos.astype(jnp.float32),
            light_radius.astype(jnp.float32)[:, None],
            light_color.astype(jnp.float32),
            is_spot,
            spot_cols,
        ],
        axis=1,
    )


def accumulate_point_lights(
    albedo_metal: jnp.ndarray,  # (H, W, 4)
    normal_rough: jnp.ndarray,  # (H, W, 4)
    pos_emissive: jnp.ndarray,  # (H, W, 4)
    depth: jnp.ndarray,  # (H, W) coverage: > 0
    camera_pos: jnp.ndarray,  # (3,)
    light_pos: jnp.ndarray,  # (L, 3)
    light_color: jnp.ndarray,  # (L, 3)
    light_radius: jnp.ndarray,  # (L,)
    tile_h: int = 16,
    tile_w: int = 16,
    interpret: Optional[bool] = None,
    spot_params: "Optional[jnp.ndarray]" = None,  # (L, 5): dir3 ci co
) -> jnp.ndarray:
    """Tile-culled point/spot-light sum → (H, W, 3) linear radiance.

    ``spot_params`` rows are (dir_x, dir_y, dir_z, cos_inner, cos_outer)
    per light; a row of zeros (or cos_inner <= cos_outer <= -1) marks a
    point light. Spots reuse the point path (position, radius window,
    inverse-square) times a smooth cone-edge factor."""
    if interpret is None:
        interpret = pallas_interpret()
    h, w = depth.shape
    l = light_pos.shape[0]
    if l == 0:
        return jnp.zeros((h, w, 3), jnp.float32)
    lights = _pack_lights(light_pos, light_color, light_radius, spot_params)
    cam = jnp.zeros((8,), jnp.float32).at[:3].set(camera_pos.astype(jnp.float32))

    hp = cdiv(h, tile_h) * tile_h
    wp = cdiv(w, tile_w) * tile_w

    def to_planes(img4):
        p = jnp.moveaxis(img4.astype(jnp.float32), -1, 0)  # (4, H, W)
        if (hp, wp) != (h, w):
            p = jnp.pad(p, ((0, 0), (0, hp - h), (0, wp - w)))
        return p

    am = to_planes(albedo_metal)
    nr = to_planes(normal_rough)
    pe = to_planes(pos_emissive)
    dz = depth.astype(jnp.float32)
    if (hp, wp) != (h, w):
        dz = jnp.pad(dz, ((0, hp - h), (0, wp - w)))

    planes = pl.BlockSpec((4, tile_h, tile_w), lambda ty, tx: (0, ty, tx))
    out = pl.pallas_call(
        functools.partial(_tiled_lights_kernel, num_lights=l),
        grid=(hp // tile_h, wp // tile_w),
        in_specs=[
            pl.BlockSpec((l, 16), lambda ty, tx: (0, 0)),
            pl.BlockSpec((8,), lambda ty, tx: (0,)),
            planes,
            planes,
            planes,
            pl.BlockSpec((tile_h, tile_w), lambda ty, tx: (ty, tx)),
        ],
        out_specs=planes,
        out_shape=jax.ShapeDtypeStruct((4, hp, wp), jnp.float32),
        backend=TRITON,
        compiler_params=triton_params(num_warps=4),
        interpret=interpret,
        name="zenith_tiled_lights",
    )(lights, cam, am, nr, pe, dz)
    out = out[:3, :h, :w]
    return jnp.moveaxis(out, 0, -1)


def accumulate_point_lights_dense(
    albedo_metal, normal_rough, pos_emissive, depth, camera_pos,
    light_pos, light_color, light_radius, spot_params=None,
) -> jnp.ndarray:
    """The same sum in plain XLA: every light at every pixel, no culling —
    the reference for the kernel and its timing opponent."""
    l = light_pos.shape[0]
    h, w = depth.shape
    if l == 0:
        return jnp.zeros((h, w, 3), jnp.float32)
    lights = _pack_lights(light_pos, light_color, light_radius, spot_params)
    wx, wy, wz = (pos_emissive[..., i].astype(jnp.float32) for i in range(3))
    nx, ny, nz, rough = (normal_rough[..., i] for i in range(4))
    ar, ag, ab, metal = (albedo_metal[..., i] for i in range(4))
    cam = camera_pos.astype(jnp.float32)
    vx, vy, vz = cam[0] - wx, cam[1] - wy, cam[2] - wz
    vn = jax.lax.rsqrt(jnp.maximum(vx * vx + vy * vy + vz * vz, 1e-16))
    vx, vy, vz = vx * vn, vy * vn, vz * vn

    def one_light(li, acc):
        r, g, b = _light_contrib(
            lambda i, c: lights[i, c], li, wx, wy, wz, nx, ny, nz,
            vx, vy, vz, ar, ag, ab, metal, rough,
        )
        # Outside the radius the window is exactly 0, as in the kernel's cull.
        return acc[0] + r, acc[1] + g, acc[2] + b

    zero = jnp.zeros((h, w), jnp.float32)
    r, g, b = jax.lax.fori_loop(0, l, one_light, (zero, zero, zero))
    out = jnp.stack([r, g, b], axis=-1)
    return jnp.where((depth > 0.0)[..., None], out, 0.0)
