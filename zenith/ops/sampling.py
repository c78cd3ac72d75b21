"""Texture sampling — the sampler hardware of the Vulkan pipeline.

Dense gather-based sampling over per-pixel UV images, interpreting
SamplerConfig (zenith.rhi.sampler). Vulkan texel conventions:
unnormalized coords x = u*W - 0.5; bilinear weights from the fractional
part; wrap applied per-tap on texel indices.

Mipmapping uses a packed pyramid (all levels flattened into one texel array
with per-level offsets) so per-pixel LOD selection is a pair of gathers, and
screen-space derivatives come from neighbor differences over the dense UV
image — the same quad-derivative trick GPUs use, available here because
fragment shading is a dense pass.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from zenith.rhi.sampler import AddressMode, Filter, MipmapMode, SamplerConfig


def _wrap_indices(i: jnp.ndarray, n: int, mode: AddressMode) -> "tuple[jnp.ndarray, jnp.ndarray]":
    """Wrap integer texel indices; returns (indices, in_bounds_mask)."""
    if mode == AddressMode.REPEAT:
        return jnp.mod(i, n), jnp.ones(i.shape, dtype=bool)
    if mode == AddressMode.MIRRORED_REPEAT:
        period = 2 * n
        m = jnp.mod(i, period)
        m = jnp.where(m >= n, period - 1 - m, m)
        return m, jnp.ones(i.shape, dtype=bool)
    if mode == AddressMode.CLAMP_TO_EDGE:
        return jnp.clip(i, 0, n - 1), jnp.ones(i.shape, dtype=bool)
    # CLAMP_TO_BORDER
    ok = (i >= 0) & (i < n)
    return jnp.clip(i, 0, n - 1), ok


def _fetch(tex: jnp.ndarray, ix: jnp.ndarray, iy: jnp.ndarray,
           sampler: SamplerConfig) -> jnp.ndarray:
    """Gather texels at integer coords with wrap + border handling.
    tex: (H, W, C); ix/iy: (...,) int32 → (..., C)."""
    h, w = tex.shape[0], tex.shape[1]
    jx, okx = _wrap_indices(ix, w, sampler.address_mode_u)
    jy, oky = _wrap_indices(iy, h, sampler.address_mode_v)
    flat = (jy * w + jx).reshape(-1)
    texels = jnp.take(tex.reshape(h * w, -1), flat, axis=0)
    texels = texels.reshape(ix.shape + (tex.shape[-1],))
    ok = (okx & oky)[..., None]
    border = jnp.asarray(sampler.border_color.value[: tex.shape[-1]], jnp.float32)
    return jnp.where(ok, texels, border)


def sample_2d(
    tex: jnp.ndarray,  # (H, W, C) linear float
    uv: jnp.ndarray,  # (..., 2)
    sampler: SamplerConfig = SamplerConfig(),
) -> jnp.ndarray:
    """Single-level sample (mag-filter path). Returns (..., C)."""
    h, w = tex.shape[0], tex.shape[1]
    u = uv[..., 0] * w
    v = uv[..., 1] * h
    if sampler.mag_filter == Filter.NEAREST:
        ix = jnp.floor(u).astype(jnp.int32)
        iy = jnp.floor(v).astype(jnp.int32)
        return _fetch(tex, ix, iy, sampler)
    # Bilinear.
    x = u - 0.5
    y = v - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    t00 = _fetch(tex, x0, y0, sampler)
    t10 = _fetch(tex, x0 + 1, y0, sampler)
    t01 = _fetch(tex, x0, y0 + 1, sampler)
    t11 = _fetch(tex, x0 + 1, y0 + 1, sampler)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


class PackedMips(NamedTuple):
    """A full mip pyramid flattened for per-pixel LOD gathers."""

    texels: jnp.ndarray  # (total, C)
    offsets: jnp.ndarray  # (L,) i32
    widths: jnp.ndarray  # (L,) i32
    heights: jnp.ndarray  # (L,) i32

    @property
    def num_levels(self) -> int:
        return self.offsets.shape[0]


def pack_mips(mips: "list[jnp.ndarray]") -> PackedMips:
    offsets, widths, heights, flats = [], [], [], []
    off = 0
    for m in mips:
        h, w = int(m.shape[0]), int(m.shape[1])
        offsets.append(off)
        widths.append(w)
        heights.append(h)
        flats.append(m.reshape(h * w, -1))
        off += h * w
    return PackedMips(
        jnp.concatenate(flats, axis=0).astype(jnp.float32),
        jnp.asarray(offsets, jnp.int32),
        jnp.asarray(widths, jnp.int32),
        jnp.asarray(heights, jnp.int32),
    )


def _sample_level(packed: PackedMips, uv: jnp.ndarray, level: jnp.ndarray,
                  sampler: SamplerConfig) -> jnp.ndarray:
    """Bilinear sample at a (per-pixel, integer) mip level."""
    w = jnp.take(packed.widths, level)
    h = jnp.take(packed.heights, level)
    off = jnp.take(packed.offsets, level)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)

    def fetch(ix, iy):
        # Wrap per level dims (dynamic n → use arithmetic wrap).
        if sampler.address_mode_u == AddressMode.REPEAT:
            jx = jnp.mod(ix, w)
        else:
            jx = jnp.clip(ix, 0, w - 1)
        if sampler.address_mode_v == AddressMode.REPEAT:
            jy = jnp.mod(iy, h)
        else:
            jy = jnp.clip(iy, 0, h - 1)
        flat = (off + jy * w + jx).reshape(-1)
        t = jnp.take(packed.texels, flat, axis=0)
        return t.reshape(ix.shape + (packed.texels.shape[-1],))

    t00, t10 = fetch(x0, y0), fetch(x0 + 1, y0)
    t01, t11 = fetch(x0, y0 + 1), fetch(x0 + 1, y0 + 1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def screen_space_lod(uv: jnp.ndarray, tex_w: int, tex_h: int) -> jnp.ndarray:
    """Per-pixel LOD from neighbor differences of a dense (H, W, 2) UV image
    (the GPU quad-derivative analog)."""
    du_dx = uv - jnp.roll(uv, 1, axis=1)
    du_dy = uv - jnp.roll(uv, 1, axis=0)
    scale = jnp.asarray([tex_w, tex_h], jnp.float32)
    rx = jnp.linalg.norm(du_dx * scale, axis=-1)
    ry = jnp.linalg.norm(du_dy * scale, axis=-1)
    rho = jnp.maximum(rx, ry)
    return jnp.log2(jnp.maximum(rho, 1e-8))


def sample_2d_lod(
    packed: PackedMips,
    uv: jnp.ndarray,
    lod: jnp.ndarray,
    sampler: SamplerConfig = SamplerConfig(),
) -> jnp.ndarray:
    """Trilinear (or nearest-mip) sample with per-pixel LOD."""
    lmax = packed.num_levels - 1
    lod = jnp.clip(lod + sampler.mip_lod_bias, sampler.min_lod,
                   jnp.minimum(sampler.max_lod, lmax))
    if sampler.mipmap_mode == MipmapMode.NEAREST:
        level = jnp.round(lod).astype(jnp.int32)
        return _sample_level(packed, uv, level, sampler)
    l0 = jnp.floor(lod)
    frac = (lod - l0)[..., None]
    l0 = l0.astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, lmax)
    s0 = _sample_level(packed, uv, l0, sampler)
    s1 = _sample_level(packed, uv, l1, sampler)
    return s0 * (1 - frac) + s1 * frac


def sample_2d_aniso(
    packed: PackedMips,
    uv: jnp.ndarray,  # (H, W, 2) dense UV image (derivatives required)
    sampler: SamplerConfig,
    tex_w: int,
    tex_h: int,
) -> jnp.ndarray:
    """Anisotropic filtering (sampler.rs:19-20,39-40): N trilinear probes
    spread along the major axis of the pixel's UV footprint — the standard
    hardware approximation of the EWA ellipse. LOD is taken from the minor
    axis (rho_major / ratio), so oblique surfaces keep detail that isotropic
    trilinear would blur away.
    """
    scale = jnp.asarray([tex_w, tex_h], jnp.float32)
    ddx = uv - jnp.roll(uv, 1, axis=1)  # UV change per screen-x step
    ddy = uv - jnp.roll(uv, 1, axis=0)
    px = jnp.linalg.norm(ddx * scale, axis=-1)
    py = jnp.linalg.norm(ddy * scale, axis=-1)
    major_is_x = px >= py
    vmaj = jnp.where(major_is_x[..., None], ddx, ddy)  # UV-space major axis
    rho_maj = jnp.maximum(jnp.maximum(px, py), 1e-8)
    rho_min = jnp.maximum(jnp.minimum(px, py), 1e-8)
    ratio = jnp.clip(rho_maj / rho_min, 1.0, float(sampler.max_anisotropy))
    lod = jnp.log2(jnp.maximum(rho_maj / ratio, 1e-8))

    # Static probe count = max_anisotropy; probes bunch together (toward
    # plain trilinear) as the per-pixel ratio shrinks below the cap.
    s = max(2, int(round(float(sampler.max_anisotropy))))
    spread = (1.0 - 1.0 / ratio)[..., None]  # total extent the probes cover
    acc = None
    for i in range(s):
        t = (i + 0.5) / s - 0.5
        tap = sample_2d_lod(packed, uv + vmaj * (t * spread), lod, sampler)
        acc = tap if acc is None else acc + tap
    return acc / s


def sample_texture(
    tex,  # (H, W, C) array | tuple of mip arrays (graph import of a mipped Texture)
    uv: jnp.ndarray,  # (H, W, 2) dense UV image (fragment-stage varying)
    sampler: SamplerConfig = SamplerConfig(),
) -> jnp.ndarray:
    """Sample a bound texture resource inside a fragment shader.

    Accepts what ``ctx.get`` yields for an imported texture: a plain array
    (single level) or a tuple of mip arrays — mipped textures use trilinear
    filtering with screen-space-derivative LOD (the GPU's implicit-LOD
    sample), which requires the dense (H, W, 2) UV image fragment shaders
    receive. Samplers with ``anisotropy_enable`` take the multi-probe
    anisotropic path (requires the dense UV image for derivatives).
    """
    if isinstance(tex, (tuple, list)):
        levels = list(tex)
    else:
        levels = [tex]
    h0, w0 = levels[0].shape[0], levels[0].shape[1]
    if sampler.anisotropy_enable and uv.ndim == 3:
        return sample_2d_aniso(pack_mips(levels), uv, sampler, w0, h0)
    if len(levels) == 1 or sampler.mipmap_mode is None:
        return sample_2d(levels[0], uv, sampler)
    lod = screen_space_lod(uv, w0, h0)
    return sample_2d_lod(pack_mips(levels), uv, lod, sampler)


def sample_2d_array(
    tex: jnp.ndarray,  # (L, H, W, C)
    uv: jnp.ndarray,  # (..., 2)
    layer: jnp.ndarray,  # (...,) float or int layer index
    sampler: SamplerConfig = SamplerConfig(),
) -> jnp.ndarray:
    """Layered-2D sample (reference texture.rs:107-114): the layer index is
    rounded and clamped (Vulkan array-layer selection), then filtered in-plane
    like a plain 2D sample."""
    layers, h, w, c = tex.shape
    li = jnp.clip(jnp.round(layer).astype(jnp.int32), 0, layers - 1)
    # Fold the layer into the row index of a (L*H, W, C) sheet: all wrap
    # modes operate on the in-layer coords first, so row = li*h + iy.
    sheet = tex.reshape(layers * h, w, c)
    u = uv[..., 0] * w
    v = uv[..., 1] * h
    if sampler.mag_filter == Filter.NEAREST:
        ix = jnp.floor(u).astype(jnp.int32)
        iy = jnp.floor(v).astype(jnp.int32)
        jx, okx = _wrap_indices(ix, w, sampler.address_mode_u)
        jy, oky = _wrap_indices(iy, h, sampler.address_mode_v)
        out = _fetch_rows(sheet, li * h + jy, jx)
        border = jnp.asarray(sampler.border_color.value[:c], jnp.float32)
        return jnp.where((okx & oky)[..., None], out, border)
    x = u - 0.5
    y = v - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    border = jnp.asarray(sampler.border_color.value[:c], jnp.float32)

    def tap(ix, iy):
        jx, okx = _wrap_indices(ix, w, sampler.address_mode_u)
        jy, oky = _wrap_indices(iy, h, sampler.address_mode_v)
        t = _fetch_rows(sheet, li * h + jy, jx)
        return jnp.where((okx & oky)[..., None], t, border)

    t00, t10 = tap(x0, y0), tap(x0 + 1, y0)
    t01, t11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def _fetch_rows(sheet: jnp.ndarray, row: jnp.ndarray, col: jnp.ndarray) -> jnp.ndarray:
    """Gather texels from a (Rows, W, C) sheet at precomputed indices."""
    w = sheet.shape[1]
    flat = (row * w + col).reshape(-1)
    t = jnp.take(sheet.reshape(-1, sheet.shape[-1]), flat, axis=0)
    return t.reshape(row.shape + (sheet.shape[-1],))


def cube_direction_to_face_uv(d: jnp.ndarray) -> "tuple[jnp.ndarray, jnp.ndarray]":
    """Direction (..., 3) → (face (...,) i32, uv (..., 2)) per the Vulkan
    cube-map face selection rules (face order +X -X +Y -Y +Z -Z)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)

    x_major = (ax >= ay) & (ax >= az)
    y_major = (~x_major) & (ay >= az)
    face = jnp.where(
        x_major, jnp.where(x > 0, 0, 1),
        jnp.where(y_major, jnp.where(y > 0, 2, 3), jnp.where(z > 0, 4, 5)),
    ).astype(jnp.int32)

    ma = jnp.where(x_major, ax, jnp.where(y_major, ay, az))
    ma = jnp.maximum(ma, 1e-20)
    # Per-face (sc, tc) numerators (Vulkan 16.5.4 table).
    sc = jnp.where(
        x_major, jnp.where(x > 0, -z, z),
        jnp.where(y_major, x, jnp.where(z > 0, x, -x)),
    )
    tc = jnp.where(
        x_major, -y, jnp.where(y_major, jnp.where(y > 0, z, -z), -y)
    )
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)
    return face, jnp.stack([u, v], axis=-1)


def sample_cube(
    tex: jnp.ndarray,  # (6, S, S, C), faces +X -X +Y -Y +Z -Z
    directions: jnp.ndarray,  # (..., 3), need not be normalized
    sampler: SamplerConfig = SamplerConfig(),
) -> jnp.ndarray:
    """Cube-map sample by direction (reference texture.rs:94-105). Faces are
    filtered independently with clamp-to-edge at the seams (the standard
    software simplification of seamless filtering)."""
    face, uv = cube_direction_to_face_uv(directions)
    clamped = SamplerConfig(
        mag_filter=sampler.mag_filter,
        min_filter=sampler.min_filter,
        mipmap_mode=sampler.mipmap_mode,
        address_mode_u=AddressMode.CLAMP_TO_EDGE,
        address_mode_v=AddressMode.CLAMP_TO_EDGE,
        border_color=sampler.border_color,
    )
    return sample_2d_array(tex, uv, face, clamped)


def sample_cube_lod(
    levels,  # list/tuple of (6, S_m, S_m, C) cube mips (e.g. a prefiltered chain)
    directions: jnp.ndarray,  # (..., 3), need not be normalized
    lod: jnp.ndarray,  # (...,) float mip level
    sampler: SamplerConfig = SamplerConfig(),
) -> jnp.ndarray:
    """Cube sample with explicit per-pixel LOD (textureLod on a cube) —
    the IBL specular lookup (ops.ibl prefiltered chains; roughness → lod).

    Levels have distinct shapes, so instead of a packed-pyramid gather this
    blends all levels with tent weights max(0, 1−|lod−m|): trilinear-exact
    (at most two non-zero weights), and for the short prefiltered chains it
    serves (≤6 levels of ≤64² faces) the dense blend replaces
    a dynamic packed gather with per-level wrap arithmetic."""
    face, uv = cube_direction_to_face_uv(directions)
    clamped = SamplerConfig(
        mag_filter=sampler.mag_filter,
        min_filter=sampler.min_filter,
        address_mode_u=AddressMode.CLAMP_TO_EDGE,
        address_mode_v=AddressMode.CLAMP_TO_EDGE,
        border_color=sampler.border_color,
    )
    lmax = len(levels) - 1
    lod = jnp.clip(lod + sampler.mip_lod_bias, 0.0, float(lmax))
    acc = None
    for m, tex in enumerate(levels):
        w = jnp.clip(1.0 - jnp.abs(lod - m), 0.0, 1.0)[..., None]
        tap = sample_2d_array(tex, uv, face, clamped) * w
        acc = tap if acc is None else acc + tap
    return acc


def sample_3d(
    tex: jnp.ndarray,  # (D, H, W, C)
    uvw: jnp.ndarray,  # (..., 3)
    sampler: SamplerConfig = SamplerConfig(),
) -> jnp.ndarray:
    """Volume sample (reference texture.rs:81-92): trilinear across the two
    nearest depth slices (or nearest slice + in-plane filter for NEAREST)."""
    d = tex.shape[0]
    zc = uvw[..., 2] * d
    if sampler.mag_filter == Filter.NEAREST:
        iz = jnp.floor(zc).astype(jnp.int32)
        if sampler.address_mode_w == AddressMode.REPEAT:
            iz = jnp.mod(iz, d)
        else:
            iz = jnp.clip(iz, 0, d - 1)
        return sample_2d_array(tex, uvw[..., :2], iz, sampler)
    z = zc - 0.5
    z0 = jnp.floor(z)
    fz = (z - z0)[..., None]
    z0 = z0.astype(jnp.int32)
    if sampler.address_mode_w == AddressMode.REPEAT:
        za, zb = jnp.mod(z0, d), jnp.mod(z0 + 1, d)
    else:
        za, zb = jnp.clip(z0, 0, d - 1), jnp.clip(z0 + 1, 0, d - 1)
    s0 = sample_2d_array(tex, uvw[..., :2], za, sampler)
    s1 = sample_2d_array(tex, uvw[..., :2], zb, sampler)
    return s0 * (1 - fz) + s1 * fz


def sample_shadow_pcf(
    shadow_depth: jnp.ndarray,  # (H, W) depth map (reverse-Z)
    uv: jnp.ndarray,  # (..., 2)
    ref_z: jnp.ndarray,  # (...,) reference depth to compare
    sampler: SamplerConfig = SamplerConfig.shadow_pcf(),
) -> jnp.ndarray:
    """2×2 PCF compare sample → light visibility in [0, 1].

    Each bilinear tap is compared (sampler.compare_op) against ref_z, then
    the binary results are bilinearly weighted (Vulkan D32 compare sampling).
    """
    from zenith.rhi.state import CompareOp

    h, w = shadow_depth.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f, y0f = jnp.floor(x), jnp.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.astype(jnp.int32), y0f.astype(jnp.int32)

    cmp = {
        CompareOp.GREATER_OR_EQUAL: lambda a, b: a >= b,
        CompareOp.GREATER: lambda a, b: a > b,
        CompareOp.LESS_OR_EQUAL: lambda a, b: a <= b,
        CompareOp.LESS: lambda a, b: a < b,
    }[sampler.compare_op]

    tex = shadow_depth[..., None]

    def tap(ix, iy):
        d = _fetch(tex, ix, iy, sampler)[..., 0]
        return cmp(ref_z, d).astype(jnp.float32)

    t00, t10 = tap(x0, y0), tap(x0 + 1, y0)
    t01, t11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def sample_shadow_pcf_layered(
    shadow_layers: jnp.ndarray,  # (L, H, W) or (L, H, W, 1) depth layers
    layer: jnp.ndarray,  # (...,) int32 per-pixel layer index in [0, L)
    uv: jnp.ndarray,  # (..., 2)
    ref_z: jnp.ndarray,  # (...,) reference depth to compare
    sampler: SamplerConfig = SamplerConfig.shadow_pcf(),
) -> jnp.ndarray:
    """2x2 PCF compare sample from ONE layer of a depth array texture,
    selected per pixel — cascaded shadow maps (renderer/csm.py). Taps
    gather from the flattened (L*H*W) stack with a per-pixel layer base
    offset, so the gather count equals the single-layer PCF."""
    from zenith.rhi.state import CompareOp

    if shadow_layers.ndim == 4:
        shadow_layers = shadow_layers[..., 0]
    n_layers, h, w = shadow_layers.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f, y0f = jnp.floor(x), jnp.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.astype(jnp.int32), y0f.astype(jnp.int32)

    cmp = {
        CompareOp.GREATER_OR_EQUAL: lambda a, b: a >= b,
        CompareOp.GREATER: lambda a, b: a > b,
        CompareOp.LESS_OR_EQUAL: lambda a, b: a <= b,
        CompareOp.LESS: lambda a, b: a < b,
    }[sampler.compare_op]

    flat = shadow_layers.reshape(-1)
    base = jnp.clip(layer, 0, n_layers - 1) * (h * w)
    border = jnp.float32(sampler.border_color.value[0])

    def tap(ix, iy):
        jx, okx = _wrap_indices(ix, w, sampler.address_mode_u)
        jy, oky = _wrap_indices(iy, h, sampler.address_mode_v)
        d = jnp.take(flat, (base + jy * w + jx).reshape(-1), axis=0).reshape(
            ix.shape
        )
        d = jnp.where(okx & oky, d, border)
        return cmp(ref_z, d).astype(jnp.float32)

    t00, t10 = tap(x0, y0), tap(x0 + 1, y0)
    t01, t11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy
