"""Image-based lighting — environment-map preintegration for the PBR
resolve (split-sum approximation).

The reference has no IBL (its only renderer is TriangleRenderer;
zenith-renderer/src/lib.rs); this implements the standard production
pipeline the full PBR configuration (BASELINE.md config #5) implies, as
pure jittable array math:

- ``irradiance_sh9``: diffuse irradiance projected onto 9 spherical-
  harmonic coefficients (Ramamoorthi & Hanrahan 2001) — evaluated per
  pixel in the lighting resolve for a few fused FLOPs instead of a
  convolved cube sample.
- ``prefilter_ggx``: the specular prefiltered mip chain — each mip is the
  environment convolved with the GGX lobe of increasing roughness via
  importance sampling (Karis 2013, "Real Shading in Unreal Engine 4").
  Runs ONCE at EnvironmentLight build as a single jitted program: the
  sample loop is a fixed-trip ``lax.fori_loop`` over precomputed
  Hammersley points, so the whole convolution is one compiled kernel.
- ``env_brdf_approx``: the analytic split-sum BRDF term (Lazarov/Karis
  mobile approximation) — avoids the 2D LUT texture entirely, trading a
  texture gather for 8 elementwise ops.

Shape notes: everything is dense (6, S, S, ·) math — face direction
grids are precomputed constants, the importance-sample loop carries a
(6·S·S, C) accumulator through ``fori_loop`` (static shapes, no
per-sample materialization of the (P, K, 3) tensor at large sizes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Vulkan cube face order: +X -X +Y -Y +Z -Z (sampling.cube_direction_to_face_uv).
# Rows: direction = axis + (2u-1)*du + (2v-1)*dv, normalized.
_FACE_BASIS = np.asarray(
    [
        # axis          du (sc)         dv (tc)
        [[1, 0, 0],     [0, 0, -1],     [0, -1, 0]],   # +X
        [[-1, 0, 0],    [0, 0, 1],      [0, -1, 0]],   # -X
        [[0, 1, 0],     [1, 0, 0],      [0, 0, 1]],    # +Y
        [[0, -1, 0],    [1, 0, 0],      [0, 0, -1]],   # -Y
        [[0, 0, 1],     [1, 0, 0],      [0, -1, 0]],   # +Z
        [[0, 0, -1],    [-1, 0, 0],     [0, -1, 0]],   # -Z
    ],
    np.float32,
)


def cube_face_directions(size: int) -> np.ndarray:
    """(6, S, S, 3) unit directions at face texel centers (host constant).

    Inverse of ``sampling.cube_direction_to_face_uv`` — round-trips through
    it exactly (covered by tests/test_ibl.py)."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    sc = np.broadcast_to(t[None, :], (size, size))
    tc = np.broadcast_to(t[:, None], (size, size))
    dirs = (
        _FACE_BASIS[:, None, None, 0]
        + sc[None, ..., None] * _FACE_BASIS[:, None, None, 1]
        + tc[None, ..., None] * _FACE_BASIS[:, None, None, 2]
    )
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def cube_texel_solid_angles(size: int) -> np.ndarray:
    """(S, S) solid angle of each face texel (identical for all 6 faces).

    Exact per-texel integral via the standard AreaElement formulation:
    ω = AE(x1,y1) − AE(x0,y1) − AE(x1,y0) + AE(x0,y0)."""

    def area(x, y):
        return np.arctan2(x * y, np.sqrt(x * x + y * y + 1.0))

    e = np.arange(size + 1, dtype=np.float64) / size * 2.0 - 1.0
    x0, x1 = e[:-1][None, :], e[1:][None, :]
    y0, y1 = e[:-1][:, None], e[1:][:, None]
    w = area(x1, y1) - area(x0, y1) - area(x1, y0) + area(x0, y0)
    return w.astype(np.float32)


# Real SH basis constants (l ≤ 2) and the cosine-lobe convolution weights
# Â_l = (π, 2π/3, π/4) folded with 1/π so evaluation yields the LAMBERTIAN
# RADIANCE factor directly (outgoing = albedo * eval, no extra 1/π).
_SH_C = np.asarray(
    [0.282095, 0.488603, 0.488603, 0.488603,
     1.092548, 1.092548, 0.315392, 1.092548, 0.546274],
    np.float32,
)
_SH_A_OVER_PI = np.asarray(
    [1.0, 2.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0,
     0.25, 0.25, 0.25, 0.25, 0.25],
    np.float32,
)


def _sh9_basis(d):
    """(..., 3) unit directions → (..., 9) real SH basis values."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    one = jnp.ones_like(x)
    return jnp.stack(
        [one * _SH_C[0],
         _SH_C[1] * y, _SH_C[2] * z, _SH_C[3] * x,
         _SH_C[4] * x * y, _SH_C[5] * y * z,
         _SH_C[6] * (3.0 * z * z - 1.0),
         _SH_C[7] * x * z, _SH_C[8] * (x * x - y * y)],
        axis=-1,
    )


def irradiance_sh9(cube) -> jnp.ndarray:
    """Project environment radiance onto 9 SH coefficients → (9, 3).

    ``cube`` is a (6, S, S, C≥3) linear-radiance cube map. The result feeds
    ``eval_irradiance_sh9``; together they are the Ramamoorthi-Hanrahan
    irradiance map, exact to l=2 (≤1% error for natural environments)."""
    cube = jnp.asarray(cube)
    size = cube.shape[1]
    dirs = jnp.asarray(cube_face_directions(size))  # (6,S,S,3)
    dw = jnp.asarray(cube_texel_solid_angles(size))  # (S,S)
    basis = _sh9_basis(dirs)  # (6,S,S,9)
    rad = cube[..., :3] * dw[None, :, :, None]  # radiance · dω
    # (6·S·S, 9)ᵀ @ (6·S·S, 3) — one small matmul.
    return basis.reshape(-1, 9).T @ rad.reshape(-1, 3)


def eval_irradiance_sh9(sh: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """(9, 3) coefficients + (..., 3) unit normals → (..., 3) Lambertian
    radiance factor E(n)/π (multiply by albedo for outgoing radiance)."""
    basis = _sh9_basis(n) * jnp.asarray(_SH_A_OVER_PI)  # (..., 9)
    return jnp.maximum(basis @ sh, 0.0)


def irradiance_sh9_host(cube: np.ndarray) -> np.ndarray:
    """NumPy twin of ``irradiance_sh9`` for host-resident pixels → (9, 3)
    float32. EnvironmentLight uses this so the coefficients can ride as a
    plain host dynamic WITHOUT a device→host readback."""
    cube = np.asarray(cube, np.float32)
    size = cube.shape[1]
    d = cube_face_directions(size)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    basis = np.stack(
        [np.full_like(x, _SH_C[0]),
         _SH_C[1] * y, _SH_C[2] * z, _SH_C[3] * x,
         _SH_C[4] * x * y, _SH_C[5] * y * z,
         _SH_C[6] * (3.0 * z * z - 1.0),
         _SH_C[7] * x * z, _SH_C[8] * (x * x - y * y)],
        axis=-1,
    )
    dw = cube_texel_solid_angles(size)
    rad = cube[..., :3] * dw[None, :, :, None]
    return (basis.reshape(-1, 9).T @ rad.reshape(-1, 3)).astype(np.float32)


def _hammersley(count: int) -> np.ndarray:
    """(K, 2) Hammersley low-discrepancy points (van der Corput base 2)."""
    i = np.arange(count, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << np.uint32(16)) | (bits >> np.uint32(16))) & np.uint32(0xFFFFFFFF)
    bits = ((bits & np.uint32(0x55555555)) << np.uint32(1)) | (
        (bits & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    bits = ((bits & np.uint32(0x33333333)) << np.uint32(2)) | (
        (bits & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    bits = ((bits & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | (
        (bits & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    bits = ((bits & np.uint32(0x00FF00FF)) << np.uint32(8)) | (
        (bits & np.uint32(0xFF00FF00)) >> np.uint32(8))
    return np.stack(
        [i.astype(np.float64) / count, bits.astype(np.float64) * 2.3283064365386963e-10],
        axis=-1,
    ).astype(np.float32)


def _ggx_importance_dirs(xi: np.ndarray, roughness: float) -> np.ndarray:
    """(K, 2) points → (K, 3) GGX half-vectors in tangent space (+Z normal)."""
    a = max(roughness * roughness, 1e-4)
    phi = 2.0 * np.pi * xi[:, 0]
    cos_t = np.sqrt((1.0 - xi[:, 1]) / (1.0 + (a * a - 1.0) * xi[:, 1]))
    sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 0.0))
    return np.stack(
        [sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], axis=-1
    ).astype(np.float32)


def prefilter_ggx(cube, num_mips: int = 5, samples: int = 64) -> "list[jnp.ndarray]":
    """GGX-prefiltered specular mip chain (split-sum term 1).

    mip m (size S/2^m) = environment convolved with the GGX lobe at
    roughness m/(num_mips−1) under the standard N = V = R approximation.
    Mip 0 (roughness 0) is the unfiltered environment (a mirror reflection).
    Returns ``num_mips`` device arrays [(6, S_m, S_m, C), ...].
    """
    from zenith.ops.sampling import SamplerConfig, sample_cube

    cube = jnp.asarray(cube)
    size = int(cube.shape[1])
    chans = int(cube.shape[-1])
    assert num_mips >= 2 and size >> (num_mips - 1) >= 4, (
        f"cube size {size} too small for {num_mips} mips"
    )
    xi = _hammersley(samples)
    out = [cube]
    lin = SamplerConfig.linear()

    for m in range(1, num_mips):
        roughness = m / (num_mips - 1)
        sm = size >> m
        n = jnp.asarray(cube_face_directions(sm).reshape(-1, 3))  # (P, 3)
        # Per-direction tangent frame (branchless up-vector selection).
        helper = jnp.where(
            (jnp.abs(n[:, 2:3]) < 0.999),
            jnp.asarray([0.0, 0.0, 1.0]),
            jnp.asarray([1.0, 0.0, 0.0]),
        )
        t = jnp.cross(helper, n)
        t = t / jnp.linalg.norm(t, axis=-1, keepdims=True)
        b = jnp.cross(n, t)
        h_tan = jnp.asarray(_ggx_importance_dirs(xi, roughness))  # (K, 3)

        def body(k, acc, n=n, t=t, b=b, h_tan=h_tan):
            color_acc, weight_acc = acc
            h = (h_tan[k, 0] * t + h_tan[k, 1] * b + h_tan[k, 2] * n)
            ndh = jnp.sum(n * h, axis=-1, keepdims=True)
            l = 2.0 * ndh * h - n  # reflect V(=N) about H
            ndl = jnp.maximum(jnp.sum(n * l, axis=-1, keepdims=True), 0.0)
            tap = sample_cube(cube, l, lin)[..., :chans]
            return (color_acc + tap * ndl, weight_acc + ndl)

        init = (
            jnp.zeros((n.shape[0], chans), jnp.float32),
            jnp.zeros((n.shape[0], 1), jnp.float32),
        )
        color, weight = jax.lax.fori_loop(0, samples, body, init)
        mip = (color / jnp.maximum(weight, 1e-6)).reshape(6, sm, sm, chans)
        out.append(mip)
    return out


def env_brdf_approx(ndv: jnp.ndarray, roughness: jnp.ndarray):
    """Analytic split-sum environment BRDF (the Karis "mobile" polynomial
    fit of the 2D LUT): returns (scale, bias) such that
    specular ≈ prefiltered · (F0 · scale + bias). Replaces the LUT texture
    entirely.
    Limits: roughness→0, ndv→1 gives (≈1, ≈0) — a pure mirror F0."""
    rx = roughness * -1.0 + 1.0
    ry = roughness * -0.0275 + 0.0425
    rz = roughness * -0.572 + 1.04
    rw = roughness * 0.022 - 0.04
    a004 = jnp.minimum(rx * rx, jnp.exp2(-9.28 * ndv)) * rx + ry
    # The raw fit strays a few 1e-3 outside [0, 1] at the corners of the
    # domain; clamp to the physical range of the split-sum integral.
    scale = jnp.clip(a004 * -1.04 + rz, 0.0, 1.0)
    bias = jnp.clip(a004 * 1.04 + rw, 0.0, 1.0)
    return scale, bias
