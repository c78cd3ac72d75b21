"""Procedural atmosphere: single-scattering Rayleigh + Mie sky.

The classic Nishita-style integral (march the view ray through a
spherical atmosphere, accumulating in-scattered sunlight attenuated by
the optical depth to the camera AND to the sun), in the compact
O'Neil/`glsl-atmosphere` formulation GPU engines bake into sky shaders.

Shape: the march is a HOST-UNROLLED loop of elementwise
(H, W) math — no gathers, no data-dependent control flow — so XLA fuses
the whole sky into the lighting resolve the way a GPU fuses it into the
background shader. Step counts are static (trace-shaping); every
live-tunable knob (sun intensity, density multipliers, Mie anisotropy,
sun-disk boost, camera height) rides ONE packed dynamic, so tweaking the
sky or flying upward never recompiles.

No reference counterpart (the reference's only background is a clear
color — zenith-rendergraph clear values, builder.rs:337-412); this is
breadth on the environment stack beside the cube-map skybox and IBL
(`renderer/environment.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

# Earth-ish defaults (meters): the standard constants used by every
# real-time single-scatter implementation.
_BETA_RAYLEIGH = (5.802e-6, 13.558e-6, 33.1e-6)
_BETA_MIE = 3.996e-6


@dataclass
class Atmosphere:
    """Sky config. Fields split by trace role:

    STATIC (baked into the program; changing them recompiles): the march
    step counts and the planetary geometry / scattering coefficients.

    DYNAMIC (ride the packed ``atmo`` dynamic; changing them per frame
    never recompiles): ``sun_intensity``, ``rayleigh_mult``, ``mie_mult``,
    ``mie_g``, ``disk_intensity`` and the camera height (computed per
    frame from the camera by :meth:`packed`).

    ``units_to_m`` maps scene units to meters for the camera height (the
    sandbox scene is ~meters, so 1.0).
    """

    # -- static ------------------------------------------------------------
    steps: int = 12
    light_steps: int = 4
    planet_radius: float = 6371e3
    atmosphere_radius: float = 6471e3
    rayleigh_scale_height: float = 8500.0
    mie_scale_height: float = 1200.0
    beta_rayleigh: tuple = _BETA_RAYLEIGH
    beta_mie: float = _BETA_MIE
    # Mie extinction = scatter * (1 + absorb_factor) — the usual /0.9.
    mie_absorb_factor: float = 0.11
    sun_angular_radius_deg: float = 0.27
    units_to_m: float = 1.0
    # -- dynamic -----------------------------------------------------------
    sun_intensity: float = 22.0
    rayleigh_mult: float = 1.0
    mie_mult: float = 1.0
    mie_g: float = 0.76
    disk_intensity: float = 100.0

    def __zenith_capture_key__(self):
        # Static fields only — the knobs ride the packed dynamic.
        return ("atmosphere", self.steps, self.light_steps,
                self.planet_radius, self.atmosphere_radius,
                self.rayleigh_scale_height, self.mie_scale_height,
                tuple(self.beta_rayleigh), self.beta_mie,
                self.mie_absorb_factor, self.sun_angular_radius_deg,
                self.units_to_m)

    def packed(self, camera_height: float) -> np.ndarray:
        """The per-frame dynamic: [sun_I, rayleigh_mult, mie_mult, g,
        disk_I, camera_height_m]. ``camera_height`` in scene units."""
        h_m = max(float(camera_height) * self.units_to_m, 2.0)
        return np.asarray(
            [self.sun_intensity, self.rayleigh_mult, self.mie_mult,
             self.mie_g, self.disk_intensity, h_m],
            np.float32,
        )


def sky_radiance(dirs, sun_dir, params, cfg: Atmosphere):
    """HDR sky radiance for normalized view rays.

    ``dirs``: (..., 3) unit view directions (Z-up world, like the camera —
    camera.rs:17-20 basis parity). ``sun_dir``: (3,) unit vector TOWARD
    the sun (DirectionalLight convention). ``params``: the (6,) packed
    dynamic from :meth:`Atmosphere.packed`. Returns (..., 3) linear HDR.

    Rays that hit the planet march only to the ground hit (the aerial
    haze in front of terrain) — the caller composites scene geometry over
    this, so ground rays just need to not contribute sky through the
    floor.
    """
    f32 = jnp.float32
    sun_i, ray_mult, mie_mult, g, disk_i, cam_h = (params[k] for k in range(6))
    rp, ra = cfg.planet_radius, cfg.atmosphere_radius
    hr, hm = cfg.rayleigh_scale_height, cfg.mie_scale_height
    beta_r = jnp.asarray(cfg.beta_rayleigh, f32) * ray_mult
    beta_m_s = cfg.beta_mie * mie_mult
    beta_m_e = beta_m_s * (1.0 + cfg.mie_absorb_factor)

    rd = dirs
    rx, ry, rz = rd[..., 0], rd[..., 1], rd[..., 2]
    sx, sy, sz = sun_dir[0], sun_dir[1], sun_dir[2]
    oz = rp + cam_h  # camera on the +z axis of the planet

    # Ray-sphere: origin (0, 0, oz), |o + t·d|² = R². b = o·d = oz·dz.
    b = oz * rz
    c_atmo = oz * oz - ra * ra  # < 0: we start inside the atmosphere
    t_exit = -b + jnp.sqrt(jnp.maximum(b * b - c_atmo, 0.0))
    c_gnd = oz * oz - rp * rp
    disc_g = b * b - c_gnd
    t_gnd = -b - jnp.sqrt(jnp.maximum(disc_g, 0.0))
    hits_ground = (disc_g > 0.0) & (t_gnd > 0.0)
    t_end = jnp.where(hits_ground, t_gnd, t_exit)
    dt = t_end / float(cfg.steps)

    mu = rx * sx + ry * sy + rz * sz
    phase_r = 3.0 / (16.0 * np.pi) * (1.0 + mu * mu)
    g2 = g * g
    phase_m = (3.0 / (8.0 * np.pi)) * ((1.0 - g2) * (1.0 + mu * mu)) / (
        (2.0 + g2) * jnp.power(1.0 + g2 - 2.0 * g * mu, 1.5)
    )

    tau_r = jnp.zeros_like(rz)
    tau_m = jnp.zeros_like(rz)
    sum_r = jnp.zeros(rd.shape[:-1] + (3,), f32)
    sum_m = jnp.zeros(rd.shape[:-1] + (3,), f32)
    inv_ls = 1.0 / float(cfg.light_steps)
    for i in range(cfg.steps):
        t = (i + 0.5) * dt
        px, py, pz = rx * t, ry * t, oz + rz * t
        pr = jnp.sqrt(px * px + py * py + pz * pz)
        h = pr - rp
        dr = jnp.exp(-h / hr) * dt
        dm = jnp.exp(-h / hm) * dt
        tau_r = tau_r + dr
        tau_m = tau_m + dm
        # Secondary ray: optical depth from the sample to the sun.
        bl = px * sx + py * sy + pz * sz
        tl = -bl + jnp.sqrt(jnp.maximum(bl * bl - (pr * pr - ra * ra), 0.0))
        dtl = tl * inv_ls
        ltau_r = jnp.zeros_like(rz)
        ltau_m = jnp.zeros_like(rz)
        for j in range(cfg.light_steps):
            tj = (j + 0.5) * dtl
            hl = jnp.sqrt(
                (px + sx * tj) ** 2 + (py + sy * tj) ** 2
                + (pz + sz * tj) ** 2
            ) - rp
            ltau_r = ltau_r + jnp.exp(-hl / hr)
            ltau_m = ltau_m + jnp.exp(-hl / hm)
        ltau_r = ltau_r * dtl
        ltau_m = ltau_m * dtl
        att = jnp.exp(
            -(beta_r * (tau_r + ltau_r)[..., None]
              + beta_m_e * (tau_m + ltau_m)[..., None])
        )
        sum_r = sum_r + dr[..., None] * att
        sum_m = sum_m + dm[..., None] * att

    radiance = sun_i * (
        sum_r * beta_r * phase_r[..., None]
        + sum_m * beta_m_s * phase_m[..., None]
    )

    # Sun disk: view-path transmittance times a smooth angular window,
    # only for rays that reach space.
    cos_disk = float(np.cos(np.deg2rad(cfg.sun_angular_radius_deg)))
    edge = 1.0 - cos_disk  # smoothstep band ~ one disk radius wide
    w = jnp.clip((mu - cos_disk + edge) / edge, 0.0, 1.0)
    w = w * w * (3.0 - 2.0 * w)
    trans = jnp.exp(-(beta_r * tau_r[..., None] + beta_m_e * tau_m[..., None]))
    disk = jnp.where(hits_ground, 0.0, w) * disk_i * sun_i
    return radiance + trans * disk[..., None]
