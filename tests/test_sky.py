"""Procedural atmosphere (ops.atmosphere): single-scatter Rayleigh+Mie
sky — physical sanity of the march, the packed-dynamic contract, and the
deferred background integration."""

import numpy as np
import pytest

import jax.numpy as jnp

from zenith.ops.atmosphere import Atmosphere, sky_radiance


def dirs_from_elevations(elev_deg, azim_deg=0.0):
    """Unit view rays at given elevations (Z-up world)."""
    e = np.deg2rad(np.atleast_1d(elev_deg).astype(np.float64))
    a = np.deg2rad(azim_deg)
    d = np.stack([
        np.cos(e) * np.cos(a), np.cos(e) * np.sin(a) * np.ones_like(e),
        np.sin(e),
    ], axis=-1)
    return jnp.asarray(d, jnp.float32)


def radiance(dirs, sun_dir, cfg=None, **packed_overrides):
    cfg = cfg or Atmosphere()
    params = cfg.packed(packed_overrides.pop("camera_height", 2.0))
    for k, v in packed_overrides.items():
        params[{"sun_intensity": 0, "rayleigh_mult": 1, "mie_mult": 2,
                "mie_g": 3, "disk_intensity": 4}[k]] = v
    sun = np.asarray(sun_dir, np.float64)
    sun = jnp.asarray(sun / np.linalg.norm(sun), jnp.float32)
    return np.asarray(sky_radiance(dirs, sun, jnp.asarray(params), cfg))


def luma(rgb):
    return rgb @ np.asarray([0.2126, 0.7152, 0.0722])


class TestPhysics:
    def test_zenith_is_blue_horizon_is_brighter(self):
        """High sun: the horizon accumulates more air mass (brighter,
        whiter); the zenith is a purer Rayleigh blue."""
        out = radiance(dirs_from_elevations([2.0, 88.0]), (0.3, 0.0, 0.8),
                       disk_intensity=0.0)
        horizon, zenith = out[0], out[1]
        assert luma(horizon) > luma(zenith)
        frac = out[..., 2] / out.sum(axis=-1)
        assert frac[1] > frac[0]  # blue fraction higher at zenith

    def test_sunset_is_redder_than_midday(self):
        """Same view ray toward the sun's azimuth: with the sun at the
        horizon the light paths are long and blue extinguishes first —
        the red/blue ratio must far exceed the high-sun value."""
        view = dirs_from_elevations(8.0, azim_deg=0.0)
        sunset = radiance(view, (1.0, 0.0, 0.02), disk_intensity=0.0)[0]
        midday = radiance(view, (0.3, 0.0, 0.9), disk_intensity=0.0)[0]
        rb_sunset = sunset[0] / max(sunset[2], 1e-9)
        rb_midday = midday[0] / max(midday[2], 1e-9)
        assert rb_sunset > 2.0 * rb_midday

    def test_forward_mie_brightens_toward_the_sun(self):
        """Sun low: the forward Mie lobe makes the sky near the sun's
        azimuth brighter than the sky opposite it."""
        sun = (1.0, 0.0, 0.02)
        near = radiance(dirs_from_elevations(8.0, azim_deg=0.0), sun,
                        disk_intensity=0.0)[0]
        far = radiance(dirs_from_elevations(8.0, azim_deg=180.0), sun,
                       disk_intensity=0.0)[0]
        assert luma(near) > luma(far)

    def test_sun_disk_brightest_at_sun(self):
        sun = (0.5, 0.0, 0.5)
        elevs = np.linspace(5.0, 85.0, 81)
        out = radiance(dirs_from_elevations(elevs), sun)
        assert abs(float(elevs[luma(out).argmax()]) - 45.0) < 1.5

    def test_ground_rays_see_no_sun_disk(self):
        """Below-horizon rays hit the planet: haze only, no disk."""
        sun = (0.7, 0.0, -0.05)  # sun below horizon in exactly that dir
        down = radiance(dirs_from_elevations(-4.1), sun)[0]
        up = radiance(dirs_from_elevations(4.1, azim_deg=0.0),
                      (0.7, 0.0, 0.0717), )[0]
        assert luma(down) < luma(up)

    def test_finite_and_nonnegative_everywhere(self):
        rng = np.random.default_rng(7)
        d = rng.normal(size=(64, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        out = radiance(jnp.asarray(d, jnp.float32), (0.2, 0.3, 0.6))
        assert np.isfinite(out).all()
        assert (out >= 0.0).all()

    def test_altitude_thins_the_sky(self):
        """From 50 km up, looking sideways, there is far less air above —
        the sky darkens."""
        d = dirs_from_elevations(30.0)
        low = radiance(d, (0.3, 0.0, 0.8), disk_intensity=0.0,
                       camera_height=2.0)
        high = radiance(d, (0.3, 0.0, 0.8), disk_intensity=0.0,
                        camera_height=50e3)
        assert luma(high[0]) < luma(low[0]) * 0.6


class TestDynamics:
    def test_knobs_ride_params_not_the_trace(self):
        """The same jitted radiance serves different knob values: mie_mult
        changes the output with no retrace (cfg stays identical)."""
        import jax

        cfg = Atmosphere()
        traces = []

        @jax.jit
        def run(params):
            d = dirs_from_elevations([10.0, 60.0])
            traces.append(1)
            return sky_radiance(
                d, jnp.asarray([0.3, 0.0, 0.8], jnp.float32) / np.sqrt(0.73),
                params, cfg,
            )

        a = np.asarray(run(jnp.asarray(cfg.packed(2.0))))
        p2 = cfg.packed(2.0)
        p2[2] = 8.0  # mie_mult
        b = np.asarray(run(jnp.asarray(p2)))
        assert len(traces) == 1
        assert np.abs(a - b).max() > 1e-4

    def test_capture_key_static_fields_only(self):
        a = Atmosphere()
        b = Atmosphere(sun_intensity=5.0, mie_g=0.2, disk_intensity=0.0)
        c = Atmosphere(steps=8)
        assert a.__zenith_capture_key__() == b.__zenith_capture_key__()
        assert a.__zenith_capture_key__() != c.__zenith_capture_key__()


class TestScene:
    def test_scene_sky_one_program_and_colored_background(self):
        from zenith.launch import launch
        from zenith.rendergraph.graph import (
            clear_frame_program_cache,
            frame_program_cache_size,
        )
        from zenith.sandbox.scene import SceneApp
        from zenith.window import Window

        clear_frame_program_cache()
        window = Window(width=128, height=64, title="t")
        launch(
            SceneApp,
            argv=["--", "--mode", "deferred", "--lights", "4", "--sky"],
            window=window,
            max_frames=4,
        )
        assert frame_program_cache_size() == 1
        frame = np.asarray(window.last_frame)
        assert np.isfinite(frame.astype(np.float64)).all()
        # The upper rows are sky: visibly non-gray (the atmosphere tints
        # them) and not the flat def.background constant.
        top = frame[:8, :, :3].astype(np.float64)
        assert top.std() > 1.0
        assert top.mean() > 8.0

    def test_skybox_wins_over_atmosphere(self):
        """Scene.atmosphere is the lowest-priority background: with an
        environment/skybox set, the renderer must not consume def.atmo."""
        from zenith.renderer import DeferredRenderer
        from zenith.renderer.scene import Scene
        from zenith.ops.atmosphere import Atmosphere

        scene = Scene(objects=[], atmosphere=Atmosphere(),
                      skybox=object())
        r = DeferredRenderer.__new__(DeferredRenderer)
        r.scene = scene
        # frame_dynamics must not emit def.atmo when a skybox is present.
        from zenith.core.camera import Camera
        from zenith.core.mathtypes import Degree

        r.shadows = False
        r.velocity = False
        cam = Camera(fov_y=Degree(40.0), aspect_ratio=2.0)
        d = DeferredRenderer.frame_dynamics(r, cam)
        assert "def.atmo" not in d
        assert "def.inv_vp" in d  # the skybox still needs rays
