"""Volumetric fog/shafts: transmittance math, height falloff, shadow
gating, node SPMD, scene."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zenith.ops.volumetric import volumetric_sun

W, H = 32, 16


def _params(density=0.01, height=0.0, falloff=1e6, g=0.0, max_dist=100.0,
            sun_boost=1.0, ambient=0.0):
    return jnp.asarray(
        [density, height, falloff, g, max_dist, sun_boost, ambient, 0.0],
        jnp.float32,
    )


def _flat_inputs(dist=50.0, color=0.8):
    """Every pixel: a surface straight ahead (+y) at ``dist``."""
    hdr = np.full((H, W, 4), color, np.float32)
    hdr[..., 3] = 1.0
    pos = np.zeros((H, W, 3), np.float32)
    pos[..., 1] = dist
    depth = np.full((H, W), 0.5, np.float32)
    cam = np.zeros(3, np.float32)
    dirs = np.zeros((H, W, 3), np.float32)
    dirs[..., 1] = 1.0
    return hdr, pos, depth, cam, dirs


def _run(hdr, pos, depth, cam, dirs, params, sun_dir=(0.0, 0.0, 1.0),
         sun_color=(1.0, 1.0, 1.0), steps=16, jitter=False, **kw):
    return np.asarray(volumetric_sun(
        jnp.asarray(hdr), jnp.asarray(pos), jnp.asarray(depth),
        jnp.asarray(cam), jnp.asarray(dirs),
        jnp.asarray(sun_dir, dtype=jnp.float32),
        jnp.asarray(sun_color, dtype=jnp.float32),
        params, steps=steps, jitter=jitter, **kw,
    ))


class TestFog:
    def test_zero_density_identity(self):
        hdr, pos, depth, cam, dirs = _flat_inputs()
        out = _run(hdr, pos, depth, cam, dirs, _params(density=0.0))
        np.testing.assert_allclose(out, hdr, atol=1e-6)

    def test_uniform_fog_closed_form(self):
        """Uniform density (no height falloff), no shadow map: the K-step
        Beer-Lambert march telescopes exactly — transmittance e^{-ρ·d}
        and in-scatter (1 − e^{-ρ·d})·C with C = (HG·boost + amb)·sun.
        Horizontal ray ⊥ vertical sun → HG(g=0) = 1."""
        rho, d = 0.01, 50.0
        hdr, pos, depth, cam, dirs = _flat_inputs(dist=d, color=0.8)
        out = _run(hdr, pos, depth, cam, dirs,
                   _params(density=rho, sun_boost=1.0, ambient=0.25),
                   sun_color=(2.0, 1.0, 0.5))
        t = np.exp(-rho * d)
        c = np.asarray([2.0, 1.0, 0.5]) * (1.0 + 0.25)
        expect = 0.8 * t + (1.0 - t) * c
        np.testing.assert_allclose(
            out[..., :3], np.broadcast_to(expect, out[..., :3].shape),
            rtol=1e-5,
        )
        np.testing.assert_allclose(out[..., 3], 1.0, atol=1e-6)

    def test_sky_marches_to_max_dist(self):
        """Background pixels (depth 0) integrate to ``max_dist``."""
        rho = 0.01
        hdr, pos, depth, cam, dirs = _flat_inputs(color=0.0)
        depth[:] = 0.0
        out = _run(hdr, pos, depth, cam, dirs,
                   _params(density=rho, max_dist=200.0))
        t = np.exp(-rho * 200.0)
        np.testing.assert_allclose(out[..., :3], 1.0 - t, rtol=1e-5)

    def test_height_falloff_thins_fog_aloft(self):
        """The same ray at altitude 100 with a 10-unit falloff sees
        ~e^{-10} of the ground density — visibly less in-scatter."""
        hdr, pos, depth, cam, dirs = _flat_inputs(color=0.0)
        lo = _run(hdr, pos, depth, cam, dirs,
                  _params(density=0.02, height=0.0, falloff=10.0))
        cam_hi = np.asarray([0.0, 0.0, 100.0], np.float32)
        pos_hi = pos.copy()
        pos_hi[..., 2] = 100.0
        hi = _run(hdr, pos_hi, depth, cam_hi, dirs,
                  _params(density=0.02, height=0.0, falloff=10.0))
        assert lo[..., :3].mean() > 10 * hi[..., :3].mean()

    def test_anisotropy_brightens_toward_sun(self):
        """g > 0: looking INTO the sun in-scatters more than away."""
        hdr, pos, depth, cam, dirs = _flat_inputs(color=0.0)
        toward = _run(hdr, pos, depth, cam, dirs,
                      _params(density=0.01, g=0.5), sun_dir=(0.0, 1.0, 0.0))
        away = _run(hdr, pos, depth, cam, dirs,
                    _params(density=0.01, g=0.5), sun_dir=(0.0, -1.0, 0.0))
        assert toward[..., :3].mean() > 3 * away[..., :3].mean()

    def test_shadow_map_gates_shafts(self):
        """A fully-occluding map (stored depth 1, reverse-Z nearest) kills
        the sun term; ambient in-scatter survives. A fully-open map
        (stored 0) matches the no-map result."""
        hdr, pos, depth, cam, dirs = _flat_inputs(color=0.0)
        # Light VP: constant clip (0, 0, 0.5, 1) → uv (0.5, 0.5), inside.
        lvp = np.zeros((4, 4), np.float32)
        lvp[2, 3] = 0.5
        lvp[3, 3] = 1.0
        p = _params(density=0.01, sun_boost=1.0, ambient=0.2)
        open_map = _run(hdr, pos, depth, cam, dirs, p,
                        shadow_map=jnp.zeros((8, 8), jnp.float32),
                        light_vp=jnp.asarray(lvp))
        blocked = _run(hdr, pos, depth, cam, dirs, p,
                       shadow_map=jnp.ones((8, 8), jnp.float32),
                       light_vp=jnp.asarray(lvp))
        nomap = _run(hdr, pos, depth, cam, dirs, p)
        np.testing.assert_allclose(open_map, nomap, atol=1e-6)
        t = np.exp(-0.01 * 50.0)
        np.testing.assert_allclose(blocked[..., :3], (1 - t) * 0.2,
                                   rtol=1e-5)

    def test_alpha_passthrough(self):
        hdr, pos, depth, cam, dirs = _flat_inputs()
        hdr[..., 3] = 0.42
        out = _run(hdr, pos, depth, cam, dirs, _params())
        np.testing.assert_allclose(out[..., 3], 0.42, atol=1e-6)


class _FakeCam:
    def __init__(self, inv_vp, loc):
        self.render_inv_view_projection = inv_vp
        self.location = loc


class TestSPMD:
    def test_fog_node_sharded_matches_single(self, cpu_devices):
        """The fog node under CompileOptions(mesh): only the shadow map
        gathers full; screen math stays on the band; the jitter hash uses
        global rows — output matches single-device exactly."""
        from zenith.parallel.sharding import default_mesh
        from zenith.renderer.volumetric import VolumetricFog
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import Format, PipelineCache, RhiCore, TextureDesc

        core = RhiCore()
        device = core.create_render_device()
        h2, w2 = 128, 64
        # A real perspective-ish camera: inv VP mapping NDC to world rays.
        from zenith.core.camera import Camera
        from zenith.core.mathtypes import Degree, Radians

        real = Camera(fov_y=Degree(40.0), aspect_ratio=w2 / h2)
        real.set_position(np.array([0.0, -60.0, 20.0], np.float32))
        real.set_yaw_pitch(Radians(0.0), Radians(-0.2))
        cam = _FakeCam(
            np.asarray(real.render_inv_view_projection, np.float32),
            np.asarray(real.location, np.float32),
        )
        lvp = np.zeros((4, 4), np.float32)
        lvp[0, 0] = 0.01
        lvp[1, 1] = 0.01
        lvp[2, 3] = 0.5
        lvp[3, 3] = 1.0

        def run(options):
            fog = VolumetricFog(density=0.01, anisotropy=0.4, steps=12)
            builder = RenderGraphBuilder()
            builder.set_dynamic("def.light_vp", lvp)
            builder.set_dynamic("def.shadow_bias", np.float32(0.001))
            hdr = builder.create(TextureDesc.color("hdr", w2, h2))
            gpos = builder.create(TextureDesc.color("gpos", w2, h2))
            gdep = builder.create(TextureDesc.depth("gdep", w2, h2))
            sm = builder.create(TextureDesc.depth("sm", 32, 32))
            out = builder.create(TextureDesc.color("fog.out", w2, h2))

            gen = builder.add_lambda_node("gen")
            hdr_w = gen.write(hdr)
            p_w = gen.write(gpos)
            d_w = gen.write(gdep)
            sm_w = gen.write(sm)

            def record_gen(ctx):
                bh = h2 // ctx.num_shards
                row0 = 0
                if ctx.sharded:
                    row0 = jax.lax.axis_index(ctx.shard_axis) * bh
                rows = (row0 + jnp.arange(bh, dtype=jnp.float32))[:, None]
                cols = jnp.arange(w2, dtype=jnp.float32)[None, :]
                base = 0.2 + 0.4 * jnp.sin(rows * 0.2) * jnp.cos(cols * 0.13)
                base = jnp.broadcast_to(base, (bh, w2))
                ctx.set(hdr_w, jnp.stack(
                    [base, base * 0.5, 1.0 - base, jnp.ones_like(base)], -1
                ))
                wx = jnp.broadcast_to((cols - w2 / 2) * 1.5, (bh, w2))
                wy = jnp.broadcast_to(rows * 0.0 + 40.0, (bh, w2))
                wz = jnp.broadcast_to((rows - h2 / 2) * -0.5, (bh, w2))
                ctx.set(p_w, jnp.stack(
                    [wx, wy, wz, jnp.zeros_like(wx)], -1
                ))
                ctx.set(d_w, jnp.full((bh, w2), 0.5, jnp.float32))
                if ctx.sharded:
                    # The map is its own (small) surface: bands of rows.
                    bsm = 32 // ctx.num_shards
                    r0 = jax.lax.axis_index(ctx.shard_axis) * bsm
                    rr = (r0 + jnp.arange(bsm, dtype=jnp.float32))[:, None]
                    ctx.set(sm_w, jnp.broadcast_to(
                        (rr > 16.0).astype(jnp.float32), (bsm, 32)
                    ))
                else:
                    rr = jnp.arange(32, dtype=jnp.float32)[:, None]
                    ctx.set(sm_w, jnp.broadcast_to(
                        (rr > 16.0).astype(jnp.float32), (32, 32)
                    ))

            gen.execute(record_gen)
            fog.render_to(builder, hdr, out, cam,
                          {"pos": gpos, "depth": gdep, "sun_shadow": sm},
                          sun=None)
            builder.export(out)
            builder.export(hdr)
            compiled = builder.build().compile(
                device, PipelineCache(), options
            )
            compiled.execute(device)
            return np.asarray(compiled.value(out)), np.asarray(
                compiled.value(hdr)
            )

        img1, src1 = run(CompileOptions(tile_h=8, tile_w=64))
        mesh = default_mesh(8, backend="cpu")
        img8, _ = run(CompileOptions(tile_h=8, tile_w=64, mesh=mesh))
        assert np.abs(img1[..., :3] - src1[..., :3]).max() > 1e-3
        np.testing.assert_allclose(img8, img1, atol=1e-5)


class TestScene:
    def test_scene_fog_one_program_and_finite(self):
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
            argv=["--", "--mode", "deferred", "--lights", "4", "--fog"],
            window=window,
            max_frames=4,
        )
        assert frame_program_cache_size() == 1
        frame = np.asarray(window.last_frame)
        assert np.isfinite(frame.astype(np.float64)).all()
        assert frame[..., :3].std() > 1.0
