"""Lens flare (renderer.flare): procedural ghosts/halo/streak over HDR,
host sun projection, and the HDR occlusion probe."""

import jax.numpy as jnp
import numpy as np
import pytest

from zenith.core.camera import Camera
from zenith.core.mathtypes import Degree, Radians
from zenith.renderer import LensFlare
from zenith.renderer.flare import _apply_flare, _probe_visibility

W, H = 128, 64


def make_camera():
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -60.0, 25.0], np.float32))
    cam.set_yaw_pitch(Radians(0.0), Radians(0.0))
    return cam


class TestSunDynamics:
    def test_sun_ahead_projects_into_frame(self):
        cam = make_camera()
        # Camera at yaw 0 looks along +y (z-up world); sun ahead.
        d = LensFlare().sun_dynamics(cam, (0.0, 1.0, 0.0))
        uv, vis = d["flare.sun_uv"], d["flare.vis"]
        np.testing.assert_allclose(uv, [0.5, 0.5], atol=1e-3)
        assert vis == pytest.approx(1.0)

    def test_sun_behind_is_invisible(self):
        cam = make_camera()
        d = LensFlare().sun_dynamics(cam, (0.0, -1.0, 0.0))
        assert d["flare.vis"] == 0.0

    def test_offscreen_sun_fades(self):
        cam = make_camera()
        # Well off to the side but still in the front hemisphere.
        d = LensFlare().sun_dynamics(cam, (5.0, 1.0, 0.0))
        assert 0.0 <= d["flare.vis"] < 1.0


class TestApply:
    def test_adds_energy_when_visible_only(self):
        rgb = jnp.full((H, W, 3), 0.1, jnp.float32)
        uv = jnp.asarray([0.3, 0.4], jnp.float32)
        cfg = LensFlare(occlusion=False)
        lit = _apply_flare(rgb, uv, jnp.float32(1.0),
                           np.ones(3, np.float32), cfg, 0, H)
        dark = _apply_flare(rgb, uv, jnp.float32(0.0),
                            np.ones(3, np.float32), cfg, 0, H)
        assert float(jnp.sum(lit)) > float(jnp.sum(rgb)) + 0.5
        np.testing.assert_allclose(np.asarray(dark), np.asarray(rgb))

    def test_streak_brightest_on_sun_row(self):
        rgb = jnp.zeros((H, W, 3), jnp.float32)
        uv = jnp.asarray([0.5, 0.25], jnp.float32)
        cfg = LensFlare(occlusion=False, intensity=1.0)
        out = np.asarray(_apply_flare(rgb, uv, jnp.float32(1.0),
                                      np.ones(3, np.float32), cfg, 0, H))
        # Sample a column band far from the ghost axis (ghosts march down
        # the sun→center line at x=0.5) so only the streak contributes.
        row_energy = out[:, int(0.85 * W):int(0.95 * W)].sum(axis=(1, 2))
        assert abs(int(row_energy.argmax()) - H // 4) <= 1

    def test_banded_matches_full(self):
        """Row-banded evaluation (row0/full_h) tiles to the full image."""
        rgb = jnp.full((H, W, 3), 0.05, jnp.float32)
        uv = jnp.asarray([0.62, 0.37], jnp.float32)
        cfg = LensFlare(occlusion=False)
        full = np.asarray(_apply_flare(rgb, uv, jnp.float32(1.0),
                                       np.ones(3, np.float32), cfg, 0, H))
        bh = H // 4
        bands = [
            np.asarray(_apply_flare(rgb[k * bh:(k + 1) * bh], uv,
                                    jnp.float32(1.0), np.ones(3, np.float32),
                                    cfg, k * bh, H))
            for k in range(4)
        ]
        np.testing.assert_allclose(np.concatenate(bands), full, atol=1e-6)


class TestProbe:
    def test_bright_sky_passes_dark_occluder_blocks(self):
        cfg = LensFlare()
        uv = jnp.asarray([0.75, 0.25], jnp.float32)
        bright = jnp.full((H, W, 3), 2.0, jnp.float32)
        dark = jnp.full((H, W, 3), 0.02, jnp.float32)
        assert float(_probe_visibility(bright, uv, cfg)) == pytest.approx(1.0)
        assert float(_probe_visibility(dark, uv, cfg)) == pytest.approx(0.0)

    def test_probe_clamps_at_edges(self):
        cfg = LensFlare()
        img = jnp.full((H, W, 3), 2.0, jnp.float32)
        for uv in ([0.0, 0.0], [1.0, 1.0], [1.2, -0.1]):
            v = float(_probe_visibility(img, jnp.asarray(uv, jnp.float32), cfg))
            assert v == pytest.approx(1.0)


class TestSPMD:
    def test_flare_sharded_matches_single(self, cpu_devices):
        """Flare under CompileOptions(mesh): lobes are evaluated per band
        with global row coordinates, and the occlusion probe gathers the
        FULL image (the sun window can live in another band) — output
        matches single-device exactly."""
        import jax

        from zenith.parallel.sharding import default_mesh
        from zenith.rendergraph import RenderGraphBuilder
        from zenith.rendergraph.graph import CompileOptions
        from zenith.rhi import PipelineCache, RhiCore, TextureDesc

        device = RhiCore().create_render_device()
        # Sun near the TOP band; with 8 shards its probe window is far
        # from most bands, so get_full is load-bearing.
        sun_uv = np.asarray([0.7, 0.08], np.float32)

        def run(options):
            flare = LensFlare()  # occlusion ON
            builder = RenderGraphBuilder()
            hdr = builder.create(TextureDesc.color("hdr", W, H))
            gen = builder.add_lambda_node("gen")
            dst = gen.write(hdr)

            def record_gen(ctx):
                bh = H // ctx.num_shards
                row0 = 0
                if ctx.sharded:
                    row0 = jax.lax.axis_index(ctx.shard_axis) * bh
                rows = (row0 + jnp.arange(bh, dtype=jnp.float32))[:, None]
                cols = jnp.arange(W, dtype=jnp.float32)[None, :]
                # Dim scene + a bright sky patch around the sun pixel.
                base = 0.05 + 0.02 * jnp.sin(rows * 0.3) * jnp.cos(cols * 0.2)
                sun_d2 = ((cols - sun_uv[0] * W) ** 2
                          + (rows - sun_uv[1] * H) ** 2)
                bright = 3.0 * jnp.exp(-sun_d2 / 40.0)
                c = jnp.broadcast_to(base + bright, (bh, W))
                ctx.set(dst, jnp.stack(
                    [c, c * 0.9, c * 0.8, jnp.ones_like(c)], -1
                ))

            gen.execute(record_gen)
            builder.set_dynamic("flare.sun_uv", sun_uv)
            builder.set_dynamic("flare.vis", np.float32(1.0))
            flare.render_to(builder, hdr)
            builder.export(hdr)
            compiled = builder.build().compile(
                device, PipelineCache(), options
            )
            compiled.execute(device)
            return np.asarray(compiled.value(hdr))

        img1 = run(CompileOptions(tile_h=8, tile_w=128))
        mesh = default_mesh(8, backend="cpu")
        img8 = run(CompileOptions(tile_h=8, tile_w=128, mesh=mesh))
        # The flare actually fired (probe saw the bright sun patch).
        assert img8[..., :3].sum() > 0.0
        np.testing.assert_allclose(img8, img1, atol=1e-5)


class TestGraphNode:
    def test_flare_node_in_graph(self):
        """The flare node traces into a frame program and brightens the
        HDR image near the streak row."""
        from zenith.rendergraph import RenderGraphBuilder
        from zenith.rendergraph.graph import CompileOptions
        from zenith.rhi import PipelineCache, RhiCore, TextureDesc

        device = RhiCore().create_render_device()
        flare = LensFlare(occlusion=False)
        builder = RenderGraphBuilder()
        hdr = builder.create(TextureDesc.color("hdr", W, H))
        node = builder.add_lambda_node("fill")
        dst = node.write(hdr)

        def fill(ctx):
            ctx.set(dst, jnp.full((H, W, 4), 0.1, jnp.float32))

        node.execute(fill)
        builder.set_dynamic("flare.sun_uv",
                            np.asarray([0.5, 0.3], np.float32))
        builder.set_dynamic("flare.vis", np.float32(1.0))
        flare.render_to(builder, hdr)
        builder.export(hdr)
        compiled = builder.build().compile(
            device, PipelineCache(), CompileOptions(tile_h=8, tile_w=128)
        )
        compiled.execute(device)
        out = np.asarray(compiled.value(hdr))
        assert out[..., :3].sum() > 0.1 * H * W * 3 + 0.5
        assert np.all(out[..., 3] == out[0, 0, 3])  # alpha untouched
