"""Film effects (renderer.post.FilmEffects): chromatic aberration,
CAS-style sharpen, animated grain — and their SPMD routing."""

import numpy as np
import pytest

import jax.numpy as jnp

from zenith.renderer.post import FilmEffects, apply_film

H, W = 64, 128


def pack(ca=0.0, sharpen=0.0, grain=0.0, seed=3.0, response=0.8):
    return jnp.asarray([ca, sharpen, grain, seed, response], jnp.float32)


class TestChromaticAberration:
    def test_fringes_at_corner_not_center(self):
        """A white square at the corner grows R/B fringes; one at the
        center (zero radius) stays neutral."""
        img = np.zeros((H, W, 3), np.float32)
        img[4:12, 4:12] = 1.0  # corner patch
        ch, cw = H // 2, W // 2
        img[ch - 4:ch + 4, cw - 4:cw + 4] = 1.0  # center patch
        out = np.asarray(apply_film(jnp.asarray(img), pack(ca=4.0), True))
        fringe = np.abs(out[..., 0] - out[..., 2])
        corner = fringe[:16, :16].max()
        center = fringe[ch - 6:ch + 6, cw - 6:cw + 6].max()
        assert corner > 0.2
        assert center < 0.02

    def test_zero_strength_is_identity(self):
        rng = np.random.default_rng(0)
        img = rng.random((H, W, 3)).astype(np.float32)
        out = np.asarray(apply_film(jnp.asarray(img), pack(ca=0.0), True))
        np.testing.assert_allclose(out, img, atol=1e-6)


class TestSharpen:
    def test_increases_edge_contrast(self):
        img = np.full((H, W, 3), 0.5, np.float32)
        img[:, W // 2:] = 0.2
        out = np.asarray(apply_film(jnp.asarray(img), pack(sharpen=0.8),
                                    False))
        col_l, col_r = W // 2 - 1, W // 2
        # Overshoot on the bright side, undershoot on the dark side.
        assert out[10, col_l, 0] > 0.5 + 0.05
        assert out[10, col_r, 0] < 0.2 - 0.03
        # Flat regions untouched.
        np.testing.assert_allclose(out[10, 5], 0.5, atol=1e-5)

    def test_clips_to_ldr_range(self):
        img = np.zeros((H, W, 3), np.float32)
        img[:, ::2] = 1.0
        out = np.asarray(apply_film(jnp.asarray(img), pack(sharpen=3.0),
                                    False))
        assert out.min() >= 0.0 and out.max() <= 1.0


class TestGrain:
    def test_deterministic_per_seed_and_animated_across_seeds(self):
        img = jnp.full((H, W, 3), 0.4, jnp.float32)
        a = np.asarray(apply_film(img, pack(grain=0.1, seed=5.0), False))
        b = np.asarray(apply_film(img, pack(grain=0.1, seed=5.0), False))
        c = np.asarray(apply_film(img, pack(grain=0.1, seed=6.0), False))
        np.testing.assert_array_equal(a, b)
        assert np.abs(a - c).max() > 0.01
        assert a.std() > 0.01  # noise actually present

    def test_response_fades_grain_in_highlights(self):
        dark = jnp.full((H, W, 3), 0.15, jnp.float32)
        bright = jnp.full((H, W, 3), 1.0, jnp.float32)
        p = pack(grain=0.1, response=1.0)
        gd = np.asarray(apply_film(dark, p, False)) - 0.15
        gb = np.asarray(apply_film(bright, p, False)) - 1.0
        assert gd.std() > 5 * max(gb.std(), 1e-6)

    def test_global_rows_make_bands_tile(self):
        """row0/full_h: evaluating the surface in bands reproduces the
        full-surface grain exactly (the SPMD halo-path contract)."""
        img = jnp.full((H, W, 3), 0.3, jnp.float32)
        p = pack(grain=0.08, sharpen=0.2)
        full = np.asarray(apply_film(img, p, False))
        bh = H // 4
        bands = [
            np.asarray(apply_film(img[k * bh:(k + 1) * bh], p, False,
                                  row0=k * bh, full_h=H))
            for k in range(4)
        ]
        np.testing.assert_allclose(np.concatenate(bands), full, atol=1e-6)


class TestConfig:
    def test_pack_advances_seed(self):
        f = FilmEffects(grain=0.05)
        s0 = f.pack()[3]
        s1 = f.pack()[3]
        assert s0 != s1

    def test_capture_key_tracks_ca_enablement_only(self):
        a = FilmEffects(sharpen=0.5, grain=0.1)
        b = FilmEffects(sharpen=0.1, grain=0.0)
        c = FilmEffects(chromatic_aberration=2.0)
        assert a.__zenith_capture_key__() == b.__zenith_capture_key__()
        assert a.__zenith_capture_key__() != c.__zenith_capture_key__()


class TestGraph:
    def _run(self, options, film, seed=7):
        import jax

        from zenith.renderer.post import PostProcess
        from zenith.rendergraph import RenderGraphBuilder
        from zenith.rendergraph.graph import CompileOptions
        from zenith.rhi import PipelineCache, RhiCore, TextureDesc

        device = RhiCore().create_render_device()
        post = PostProcess(film=film)
        builder = RenderGraphBuilder()
        hdr = builder.create(TextureDesc.color("hdr", W, H))
        out = builder.create(TextureDesc.color("ldr", W, H))
        gen = builder.add_lambda_node("gen")
        dst = gen.write(hdr)

        def record_gen(ctx):
            bh = H // ctx.num_shards
            row0 = 0
            if ctx.sharded:
                row0 = jax.lax.axis_index(ctx.shard_axis) * bh
            rows = (row0 + jnp.arange(bh, dtype=jnp.float32))[:, None]
            cols = jnp.arange(W, dtype=jnp.float32)[None, :]
            c = 0.3 + 0.5 * jnp.sin(rows * 0.4) * jnp.cos(cols * 0.1)
            c = jnp.broadcast_to(jnp.maximum(c, 0.0), (bh, W))
            ctx.set(dst, jnp.stack(
                [c, c * 0.8, 1.0 - c * 0.5, jnp.ones_like(c)], -1
            ))

        gen.execute(record_gen)
        post.render_to(builder, hdr, out)
        builder.export(out)
        compiled = builder.build().compile(device, PipelineCache(), options)
        compiled.execute(device)
        return np.asarray(compiled.value(out))

    def test_film_changes_output_single_chip(self):
        from zenith.rendergraph.graph import CompileOptions

        base = self._run(CompileOptions(tile_h=8, tile_w=128), None)
        f = FilmEffects(chromatic_aberration=3.0, sharpen=0.5, grain=0.04)
        f._seed = 41
        filmed = self._run(CompileOptions(tile_h=8, tile_w=128), f)
        assert np.abs(filmed - base)[..., :3].max() > 0.01
        assert np.isfinite(filmed).all()

    def test_spmd_ca_matches_single_device(self, cpu_devices):
        """CA forces the gather-full path under a mesh; output matches the
        single-device image exactly."""
        from zenith.parallel.sharding import default_mesh
        from zenith.rendergraph.graph import CompileOptions

        def film():
            f = FilmEffects(chromatic_aberration=3.0, sharpen=0.4,
                            grain=0.03)
            f._seed = 100  # same seed both runs (pack advances it)
            return f

        img1 = self._run(CompileOptions(tile_h=8, tile_w=128), film())
        mesh = default_mesh(8, backend="cpu")
        img8 = self._run(CompileOptions(tile_h=8, tile_w=128, mesh=mesh),
                         film())
        np.testing.assert_allclose(img8, img1, atol=1e-5)

    def test_spmd_halo_path_matches_single_device(self, cpu_devices):
        """No CA: the halo path carries sharpen+grain; global-row grain
        keeps bands identical to single-chip."""
        from zenith.parallel.sharding import default_mesh
        from zenith.rendergraph.graph import CompileOptions

        def film():
            f = FilmEffects(sharpen=0.5, grain=0.05)
            f._seed = 7
            return f

        img1 = self._run(CompileOptions(tile_h=8, tile_w=128), film())
        mesh = default_mesh(8, backend="cpu")
        img8 = self._run(CompileOptions(tile_h=8, tile_w=128, mesh=mesh),
                         film())
        np.testing.assert_allclose(img8, img1, atol=1e-5)
