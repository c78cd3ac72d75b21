"""Depth of field: CoC level blend analytics + SPMD parity."""

import jax
import jax.numpy as jnp
import numpy as np

from zenith.renderer.dof import DepthOfField, dof_blend

H, W = 64, 128


def _pattern():
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    r = 0.5 + 0.5 * np.sin(xs * 0.9)  # high-frequency stripes
    img = np.stack([r, 1.0 - r, r * 0.5, np.ones_like(r)], -1)
    return img.astype(np.float32)


class TestBlend:
    def test_in_focus_is_untouched(self):
        hdr = _pattern()
        dist = np.full((H, W), 100.0, np.float32)
        params = jnp.asarray([100.0, 20.0, 1.5, 0.0])  # focused at 100
        out = np.asarray(dof_blend(jnp.asarray(hdr), jnp.asarray(dist),
                                   params))
        np.testing.assert_allclose(out, hdr, atol=1e-5)

    def test_defocus_blurs_high_frequencies(self):
        hdr = _pattern()
        dist = np.full((H, W), 100.0, np.float32)
        params = jnp.asarray([10.0, 5.0, 1.5, 0.0])  # focused far nearer
        out = np.asarray(dof_blend(jnp.asarray(hdr), jnp.asarray(dist),
                                   params))
        # The stripes' contrast collapses under the deep pyramid levels.
        assert out[..., 0].std() < 0.35 * hdr[..., 0].std()

    def test_sky_focuses_at_infinity(self):
        hdr = _pattern()
        dist = np.zeros((H, W), np.float32)  # all background
        # Focused near → sky (infinity) should be maximally defocused.
        params = jnp.asarray([10.0, 5.0, 1.5, 0.0])
        out = np.asarray(dof_blend(jnp.asarray(hdr), jnp.asarray(dist),
                                   params))
        assert out[..., 0].std() < 0.35 * hdr[..., 0].std()

    def test_tent_weights_partition_energy(self):
        """Uniform-color input must stay uniform at ANY lod (weights sum
        to 1 — no brightness pumping as focus racks)."""
        hdr = np.full((H, W, 4), 0.6, np.float32)
        for focus in (5.0, 50.0, 100.0, 400.0):
            dist = np.full((H, W), 100.0, np.float32)
            out = np.asarray(dof_blend(
                jnp.asarray(hdr), jnp.asarray(dist),
                jnp.asarray([focus, 10.0, 1.5, 0.0]),
            ))
            np.testing.assert_allclose(out[..., :3], 0.6, atol=1e-4)


class TestSPMD:
    def test_banded_matches_single(self, cpu_devices):
        from zenith.parallel.sharding import default_mesh
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import Format, PipelineCache, RhiCore, TextureDesc

        core = RhiCore()
        device = core.create_render_device()
        h2, w2 = 256, 128

        def run(options):
            dof = DepthOfField(focus_distance=20.0, focal_range=5.0,
                               strength=1.5)
            builder = RenderGraphBuilder()
            hdr = builder.create(TextureDesc.color("hdr", w2, h2))
            gpos = builder.create(TextureDesc.color("gpos", w2, h2))
            gdep = builder.create(TextureDesc.depth("gdep", w2, h2))
            out = builder.create(TextureDesc.color("out", w2, h2))
            builder.export(out)
            builder.set_dynamic("def.camera_pos",
                                np.zeros(3, np.float32))

            gen = builder.add_lambda_node("gen")
            hdr_w = gen.write(hdr)
            p_w = gen.write(gpos)
            d_w = gen.write(gdep)

            def record_gen(ctx):
                bh = h2 // ctx.num_shards
                row0 = 0
                if ctx.sharded:
                    row0 = jax.lax.axis_index(ctx.shard_axis) * bh
                rows = row0 + jnp.arange(bh, dtype=jnp.float32)[:, None]
                cols = jnp.arange(w2, dtype=jnp.float32)[None, :]
                base = 0.5 + 0.5 * jnp.sin(cols * 0.8) * jnp.cos(rows * 0.3)
                ctx.set(hdr_w, jnp.stack(
                    [base, 1.0 - base, base, jnp.ones_like(base)], -1
                ))
                # Distance ramps with global row → the blur varies by row.
                dd = 5.0 + jnp.broadcast_to(rows * 0.4, (bh, w2))
                ctx.set(p_w, jnp.stack(
                    [dd, jnp.zeros_like(dd), jnp.zeros_like(dd),
                     jnp.zeros_like(dd)], -1
                ))
                ctx.set(d_w, jnp.full((bh, w2), 0.5, jnp.float32))

            gen.execute(record_gen)
            dof.render_to(builder, hdr, out,
                          {"pos": gpos, "depth": gdep})
            compiled = builder.build().compile(
                device, PipelineCache(), options
            )
            compiled.execute(device)
            return np.asarray(compiled.value(out))

        img1 = run(CompileOptions(tile_h=8, tile_w=128))
        mesh = default_mesh(8, backend="cpu")
        img8 = run(CompileOptions(tile_h=8, tile_w=128, mesh=mesh))
        assert img1[..., :3].std() > 0.01
        np.testing.assert_allclose(img8, img1, atol=1e-5)
