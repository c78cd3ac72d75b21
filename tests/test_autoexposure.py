"""Auto-exposure: log-average metering, temporal adaptation, device-resident
feedback, SPMD pmean consistency."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zenith.renderer import PostProcess
from zenith.rendergraph import CompileOptions, RenderGraphBuilder
from zenith.rendergraph.graph import clear_frame_program_cache, \
    frame_program_cache_size
from zenith.rhi import PipelineCache, RhiCore, TextureDesc

H, W = 64, 128


def _run_frame(device, post, lum, options=CompileOptions(tile_h=8)):
    """One frame: a gen node writes a uniform gray HDR plane of luminance
    ``lum`` (a dynamic — brightness changes never recompile), post meters
    and tonemaps it. Returns (output image, adapted exposure array)."""
    builder = RenderGraphBuilder()
    hdr = builder.create(TextureDesc.color("hdr", W, H))
    out = builder.create(TextureDesc.color("out", W, H))
    builder.export(out)
    builder.set_dynamic("lum", np.float32(lum))

    gen = builder.add_lambda_node("gen")
    hdr_w = gen.write(hdr)

    def record_gen(ctx):
        g = ctx.dynamic("lum")
        bh = H // ctx.num_shards
        plane = jnp.full((bh, W), 1.0, jnp.float32) * g
        ctx.set(hdr_w, jnp.stack(
            [plane, plane, plane, jnp.ones_like(plane)], -1
        ))

    gen.execute(record_gen)
    post.render_to(builder, hdr, out)
    compiled = builder.build().compile(device, PipelineCache(), options)
    compiled.execute(device)
    return (
        np.asarray(compiled.value(out)),
        compiled.value(post.exposure_out),
    )


class TestAdaptation:
    def test_meters_toward_key_and_applies(self):
        core = RhiCore()
        device = core.create_render_device()
        post = PostProcess(auto_exposure=True)
        post.set_delta_time(0.5)  # adaptation step k = 1 - e^(-0.75)
        k = 1.0 - np.exp(-0.5 * post.adapt_speed)
        clear_frame_program_cache()

        # Frame 0 (no history): exposure snaps to key / L.
        img0, e0 = _run_frame(device, post, 0.02)
        assert np.asarray(e0).shape == (1,)
        np.testing.assert_allclose(np.asarray(e0)[0], 0.18 / 0.0201,
                                   rtol=1e-3)  # metering eps: log(L+1e-4)
        post.feedback(e0)

        # Frame 1, same luminance: already adapted — no drift.
        img1, e1 = _run_frame(device, post, 0.02)
        np.testing.assert_allclose(np.asarray(e1)[0], np.asarray(e0)[0],
                                   rtol=1e-5)
        post.feedback(e1)

        # Frame 2: scene steps 90x brighter; exposure moves a fraction k
        # toward the new target (temporal smoothing, not a snap).
        img2, e2 = _run_frame(device, post, 1.8)
        e1v = float(np.asarray(e1)[0])
        expect = e1v + (0.18 / 1.8001 - e1v) * k
        np.testing.assert_allclose(np.asarray(e2)[0], expect, rtol=1e-3)
        # The over-exposed transition frame is brighter than the adapted
        # dark frame (exposure hasn't caught down to the bright scene yet).
        assert img2[..., :3].mean() > img1[..., :3].mean()

        # Brightness changes + valid-flag flip never recompiled: ONE program.
        assert frame_program_cache_size() == 1

    def test_exposure_actually_scales_output(self):
        core = RhiCore()
        device = core.create_render_device()
        on = PostProcess(auto_exposure=True)
        off = PostProcess(auto_exposure=False)
        dark, _ = _run_frame(device, on, 0.02)
        dark_off = _run_frame_no_ae(device, off, 0.02)
        # Metered dark scene is pushed toward mid-gray; unmetered stays dark.
        assert dark[..., :3].mean() > 3.0 * dark_off[..., :3].mean()

    def test_mip_chain_path(self):
        """bloom_mips >= 2: exposure rides the bright-pass node and the
        combine node reads it back through the (1,) buffer."""
        core = RhiCore()
        device = core.create_render_device()
        post = PostProcess(auto_exposure=True, bloom_mips=2)
        img0, e0 = _run_frame(device, post, 0.02)
        np.testing.assert_allclose(np.asarray(e0)[0], 0.18 / 0.0201,
                                   rtol=1e-3)
        post.feedback(e0)
        img1, e1 = _run_frame(device, post, 0.02)
        np.testing.assert_allclose(np.asarray(e1)[0], np.asarray(e0)[0],
                                   rtol=1e-5)
        assert img0[..., :3].mean() > 0.1  # metering applied


def _run_frame_no_ae(device, post, lum):
    """_run_frame for an AE-less PostProcess (no exposure_out to read)."""
    builder = RenderGraphBuilder()
    hdr = builder.create(TextureDesc.color("hdr", W, H))
    out = builder.create(TextureDesc.color("out", W, H))
    builder.export(out)
    builder.set_dynamic("lum", np.float32(lum))

    gen = builder.add_lambda_node("gen")
    hdr_w = gen.write(hdr)

    def record_gen(ctx):
        g = ctx.dynamic("lum")
        bh = H // ctx.num_shards
        plane = jnp.full((bh, W), 1.0, jnp.float32) * g
        ctx.set(hdr_w, jnp.stack(
            [plane, plane, plane, jnp.ones_like(plane)], -1
        ))

    gen.execute(record_gen)
    post.render_to(builder, hdr, out)
    compiled = builder.build().compile(
        device, PipelineCache(), CompileOptions(tile_h=8)
    )
    compiled.execute(device)
    return np.asarray(compiled.value(out))


class TestSPMD:
    def test_sharded_metering_matches_single(self, cpu_devices):
        """The banded post node pmeans the log-average so every band adapts
        identically; output and exposure match single-device bit-for-bit
        (within fp tolerance)."""
        from zenith.parallel.sharding import default_mesh

        core = RhiCore()
        device = core.create_render_device()

        def run(options):
            post = PostProcess(auto_exposure=True)
            builder = RenderGraphBuilder()
            h2, w2 = 256, 128
            hdr = builder.create(TextureDesc.color("hdr", w2, h2))
            out = builder.create(TextureDesc.color("out", w2, h2))
            builder.export(out)
            gen = builder.add_lambda_node("gen")
            hdr_w = gen.write(hdr)

            def record_gen(ctx):
                bh = h2 // ctx.num_shards
                row0 = 0
                if ctx.sharded:
                    row0 = jax.lax.axis_index(ctx.shard_axis) * bh
                rows = row0 + jnp.arange(bh, dtype=jnp.float32)[:, None]
                cols = jnp.arange(w2, dtype=jnp.float32)[None, :]
                base = 0.05 + 2.0 * jnp.exp(
                    -((rows - 97.0) ** 2 + (cols - 41.0) ** 2) / 900.0
                )
                ctx.set(hdr_w, jnp.stack(
                    [base, base * 0.6, base * 0.3, jnp.ones_like(base)], -1
                ))

            gen.execute(record_gen)
            post.render_to(builder, hdr, out)
            compiled = builder.build().compile(
                device, PipelineCache(), options
            )
            compiled.execute(device)
            return (
                np.asarray(compiled.value(out)),
                np.asarray(compiled.value(post.exposure_out)),
            )

        img1, e1 = run(CompileOptions(tile_h=8, tile_w=128))
        mesh = default_mesh(8, backend="cpu")
        img8, e8 = run(CompileOptions(tile_h=8, tile_w=128, mesh=mesh))
        np.testing.assert_allclose(e8, e1, rtol=1e-5)
        np.testing.assert_allclose(img8, img1, atol=1e-5)
