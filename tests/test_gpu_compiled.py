"""Compiled-on-GPU pixel verification.

Every other test exercises the Pallas kernels in interpreter mode; these run
the SAME frames compiled through Triton on the card and diff them against
the interpreter and the NumPy oracle — the kernels are verified where they
ship, not just where they are convenient to run.

Marked ``gpu``: run with ``python -m pytest tests/ -m gpu --gpu -p no:xdist``
on a machine with a GPU; elsewhere the ``gpu_device`` fixture skips them.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from np_reference import render_reference

W, H = 256, 64

pytestmark = pytest.mark.gpu


def render_frame(interpret: bool, device):
    """One deterministic multi-triangle frame through draw_indexed."""
    from zenith.ops import TileGrid, clear_color, clear_depth, draw_indexed
    from zenith.rhi import (
        ColorAttachmentDesc,
        CullMode,
        Format,
        GraphicPipelineAttachments,
        GraphicPipelineDesc,
        GraphicShaderInput,
        PipelineCache,
        RasterizationState,
        Shader,
        VertexLayout,
    )
    from zenith.rhi.state import DepthStencilDesc, GraphicPipelineState

    def vs(attrs, res):
        p = attrs["position"]
        return {
            "position": jnp.concatenate(
                [p, jnp.ones((p.shape[0], 1), jnp.float32)], 1
            ),
            "color": attrs["color"],
        }

    def fs(varyings, res, builtins):
        c = varyings["color"]
        return jnp.concatenate([c, jnp.ones_like(c[..., :1])], -1)

    layout = VertexLayout.from_fields(("position", 3), ("color", 3))
    desc = GraphicPipelineDesc(
        shader_input=GraphicShaderInput(
            Shader.vertex("gpu.vs", vs), Shader.fragment("gpu.fs", fs), layout
        ),
        state=GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE),
            depth_stencil=DepthStencilDesc().reverse_z(),
        ),
        attachments=GraphicPipelineAttachments(
            color_formats=(Format.RGBA32F,), depth_format=Format.D32F
        ),
        color_attachment_descs=(ColorAttachmentDesc(clear_value=(0, 0, 0, 1)),),
    )
    pipeline = PipelineCache().get_or_create(desc)
    grid = TileGrid(width=W, height=H)

    rng = np.random.default_rng(42)
    n_tris = 40
    pos = rng.uniform(-1.05, 1.05, size=(3 * n_tris, 2)).astype(np.float32)
    z = rng.uniform(0.1, 0.9, size=(3 * n_tris, 1)).astype(np.float32)
    col = rng.uniform(0, 1, size=(3 * n_tris, 3)).astype(np.float32)
    vb_np = np.concatenate([pos, z, col], axis=1)
    idx_np = np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)

    with jax.default_device(device):
        vb = jnp.asarray(vb_np)
        ib = jnp.asarray(idx_np)

        @jax.jit
        def frame(vbuf):
            colors = [clear_color(H, W, (0, 0, 0, 1))]
            depth = clear_depth(H, W, 0.0)
            colors, depth, stats = draw_indexed(
                colors, depth, pipeline, vbuf, ib, {}, grid,
                interpret=interpret,
            )
            return colors[0], depth, stats.bin_overflow

        color, depth, overflow = jax.block_until_ready(frame(vb))
    clip = np.concatenate(
        [vb_np[:, :2], vb_np[:, 2:3], np.ones((vb_np.shape[0], 1), np.float32)],
        axis=1,
    )
    return (
        np.asarray(color),
        np.asarray(depth),
        int(overflow),
        clip,
        idx_np,
        {"c": vb_np[:, 3:6]},
    )


class TestCompiledGPUPixels:
    def test_compiled_matches_interpreter_and_oracle(self, gpu_device):
        col_gpu, z_gpu, ovf, clip, idx, vary = render_frame(
            interpret=False, device=gpu_device
        )
        cpu = jax.devices("cpu")[0]
        col_int, z_int, _, _, _, _ = render_frame(interpret=True, device=cpu)

        assert ovf == 0
        # Compiled vs interpreter: same program, different execution engines —
        # require ≤ 1-LSB-scale float divergence everywhere.
        np.testing.assert_allclose(z_gpu, z_int, atol=2e-6)
        np.testing.assert_allclose(col_gpu, col_int, atol=2e-5)

        # And both against the independent NumPy oracle.
        ref = render_reference(clip, idx, W, H, cull="none", varyings=vary)
        covered = ref["tri"] >= 0
        np.testing.assert_allclose(z_gpu, ref["z"], atol=1e-4)
        np.testing.assert_allclose(
            col_gpu[covered][:, :3], ref["c"][covered], atol=2e-3
        )


class TestCompiledGPUStencil:
    def test_stencil_kernel_compiled_matches_interpreter(self, gpu_device):
        """The stencil variant of the raster kernel — verify it where it
        ships too."""
        from zenith.ops import (
            TileGrid,
            bin_segmented,
            corner_attributes,
            raster_segmented,
            setup_triangles,
        )
        from zenith.rhi.state import CompareOp, CullMode, StencilOp, StencilOpState

        jax.config.update("jax_compilation_cache_dir", ".jax_cache")
        grid = TileGrid(width=W, height=H)
        rng = np.random.default_rng(7)
        nv = 30
        pos = rng.uniform(-1.0, 1.0, size=(nv, 2)).astype(np.float32)
        zz = rng.uniform(0.1, 0.9, size=(nv, 1)).astype(np.float32)
        clip_np = np.concatenate(
            [pos, zz, np.ones((nv, 1), np.float32)], axis=1
        )
        idx_np = rng.integers(0, nv, size=(16, 3)).astype(np.int32)
        front = StencilOpState(
            pass_op=StencilOp.INCREMENT_AND_WRAP, compare_op=CompareOp.ALWAYS
        )

        def run(interpret, device):
            with jax.default_device(device):
                clip = jnp.asarray(clip_np)
                idx = jnp.asarray(idx_np)

                @jax.jit
                def f(c):
                    records = setup_triangles(
                        c, idx, W, H, cull_mode=CullMode.NONE
                    )
                    corner = corner_attributes(
                        records, idx, jnp.zeros((nv, 0), jnp.float32)
                    )
                    bins = bin_segmented(records, corner, grid)
                    z, acc, s = raster_segmented(
                        bins, grid, jnp.zeros((H, W), jnp.float32),
                        compare_op=CompareOp.ALWAYS,
                        init_stencil=jnp.zeros((H, W), jnp.int32),
                        stencil_front=front,
                        interpret=interpret,
                    )
                    return z, s

                return jax.block_until_ready(f(clip))

        z_gpu, s_gpu = run(False, gpu_device)
        cpu = jax.devices("cpu")[0]
        z_int, s_int = run(True, cpu)
        np.testing.assert_allclose(np.asarray(z_gpu), np.asarray(z_int), atol=2e-6)
        np.testing.assert_array_equal(np.asarray(s_gpu), np.asarray(s_int))
        assert int(np.asarray(s_gpu).max()) >= 2  # overlaps actually counted


class TestCompiledGPULights:
    def test_lights_kernel_compiled_matches_dense(self, gpu_device):
        """The tiled-lights kernel compiled on the card agrees with the
        dense per-light sum at float32 ("highest") precision."""
        from zenith.ops.lighting import (
            accumulate_point_lights,
            accumulate_point_lights_dense,
        )

        rng = np.random.default_rng(5)
        nrm = rng.normal(size=(H, W, 3))
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        am = np.concatenate([rng.uniform(0.1, 1, (H, W, 3)),
                             rng.uniform(0, 1, (H, W, 1))], -1)
        nr = np.concatenate([nrm, rng.uniform(0.05, 1, (H, W, 1))], -1)
        pe = np.concatenate([rng.uniform(-20, 20, (H, W, 3)),
                             np.zeros((H, W, 1))], -1)
        depth = (rng.uniform(0, 1, (H, W)) > 0.2) * 0.5
        lp = rng.uniform(-25, 25, (24, 3))
        lc = rng.uniform(0.5, 8, (24, 3))
        lr = rng.uniform(3, 15, (24,))
        args = [jnp.asarray(a, jnp.float32) for a in
                (am, nr, pe, depth, [0.0, -30.0, 10.0], lp, lc, lr)]
        with jax.default_device(gpu_device), jax.default_matmul_precision("highest"):
            args = [jax.device_put(a, gpu_device) for a in args]
            got = np.asarray(jax.jit(
                lambda *a: accumulate_point_lights(*a, interpret=False))(*args))
            ref = np.asarray(jax.jit(accumulate_point_lights_dense)(*args))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
        assert got.max() > 0.01
