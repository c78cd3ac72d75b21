"""Stencil test/ops vs the NumPy oracle + a masked two-pass graph test.

Reference model: DepthStencilDesc.stencil_* (pipeline.rs:426-450),
vk::StencilOpState per face. Vulkan order per fragment: coverage →
stencil test (compare(ref & mask, stored & mask)) → depth test; ops
fail_op/depth_fail_op/pass_op fire on the respective outcomes, writes
masked by write_mask (spec 27.19).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from np_reference import render_reference
from zenith.ops import (
    TileGrid,
    bin_segmented,
    corner_attributes,
    raster_segmented,
    setup_triangles,
)
from zenith.rhi.state import (
    CompareOp,
    CullMode,
    StencilOp,
    StencilOpState,
)

W, H = 128, 32
GRID = TileGrid(width=W, height=H, tile_h=8, tile_w=128)


def run_stencil(
    clip,
    idx,
    front: StencilOpState,
    back: "StencilOpState | None" = None,
    init_stencil=None,
    cull=CullMode.NONE,
    depth_test=True,
    compare=CompareOp.GREATER,
    depth_write=True,
):
    records = setup_triangles(
        jnp.asarray(clip, jnp.float32), jnp.asarray(idx, jnp.int32),
        W, H, cull_mode=cull,
    )
    corner = corner_attributes(
        records, jnp.asarray(idx, jnp.int32),
        jnp.zeros((np.asarray(clip).shape[0], 0), jnp.float32),
    )
    bins = bin_segmented(records, corner, GRID)
    init_s = (
        jnp.asarray(init_stencil, jnp.int32)
        if init_stencil is not None
        else jnp.zeros((H, W), jnp.int32)
    )
    z, acc, s = raster_segmented(
        bins, GRID, jnp.zeros((H, W), jnp.float32),
        depth_test=depth_test, depth_write=depth_write, compare_op=compare,
        init_stencil=init_s, stencil_front=front, stencil_back=back,
    )
    return np.asarray(z), np.asarray(acc), np.asarray(s)


def face_dict(st: StencilOpState) -> dict:
    return {
        "compare": st.compare_op.value,
        "reference": st.reference,
        "compare_mask": st.compare_mask,
        "write_mask": st.write_mask,
        "fail_op": st.fail_op.value,
        "pass_op": st.pass_op.value,
        "depth_fail_op": st.depth_fail_op.value,
    }


def oracle(clip, idx, front, back=None, init=0, cull="none",
           compare="greater", depth_test=True, depth_write=True):
    return render_reference(
        clip, idx, W, H, cull=cull, compare=compare,
        depth_test=depth_test, depth_write=depth_write,
        stencil={
            "front": face_dict(front),
            "back": face_dict(back or front),
            "init": init,
        },
    )


def ndc_tri(verts2d, z=0.5, w=1.0):
    return np.array([[x * w, y * w, z * w, w] for x, y in verts2d], np.float32)


class TestStencilOps:
    def test_replace_marks_coverage(self):
        clip = ndc_tri([(0.0, -0.8), (0.7, 0.7), (-0.7, 0.7)])
        idx = np.array([[0, 1, 2]])
        st = StencilOpState(
            pass_op=StencilOp.REPLACE, compare_op=CompareOp.ALWAYS, reference=7
        )
        _, _, s = run_stencil(clip, idx, st)
        ref = oracle(clip, idx, st)
        np.testing.assert_array_equal(s, ref["stencil"])
        assert (s == 7).sum() > 50 and (s == 0).sum() > 50

    def test_increment_wrap_counts_overlaps(self, rng):
        nv = 24
        pos = rng.uniform(-1.0, 1.0, size=(nv, 2))
        zz = rng.uniform(0.1, 0.9, size=(nv, 1))
        clip = np.concatenate([pos, zz, np.ones((nv, 1))], 1).astype(np.float32)
        idx = rng.integers(0, nv, size=(14, 3)).astype(np.int32)
        st = StencilOpState(
            pass_op=StencilOp.INCREMENT_AND_WRAP,
            compare_op=CompareOp.ALWAYS,
        )
        # depth ALWAYS so every covered fragment passes → stencil counts
        # true overlap (incl. both faces).
        _, _, s = run_stencil(clip, idx, st, compare=CompareOp.ALWAYS)
        ref = oracle(clip, idx, st, compare="always")
        np.testing.assert_array_equal(s, ref["stencil"])
        assert s.max() >= 2  # overlapping geometry actually counted

    def test_depth_fail_op_fires_on_zfail(self, rng):
        # Two stacked triangles: the occluded one takes the depth_fail path.
        near = ndc_tri([(-0.8, -0.8), (0.8, -0.8), (0.0, 0.8)], z=0.9)
        far = ndc_tri([(-0.8, -0.8), (0.8, -0.8), (0.0, 0.8)], z=0.1)
        clip = np.concatenate([near, far])
        idx = np.array([[0, 1, 2], [3, 4, 5]])
        st = StencilOpState(
            pass_op=StencilOp.REPLACE,
            depth_fail_op=StencilOp.INCREMENT_AND_CLAMP,
            compare_op=CompareOp.ALWAYS,
            reference=9,
        )
        _, _, s = run_stencil(clip, idx, st)
        ref = oracle(clip, idx, st)
        np.testing.assert_array_equal(s, ref["stencil"])
        assert (s == 10).sum() > 50  # 9 (pass) then +1 (depth fail)

    def test_fail_op_and_compare_mask(self, rng):
        clip = ndc_tri([(0.0, -0.8), (0.7, 0.7), (-0.7, 0.7)])
        idx = np.array([[0, 1, 2]])
        init = rng.integers(0, 256, size=(H, W)).astype(np.int32)
        st = StencilOpState(
            fail_op=StencilOp.ZERO,
            pass_op=StencilOp.INVERT,
            compare_op=CompareOp.LESS,  # ref < stored&mask passes
            compare_mask=0x0F,
            write_mask=0x3C,
            reference=5,
        )
        _, _, s = run_stencil(clip, idx, st, init_stencil=init)
        ref = oracle(clip, idx, st, init=init)
        np.testing.assert_array_equal(s, ref["stencil"])

    def test_front_back_faces_differ(self, rng):
        # Mixed winding, CULL_NONE: front fragments +1, back fragments
        # replace with 100.
        nv = 18
        pos = rng.uniform(-1.0, 1.0, size=(nv, 2))
        zz = rng.uniform(0.1, 0.9, size=(nv, 1))
        clip = np.concatenate([pos, zz, np.ones((nv, 1))], 1).astype(np.float32)
        idx = rng.integers(0, nv, size=(10, 3)).astype(np.int32)
        front = StencilOpState(
            pass_op=StencilOp.INCREMENT_AND_CLAMP, compare_op=CompareOp.ALWAYS
        )
        back = StencilOpState(
            pass_op=StencilOp.REPLACE, compare_op=CompareOp.ALWAYS, reference=100
        )
        _, _, s = run_stencil(clip, idx, front, back, compare=CompareOp.ALWAYS)
        ref = oracle(clip, idx, front, back, compare="always")
        np.testing.assert_array_equal(s, ref["stencil"])
        assert (s == 100).any()  # back faces hit
        assert ((s > 0) & (s < 100)).any()  # front faces hit

    def test_stencil_mask_gates_draw(self):
        """Write-then-test: pass 1 marks a small triangle; pass 2 draws a
        fullscreen quad gated on stencil EQUAL — only marked pixels shade."""
        small = ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)], z=0.5)
        idx1 = np.array([[0, 1, 2]])
        write = StencilOpState(
            pass_op=StencilOp.REPLACE, compare_op=CompareOp.ALWAYS, reference=1
        )
        _, _, s1 = run_stencil(small, idx1, write)

        quad = ndc_tri(
            [(-2, -2), (2, -2), (2, 2), (-2, 2)], z=0.6
        )
        idx2 = np.array([[0, 1, 2], [0, 2, 3]])
        test = StencilOpState(compare_op=CompareOp.EQUAL, reference=1)
        z2, acc2, s2 = run_stencil(
            quad, idx2, test, init_stencil=s1, compare=CompareOp.GREATER
        )
        covered = np.asarray(acc2[-1]) > 0
        np.testing.assert_array_equal(covered, s1 == 1)  # gated exactly
        np.testing.assert_array_equal(s2, s1)  # KEEP ops leave the plane


class TestStencilGraph:
    """The masked-draw flow through the full render graph (VERDICT item 4:
    write stencil in pass 1, stencil-test in pass 2)."""

    def test_two_pass_masked_draw(self):
        import jax

        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rendergraph.graph import clear_frame_program_cache
        from zenith.rhi import (
            Buffer,
            ColorAttachmentDesc,
            GraphicShaderInput,
            PipelineCache,
            RhiCore,
            Shader,
            TextureDesc,
        )
        from zenith.rhi.state import (
            DepthStencilDesc,
            GraphicPipelineState,
            RasterizationState,
            VertexLayout,
        )

        core = RhiCore()
        device = core.create_render_device()
        pcache = PipelineCache()
        clear_frame_program_cache()

        layout = VertexLayout.from_fields(("position", 4))
        vs = Shader.vertex("vs", lambda attrs, res: {"position": attrs["position"]})
        fs_red = Shader.fragment(
            "fs_red",
            lambda varyings, res, b: jnp.broadcast_to(
                jnp.asarray([1.0, 0.0, 0.0, 1.0]),
                b.depth.shape + (4,),
            ),
        )

        tri = np.array(
            [[0.0, -0.5, 0.5, 1.0], [0.5, 0.5, 0.5, 1.0], [-0.5, 0.5, 0.5, 1.0]],
            np.float32,
        )
        quad = np.array(
            [[-2, -2, 0.6, 1.0], [2, -2, 0.6, 1.0], [2, 2, 0.6, 1.0], [-2, 2, 0.6, 1.0]],
            np.float32,
        )
        vb1 = Buffer.from_numpy("tri.vb", tri)
        ib1 = Buffer.from_numpy("tri.ib", np.array([0, 1, 2], np.int32))
        vb2 = Buffer.from_numpy("quad.vb", quad)
        ib2 = Buffer.from_numpy("quad.ib", np.array([0, 1, 2, 0, 2, 3], np.int32))

        builder = RenderGraphBuilder()
        v1, i1 = builder.import_resource(vb1), builder.import_resource(ib1)
        v2, i2 = builder.import_resource(vb2), builder.import_resource(ib2)
        color = builder.create(TextureDesc.color("out", W, H))
        sten = builder.create(TextureDesc.stencil("mask", W, H))
        builder.export(color)

        raster = RasterizationState(cull_mode=CullMode.NONE)

        # Pass 1: mark the triangle's coverage in the stencil plane.
        node = builder.add_graphic_node("mark")
        v1a, i1a = node.read(v1), node.read(i1)
        sa = node.write(sten)
        with node.pipeline(
            GraphicShaderInput(vs, None, layout),
            GraphicPipelineState(
                rasterization=raster,
                depth_stencil=DepthStencilDesc().stencil_write(1),
            ),
        ) as binder:
            binder.set_stencil(sa)

        def record_mark(ctx):
            ctx.draw_indexed(v1a, i1a)

        node.execute(record_mark)

        # Pass 2: fullscreen red quad gated on stencil == 1.
        node = builder.add_graphic_node("gated")
        v2a, i2a = node.read(v2), node.read(i2)
        node.read(sten)
        ca = node.write(color)
        sa2 = node.write(sten)
        with node.pipeline(
            GraphicShaderInput(vs, fs_red, layout),
            GraphicPipelineState(
                rasterization=raster,
                depth_stencil=DepthStencilDesc().stencil_mask(1),
            ),
        ) as binder:
            binder.push_color(ca, ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
            binder.set_stencil(sa2)

        def record_gated(ctx):
            ctx.draw_indexed(v2a, i2a)

        node.execute(record_gated)

        compiled = builder.build().compile(
            device, pcache, CompileOptions(tile_h=8, tile_w=128)
        )
        compiled.execute(device)
        img = np.asarray(compiled.value(color))

        # Oracle: triangle coverage = where red must appear.
        ref = render_reference(tri, np.array([[0, 1, 2]]), W, H, cull="none")
        inside = ref["tri"] >= 0
        np.testing.assert_allclose(img[inside][:, 0], 1.0, atol=1e-6)
        np.testing.assert_allclose(img[~inside][:, 0], 0.0, atol=1e-6)


class TestStencilMSAA:
    """Stencil + multisampling: per-sample stencil planes inside a node;
    across nodes the graph stores the sample-0 resolve (Vulkan's default
    resolve mode). Pixel-aligned geometry makes every sample position agree,
    so the 2x result must equal the 1x result exactly."""

    def _run(self, samples):
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rendergraph.graph import clear_frame_program_cache
        from zenith.rhi import (
            Buffer,
            ColorAttachmentDesc,
            GraphicShaderInput,
            PipelineCache,
            RhiCore,
            Shader,
            TextureDesc,
        )
        from zenith.rhi.state import (
            DepthStencilDesc,
            GraphicPipelineState,
            MultisampleState,
            RasterizationState,
            VertexLayout,
        )

        device = RhiCore().create_render_device()
        clear_frame_program_cache()
        layout = VertexLayout.from_fields(("position", 4))
        vs = Shader.vertex("vs", lambda attrs, res: {"position": attrs["position"]})
        fs_red = Shader.fragment(
            "fs_red",
            lambda varyings, res, b: jnp.broadcast_to(
                jnp.asarray([1.0, 0.0, 0.0, 1.0]), b.depth.shape + (4,)
            ),
        )
        # Left-half quad, edges on exact pixel boundaries (NDC x = 0 is
        # pixel column W/2): identical coverage at every sample position.
        half = np.array(
            [[-2, -2, 0.5, 1], [0, -2, 0.5, 1], [0, 2, 0.5, 1], [-2, 2, 0.5, 1]],
            np.float32,
        )
        full = np.array(
            [[-2, -2, 0.6, 1], [2, -2, 0.6, 1], [2, 2, 0.6, 1], [-2, 2, 0.6, 1]],
            np.float32,
        )
        quad_idx = np.array([0, 1, 2, 0, 2, 3], np.int32)
        vb1 = Buffer.from_numpy("half.vb", half)
        vb2 = Buffer.from_numpy("full.vb", full)
        ib = Buffer.from_numpy("quad.ib", quad_idx)

        builder = RenderGraphBuilder()
        v1, v2 = builder.import_resource(vb1), builder.import_resource(vb2)
        i0 = builder.import_resource(ib)
        color = builder.create(TextureDesc.color("out", W, H))
        sten = builder.create(TextureDesc.stencil("mask", W, H))
        builder.export(color)
        raster = RasterizationState(cull_mode=CullMode.NONE)
        ms = MultisampleState(samples=samples)

        node = builder.add_graphic_node("mark")
        v1a, ia = node.read(v1), node.read(i0)
        sa = node.write(sten)
        with node.pipeline(
            GraphicShaderInput(vs, None, layout),
            GraphicPipelineState(
                rasterization=raster, multisample=ms,
                depth_stencil=DepthStencilDesc().stencil_write(1),
            ),
        ) as binder:
            binder.set_stencil(sa)
        node.execute(lambda ctx: ctx.draw_indexed(v1a, ia))

        node = builder.add_graphic_node("gated")
        v2a, ia2 = node.read(v2), node.read(i0)
        node.read(sten)
        ca = node.write(color)
        sa2 = node.write(sten)
        with node.pipeline(
            GraphicShaderInput(vs, fs_red, layout),
            GraphicPipelineState(
                rasterization=raster, multisample=ms,
                depth_stencil=DepthStencilDesc().stencil_mask(1),
            ),
        ) as binder:
            binder.push_color(ca, ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
            binder.set_stencil(sa2)
        node.execute(lambda ctx: ctx.draw_indexed(v2a, ia2))

        from zenith.rhi import PipelineCache as _PC

        compiled = builder.build().compile(
            device, _PC(), CompileOptions(tile_h=8, tile_w=128)
        )
        compiled.execute(device)
        return np.asarray(compiled.value(color))

    def test_msaa2_stencil_masked_draw_matches_1x(self):
        img1 = self._run(1)
        img2 = self._run(2)
        # Left half red, right half clear, both sample counts.
        np.testing.assert_allclose(img1[:, : W // 2, 0], 1.0, atol=1e-6)
        np.testing.assert_allclose(img1[:, W // 2 :, 0], 0.0, atol=1e-6)
        np.testing.assert_allclose(img2, img1, atol=1e-6)
