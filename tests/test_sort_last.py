"""Engine-integrated sort-last SPMD (CompileOptions.parallel="sort_last"):
eligible opaque graphic nodes shard TRIANGLES across the mesh and a
binary-swap depth composite lands the result in the row-band layout — the
load-balance answer to sort-first's banded imbalance (a scene clustered in
one band rasterizes on ONE device under sort-first, on ALL under
sort-last). Every test checks equality against the single-device render.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zenith.parallel import default_mesh
from zenith.rendergraph import CompileOptions, RenderGraphBuilder
from zenith.rendergraph.graph import clear_frame_program_cache
from zenith.rhi import (
    ColorAttachmentDesc,
    CullMode,
    Format,
    GraphicPipelineAttachments,
    GraphicPipelineDesc,
    GraphicShaderInput,
    PipelineCache,
    RasterizationState,
    RhiCore,
    Shader,
    TextureDesc,
    VertexLayout,
)
from zenith.rhi.state import DepthStencilDesc, GraphicPipelineState

W, H = 128, 64  # 8 devices x 8-row bands


def _vs(attrs, res):
    p = attrs["position"]
    return {
        "position": jnp.concatenate(
            [p, jnp.ones((p.shape[0], 1), jnp.float32)], 1
        ),
        "color": attrs["color"],
    }


def _fs(varyings, res, builtins):
    c = varyings["color"]
    return jnp.concatenate([c, jnp.ones_like(c[..., :1])], -1)


LAYOUT = VertexLayout.from_fields(("position", 3), ("color", 3))
VS = Shader.vertex("sl.vs", _vs)
FS = Shader.fragment("sl.fs", _fs)


def _shader_input():
    return GraphicShaderInput(VS, FS, LAYOUT)


def _state():
    return GraphicPipelineState(
        rasterization=RasterizationState(cull_mode=CullMode.NONE),
        depth_stencil=DepthStencilDesc().reverse_z(),
    )


def _tri_vb(rng, nv, y_range=(-1.0, 1.0)):
    pos = rng.uniform(-1.0, 1.0, size=(nv, 2)).astype(np.float32)
    pos[:, 1] = rng.uniform(y_range[0], y_range[1], size=nv)
    zz = rng.uniform(0.1, 0.9, size=(nv, 1)).astype(np.float32)
    col = rng.uniform(0, 1, size=(nv, 3)).astype(np.float32)
    return np.concatenate([pos, zz.reshape(-1, 1), col], axis=1).astype(
        np.float32
    )


def _render_graph(device, options, record_draws, exports=("color", "depth")):
    """One opaque graphic node driven by ``record_draws(ctx, handles)``."""
    clear_frame_program_cache()
    builder = RenderGraphBuilder()
    color = builder.create(TextureDesc.color("rt", W, H))
    depth = builder.create(TextureDesc.depth("ds", W, H))
    builder.export(color)
    builder.export(depth)

    node = builder.add_graphic_node("scene")
    rt = node.write(color)
    ds = node.write(depth)
    with node.pipeline(_shader_input(), _state()) as binder:
        binder.push_color(rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
        binder.set_depth(ds, DepthStencilDesc().reverse_z())
    node.execute(record_draws)

    compiled = builder.build().compile(device, PipelineCache(), options)
    compiled.execute(device)
    return (
        np.asarray(compiled.value(color)),
        np.asarray(compiled.value(depth)),
    )


def _assert_images_match(a, b, tol=1e-3, frac=0.0):
    """Sort-last rasterizes the SAME triangles with the SAME full-res grid
    as single-chip (no viewport shift), so results should be bit-close;
    ``frac`` allows a few edge pixels when compilation differs ulp-level."""
    diff = np.abs(a - b).max(axis=-1) if a.ndim == 3 else np.abs(a - b)
    assert (diff > tol).mean() <= frac, (
        f"{(diff > tol).mean():.4%} pixels differ (max {diff.max()})"
    )


class TestSortLastGraph:
    def test_matches_single_device(self, cpu_devices, rng):
        vb = _tri_vb(rng, 48)
        ib = rng.integers(0, 48, size=(30, 3)).astype(np.int32)  # 30 % 8 != 0

        def record(ctx):
            ctx.draw_indexed(jnp.asarray(vb), jnp.asarray(ib))

        img1, z1 = _render_graph(None, CompileOptions(tile_h=8), record)
        mesh = default_mesh(8, backend="cpu")
        img8, z8 = _render_graph(
            None,
            CompileOptions(tile_h=8, mesh=mesh, parallel="sort_last"),
            record,
        )
        assert img1[..., :3].std() > 0.01  # something rendered
        _assert_images_match(img8, img1, frac=0.002)
        _assert_images_match(z8, z1, tol=1e-5, frac=0.002)

    def test_worst_case_band_imbalance(self, cpu_devices, rng):
        """All geometry inside the TOP band: sort-first leaves 7 of 8
        devices idle; sort-last must still produce the identical image
        (the perf trade belongs to the benchmark's four-GPU cells)."""
        vb = _tri_vb(rng, 60, y_range=(-1.0, -0.76))  # top 12% of the frame
        ib = rng.integers(0, 60, size=(40, 3)).astype(np.int32)

        def record(ctx):
            ctx.draw_indexed(jnp.asarray(vb), jnp.asarray(ib))

        img1, z1 = _render_graph(None, CompileOptions(tile_h=8), record)
        mesh = default_mesh(8, backend="cpu")
        img8, z8 = _render_graph(
            None,
            CompileOptions(tile_h=8, mesh=mesh, parallel="sort_last"),
            record,
        )
        assert (z1 > 0).any()  # geometry landed
        _assert_images_match(img8, img1, frac=0.002)
        _assert_images_match(z8, z1, tol=1e-5, frac=0.002)

    def test_equal_z_ties_resolve_in_draw_order(self, cpu_devices):
        """Two coplanar full-screen quads at the SAME depth, drawn red then
        green in separate draws: strict GREATER means the FIRST draw wins
        every pixel. Under sort-last the two draws' triangles land on
        different shards — the submission-order plane must still pick red."""

        def quad(color):
            c = np.asarray(color, np.float32)
            v = np.array(
                [
                    [-1, -1, 0.5], [1, -1, 0.5], [1, 1, 0.5], [-1, 1, 0.5],
                ],
                np.float32,
            )
            return np.concatenate(
                [v, np.tile(c, (4, 1))], axis=1
            ).astype(np.float32)

        ib = np.array([[0, 1, 2], [0, 2, 3]], np.int32)

        def record(ctx):
            ctx.draw_indexed(jnp.asarray(quad((1, 0, 0))), jnp.asarray(ib))
            ctx.draw_indexed(jnp.asarray(quad((0, 1, 0))), jnp.asarray(ib))

        img1, _ = _render_graph(None, CompileOptions(tile_h=8), record)
        mesh = default_mesh(8, backend="cpu")
        img8, _ = _render_graph(
            None,
            CompileOptions(tile_h=8, mesh=mesh, parallel="sort_last"),
            record,
        )
        # Single chip: red everywhere (first draw wins equal z).
        np.testing.assert_allclose(
            img1[..., :3], np.broadcast_to([1.0, 0, 0], img1[..., :3].shape),
            atol=1e-6,
        )
        np.testing.assert_allclose(img8, img1, atol=1e-6)

    def test_batched_draws(self, cpu_devices, rng):
        vb_a = _tri_vb(rng, 24)
        vb_b = _tri_vb(rng, 24)
        ib = rng.integers(0, 24, size=(12, 3)).astype(np.int32)

        def record(ctx):
            ctx.draw_indexed_batch(
                [
                    (jnp.asarray(vb_a), jnp.asarray(ib), {}),
                    (jnp.asarray(vb_b), jnp.asarray(ib), {}),
                ]
            )

        img1, z1 = _render_graph(None, CompileOptions(tile_h=8), record)
        mesh = default_mesh(8, backend="cpu")
        img8, z8 = _render_graph(
            None,
            CompileOptions(tile_h=8, mesh=mesh, parallel="sort_last"),
            record,
        )
        _assert_images_match(img8, img1, frac=0.002)
        _assert_images_match(z8, z1, tol=1e-5, frac=0.002)

    def test_instanced_draw(self, cpu_devices, rng):
        base = _tri_vb(rng, 12)
        ib = rng.integers(0, 12, size=(6, 3)).astype(np.int32)
        offsets = np.array(
            [[-0.4, -0.4, 0.0], [0.4, 0.4, 0.1]], np.float32
        )

        def vs_inst(attrs, res):
            p = attrs["position"] + attrs["offset"]
            return {
                "position": jnp.concatenate(
                    [p, jnp.ones((p.shape[0], 1), jnp.float32)], 1
                ),
                "color": attrs["color"],
            }

        vs = Shader.vertex("sl.inst.vs", vs_inst)

        def record(ctx):
            ctx.draw_indexed(
                jnp.asarray(base), jnp.asarray(ib),
                instance_count=2,
                instance_data={"offset": offsets},
            )

        def render(options):
            clear_frame_program_cache()
            builder = RenderGraphBuilder()
            color = builder.create(TextureDesc.color("rt", W, H))
            depth = builder.create(TextureDesc.depth("ds", W, H))
            builder.export(color)
            node = builder.add_graphic_node("inst")
            rt = node.write(color)
            ds = node.write(depth)
            with node.pipeline(
                GraphicShaderInput(vs, FS, LAYOUT), _state()
            ) as binder:
                binder.push_color(
                    rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1))
                )
                binder.set_depth(ds, DepthStencilDesc().reverse_z())
            node.execute(record)
            compiled = builder.build().compile(
                None, PipelineCache(), options
            )
            compiled.execute(None)
            return np.asarray(compiled.value(color))

        img1 = render(CompileOptions(tile_h=8))
        mesh = default_mesh(8, backend="cpu")
        img8 = render(
            CompileOptions(tile_h=8, mesh=mesh, parallel="sort_last")
        )
        _assert_images_match(img8, img1, frac=0.002)

    def test_blended_node_falls_back_banded(self, cpu_devices, rng):
        """A graph mixing a sort-last opaque node with a BLENDED node (not
        eligible): the blended node must take the banded path on the
        composited result and still match single-chip."""
        vb = _tri_vb(rng, 36)
        ib = rng.integers(0, 36, size=(16, 3)).astype(np.int32)
        # A translucent full-width quad over the middle of the frame.
        gq = np.array(
            [
                [-0.9, -0.4, 0.8, 0.2, 0.4, 1.0],
                [0.9, -0.4, 0.8, 0.2, 0.4, 1.0],
                [0.9, 0.4, 0.8, 0.2, 0.4, 1.0],
                [-0.9, 0.4, 0.8, 0.2, 0.4, 1.0],
            ],
            np.float32,
        )
        gib = np.array([[0, 1, 2], [0, 2, 3]], np.int32)

        def fs_glass(varyings, res, builtins):
            c = varyings["color"]
            return jnp.concatenate(
                [c, jnp.full_like(c[..., :1], 0.5)], -1
            )

        fs_g = Shader.fragment("sl.glass.fs", fs_glass)

        def render(options):
            clear_frame_program_cache()
            builder = RenderGraphBuilder()
            color = builder.create(TextureDesc.color("rt", W, H))
            depth = builder.create(TextureDesc.depth("ds", W, H))
            builder.export(color)

            node = builder.add_graphic_node("opaque")
            rt = node.write(color)
            ds = node.write(depth)
            with node.pipeline(_shader_input(), _state()) as binder:
                binder.push_color(
                    rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1))
                )
                binder.set_depth(ds, DepthStencilDesc().reverse_z())
            node.execute(
                lambda ctx: ctx.draw_indexed(jnp.asarray(vb), jnp.asarray(ib))
            )

            from dataclasses import replace as dc_replace

            from zenith.rhi.state import (
                BlendFactor,
                CompareOp,
                LoadOp,
            )

            glass = builder.add_graphic_node("glass")
            glass.read(color)
            glass.read(depth)
            rt2 = glass.write(color)
            ds2 = glass.write(depth)
            glass_state = GraphicPipelineState(
                rasterization=RasterizationState(cull_mode=CullMode.NONE),
            )
            glass_blend = ColorAttachmentDesc(
                blend_enable=True,
                src_color_blend=BlendFactor.SRC_ALPHA,
                dst_color_blend=BlendFactor.ONE_MINUS_SRC_ALPHA,
                src_alpha_blend=BlendFactor.ONE,
                dst_alpha_blend=BlendFactor.ONE_MINUS_SRC_ALPHA,
                load_op=LoadOp.LOAD,
            )
            glass_depth = dc_replace(
                DepthStencilDesc(
                    depth_test_enable=True,
                    depth_write_enable=False,
                    depth_compare_op=CompareOp.GREATER,
                ),
                depth_load_op=LoadOp.LOAD,
            )
            with glass.pipeline(
                GraphicShaderInput(VS, fs_g, LAYOUT), glass_state
            ) as binder:
                binder.push_color(rt2, glass_blend)
                binder.set_depth(ds2, glass_depth)
            glass.execute(
                lambda ctx: ctx.draw_indexed(jnp.asarray(gq), jnp.asarray(gib))
            )

            compiled = builder.build().compile(None, PipelineCache(), options)
            compiled.execute(None)
            return np.asarray(compiled.value(color))

        img1 = render(CompileOptions(tile_h=8))
        mesh = default_mesh(8, backend="cpu")
        img8 = render(
            CompileOptions(tile_h=8, mesh=mesh, parallel="sort_last")
        )
        assert img1[..., :3].std() > 0.01
        _assert_images_match(img8, img1, frac=0.002)

    def test_post_lambda_consumes_banded_composite(self, cpu_devices, rng):
        """Sort-last node → banded result → a band-local post lambda —
        proving the composite output feeds the standard banded pipeline."""
        vb = _tri_vb(rng, 36)
        ib = rng.integers(0, 36, size=(16, 3)).astype(np.int32)

        def render(options):
            clear_frame_program_cache()
            builder = RenderGraphBuilder()
            color = builder.create(TextureDesc.color("rt", W, H))
            depth = builder.create(TextureDesc.depth("ds", W, H))
            out = builder.create(TextureDesc.color("post", W, H))
            builder.export(out)

            node = builder.add_graphic_node("opaque")
            rt = node.write(color)
            ds = node.write(depth)
            with node.pipeline(_shader_input(), _state()) as binder:
                binder.push_color(
                    rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1))
                )
                binder.set_depth(ds, DepthStencilDesc().reverse_z())
            node.execute(
                lambda ctx: ctx.draw_indexed(jnp.asarray(vb), jnp.asarray(ib))
            )

            post = builder.add_lambda_node("post")
            src = post.read(color)
            dst = post.write(out)

            def record_post(ctx):
                img = ctx.get(src)
                ctx.set(dst, jnp.sqrt(jnp.clip(img, 0.0, 1.0)))

            post.execute(record_post)

            compiled = builder.build().compile(None, PipelineCache(), options)
            compiled.execute(None)
            return np.asarray(compiled.value(out))

        img1 = render(CompileOptions(tile_h=8))
        mesh = default_mesh(8, backend="cpu")
        img8 = render(
            CompileOptions(tile_h=8, mesh=mesh, parallel="sort_last")
        )
        _assert_images_match(img8, img1, frac=0.002)


class TestSortLastMsaa:
    """MSAA nodes are sort-last ELIGIBLE (VERDICT r4 next #3): the
    binary-swap composite runs per sample plane (vmapped collectives) and
    lands banded per-sample planes — the same layout sort-first MSAA
    persistence uses, so a following LOAD node continues per-sample."""

    def _render(self, options):
        from dataclasses import replace

        from zenith.rhi import Buffer, MultisampleState, RhiCore
        from zenith.rhi.state import LoadOp

        w2, h2 = 128, 64
        device = RhiCore().create_render_device()
        clear_frame_program_cache()
        vs = Shader.vertex(
            "slm.vs", lambda attrs, res: {"position": attrs["position"]}
        )
        fs = Shader.fragment(
            "slm.fs",
            lambda varyings, res, b: jnp.broadcast_to(
                jnp.asarray((1.0, 0.5, 0.25, 1.0)), b.depth.shape + (4,)
            ),
        )
        # Two thin slivers crossing in an X at different depths: fractional
        # edge coverage everywhere, and the deeper sliver must lose where
        # they cross — per-sample depth through the composite.
        tri_a = np.array(
            [[-0.95, -0.95, 0.5, 1], [0.95, 0.95, 0.5, 1],
             [-0.95, -0.80, 0.5, 1]], np.float32,
        )
        tri_b = np.array(
            [[-0.95, 0.95, 0.7, 1], [0.95, -0.95, 0.7, 1],
             [0.95, -0.80, 0.7, 1]], np.float32,
        )
        vba = Buffer.from_numpy("slma.vb", tri_a)
        vbb = Buffer.from_numpy("slmb.vb", tri_b)
        ibb = Buffer.from_numpy("slm.ib", np.array([0, 1, 2], np.int32))
        layout = VertexLayout.from_fields(("position", 4))
        state = GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE),
            depth_stencil=DepthStencilDesc().reverse_z(),
            multisample=MultisampleState(samples=4),
        )

        builder = RenderGraphBuilder()
        ra = builder.import_resource(vba)
        rb = builder.import_resource(vbb)
        ri = builder.import_resource(ibb)
        out = builder.create(TextureDesc.color("slm.rt", w2, h2))
        dep = builder.create(TextureDesc.depth("slm.ds", w2, h2))
        builder.export(out)

        def add_node(name, vhandle, first):
            node = builder.add_graphic_node(name)
            va = node.read(vhandle)
            ia = node.read(ri)
            rt = node.write(out)
            ds = node.write(dep)
            with node.pipeline(GraphicShaderInput(vs, fs, layout),
                               state) as b:
                if first:
                    b.push_color(
                        rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1))
                    )
                    b.set_depth(ds, DepthStencilDesc().reverse_z())
                else:
                    b.push_color(rt, ColorAttachmentDesc(load_op=LoadOp.LOAD))
                    b.set_depth(ds, replace(
                        DepthStencilDesc().reverse_z(),
                        depth_load_op=LoadOp.LOAD,
                    ))
            node.execute(lambda ctx, va=va, ia=ia: ctx.draw_indexed(va, ia))

        add_node("pass1", ra, first=True)
        add_node("pass2", rb, first=False)
        graph = builder.build()
        compiled = graph.compile(device, PipelineCache(), options)
        compiled.execute(device)
        return np.asarray(compiled.value(out)), graph

    def test_msaa_chain_sort_last_matches_single(self, cpu_devices):
        single, _ = self._render(CompileOptions(tile_h=8, tile_w=128))
        mesh = default_mesh(8, backend="cpu")
        sharded, graph = self._render(
            CompileOptions(tile_h=8, tile_w=128, mesh=mesh,
                           parallel="sort_last")
        )
        # Both passes take sort-last (MSAA no longer disqualifies).
        assert graph.parallel_modes == {
            "pass1": "sort_last", "pass2": "sort_last"
        }
        vals = single[..., 0]
        edge = ((vals > 0.1) & (vals < 0.9)).sum()
        assert edge > 50, f"only {edge} fractional-coverage pixels"
        np.testing.assert_allclose(sharded, single, atol=1e-6)
