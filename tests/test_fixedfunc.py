"""Fixed-function state that round 1 declared but did not honor:
TRIANGLE_STRIP (+ primitive restart), depth bias, depth clamp, anisotropic
sampling, and the samples>1 / stencil-format validation errors.

Reference semantics: InputAssemblyState (pipeline.rs:483-506),
RasterizationState depth bias/clamp (pipeline.rs:508-586), Sampler
anisotropy (sampler.rs:19-40), MultisampleState (pipeline.rs:589-615).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from zenith.ops import TileGrid, setup_triangles
from zenith.ops.draw import assemble_triangles
from zenith.rhi.state import (
    CompareOp,
    CullMode,
    DepthStencilDesc,
    GraphicPipelineAttachments,
    GraphicPipelineState,
    InputAssemblyState,
    MultisampleState,
    PrimitiveTopology,
    RasterizationState,
)

W, H = 128, 32
GRID = TileGrid(width=W, height=H, tile_h=8, tile_w=128)

STRIP = InputAssemblyState(topology=PrimitiveTopology.TRIANGLE_STRIP)
STRIP_RESTART = InputAssemblyState(
    topology=PrimitiveTopology.TRIANGLE_STRIP, primitive_restart=True
)


class TestTriangleStrip:
    def test_list_passthrough(self):
        idx = jnp.asarray([0, 1, 2, 2, 1, 3], jnp.int32)
        tris = assemble_triangles(idx, InputAssemblyState())
        np.testing.assert_array_equal(np.asarray(tris), [[0, 1, 2], [2, 1, 3]])

    def test_strip_decode_winding(self):
        # Vulkan rule: even i → (i, i+1, i+2); odd i → (i+1, i, i+2).
        idx = jnp.asarray([0, 1, 2, 3, 4], jnp.int32)
        tris = np.asarray(assemble_triangles(idx, STRIP))
        np.testing.assert_array_equal(tris, [[0, 1, 2], [2, 1, 3], [2, 3, 4]])

    def test_restart_splits_and_resets_parity(self):
        # Strip [0 1 2 3] | restart | [4 5 6 7]: the second strip's first
        # triangle must be even-parity again.
        idx = jnp.asarray([0, 1, 2, 3, -1, 4, 5, 6, 7], jnp.int32)
        tris = np.asarray(assemble_triangles(idx, STRIP_RESTART))
        # Positions touching the restart collapse to degenerate (0,0,0).
        expected = [
            [0, 1, 2],
            [2, 1, 3],
            [0, 0, 0],  # (2,3,-1)
            [0, 0, 0],  # (3,-1,4) — odd parity, but degenerate anyway
            [0, 0, 0],  # (-1,4,5)
            [4, 5, 6],  # fresh strip: even parity
            [6, 5, 7],
        ]
        np.testing.assert_array_equal(tris, expected)

    def test_without_restart_flag_sentinel_is_literal(self):
        # primitive_restart off: -1 is used as an ordinary (bogus) index —
        # decode must not special-case it.
        idx = jnp.asarray([0, 1, 2, -1], jnp.int32)
        tris = np.asarray(assemble_triangles(idx, STRIP))
        np.testing.assert_array_equal(tris, [[0, 1, 2], [2, 1, -1]])

    def test_strip_render_equals_list_render(self):
        """End-to-end: a strip draw covers the same pixels as the equivalent
        triangle list (same winding ⇒ same culling)."""
        from zenith.ops import bin_segmented, corner_attributes, raster_segmented

        verts = np.array(
            [[-0.8, -0.8], [-0.8, 0.8], [0.0, -0.8], [0.0, 0.8], [0.8, -0.8]],
            np.float32,
        )
        clip = np.concatenate(
            [verts, np.full((5, 1), 0.5), np.ones((5, 1))], axis=1
        ).astype(np.float32)

        def cover(idx_tris):
            records = setup_triangles(
                jnp.asarray(clip), jnp.asarray(idx_tris, jnp.int32), W, H,
                cull_mode=CullMode.BACK,
            )
            corner = corner_attributes(
                records, jnp.asarray(idx_tris, jnp.int32),
                jnp.zeros((5, 0), jnp.float32),
            )
            bins = bin_segmented(records, corner, GRID)
            z, acc = raster_segmented(
                bins, GRID, jnp.zeros((H, W), jnp.float32),
                compare_op=CompareOp.GREATER,
            )
            return np.asarray(acc[-1] > 0)

        strip_tris = assemble_triangles(jnp.arange(5, dtype=jnp.int32), STRIP)
        list_tris = jnp.asarray([[0, 1, 2], [2, 1, 3], [2, 3, 4]], jnp.int32)
        np.testing.assert_array_equal(cover(strip_tris), cover(list_tris))
        assert cover(list_tris).sum() > 100  # nontrivial, not all-culled


class TestDepthBias:
    def _z_at_center(self, depth_bias=None, z0=0.5, slope=False):
        from zenith.ops import bin_segmented, raster_segmented
        from zenith.ops.geometry import setup_with_attrs

        zs = np.array([z0, z0 + (0.2 if slope else 0.0), z0], np.float32)
        clip = np.array(
            [
                [-0.9 * 1, -0.9, zs[0], 1.0],
                [0.9, -0.9, zs[1], 1.0],
                [0.0, 0.9, zs[2], 1.0],
            ],
            np.float32,
        )
        records, corner = setup_with_attrs(
            jnp.asarray(clip), jnp.asarray([[0, 1, 2]], jnp.int32),
            jnp.zeros((3, 0), jnp.float32), W, H,
            cull_mode=CullMode.NONE, depth_bias=depth_bias,
        )
        bins = bin_segmented(records, corner, GRID)
        z, _ = raster_segmented(
            bins, GRID, jnp.zeros((H, W), jnp.float32),
            compare_op=CompareOp.GREATER,
        )
        return float(np.asarray(z)[H // 2, W // 2])

    def test_constant_bias_offsets_depth(self):
        base = self._z_at_center()
        # 2^20 ULPs at z≈0.5 (ulp = 2^-24 there... exponent floor(log2 .5)=-1
        # → r = 2^-24): bias = 2^20 · 2^-24 = 1/16.
        biased = self._z_at_center(depth_bias=(2.0**20, 0.0))
        assert biased > base
        np.testing.assert_allclose(biased - base, 2.0**20 * 2.0**-24, rtol=1e-3)

    def test_slope_bias_scales_with_gradient(self):
        flat_delta = self._z_at_center(depth_bias=(0.0, 1.0)) - self._z_at_center()
        # Flat triangle: dz/dx = dz/dy = 0 ⇒ slope bias is a no-op.
        assert abs(flat_delta) < 1e-7
        sloped_base = self._z_at_center(slope=True)
        sloped = self._z_at_center(depth_bias=(0.0, 1.0), slope=True)
        # Sloped triangle: bias = m = max(|dz/dx|, |dz/dy|) > 0.
        assert sloped - sloped_base > 1e-5

    def test_disabled_in_state_means_none(self):
        # draw_indexed only applies bias when depth_bias_enable is set.
        rs = RasterizationState()
        assert not rs.depth_bias_enable


class TestDepthClamp:
    def test_out_of_range_z_clamps_instead_of_discarding(self):
        from zenith.ops import bin_segmented, raster_segmented
        from zenith.ops.geometry import setup_with_attrs

        # Triangle entirely past the far plane (z = 1.5 > 1).
        clip = np.array(
            [[-0.9, -0.9, 1.5, 1.0], [0.9, -0.9, 1.5, 1.0], [0.0, 0.9, 1.5, 1.0]],
            np.float32,
        )

        def run(clamp):
            records, corner = setup_with_attrs(
                jnp.asarray(clip), jnp.asarray([[0, 1, 2]], jnp.int32),
                jnp.zeros((3, 0), jnp.float32), W, H,
                cull_mode=CullMode.NONE, depth_clamp=clamp,
            )
            bins = bin_segmented(records, corner, GRID)
            z, acc = raster_segmented(
                bins, GRID, jnp.full((H, W), -1.0, jnp.float32),
                compare_op=CompareOp.GREATER, depth_clamp=clamp,
            )
            return np.asarray(z), np.asarray(acc[-1] > 0)

        z_off, cov_off = run(False)
        assert not cov_off.any()  # discarded without clamp
        z_on, cov_on = run(True)
        assert cov_on.sum() > 100
        np.testing.assert_allclose(z_on[cov_on], 1.0, atol=1e-6)  # clamped


class TestAnisotropic:
    def _checker(self, n=64):
        # 8-texel cells: sample points must not all land on cell boundaries
        # (bilinear at a boundary is identically 0.5 — a degenerate probe).
        yy, xx = np.mgrid[0:n, 0:n]
        c = ((xx // 8 + yy // 8) % 2).astype(np.float32)
        return np.stack([c, c, c], axis=-1)

    def _mips(self, base):
        mips = [jnp.asarray(base)]
        cur = base
        while min(cur.shape[:2]) > 1:
            hh, ww = cur.shape[0] // 2, cur.shape[1] // 2
            cur = cur[: hh * 2, : ww * 2].reshape(hh, 2, ww, 2, -1).mean((1, 3))
            mips.append(jnp.asarray(cur.astype(np.float32)))
        return mips

    def test_isotropic_footprint_matches_trilinear(self):
        from zenith.ops.sampling import sample_texture
        from zenith.rhi.sampler import SamplerConfig

        base = self._checker()
        mips = self._mips(base)
        hh, ww = 16, 16
        u = (np.arange(ww, dtype=np.float32) + 0.5) / ww
        v = (np.arange(hh, dtype=np.float32) + 0.5) / hh
        uv = jnp.asarray(np.stack(np.meshgrid(u, v), axis=-1))
        tri = sample_texture(tuple(mips), uv, SamplerConfig.linear())
        aniso = sample_texture(tuple(mips), uv, SamplerConfig.anisotropic(4.0))
        # Isotropic UV grid ⇒ ratio = 1 ⇒ all probes coincide with trilinear.
        np.testing.assert_allclose(
            np.asarray(aniso)[1:, 1:], np.asarray(tri)[1:, 1:], atol=1e-5
        )

    def test_anisotropic_footprint_sharper_than_trilinear(self):
        from zenith.ops.sampling import sample_texture
        from zenith.rhi.sampler import SamplerConfig

        base = self._checker()
        mips = self._mips(base)
        # Stretched footprint: u steps fast (minified 8×), v slow (1:1) —
        # trilinear must blur to the major axis; aniso keeps v-detail.
        hh, ww = 32, 8
        u = (np.arange(ww, dtype=np.float32) + 0.5) / ww
        v = (np.arange(hh, dtype=np.float32) + 0.5) / (hh * 4)
        uv = jnp.asarray(np.stack(np.meshgrid(u, v, indexing="xy"), axis=-1))
        tri = np.asarray(sample_texture(tuple(mips), uv, SamplerConfig.linear()))
        aniso = np.asarray(
            sample_texture(tuple(mips), uv, SamplerConfig.anisotropic(8.0))
        )
        assert np.isfinite(aniso).all()
        # Sharper = more variance along the minified-axis rows survived.
        assert aniso[1:, 1:].std() > tri[1:, 1:].std()


class TestStateValidation:
    def _mk_pipeline(self, state):
        from zenith.rhi.pipeline import (
            GraphicPipeline,
            GraphicPipelineDesc,
            GraphicShaderInput,
        )
        from zenith.rhi.shader import Shader
        from zenith.rhi.formats import Format

        vs = Shader.vertex("vs", lambda attrs, res: {"position": attrs["position"]})
        return GraphicPipeline(
            GraphicPipelineDesc(
                shader_input=GraphicShaderInput(vs, None, None),
                state=state,
                attachments=GraphicPipelineAttachments(
                    color_formats=(Format.RGBA32F,)
                ),
            )
        )

    def test_unsupported_sample_count_raises(self):
        state = GraphicPipelineState(multisample=MultisampleState(samples=3))
        with pytest.raises(NotImplementedError, match="multisampling"):
            self._mk_pipeline(state)

    def test_supported_sample_counts_ok(self):
        for n in (1, 2, 4, 8):
            self._mk_pipeline(
                GraphicPipelineState(multisample=MultisampleState(samples=n))
            )

    def test_stencil_without_format_raises(self):
        state = GraphicPipelineState(
            depth_stencil=DepthStencilDesc().stencil_write(1)
        )
        with pytest.raises(ValueError, match="stencil"):
            self._mk_pipeline(state)

    def test_default_state_ok(self):
        self._mk_pipeline(GraphicPipelineState())


class TestMSAA:
    """4x multisampling (Vulkan standard sample positions, spec 25.3):
    one shared binning, per-sample raster + shade, averaged resolve."""

    def _render(self, samples):
        import jax.numpy as jnp

        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rendergraph.graph import clear_frame_program_cache
        from zenith.rhi import (
            Buffer,
            ColorAttachmentDesc,
            Format,
            GraphicShaderInput,
            PipelineCache,
            RhiCore,
            Shader,
            TextureDesc,
            VertexLayout,
        )

        core = RhiCore()
        device = core.create_render_device()
        clear_frame_program_cache()
        # A thin sliver triangle maximizes partially-covered edge pixels.
        tri = np.array(
            [[-0.9, -0.85, 0.5, 1.0], [0.9, -0.62, 0.5, 1.0], [-0.9, -0.7, 0.5, 1.0]],
            np.float32,
        )
        vb = Buffer.from_numpy("sliver.vb", tri)
        ib = Buffer.from_numpy("sliver.ib", np.array([0, 1, 2], np.int32))
        vs = Shader.vertex("vs", lambda attrs, res: {"position": attrs["position"]})
        fs = Shader.fragment(
            "fs",
            lambda varyings, res, b: jnp.broadcast_to(
                jnp.asarray([1.0, 1.0, 1.0, 1.0]), b.depth.shape + (4,)
            ),
        )
        builder = RenderGraphBuilder()
        vbr, ibr = builder.import_resource(vb), builder.import_resource(ib)
        out = builder.create(TextureDesc.color("rt", W, H))
        dep = builder.create(TextureDesc.depth("ds", W, H))
        builder.export(out)
        node = builder.add_graphic_node("sliver")
        vba, iba = node.read(vbr), node.read(ibr)
        rt = node.write(out)
        dsw = node.write(dep)
        with node.pipeline(
            GraphicShaderInput(vs, fs, VertexLayout.from_fields(("position", 4))),
            GraphicPipelineState(
                rasterization=RasterizationState(cull_mode=CullMode.NONE),
                multisample=MultisampleState(samples=samples),
            ),
        ) as binder:
            binder.push_color(rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
            binder.set_depth(dsw, DepthStencilDesc().reverse_z())

        def record(ctx):
            ctx.draw_indexed(vba, iba)

        node.execute(record)
        compiled = builder.build().compile(
            device, PipelineCache(), CompileOptions(tile_h=8, tile_w=128)
        )
        compiled.execute(device)
        return np.asarray(compiled.value(out))

    def test_msaa_produces_partial_edge_coverage(self):
        img1 = self._render(1)[..., 0]
        img4 = self._render(4)[..., 0]
        # Single-sample: strictly binary coverage.
        assert set(np.round(np.unique(img1), 6)) <= {0.0, 1.0}
        # 4x: fractional coverage appears along the sliver's edges.
        partial = ((img4 > 0.1) & (img4 < 0.9)).sum()
        assert partial > 20, f"only {partial} partially covered pixels"
        # Same overall geometry: coverage masses agree within a pixel row.
        assert abs(img4.sum() - img1.sum()) / max(img1.sum(), 1) < 0.2

    def test_msaa8_edge_coverage_finer_than_4x(self):
        """8x: more coverage levels along the sliver edge than 4x."""
        img4 = self._render(4)[..., 0]
        img8 = self._render(8)[..., 0]
        levels4 = np.unique(np.round(img4, 4))
        levels8 = np.unique(np.round(img8, 4))
        assert len(levels8) > len(levels4) >= 3
        assert abs(img8.sum() - img4.sum()) / max(img4.sum(), 1) < 0.1


class TestMSAACrossNode:
    """Per-sample attachment persistence across nodes: a two-node MSAA
    chain (node 2 LOADs color+depth) must match drawing both triangles in
    ONE node — possible only if per-sample planes survive the node
    boundary (resolve-then-rebroadcast loses silhouette samples)."""

    def _build(self, split_nodes):
        import jax.numpy as jnp
        from dataclasses import replace

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
            VertexLayout,
        )
        from zenith.rhi.state import LoadOp

        device = RhiCore().create_render_device()
        clear_frame_program_cache()
        vs = Shader.vertex("vs", lambda attrs, res: {"position": attrs["position"]})

        def mk_fs(col):
            return Shader.fragment(
                f"fs{col}",
                lambda varyings, res, b, col=col: jnp.broadcast_to(
                    jnp.asarray(col), b.depth.shape + (4,)
                ),
            )

        # Two slivers crossing at different depths (reverse-Z GREATER).
        tri_a = np.array(
            [[-0.9, -0.85, 0.5, 1], [0.9, -0.62, 0.5, 1], [-0.9, -0.7, 0.5, 1]],
            np.float32,
        )
        tri_b = np.array(
            [[-0.9, -0.65, 0.7, 1], [0.9, -0.85, 0.7, 1], [0.9, -0.7, 0.7, 1]],
            np.float32,
        )
        vba = Buffer.from_numpy("a.vb", tri_a)
        vbb = Buffer.from_numpy("b.vb", tri_b)
        ib = Buffer.from_numpy("t.ib", np.array([0, 1, 2], np.int32))
        layout = VertexLayout.from_fields(("position", 4))
        state = GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE),
            depth_stencil=DepthStencilDesc().reverse_z(),
            multisample=MultisampleState(samples=4),
        )

        builder = RenderGraphBuilder()
        ra = builder.import_resource(vba)
        rb = builder.import_resource(vbb)
        ri = builder.import_resource(ib)
        out = builder.create(TextureDesc.color("rt", W, H))
        dep = builder.create(TextureDesc.depth("ds", W, H))
        builder.export(out)

        handle_of = {id(vba): ra, id(vbb): rb}

        def add_node(name, draws, first):
            node = builder.add_graphic_node(name)
            accesses = [
                (node.read(handle_of[id(v)]), node.read(ri)) for v, _ in draws
            ]
            rt = node.write(out)
            ds = node.write(dep)
            with node.pipeline(
                GraphicShaderInput(vs, draws[0][1], layout), state
            ) as binder:
                if first:
                    binder.push_color(
                        rt, ColorAttachmentDesc(clear_value=(0, 0, 0, 1))
                    )
                    binder.set_depth(ds, DepthStencilDesc().reverse_z())
                else:
                    binder.push_color(
                        rt, ColorAttachmentDesc(load_op=LoadOp.LOAD)
                    )
                    binder.set_depth(
                        ds,
                        replace(
                            DepthStencilDesc().reverse_z(),
                            depth_load_op=LoadOp.LOAD,
                        ),
                    )

            def record(ctx, accesses=accesses):
                for va, ia in accesses:
                    ctx.draw_indexed(va, ia)

            node.execute(record)

        fs_white = mk_fs((1.0, 1.0, 1.0, 1.0))
        if split_nodes:
            add_node("pass1", [(vba, fs_white)], first=True)
            add_node("pass2", [(vbb, fs_white)], first=False)
        else:
            add_node("both", [(vba, fs_white), (vbb, fs_white)], first=True)

        compiled = builder.build().compile(
            device, PipelineCache(), CompileOptions(tile_h=8, tile_w=128)
        )
        compiled.execute(device)
        return np.asarray(compiled.value(out))

    def test_two_node_msaa_chain_matches_single_node(self):
        single = self._build(split_nodes=False)
        split = self._build(split_nodes=True)
        # Fractional edge coverage exists (it's really multisampled)...
        vals = single[..., 0]
        assert ((vals > 0.1) & (vals < 0.9)).sum() > 20
        # ...and the node boundary is invisible.
        np.testing.assert_allclose(split, single, atol=1e-6)
