"""Instanced draws (vkCmdDrawIndexed instanceCount, command.rs:166):
N instances through one draw must match N separate draws exactly."""

import jax.numpy as jnp
import numpy as np

from zenith.ops import TileGrid, clear_color, clear_depth
from zenith.ops.draw import draw_indexed
from zenith.rhi.pipeline import (
    GraphicPipeline,
    GraphicPipelineDesc,
    GraphicShaderInput,
)
from zenith.rhi.formats import Format
from zenith.rhi.shader import Shader
from zenith.rhi.state import (
    ColorAttachmentDesc,
    CullMode,
    DepthStencilDesc,
    GraphicPipelineAttachments,
    GraphicPipelineState,
    RasterizationState,
    VertexLayout,
)

W, H = 128, 32
GRID = TileGrid(width=W, height=H, tile_h=8, tile_w=128)


def _vs(attrs, res):
    p = attrs["position"]
    # Instance-rate attributes: offset + color (broadcast per vertex).
    off = attrs.get("offset", jnp.zeros((p.shape[0], 4)))
    col = attrs.get("inst_color", jnp.ones((p.shape[0], 3)))
    return {"position": p + off, "color": col}


def _fs(varyings, res, builtins):
    c = varyings["color"]
    return jnp.concatenate([c, jnp.ones_like(c[..., :1])], -1)


def _pipeline():
    return GraphicPipeline(
        GraphicPipelineDesc(
            shader_input=GraphicShaderInput(
                Shader.vertex("inst.vs", _vs),
                Shader.fragment("inst.fs", _fs),
                VertexLayout.from_fields(("position", 4)),
            ),
            state=GraphicPipelineState(
                rasterization=RasterizationState(cull_mode=CullMode.NONE),
                depth_stencil=DepthStencilDesc().reverse_z(),
            ),
            attachments=GraphicPipelineAttachments(
                color_formats=(Format.RGBA32F,), depth_format=Format.D32F
            ),
            color_attachment_descs=(ColorAttachmentDesc(),),
        )
    )


class TestInstancing:
    def test_instanced_equals_separate_draws(self):
        pipeline = _pipeline()
        vb = jnp.asarray(
            [[-0.15, -0.3, 0.5, 1.0], [0.15, 0.3, 0.5, 1.0], [-0.15, 0.3, 0.5, 1.0]],
            jnp.float32,
        )
        ib = jnp.asarray([[0, 1, 2]], jnp.int32)
        n_inst = 5
        offs = np.zeros((n_inst, 4), np.float32)
        offs[:, 0] = np.linspace(-0.7, 0.7, n_inst)  # spread along x
        offs[:, 2] = np.linspace(0.1, 0.3, n_inst)  # distinct depths
        cols = np.eye(3)[np.arange(n_inst) % 3].astype(np.float32)

        # Instanced: one draw.
        colors = [clear_color(H, W, (0, 0, 0, 1))]
        depth = clear_depth(H, W, 0.0)
        colors, depth, stats = draw_indexed(
            colors, depth, pipeline, vb, ib, {}, GRID,
            instance_count=n_inst,
            instance_data={"offset": jnp.asarray(offs),
                           "inst_color": jnp.asarray(cols)},
        )
        inst_img, inst_z = np.asarray(colors[0]), np.asarray(depth)
        assert np.asarray(stats.bin_overflow) == 0

        # Reference: N separate draws with baked-in offsets.
        colors = [clear_color(H, W, (0, 0, 0, 1))]
        depth = clear_depth(H, W, 0.0)
        for i in range(n_inst):
            vb_i = vb + jnp.asarray(offs[i])[None, :]

            def vs_i(attrs, res, c=cols[i]):
                p = attrs["position"]
                return {
                    "position": p,
                    "color": jnp.broadcast_to(jnp.asarray(c), (p.shape[0], 3)),
                }

            pipe_i = GraphicPipeline(
                GraphicPipelineDesc(
                    shader_input=GraphicShaderInput(
                        Shader.vertex(f"sep{i}.vs", vs_i),
                        Shader.fragment("sep.fs", _fs),
                        VertexLayout.from_fields(("position", 4)),
                    ),
                    state=pipeline.desc.state,
                    attachments=pipeline.desc.attachments,
                    color_attachment_descs=pipeline.desc.color_attachment_descs,
                )
            )
            colors, depth, _ = draw_indexed(
                colors, depth, pipe_i, vb_i, ib, {}, GRID
            )
        sep_img, sep_z = np.asarray(colors[0]), np.asarray(depth)

        np.testing.assert_array_equal(inst_z, sep_z)
        np.testing.assert_allclose(inst_img, sep_img, atol=2e-6)
        # All five instances actually visible.
        assert (inst_img[..., 0] > 0.5).any()
        assert (inst_img[..., 1] > 0.5).any()

    def test_instance_index_builtin(self):
        """gl_InstanceIndex analog reaches the vertex stage."""
        def vs(attrs, res):
            p = attrs["position"]
            ii = attrs["instance_index"]  # (Nv, 1)
            return {
                "position": p + jnp.concatenate(
                    [ii * 0.4 - 0.4, jnp.zeros_like(p[:, :3])], axis=1
                ),
                "color": jnp.broadcast_to(
                    jnp.concatenate([ii, 1.0 - ii, jnp.zeros_like(ii)], -1),
                    (p.shape[0], 3),
                ),
            }

        pipeline = GraphicPipeline(
            GraphicPipelineDesc(
                shader_input=GraphicShaderInput(
                    Shader.vertex("ii.vs", vs),
                    Shader.fragment("ii.fs", _fs),
                    VertexLayout.from_fields(("position", 4)),
                ),
                state=GraphicPipelineState(
                    rasterization=RasterizationState(cull_mode=CullMode.NONE),
                ),
                attachments=GraphicPipelineAttachments(
                    color_formats=(Format.RGBA32F,)
                ),
                color_attachment_descs=(ColorAttachmentDesc(),),
            )
        )
        vb = jnp.asarray(
            [[0.0, -0.4, 0.5, 1.0], [0.2, 0.4, 0.5, 1.0], [-0.2, 0.4, 0.5, 1.0]],
            jnp.float32,
        )
        ib = jnp.asarray([[0, 1, 2]], jnp.int32)
        colors = [clear_color(H, W, (0, 0, 0, 1))]
        colors, _, _ = draw_indexed(
            colors, None, pipeline, vb, ib, {}, GRID, instance_count=2
        )
        img = np.asarray(colors[0])
        reds = img[..., 0] > 0.5
        greens = img[..., 1] > 0.5
        assert reds.any() and greens.any()
        # Instance 1 (red) sits right of instance 0 (green).
        assert np.where(reds)[1].mean() > np.where(greens)[1].mean()

class TestInstancedScene:
    """Instancing through the DEFERRED renderer (shadow.inst + gbuffer.inst
    nodes): one object with N instance offsets must render identically to
    N separate objects with translated model matrices."""

    def test_instanced_deferred_matches_separate_objects(self):
        import sys

        sys.path.insert(0, "tests")
        import dataclasses

        from test_renderers import H, OPTS, W, make_camera, make_cube

        from zenith.core import mathtypes as m
        from zenith.renderer import (
            DeferredRenderer,
            DirectionalLight,
            PostProcess,
            Scene,
            SceneObject,
        )
        from zenith.rendergraph import RenderGraphBuilder
        from zenith.rendergraph.graph import clear_frame_program_cache
        from zenith.rhi import PipelineCache, RhiCore, TextureDesc

        device = RhiCore().create_render_device()
        cam = make_camera()
        offsets = np.array(
            [[-18.0, 0.0, 0.0], [0.0, 6.0, 0.0], [18.0, 0.0, 4.0]], np.float32
        )
        cube_kwargs = dict(
            base_color=(0.8, 0.25, 0.2, 1.0), metallic=0.1, roughness=0.5,
            bin_capacity=64,
        )
        ground = SceneObject.quad(
            device, "ground", size=200.0, z=0.0,
            base_color=(0.4, 0.4, 0.42, 1.0), roughness=0.9,
        )
        sun = DirectionalLight(direction=(0.2, -0.1, 1.0), intensity=2.5,
                               shadow_map_size=128, shadow_extent=70.0)

        def render(scene):
            clear_frame_program_cache()
            renderer = DeferredRenderer(scene)
            builder = RenderGraphBuilder()
            out = builder.create(TextureDesc.color("rt", W, H))
            builder.export(out)
            renderer.render_to(builder, out, cam, W, H)
            compiled = builder.build().compile(device, PipelineCache(), OPTS)
            compiled.execute(device)
            return np.asarray(compiled.value(out))

        # A: one instanced cube.
        inst_cube = SceneObject.from_mesh(
            device, make_cube(size=8.0, z0=4.0), "cube",
            instance_offsets=offsets, **cube_kwargs,
        )
        img_inst = render(
            Scene(objects=[inst_cube, ground], sun=sun, ambient=(0.05,) * 3)
        )

        # B: three separate cubes at translated model matrices.
        separate = [
            SceneObject.from_mesh(
                device, make_cube(size=8.0, z0=4.0), f"cube{k}",
                model_matrix=m.mat4_translation(offsets[k]),
                **cube_kwargs,
            )
            for k in range(3)
        ]
        img_sep = render(
            Scene(objects=[*separate, ground], sun=sun, ambient=(0.05,) * 3)
        )

        assert img_inst[..., :3].std() > 0.02  # cubes visible
        np.testing.assert_allclose(img_inst, img_sep, atol=2e-3)

    def test_instanced_forward_matches_separate_objects(self):
        """Same equivalence through the FORWARD shadow+lit path
        (shadow.inst + forward.inst nodes)."""
        import sys

        sys.path.insert(0, "tests")
        from test_renderers import H, OPTS, W, make_camera, make_cube

        from zenith.core import mathtypes as m
        from zenith.renderer import (
            DirectionalLight,
            ForwardShadowRenderer,
            Scene,
            SceneObject,
        )
        from zenith.rendergraph import RenderGraphBuilder
        from zenith.rendergraph.graph import clear_frame_program_cache
        from zenith.rhi import PipelineCache, RhiCore, TextureDesc

        device = RhiCore().create_render_device()
        cam = make_camera()
        offsets = np.array(
            [[-18.0, 0.0, 0.0], [0.0, 6.0, 0.0], [18.0, 0.0, 4.0]], np.float32
        )
        cube_kwargs = dict(
            base_color=(0.2, 0.6, 0.8, 1.0), roughness=0.5, bin_capacity=64,
        )
        ground = SceneObject.quad(
            device, "ground", size=200.0, z=0.0,
            base_color=(0.4, 0.4, 0.42, 1.0), roughness=0.9,
        )
        sun = DirectionalLight(direction=(0.2, -0.1, 1.0), intensity=2.5,
                               shadow_map_size=128, shadow_extent=70.0)

        def render(scene):
            clear_frame_program_cache()
            renderer = ForwardShadowRenderer(scene)
            builder = RenderGraphBuilder()
            out = builder.create(TextureDesc.color("rt", W, H))
            depth = builder.create(TextureDesc.depth("ds", W, H))
            builder.export(out)
            renderer.render_to(builder, out, depth, cam)
            compiled = builder.build().compile(device, PipelineCache(), OPTS)
            compiled.execute(device)
            return np.asarray(compiled.value(out))

        inst_cube = SceneObject.from_mesh(
            device, make_cube(size=8.0, z0=4.0), "cube",
            instance_offsets=offsets, **cube_kwargs,
        )
        img_inst = render(
            Scene(objects=[inst_cube, ground], sun=sun, ambient=(0.05,) * 3)
        )
        separate = [
            SceneObject.from_mesh(
                device, make_cube(size=8.0, z0=4.0), f"cube{k}",
                model_matrix=m.mat4_translation(offsets[k]),
                **cube_kwargs,
            )
            for k in range(3)
        ]
        img_sep = render(
            Scene(objects=[*separate, ground], sun=sun, ambient=(0.05,) * 3)
        )
        assert img_inst[..., :3].std() > 0.02
        np.testing.assert_allclose(img_inst, img_sep, atol=2e-3)

    def test_all_instanced_scene_renders(self):
        """A scene whose only object is instanced must not trip the empty
        plain-draw batch (regression: empty draw_indexed_batch assert)."""
        import sys

        sys.path.insert(0, "tests")
        from test_renderers import H, OPTS, W, make_camera, make_cube

        from zenith.renderer import (
            DeferredRenderer,
            DirectionalLight,
            ForwardShadowRenderer,
            Scene,
            SceneObject,
        )
        from zenith.rendergraph import RenderGraphBuilder
        from zenith.rendergraph.graph import clear_frame_program_cache
        from zenith.rhi import PipelineCache, RhiCore, TextureDesc

        device = RhiCore().create_render_device()
        cam = make_camera()
        cube = SceneObject.from_mesh(
            device, make_cube(size=10.0, z0=2.0), "only",
            base_color=(0.7, 0.3, 0.2, 1.0), bin_capacity=64,
            instance_offsets=np.array(
                [[-12.0, 0.0, 0.0], [12.0, 0.0, 0.0]], np.float32
            ),
        )
        sun = DirectionalLight(direction=(0.2, -0.1, 1.0), intensity=2.0,
                               shadow_map_size=128, shadow_extent=60.0)
        scene = Scene(objects=[cube], sun=sun, ambient=(0.1,) * 3)

        for make in (
            lambda: DeferredRenderer(scene),
            lambda: ForwardShadowRenderer(scene),
        ):
            clear_frame_program_cache()
            renderer = make()
            builder = RenderGraphBuilder()
            out = builder.create(TextureDesc.color("rt", W, H))
            depth = builder.create(TextureDesc.depth("ds", W, H))
            builder.export(out)
            if isinstance(renderer, DeferredRenderer):
                renderer.render_to(builder, out, cam, W, H)
            else:
                renderer.render_to(builder, out, depth, cam)
            compiled = builder.build().compile(device, PipelineCache(), OPTS)
            compiled.execute(device)
            img = np.asarray(compiled.value(out))
            assert img[..., :3].std() > 0.01  # cubes rendered
