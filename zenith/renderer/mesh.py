"""MeshRenderer — textured forward pass with depth + Blinn-Phong.

BASELINE.md config #2: "Textured mesh (cerberus) + depth test + Blinn-Phong,
single forward pass". The reference stops at TriangleRenderer; this renderer
follows the same feature-renderer shape (owns buffers/shaders, declares one
graph node via render_to — zenith-renderer/src/triangle.rs:18-180) extended
with a camera, a depth attachment, a directional light, and optional
base-color texturing.

Winding note: with the Vulkan clip-space Y flip baked into the camera's
render_view_projection (mathtypes.VULKAN_Y_FLIP), glTF meshes keep their
standard COUNTER_CLOCKWISE front faces with BACK culling.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from zenith.asset.render_types import Mesh as MeshAsset, Vertex as VERTEX_LAYOUT
from zenith.core.camera import Camera
from zenith.rendergraph import RenderGraphBuilder
from zenith.rendergraph.resource import RenderGraphResource
from zenith.rhi import (
    BufferUsage,
    ColorAttachmentDesc,
    CullMode,
    FrontFace,
    GraphicShaderInput,
    RasterizationState,
    Shader,
    Texture,
    TextureDesc,
    attr,
    sampler as sampler_binding,
    texture2d,
    uniform,
)
from zenith.rhi.device import RenderDevice
from zenith.rhi.sampler import SamplerConfig
from zenith.rhi.state import DepthStencilDesc, GraphicPipelineState
from zenith.ops.sampling import sample_2d


def _vs(attrs, res):
    """World-space mesh through the camera (infinite-reverse-Z)."""
    pos = attrs["position"]
    n = pos.shape[0]
    model = res["Model"]  # (4, 4)
    view_proj = res["ViewProj"]  # (4, 4)
    hom = jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1)
    world = hom @ model.T
    clip = world @ view_proj.T
    # Normal matrix approximated by the model rotation (uniform scale only).
    normal_world = attrs["normal"] @ model[:3, :3].T
    return {
        "position": clip,
        "world_pos": world[:, :3],
        "normal": normal_world,
        "uv": attrs["tex_coord"],
    }


def _make_fs(textured: bool):
    def fs(varyings, res, builtins):
        """Blinn-Phong: ambient + diffuse + specular from one directional
        light, albedo from base-color factor × optional texture."""
        n = varyings["normal"]
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
        # Two-sided normal flip for back faces.
        n = jnp.where(builtins.front_facing[..., None], n, -n)

        light_dir = res["LightDir"]  # (3,) direction TOWARD the light
        light_color = res["LightColor"]  # (3,)
        ambient = res["Ambient"]  # (3,)
        camera_pos = res["CameraPos"]  # (3,)
        base_color = res["BaseColor"]  # (4,)

        albedo = jnp.broadcast_to(base_color[:3], n.shape)
        if textured:
            albedo = albedo * sample_2d(
                res["BaseColorTex"], varyings["uv"], res["BaseColorSampler"]
            )[..., :3]

        l = light_dir / jnp.linalg.norm(light_dir)
        ndotl = jnp.maximum(jnp.sum(n * l, axis=-1, keepdims=True), 0.0)
        v = camera_pos - varyings["world_pos"]
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-8)
        h = l + v
        h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-8)
        spec = jnp.power(
            jnp.maximum(jnp.sum(n * h, axis=-1, keepdims=True), 0.0), 32.0
        )
        color = albedo * (ambient + light_color * ndotl) + light_color * spec * 0.25
        alpha = jnp.ones_like(color[..., :1])
        return jnp.concatenate([color, alpha], axis=-1)

    return fs


class MeshRenderer:
    """Forward Blinn-Phong renderer for one mesh asset."""

    def __init__(
        self,
        device: RenderDevice,
        mesh: MeshAsset,
        base_color_factor=(1.0, 1.0, 1.0, 1.0),
        base_color_texture: "Optional[Texture]" = None,
        model_matrix: "Optional[np.ndarray]" = None,
        bin_capacity: int = 1024,
    ):
        self.vertex_buffer = device.upload_buffer(
            f"{mesh.url}.vb", mesh.vertices, BufferUsage.VERTEX
        )
        self.index_buffer = device.upload_buffer(
            f"{mesh.url}.ib", mesh.indices, BufferUsage.INDEX
        )
        self.base_color_factor = np.asarray(base_color_factor, np.float32)
        self.base_color_texture = base_color_texture
        self.model_matrix = (
            np.asarray(model_matrix, np.float32)
            if model_matrix is not None
            else np.eye(4, dtype=np.float32)
        )
        self.bin_capacity = bin_capacity
        self.num_triangles = mesh.num_triangles

        textured = base_color_texture is not None
        bindings = [
            uniform("Model"), uniform("ViewProj"), uniform("LightDir"),
            uniform("LightColor"), uniform("Ambient"), uniform("CameraPos"),
            uniform("BaseColor"),
        ]
        if textured:
            bindings += [texture2d("BaseColorTex"), sampler_binding("BaseColorSampler")]
        self.vertex_shader = Shader.vertex(
            "mesh.vs", _vs, bindings=[uniform("Model"), uniform("ViewProj")],
            inputs=[attr("position", 3), attr("normal", 3),
                    attr("tex_coord", 2)],
        )
        self.fragment_shader = Shader.fragment(
            "mesh.fs", _make_fs(textured), bindings=bindings
        )
        self._textured = textured

    def render_to(
        self,
        builder: RenderGraphBuilder,
        output: RenderGraphResource,
        depth: RenderGraphResource,
        camera: Camera,
        light_dir=(0.3, -0.5, 0.8),
        light_color=(1.0, 1.0, 1.0),
        ambient=(0.08, 0.08, 0.1),
        clear_color=(0.05, 0.06, 0.08, 1.0),
        load_color: bool = False,
    ) -> None:
        vb = builder.import_resource(self.vertex_buffer)
        ib = builder.import_resource(self.index_buffer)
        tex = (
            builder.import_resource(self.base_color_texture)
            if self._textured
            else None
        )

        builder.set_dynamic("mesh.model", self.model_matrix)
        builder.set_dynamic("mesh.view_proj", camera.render_view_projection)
        builder.set_dynamic("mesh.camera_pos", camera.location)
        builder.set_dynamic("mesh.light_dir", np.asarray(light_dir, np.float32))
        builder.set_dynamic("mesh.light_color", np.asarray(light_color, np.float32))
        builder.set_dynamic("mesh.ambient", np.asarray(ambient, np.float32))
        builder.set_dynamic("mesh.base_color", self.base_color_factor)

        node = builder.add_graphic_node("mesh.forward")
        vba = node.read(vb)
        iba = node.read(ib)
        texa = node.read(tex) if tex is not None else None
        rt = node.write(output)
        ds = node.write(depth)

        shader = GraphicShaderInput(
            self.vertex_shader, self.fragment_shader, VERTEX_LAYOUT
        )
        state = GraphicPipelineState(
            rasterization=RasterizationState(
                cull_mode=CullMode.BACK, front_face=FrontFace.COUNTER_CLOCKWISE
            )
        )
        color_desc = ColorAttachmentDesc(clear_value=tuple(clear_color))
        if load_color:
            color_desc = color_desc.load_input()
        with node.pipeline(shader, state) as binder:
            binder.push_color(rt, color_desc)
            binder.set_depth(ds, DepthStencilDesc().reverse_z())

        bin_capacity = self.bin_capacity

        def record(ctx):
            ctx.bind("Model", ctx.dynamic("mesh.model"))
            ctx.bind("ViewProj", ctx.dynamic("mesh.view_proj"))
            ctx.bind("CameraPos", ctx.dynamic("mesh.camera_pos"))
            ctx.bind("LightDir", ctx.dynamic("mesh.light_dir"))
            ctx.bind("LightColor", ctx.dynamic("mesh.light_color"))
            ctx.bind("Ambient", ctx.dynamic("mesh.ambient"))
            ctx.bind("BaseColor", ctx.dynamic("mesh.base_color"))
            if texa is not None:
                ctx.bind("BaseColorTex", ctx.get(texa))
                ctx.bind("BaseColorSampler", SamplerConfig.linear())
            ctx.draw_indexed(vba, iba, bin_capacity=bin_capacity)

        node.execute(record)
