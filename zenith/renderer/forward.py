"""Forward renderer with a shadow-map pass — BASELINE.md config #3:
"Multi-pass rendergraph: shadow-map pass + forward lit pass".

Two graph nodes:
1. ``shadow``  — depth-only node (no color attachments) rendering every
   scene object from the sun's orthographic camera. Regular-Z (near→0,
   LESS), cleared to 1.0.
2. ``forward`` — Blinn-Phong lit pass over the main camera with depth, each
   fragment PCF-sampling the shadow map.

In Vulkan the passes would be ordered by an image barrier on the shadow map
(reference graph.rs:350-482); here node 2 simply consumes node 1's traced
depth array — the dependency IS the schedule, and XLA may even overlap
independent parts of both passes.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from zenith.asset.render_types import Vertex as VERTEX_LAYOUT
from zenith.core import mathtypes as m
from zenith.core.camera import Camera
from zenith.ops.sampling import sample_shadow_pcf
from zenith.rendergraph import RenderGraphBuilder
from zenith.rendergraph.resource import RenderGraphResource
from zenith.renderer.scene import DirectionalLight, Scene
from zenith.renderer.static_batch import StaticGeometryCache
from zenith.rhi import (
    ColorAttachmentDesc,
    CullMode,
    FrontFace,
    GraphicShaderInput,
    RasterizationState,
    Shader,
    TextureDesc,
    attr,
    texture2d,
    uniform,
)
from zenith.rhi.state import (
    CompareOp,
    DepthStencilDesc,
    GraphicPipelineState,
    LoadOp,
)


def sun_view_projection(sun: DirectionalLight) -> np.ndarray:
    """Orthographic light camera looking along -direction at the origin.

    Memoized per sun identity — called every frame and the sun is static in
    practice; mutate a DirectionalLight's fields (replace, don't edit
    arrays in place) and the cache follows the field values."""
    # Normalize direction to a plain tuple: an ndarray direction would make
    # the key comparison raise (ambiguous array truth) or false-hit on
    # in-place mutation.
    d = tuple(float(x) for x in np.asarray(sun.direction).reshape(-1))
    key = (d, float(sun.shadow_near), float(sun.shadow_far),
           float(sun.shadow_extent))
    cached = getattr(sun, "_svp_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    out = _sun_view_projection(sun)
    object.__setattr__(sun, "_svp_cache", (key, out))
    return out


def _sun_view_projection(sun: DirectionalLight) -> np.ndarray:
    d = m.normalize(np.asarray(sun.direction, np.float32))
    eye = d * (0.5 * (sun.shadow_near + sun.shadow_far))
    up = np.array([0, 0, 1], np.float32)
    if abs(float(np.dot(d, up))) > 0.95:
        up = np.array([0, 1, 0], np.float32)
    view = m.look_to_rh(eye, -d, up)
    e = sun.shadow_extent
    proj = m.orthographic_rh(-e, e, -e, e, sun.shadow_near, sun.shadow_far)
    # Same Vulkan Y flip as the main camera (render and sample agree).
    return (m.VULKAN_Y_FLIP @ proj @ view).astype(np.float32)


def _shadow_vs(attrs, res):
    pos = attrs["position"]
    n = pos.shape[0]
    hom = jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1)
    world = hom @ res["Model"].T
    return {"position": world @ res["LightViewProj"].T}


def _forward_vs(attrs, res):
    pos = attrs["position"]
    n = pos.shape[0]
    hom = jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1)
    world = hom @ res["Model"].T
    return {
        "position": world @ res["ViewProj"].T,
        "world_pos": world[:, :3],
        "normal": attrs["normal"] @ res["Model"][:3, :3].T,
        "uv": attrs["tex_coord"],
    }


def _shadow_inst_vs(attrs, res):
    pos = attrs["position"]
    n = pos.shape[0]
    hom = jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1)
    world = hom @ res["Model"].T
    world_pos = world[:, :3] + attrs["inst_offset"]
    clip_hom = jnp.concatenate([world_pos, world[:, 3:4]], axis=1)
    return {"position": clip_hom @ res["LightViewProj"].T}


def _forward_inst_vs(attrs, res):
    """Instanced forward vertex stage: per-instance world-space offset."""
    pos = attrs["position"]
    n = pos.shape[0]
    hom = jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1)
    world = hom @ res["Model"].T
    world_pos = world[:, :3] + attrs["inst_offset"]
    clip_hom = jnp.concatenate([world_pos, world[:, 3:4]], axis=1)
    return {
        "position": clip_hom @ res["ViewProj"].T,
        "world_pos": world_pos,
        "normal": attrs["normal"] @ res["Model"][:3, :3].T,
        "uv": attrs["tex_coord"],
    }


def _forward_fs(varyings, res, builtins):
    n = varyings["normal"]
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    n = jnp.where(builtins.front_facing[..., None], n, -n)
    world = varyings["world_pos"]

    l = res["LightDir"]
    l = l / jnp.linalg.norm(l)
    ndotl = jnp.maximum(jnp.sum(n * l, axis=-1, keepdims=True), 0.0)

    # Shadow test: project into the light's clip space, offsetting along the
    # normal by ~a shadow texel (normal-offset sampling kills acne on faces
    # steep in light space, where a constant depth bias cannot).
    sample_pos = world + n * res["ShadowNormalOffset"]
    hom = jnp.concatenate([sample_pos, jnp.ones_like(world[..., :1])], axis=-1)
    light_clip = hom @ res["LightViewProj"].T  # ortho: w == 1
    uv = jnp.stack(
        [(light_clip[..., 0] + 1.0) * 0.5, (light_clip[..., 1] + 1.0) * 0.5],
        axis=-1,
    )
    ref = light_clip[..., 2] - res["ShadowBias"]
    lit = sample_shadow_pcf(res["ShadowMap"], uv, ref, _SHADOW_SAMPLER)
    # Outside the shadow frustum → fully lit.
    inside = (
        (uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0)
        & (uv[..., 1] >= 0.0) & (uv[..., 1] <= 1.0)
    )
    lit = jnp.where(inside, lit, 1.0)[..., None]

    v = res["CameraPos"] - world
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-8)
    h = l + v
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-8)
    spec = jnp.power(jnp.maximum(jnp.sum(n * h, axis=-1, keepdims=True), 0.0), 32.0)

    albedo = jnp.broadcast_to(res["BaseColor"][..., :3], n.shape)
    direct = res["LightColor"] * ndotl * lit
    color = albedo * (res["Ambient"] + direct) + res["LightColor"] * spec * 0.25 * lit
    return jnp.concatenate([color, jnp.ones_like(color[..., :1])], axis=-1)


# PCF compare for regular-Z shadow maps: fragment lit when its light-depth
# (minus bias) is ≤ the stored nearest-occluder depth.
from zenith.rhi.sampler import AddressMode, BorderColor, SamplerConfig

_SHADOW_SAMPLER = SamplerConfig(
    address_mode_u=AddressMode.CLAMP_TO_EDGE,
    address_mode_v=AddressMode.CLAMP_TO_EDGE,
    compare_enable=True,
    compare_op=CompareOp.LESS_OR_EQUAL,
    border_color=BorderColor.OPAQUE_WHITE,
)


class ForwardShadowRenderer:
    """Shadow pass + forward lit pass over a Scene."""

    def __init__(self, scene: Scene, wireframe: bool = False, msaa: int = 1,
                 sample_shading: bool = True):
        """``msaa``: sample count (1/2/4/8) on the lit pass — the shadow
        pass stays single-sample (GPU convention: shadow maps are not
        multisampled). Consumers of the output (post chain, present) read
        the resolved surface automatically; ``sample_shading`` follows
        MultisampleState semantics (batched plain draws shade per sample
        either way)."""
        self.scene = scene
        self.wireframe = wireframe
        self.msaa = msaa
        self._static_cache = StaticGeometryCache()
        self.shadow_vs = Shader.vertex(
            "shadow.vs", _shadow_vs,
            bindings=[uniform("Model"), uniform("LightViewProj")],
            inputs=[attr("position", 3)],
        )
        self.forward_vs = Shader.vertex(
            "forward.vs", _forward_vs,
            bindings=[uniform("Model"), uniform("ViewProj")],
            inputs=[attr("position", 3), attr("normal", 3), attr("tex_coord", 2)],
        )
        self.shadow_inst_vs = Shader.vertex(
            "fwd.shadow.inst.vs", _shadow_inst_vs,
            bindings=[uniform("Model"), uniform("LightViewProj")],
            inputs=[attr("position", 3),
                    attr("inst_offset", 3, per_instance=True)],
        )
        self.forward_inst_vs = Shader.vertex(
            "forward.inst.vs", _forward_inst_vs,
            bindings=[uniform("Model"), uniform("ViewProj")],
            inputs=[attr("position", 3), attr("normal", 3), attr("tex_coord", 2),
                    attr("inst_offset", 3, per_instance=True)],
        )
        self.forward_fs = Shader.fragment(
            "forward.fs", _forward_fs,
            bindings=[
                uniform("LightDir"), uniform("LightColor"), uniform("Ambient"),
                uniform("CameraPos"), uniform("BaseColor"),
                uniform("LightViewProj"), uniform("ShadowBias"),
                uniform("ShadowNormalOffset"), texture2d("ShadowMap"),
            ],
        )
        # Frame-invariant pipeline inputs, built ONCE (render_to runs every
        # frame; identical desc objects hit the hash memos / identity
        # fast paths in the structure key and pipeline cache).
        from dataclasses import replace as _dc_replace

        self._shadow_si = GraphicShaderInput(self.shadow_vs, None, VERTEX_LAYOUT)
        self._shadow_inst_si = GraphicShaderInput(
            self.shadow_inst_vs, None, VERTEX_LAYOUT
        )
        self._forward_si = GraphicShaderInput(
            self.forward_vs, self.forward_fs, VERTEX_LAYOUT
        )
        self._forward_inst_si = GraphicShaderInput(
            self.forward_inst_vs, self.forward_fs, VERTEX_LAYOUT
        )
        self._shadow_state = GraphicPipelineState(
            rasterization=RasterizationState(
                cull_mode=CullMode.NONE, front_face=FrontFace.CLOCKWISE
            )
        )
        # Wireframe debug view: LINE polygon mode on the lit pass only (the
        # shadow pass keeps FILL so shadows stay solid — matching GPU debug
        # viewers); lines go through the same lit fragment shader.
        from zenith.rhi.state import PolygonMode

        from zenith.rhi.state import MultisampleState

        self._forward_state = GraphicPipelineState(
            rasterization=RasterizationState(
                cull_mode=CullMode.BACK, front_face=FrontFace.COUNTER_CLOCKWISE,
                polygon_mode=(
                    PolygonMode.LINE if wireframe else PolygonMode.FILL
                ),
            ),
            multisample=MultisampleState(
                samples=msaa, sample_shading=sample_shading
            ),
        )
        self._shadow_depth = DepthStencilDesc(
            depth_test_enable=True,
            depth_write_enable=True,
            depth_compare_op=CompareOp.LESS,
            depth_clear_value=1.0,
        )
        self._shadow_depth_load = _dc_replace(
            self._shadow_depth, depth_load_op=LoadOp.LOAD
        )
        self._forward_depth = DepthStencilDesc().reverse_z()
        self._forward_depth_load = _dc_replace(
            self._forward_depth, depth_load_op=LoadOp.LOAD
        )
        self._ca_load = ColorAttachmentDesc(load_op=LoadOp.LOAD)

    def frame_dynamics(self, camera: Camera,
                       include_models: bool = False) -> dict:
        """Per-frame dynamic values for RETAINED execution (everything else
        this renderer declares is static per scene). Pass
        ``include_models=True`` when objects move or toggle
        ``SceneObject.visible`` between retained frames."""
        d = _camera_dynamics("fwd", camera, want_inv_vp=False)
        if include_models:
            from zenith.renderer.scene import stacked_models

            d["fwd.models"] = stacked_models(self.scene.objects)
        return d

    def render_to(
        self,
        builder: RenderGraphBuilder,
        output: RenderGraphResource,
        depth: RenderGraphResource,
        camera: Camera,
        clear_color=(0.05, 0.06, 0.08, 1.0),
    ) -> None:
        scene = self.scene
        sun = scene.sun or DirectionalLight(cast_shadows=False)
        light_vp = sun_view_projection(sun)
        size = sun.shadow_map_size

        builder.set_dynamic("fwd.view_proj", camera.render_view_projection)
        builder.set_dynamic("fwd.camera_pos", camera.location)
        builder.set_dynamic("fwd.light_vp", light_vp)
        builder.set_dynamic("fwd.light_dir", m.normalize(np.asarray(sun.direction, np.float32)))
        builder.set_dynamic(
            "fwd.light_color",
            np.asarray(sun.color, np.float32) * sun.intensity,
        )
        builder.set_dynamic("fwd.ambient", np.asarray(scene.ambient, np.float32))
        builder.set_dynamic("fwd.shadow_bias", np.float32(sun.shadow_bias))
        builder.set_dynamic(
            "fwd.shadow_noffs", np.float32(sun.effective_normal_offset)
        )
        # One dynamic per FIELD (see deferred.render_to): stacked (N, ...)
        # arrays instead of N separate dynamics; closures slice at trace
        # time.
        from zenith.renderer.scene import stacked_models

        builder.set_dynamic("fwd.models", stacked_models(scene.objects))
        builder.set_dynamic("fwd.base_colors", np.stack(
            [o.base_color_array() for o in scene.objects]
        ))
        for obj in scene.objects:
            if obj.instance_offsets is not None:
                builder.set_dynamic(
                    f"fwd.inst.{obj.name}",
                    # Device-resident offsets (GPU-sim particles) pass through
                    # untouched — np.asarray on a jax.Array would
                    # force a device sync + download per frame.
                    obj.instance_offsets
                    if isinstance(obj.instance_offsets, jax.Array)
                    else np.asarray(obj.instance_offsets, np.float32),
                )
        plain_ix = [i for i, o in enumerate(scene.objects)
                    if o.instance_offsets is None]
        inst_ix = [i for i, o in enumerate(scene.objects)
                   if o.instance_offsets is not None]

        # Static batching (renderer/static_batch.py): plain draws share one
        # concatenated buffer pair; per-frame host cost is O(1) in objects.
        static_geo = self._static_cache.get(scene.objects, plain_ix)
        per_obj_ix = inst_ix if static_geo is not None else plain_ix + inst_ix
        handles = {
            i: (
                builder.import_resource(scene.objects[i].vertex_buffer),
                builder.import_resource(scene.objects[i].index_buffer),
            )
            for i in per_obj_ix
        }
        if static_geo is not None:
            s_vb_h = builder.import_resource(static_geo.vb)
            s_ib_h = builder.import_resource(static_geo.ib)

        shadow_map = builder.create(TextureDesc.depth("sun.shadow", size, size))

        # -- node 1: shadow (depth-only) --------------------------------------
        node = builder.add_graphic_node("shadow")
        if static_geo is None:
            accesses = {
                i: (node.read(handles[i][0]), node.read(handles[i][1]))
                for i in plain_ix
            }
            s_acc = None
        else:
            accesses = None
            s_acc = (node.read(s_vb_h), node.read(s_ib_h))
        sm = node.write(shadow_map)
        with node.pipeline(self._shadow_si, self._shadow_state) as binder:
            binder.set_depth(sm, self._shadow_depth)

        objects = scene.objects

        def record_shadow(ctx):
            ctx.bind("LightViewProj", ctx.dynamic("fwd.light_vp"))
            models = ctx.dynamic("fwd.models")
            if not plain_ix:  # all-instanced scenes: clear-only shadow node
                return
            if static_geo is not None:
                vb_all, ib_all = ctx.get(s_acc[0]), ctx.get(s_acc[1])
                draws = [
                    (vb_all[vo:vo + vc], ib_all[io_:io_ + ic],
                     {"Model": models[i]})
                    for i, (vo, vc, io_, ic)
                    in zip(plain_ix, static_geo.ranges)
                ]
            else:
                draws = [
                    (accesses[i][0], accesses[i][1], {"Model": models[i]})
                    for i in plain_ix
                ]
            ctx.draw_indexed_batch(draws)

        node.execute(record_shadow)

        if inst_ix:
            node = builder.add_graphic_node("shadow.inst")
            sh_inst_acc = {
                i: (node.read(handles[i][0]), node.read(handles[i][1]))
                for i in inst_ix
            }
            node.read(shadow_map)
            sm2 = node.write(shadow_map)
            with node.pipeline(
                self._shadow_inst_si, self._shadow_state
            ) as binder:
                binder.set_depth(sm2, self._shadow_depth_load)

            def record_shadow_inst(ctx):
                ctx.bind("LightViewProj", ctx.dynamic("fwd.light_vp"))
                models = ctx.dynamic("fwd.models")
                for i in inst_ix:
                    obj = objects[i]
                    vba, iba = sh_inst_acc[i]
                    ctx.draw_indexed(
                        vba, iba,
                        {"Model": models[i]},
                        instance_count=obj.instance_count,
                        instance_data={
                            "inst_offset": ctx.dynamic(f"fwd.inst.{obj.name}")
                        },
                    )

            node.execute(record_shadow_inst)

        # -- node 2: forward lit ----------------------------------------------
        node2 = builder.add_graphic_node("forward")
        # SPMD auto-decomposition hint (lazy — see scene.band_hint_for).
        from zenith.renderer.scene import band_hint_for

        node2.set_band_hint(
            lambda objs=scene.objects, ixs=tuple(plain_ix), cam=camera:
            band_hint_for(objs, ixs, cam)
        )
        if static_geo is None:
            accesses2 = {
                i: (node2.read(handles[i][0]), node2.read(handles[i][1]))
                for i in plain_ix
            }
            s_acc2 = None
        else:
            accesses2 = None
            s_acc2 = (node2.read(s_vb_h), node2.read(s_ib_h))
        sm_read = node2.read(shadow_map)
        rt = node2.write(output)
        ds = node2.write(depth)
        with node2.pipeline(self._forward_si, self._forward_state) as binder:
            binder.push_color(rt, ColorAttachmentDesc(clear_value=tuple(clear_color)))
            binder.set_depth(ds, self._forward_depth)

        def record_forward(ctx):
            ctx.bind("ViewProj", ctx.dynamic("fwd.view_proj"))
            ctx.bind("CameraPos", ctx.dynamic("fwd.camera_pos"))
            ctx.bind("LightDir", ctx.dynamic("fwd.light_dir"))
            ctx.bind("LightColor", ctx.dynamic("fwd.light_color"))
            ctx.bind("Ambient", ctx.dynamic("fwd.ambient"))
            ctx.bind("LightViewProj", ctx.dynamic("fwd.light_vp"))
            ctx.bind("ShadowBias", ctx.dynamic("fwd.shadow_bias"))
            ctx.bind("ShadowNormalOffset", ctx.dynamic("fwd.shadow_noffs"))
            # Whole-surface read: under an SPMD mesh the shadow map is
            # banded; get_full all_gathers it for PCF sampling.
            ctx.bind("ShadowMap", ctx.get_full(sm_read))
            models = ctx.dynamic("fwd.models")
            bcs = ctx.dynamic("fwd.base_colors")
            if not plain_ix:  # all-instanced scenes: clear-only lit node
                return
            if static_geo is not None:
                vb_all, ib_all = ctx.get(s_acc2[0]), ctx.get(s_acc2[1])
                draws = [
                    (vb_all[vo:vo + vc], ib_all[io_:io_ + ic], {
                        "Model": models[i],
                        "BaseColor": bcs[i],
                    })
                    for i, (vo, vc, io_, ic)
                    in zip(plain_ix, static_geo.ranges)
                ]
            else:
                draws = [
                    (accesses2[i][0], accesses2[i][1], {
                        "Model": models[i],
                        "BaseColor": bcs[i],
                    })
                    for i in plain_ix
                ]
            ctx.draw_indexed_batch(draws, per_draw_uniforms=("BaseColor",))

        node2.execute(record_forward)

        if inst_ix:
            node3 = builder.add_graphic_node("forward.inst")
            fw_inst_acc = {
                i: (node3.read(handles[i][0]), node3.read(handles[i][1]))
                for i in inst_ix
            }
            sm_read3 = node3.read(shadow_map)
            node3.read(output)
            node3.read(depth)
            rt3 = node3.write(output)
            ds3 = node3.write(depth)
            with node3.pipeline(
                self._forward_inst_si, self._forward_state
            ) as binder:
                binder.push_color(rt3, self._ca_load)
                binder.set_depth(ds3, self._forward_depth_load)

            def record_forward_inst(ctx):
                ctx.bind("ViewProj", ctx.dynamic("fwd.view_proj"))
                ctx.bind("CameraPos", ctx.dynamic("fwd.camera_pos"))
                ctx.bind("LightDir", ctx.dynamic("fwd.light_dir"))
                ctx.bind("LightColor", ctx.dynamic("fwd.light_color"))
                ctx.bind("Ambient", ctx.dynamic("fwd.ambient"))
                ctx.bind("LightViewProj", ctx.dynamic("fwd.light_vp"))
                ctx.bind("ShadowBias", ctx.dynamic("fwd.shadow_bias"))
                ctx.bind("ShadowNormalOffset", ctx.dynamic("fwd.shadow_noffs"))
                ctx.bind("ShadowMap", ctx.get_full(sm_read3))
                models = ctx.dynamic("fwd.models")
                bcs = ctx.dynamic("fwd.base_colors")
                for i in inst_ix:
                    obj = objects[i]
                    vba, iba = fw_inst_acc[i]
                    ctx.draw_indexed(
                        vba, iba,
                        {
                            "Model": models[i],
                            "BaseColor": bcs[i],
                        },
                        instance_count=obj.instance_count,
                        instance_data={
                            "inst_offset": ctx.dynamic(f"fwd.inst.{obj.name}")
                        },
                    )

            node3.execute(record_forward_inst)


def _camera_dynamics(prefix: str, camera, want_inv_vp: bool) -> dict:
    vp = np.asarray(camera.render_view_projection, np.float32)
    d = {
        f"{prefix}.view_proj": vp,
        f"{prefix}.camera_pos": np.asarray(camera.location, np.float32),
    }
    if want_inv_vp:
        d[f"{prefix}.inv_vp"] = camera.render_inv_view_projection
    return d
