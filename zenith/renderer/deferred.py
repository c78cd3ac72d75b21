"""Deferred shading — BASELINE.md config #4: "G-buffer + lighting with ~100
point lights", with a Cook-Torrance GGX BRDF (the PBR of config #5).

Node 1 (``gbuffer``, graphic, MRT): rasterizes the scene once into
  - albedo+metallic   (RGBA32F: rgb albedo, a metallic)
  - normal+roughness  (RGBA32F: xyz world normal, w roughness)
  - world-pos+emissive-luma (RGBA32F)
  plus reverse-Z depth.

Node 2 (``lighting``, lambda): full-screen PBR resolve — sun (with optional
PCF shadow) + N point lights accumulated with a fori_loop (compiler-friendly
fixed trip count, no (H, W, L) materialization).

Deferred shading is a natural fit here: the forward rasterizer already
shades each pixel exactly once, but deferred keeps per-light work off the
geometry pass and scales to hundreds of lights as pure elementwise math.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from zenith.asset.render_types import Vertex as VERTEX_LAYOUT
from zenith.core import log as _log
from zenith.core import mathtypes as m
from zenith.core import validate as _validate
from zenith.core.camera import Camera
from zenith.ops.sampling import sample_shadow_pcf
from zenith.rendergraph import RenderGraphBuilder
from zenith.rendergraph.resource import RenderGraphResource
from zenith.renderer.forward import (
    _SHADOW_SAMPLER,
    _shadow_inst_vs,
    _shadow_vs,
    sun_view_projection,
)
from zenith.renderer.scene import DirectionalLight, Scene
from zenith.renderer.static_batch import StaticGeometryCache
from zenith.rhi import (
    ColorAttachmentDesc,
    CullMode,
    Format,
    FrontFace,
    GraphicShaderInput,
    RasterizationState,
    Shader,
    TextureDesc,
    attr,
    uniform,
)
from zenith.rhi.state import (
    CompareOp,
    DepthStencilDesc,
    GraphicPipelineState,
    LoadOp,
)

logger = _log.get(__name__)


from zenith.renderer.scene import band_hint_for as _band_hint_for


class GBufferHandles(dict):
    """The G-buffer plane handles published for screen-space consumers,
    plus advisory flags. ``animated_without_velocity`` is True when the
    scene contains animated content but the renderer runs WITHOUT the
    per-draw velocity plane — temporal consumers (TAA, motion blur) warn
    on it under validation (their camera-only reprojection ghosts/freezes
    moving objects)."""

    animated_without_velocity: bool = False


def _make_gbuffer_vs(velocity: bool):
    """Plain G-buffer vertex stage. ``velocity`` adds a ``prev_pos``
    varying: the SAME vertex transformed by the previous frame's model
    matrix (the per-draw dynamic ``PrevModel``) — the per-draw velocity
    source for TAA history reprojection and motion-blur streaks under
    animated content (static objects: PrevModel == Model, zero velocity)."""

    def _gbuffer_vs(attrs, res):
        pos = attrs["position"]
        n = pos.shape[0]
        hom = jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1)
        world = hom @ res["Model"].T
        out = {
            "position": world @ res["ViewProj"].T,
            "world_pos": world[:, :3],
            "normal": attrs["normal"] @ res["Model"][:3, :3].T,
            "uv": attrs["tex_coord"],
        }
        if velocity:
            out["prev_pos"] = (hom @ res["PrevModel"].T)[:, :3]
        return out

    return _gbuffer_vs


def _make_gbuffer_inst_vs(velocity: bool):
    """Instanced G-buffer vertex stage: per-instance world-space offset
    (the instance-rate vertex attribute, ops.draw instance_data). With
    ``velocity`` a second instance-rate attribute ``prev_inst_offset``
    carries each instance's PREVIOUS offset (moving particles get real
    per-instance velocity)."""

    def _gbuffer_inst_vs(attrs, res):
        pos = attrs["position"]
        n = pos.shape[0]
        hom = jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1)
        world = hom @ res["Model"].T
        world_pos = world[:, :3] + attrs["inst_offset"]
        clip_hom = jnp.concatenate([world_pos, world[:, 3:4]], axis=1)
        out = {
            "position": clip_hom @ res["ViewProj"].T,
            "world_pos": world_pos,
            "normal": attrs["normal"] @ res["Model"][:3, :3].T,
            "uv": attrs["tex_coord"],
        }
        if velocity:
            pw = hom @ res["PrevModel"].T
            out["prev_pos"] = pw[:, :3] + attrs["prev_inst_offset"]
        return out

    return _gbuffer_inst_vs


# Frame-invariant instances (built once; the ctor picks by mode so the
# structure key sees the same function objects every frame).
_gbuffer_vs = _make_gbuffer_vs(False)
_gbuffer_inst_vs = _make_gbuffer_inst_vs(False)


def _skin_blend(attrs, res):
    """Linear-blend skinning on device: gather each vertex's 4 joint
    matrices from the (J,4,4) palette uniform, blend by weight — dense
    batched einsum over the whole vertex buffer (one matmul). Returns
    (skinned hom positions (N,4), skinned normals (N,3))."""
    pos = attrs["position"]
    n = pos.shape[0]
    jidx = attrs["joints"].astype(jnp.int32)  # (N, 4)
    w = attrs["weights"]  # (N, 4)
    mats = res["Joints"]  # (J, 4, 4) — a dynamic; animation = value change
    flat = mats.reshape(-1, 16)
    hom = jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1)
    nrm = attrs["normal"]
    p_acc = jnp.zeros((n, 4), jnp.float32)
    n_acc = jnp.zeros((n, 3), jnp.float32)
    for k in range(4):
        mk = jnp.take(flat, jidx[:, k], axis=0).reshape(n, 4, 4)
        p_acc = p_acc + w[:, k:k + 1] * jnp.einsum("nj,nij->ni", hom, mk)
        n_acc = n_acc + w[:, k:k + 1] * jnp.einsum(
            "nj,nij->ni", nrm, mk[:, :3, :3]
        )
    return p_acc, n_acc


def _morph_weights(obj) -> np.ndarray:
    """(T,) weight vector for the MorphWeights uniform (zeros = base)."""
    if obj.morph_weights is not None:
        return np.ascontiguousarray(obj.morph_weights, np.float32)
    return np.zeros((obj.morph_deltas.shape[0],), np.float32)


def _joint_palette(obj) -> np.ndarray:
    """(J,4,4) palette for the Joints uniform: the object's animated
    matrices, or identity (bind pose) before any animation sampled."""
    if obj.joint_matrices is not None:
        return np.ascontiguousarray(obj.joint_matrices, dtype=np.float32)
    j = obj.skin.num_joints
    return np.broadcast_to(
        np.eye(4, dtype=np.float32), (j, 4, 4)
    ).copy()


def _make_gbuffer_skin_vs(velocity: bool):
    """Skinned G-buffer vertex stage. With ``velocity`` the vertex is
    ALSO skinned by the previous frame's joint palette (``PrevJoints``)
    and previous model matrix — correct per-vertex velocity for animated
    skeletons (a deforming limb streaks; the torso standing still
    doesn't)."""

    def _gbuffer_skin_vs(attrs, res):
        skinned, snrm = _skin_blend(attrs, res)
        world = skinned @ res["Model"].T
        out = {
            "position": world @ res["ViewProj"].T,
            "world_pos": world[:, :3],
            "normal": snrm @ res["Model"][:3, :3].T,
            "uv": attrs["tex_coord"],
        }
        if velocity:
            prev_skinned, _ = _skin_blend(attrs, {
                "Joints": res["PrevJoints"]
            })
            out["prev_pos"] = (prev_skinned @ res["PrevModel"].T)[:, :3]
        return out

    return _gbuffer_skin_vs


_gbuffer_skin_vs = _make_gbuffer_skin_vs(False)


def _shadow_skin_vs(attrs, res):
    skinned, _ = _skin_blend(attrs, res)
    world = skinned @ res["Model"].T
    return {"position": world @ res["LightViewProj"].T}


def _morphed_position(attrs, res):
    """Morph-target blend: base position + Σ wₜ·deltaₜ — one (T)×(T,N,3)
    contraction over the whole vertex buffer (dense, matmul-friendly). Base
    normals are kept (small-deformation approximation, documented)."""
    w = res["MorphWeights"]  # (T,) — a dynamic: animating never recompiles
    deltas = res["MorphDeltas"]  # (T, N, 3) — imported static data
    return attrs["position"] + jnp.einsum("t,tnc->nc", w, deltas)


def _make_gbuffer_morph_vs(velocity: bool):
    """Morph-target G-buffer vertex stage. With ``velocity`` the base
    position is ALSO blended by the previous frame's weights
    (``PrevMorphWeights``) and previous model matrix — per-vertex
    velocity for morph animation."""

    def _gbuffer_morph_vs(attrs, res):
        pos = _morphed_position(attrs, res)
        n = pos.shape[0]
        hom = jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1)
        world = hom @ res["Model"].T
        out = {
            "position": world @ res["ViewProj"].T,
            "world_pos": world[:, :3],
            "normal": attrs["normal"] @ res["Model"][:3, :3].T,
            "uv": attrs["tex_coord"],
        }
        if velocity:
            ppos = _morphed_position(attrs, {
                "MorphWeights": res["PrevMorphWeights"],
                "MorphDeltas": res["MorphDeltas"],
            })
            phom = jnp.concatenate(
                [ppos, jnp.ones((n, 1), jnp.float32)], axis=1
            )
            out["prev_pos"] = (phom @ res["PrevModel"].T)[:, :3]
        return out

    return _gbuffer_morph_vs


_gbuffer_morph_vs = _make_gbuffer_morph_vs(False)


def _shadow_morph_vs(attrs, res):
    pos = _morphed_position(attrs, res)
    n = pos.shape[0]
    hom = jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1)
    world = hom @ res["Model"].T
    return {"position": world @ res["LightViewProj"].T}


# Atlas binding name -> its per-draw UV-transform uniform name (each map
# type has its own atlas cell layout, hence its own transform).
_UVX_NAME = {
    "BaseAtlas": "UvxBase",
    "NormalAtlas": "UvxNormal",
    "MraAtlas": "UvxMra",
    "EmissiveAtlas": "UvxEmissive",
}


def _make_gbuffer_fs(textured: bool, use_normal: bool = False,
                     use_mra: bool = False, use_emissive: bool = False,
                     id_out: bool = False, prev_out: bool = False):
    """G-buffer fragment stage. Textured mode samples per-map ATLASES with
    a per-draw UV transform (rhi.atlas): one sample per map regardless of
    how many draws share the batch — the scalable replacement for the
    round-2 sample-each-and-select-by-draw-id chain. The full baked
    material set (render.rs:135-176) is consumed: base color, tangent-space
    normal (derivative-reconstructed frame, no vertex tangents), glTF
    metallic-roughness (B=metallic, G=roughness) and emissive.

    ``id_out`` adds a 4th MRT plane carrying the per-draw ``ObjectId``
    uniform (1-based scene-object index; background stays at the 0 clear)
    — the picking/selection buffer. It rides the existing per-draw-uniform
    machinery, so its cost is one R32F attachment, not a second
    geometry pass."""

    def _gbuffer_fs(varyings, res, builtins):
        n = varyings["normal"]
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
        n = jnp.where(builtins.front_facing[..., None], n, -n)
        # Shape-generic uniform access: (4,) per-draw vectors when drawn
        # individually, dense (H, W, 4) planes under draw_indexed_batch.
        base = res["BaseColor"]
        mat = res["MatParams"]  # (metallic, roughness, emissive_luma, _)
        albedo = jnp.broadcast_to(base[..., :3], n.shape)
        metallic = jnp.broadcast_to(mat[..., 0:1], n[..., :1].shape)
        roughness = jnp.broadcast_to(mat[..., 1:2], n[..., :1].shape)
        emissive = jnp.broadcast_to(mat[..., 2:3], n[..., :1].shape)
        if textured:
            from zenith.ops.sampling import sample_texture
            from zenith.rhi.sampler import SamplerConfig

            uv = varyings["uv"]
            lin = SamplerConfig.linear()

            def atlas_uv(x):
                # x: (4,) or per-draw (H, W, 4) plane — su, sv, ou, ov.
                # Each map type has its own atlas cell layout, hence its
                # own transform uniform.
                return jnp.stack(
                    [x[..., 2] + uv[..., 0] * x[..., 0],
                     x[..., 3] + uv[..., 1] * x[..., 1]],
                    axis=-1,
                )

            albedo = albedo * sample_texture(
                res["BaseAtlas"], atlas_uv(res["UvxBase"]), lin
            )[..., :3]
            if use_mra:
                mra = sample_texture(
                    res["MraAtlas"], atlas_uv(res["UvxMra"]), lin
                )
                metallic = metallic * mra[..., 2:3]
                roughness = roughness * mra[..., 1:2]
            if use_normal:
                from zenith.ops.shade import perturb_normal

                nm = sample_texture(
                    res["NormalAtlas"], atlas_uv(res["UvxNormal"]), lin
                )[..., :3]
                n = perturb_normal(n, varyings["world_pos"], uv, nm)
            if use_emissive:
                em = sample_texture(
                    res["EmissiveAtlas"], atlas_uv(res["UvxEmissive"]), lin
                )[..., :3]
                emissive = emissive * jnp.sum(
                    em * jnp.asarray([0.2126, 0.7152, 0.0722]), axis=-1,
                    keepdims=True,
                )
        albedo_metal = jnp.concatenate([albedo, metallic], axis=-1)
        normal_rough = jnp.concatenate([n, roughness], axis=-1)
        pos_emissive = jnp.concatenate(
            [varyings["world_pos"], emissive], axis=-1
        )
        # MRT outputs in attachment order (draw maps dict keys sorted).
        out = {
            "0_albedo": albedo_metal,
            "1_normal": normal_rough,
            "2_pos": pos_emissive,
        }
        if prev_out:
            # Previous-frame world position of this surface point (the
            # per-draw velocity plane): interpolated from the prev_pos
            # varying the velocity vertex stages emit.
            out["3_prev"] = jnp.concatenate(
                [varyings["prev_pos"],
                 jnp.ones_like(varyings["prev_pos"][..., :1])],
                axis=-1,
            )
        if id_out:
            # Shape-generic like the other per-draw uniforms: (1,) vector
            # when drawn individually, (H, W, 1) plane under
            # draw_indexed_batch.
            oid = res["ObjectId"]
            out["4_id"] = jnp.broadcast_to(oid[..., 0:1], n[..., :1].shape)
        return out

    return _gbuffer_fs


def _make_glass_vs(textured: bool, instanced: bool):
    """Translucent (glass) vertex stage.

    ``textured``: samples the per-draw ``GlassTex`` AT THE VERTICES (a
    dense (Nv,) gather in ordinary XLA — vertices, not pixels) and emits
    the sampled RGBA as a ``tint`` varying. This is how texture content
    reaches the KERNEL-SAFE blend fragment shader: the per-tile in-order
    blend kernel cannot gather (ARCHITECTURE.md blend contract), but it
    interpolates varyings for free — the classic vertex-rate (Gouraud)
    texturing trade. Sampling is level-0 bilinear (no screen-space
    derivatives exist at vertex rate); tessellate glass meshes for
    high-frequency textures, or submit such draws individually for the
    dense per-pixel fallback.

    ``instanced``: adds the per-instance ``inst_offset`` attribute
    (instanced translucents ride the blend batch's instancing)."""

    def _glass_vs(attrs, res):
        pos = attrs["position"]
        n = pos.shape[0]
        hom = jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1)
        world = hom @ res["Model"].T
        if instanced:
            wp = world[:, :3] + attrs["inst_offset"]
            clip_hom = jnp.concatenate([wp, world[:, 3:4]], axis=1)
        else:
            clip_hom = world
        out = {
            "position": clip_hom @ res["ViewProj"].T,
            "normal": attrs["normal"] @ res["Model"][:3, :3].T,
        }
        if textured:
            from zenith.ops.sampling import sample_2d
            from zenith.rhi.sampler import SamplerConfig

            tex = res["GlassTex"]
            lvl0 = tex[0] if isinstance(tex, (tuple, list)) else tex
            out["tint"] = sample_2d(
                lvl0, attrs["tex_coord"], SamplerConfig.linear()
            )
        return out

    return _glass_vs


def _make_glass_fs(textured: bool):
    def _glass_fs(varyings, res, builtins):
        """KERNEL-SAFE translucent shading (runs inside the in-order blend
        kernel): component-wise lambert tint — no texture sampling, no
        reductions, only elementwise ops and minor-dim slices of f32
        planes. Texture content arrives pre-sampled in the interpolated
        ``tint`` varying (see _make_glass_vs)."""
        n = varyings["normal"]
        nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
        inv = 1.0 / jnp.sqrt(nx * nx + ny * ny + nz * nz + 1e-8)
        l = res["SunDir"]
        # Two-sided panes: |N·L| (abs BEFORE any clamp).
        ndl = jnp.abs((nx * l[..., 0] + ny * l[..., 1] + nz * l[..., 2]) * inv)
        c = res["BaseColor"]
        shade = 0.35 + 0.65 * ndl
        r, g, b = c[..., 0], c[..., 1], c[..., 2]
        a = jnp.broadcast_to(c[..., 3], shade.shape)
        if textured:
            t = varyings["tint"]
            r, g, b = r * t[..., 0], g * t[..., 1], b * t[..., 2]
            a = a * t[..., 3]
        return jnp.stack([r * shade, g * shade, b * shade, a], axis=-1)

    return _glass_fs


def _make_glass_peel_vs(instanced: bool):
    """Translucent vertex stage for the DEPTH-PEELED path: emits the raw
    ``uv`` varying instead of vertex-rate-sampling the texture — the peel
    layers shade at full fragment rate, so the texture is sampled per
    PIXEL (exact for any texture frequency, unlike the Gouraud
    vertex-rate path of _make_glass_vs)."""

    def _vs(attrs, res):
        pos = attrs["position"]
        n = pos.shape[0]
        hom = jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1)
        world = hom @ res["Model"].T
        if instanced:
            wp = world[:, :3] + attrs["inst_offset"]
            clip_hom = jnp.concatenate([wp, world[:, 3:4]], axis=1)
        else:
            clip_hom = world
        return {
            "position": clip_hom @ res["ViewProj"].T,
            "normal": attrs["normal"] @ res["Model"][:3, :3].T,
            "uv": attrs["tex_coord"],
        }

    return _vs


def _glass_peel_fs(varyings, res, builtins):
    """FRAGMENT-RATE translucent shading (depth-peel layers shade densely):
    samples the glass atlas per pixel with the per-draw UV transform —
    per-pixel-correct for high-frequency textures where the kernel path's
    vertex-rate (Gouraud) sampling cannot be. Same lambert-tint lighting
    as _make_glass_fs."""
    from zenith.ops.sampling import sample_texture
    from zenith.rhi.sampler import SamplerConfig

    n = varyings["normal"]
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    inv = 1.0 / jnp.sqrt(nx * nx + ny * ny + nz * nz + 1e-8)
    l = res["SunDir"]
    ndl = jnp.abs((nx * l[..., 0] + ny * l[..., 1] + nz * l[..., 2]) * inv)
    c = res["BaseColor"]
    shade = 0.35 + 0.65 * ndl
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    a = jnp.broadcast_to(c[..., 3], shade.shape)
    uv = varyings["uv"]
    uvx = res["UvxGlass"]  # (4,) or per-draw (H, W, 4) plane
    auv = jnp.stack(
        [uvx[..., 2] + uv[..., 0] * uvx[..., 0],
         uvx[..., 3] + uv[..., 1] * uvx[..., 1]],
        axis=-1,
    )
    t = sample_texture(res["GlassAtlas"], auv, SamplerConfig.linear())
    r, g, b = r * t[..., 0], g * t[..., 1], b * t[..., 2]
    a = a * t[..., 3]
    return jnp.stack([r * shade, g * shade, b * shade, a], axis=-1)


_glass_vs = _make_glass_vs(False, False)
_glass_fs = _make_glass_fs(False)

_WHITE_GLASS_TEX = None


def _white_glass_texture():
    """Shared 1x1 white fallback for untextured translucents drawn through
    the textured glass pipeline (the bindless trick the atlases use)."""
    global _WHITE_GLASS_TEX
    if _WHITE_GLASS_TEX is None:
        from zenith.rhi.resource import Texture as _T

        _WHITE_GLASS_TEX = _T.from_numpy(
            "glass.white", np.ones((1, 1, 4), np.float32), Format.RGBA32F
        )
    return _WHITE_GLASS_TEX


def _ggx_brdf(n, v, l, albedo, metallic, roughness):
    """Cook-Torrance GGX (Trowbridge-Reitz NDF, Smith-Schlick G, Schlick F)."""
    h = l + v
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-8)
    ndl = jnp.maximum(jnp.sum(n * l, axis=-1, keepdims=True), 0.0)
    ndv = jnp.maximum(jnp.sum(n * v, axis=-1, keepdims=True), 1e-4)
    ndh = jnp.maximum(jnp.sum(n * h, axis=-1, keepdims=True), 0.0)
    vdh = jnp.maximum(jnp.sum(v * h, axis=-1, keepdims=True), 0.0)

    a = jnp.maximum(roughness * roughness, 1e-3)
    a2 = a * a
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    d = a2 / jnp.maximum(np.pi * denom * denom, 1e-8)

    k = (roughness + 1.0) ** 2 / 8.0
    g = (ndv / (ndv * (1 - k) + k)) * (ndl / jnp.maximum(ndl * (1 - k) + k, 1e-8))

    f0 = 0.04 * (1.0 - metallic) + albedo * metallic
    f = f0 + (1.0 - f0) * jnp.power(1.0 - vdh, 5.0)

    spec = d * g * f / jnp.maximum(4.0 * ndv * ndl, 1e-4)
    kd = (1.0 - f) * (1.0 - metallic)
    return (kd * albedo / np.pi + spec) * ndl


class SSAOOptions:
    """Screen-space ambient-occlusion settings (ops.ssao). ``radius`` and
    ``bias`` are world-space; tune radius to the scene scale."""

    def __init__(self, samples: int = 12, radius: float = 4.0,
                 bias: float = 0.04, intensity: float = 1.0,
                 blur_taps: int = 4, depth_tol: float = 5e-4):
        self.samples = int(samples)
        self.radius = float(radius)
        self.bias = float(bias)
        self.intensity = float(intensity)
        self.blur_taps = int(blur_taps)
        self.depth_tol = float(depth_tol)

    def __zenith_capture_key__(self):
        return ("ssao-opts", self.samples, self.radius, self.bias,
                self.intensity, self.blur_taps, self.depth_tol)


class DeferredRenderer:
    """G-buffer + PBR lighting over a Scene."""

    def __init__(self, scene: Scene, shadows: bool = True,
                 wireframe: bool = False,
                 ssao: "bool | SSAOOptions" = False,
                 winding_flip: bool = False,
                 id_buffer: bool = False,
                 velocity: "bool | None" = None,
                 glass_mode: str = "auto",
                 glass_peel_layers: int = 4):
        self.scene = scene
        self.wireframe = wireframe
        # Per-draw velocity: every G-buffer variant transforms the vertex
        # by the PREVIOUS frame's transform too (prev model matrix, prev
        # joint palette, prev morph weights, prev instance offsets) and
        # writes the interpolated previous world position into a 4th MRT
        # plane (g.prev). TAA reprojects and motion blur streaks with it —
        # correct under animated content, where the camera-only
        # reprojection (taa.py r3) ghosted/froze moving objects. The
        # renderer rolls the previous transforms itself (value-keyed, the
        # _observe_camera protocol).
        #
        # velocity=None (the DEFAULT) is AUTO: on when the scene contains
        # content whose motion the camera-only reprojection cannot
        # represent — skins, morph targets, or device-resident (animated)
        # instance offsets (GPU particles). An app that animates plain
        # model matrices should pass velocity=True explicitly; temporal
        # consumers (TAA / motion blur) warn under validation when such a
        # scene runs without the velocity plane (see gbuffer_handles).
        self.scene_animated = any(
            o.skin is not None or o.morph_deltas is not None
            or isinstance(o.instance_offsets, jax.Array)
            for o in scene.objects
        )
        if velocity is None:
            velocity = self.scene_animated
        self.velocity = bool(velocity)
        self._prev_motion: "dict | None" = None  # rolled prev transforms
        self._last_motion: "dict | None" = None  # latest observed values
        # Object-ID plane for picking/selection: every G-buffer variant
        # writes a 4th R32F MRT attachment holding the 1-based scene-object
        # index (background = 0, translucent "glass" objects never appear —
        # they draw after the lighting resolve). render_to exports it and
        # publishes the handle as ``self.id_resource`` so apps can
        # ``context.request_output("object_id", renderer.id_resource)`` and
        # map pixels back with ``renderer.pick``.
        self.id_buffer = bool(id_buffer)
        self.id_resource: "RenderGraphResource | None" = None
        if ssao is True:
            ssao = SSAOOptions()
        self.ssao: "SSAOOptions | None" = ssao or None
        self.shadows = shadows and scene.sun is not None and scene.sun.cast_shadows
        self._static_cache = StaticGeometryCache()
        # Textured mode: the per-draw material textures are packed into one
        # ATLAS per map type at construction (rhi.atlas) — fragments sample
        # each map ONCE with a per-draw UV transform, so per-draw texture
        # cost is independent of draw count (vs the round-2 sample-all-and-
        # select chain). Objects without a map get a fallback cell (white /
        # flat-normal / black-emissive — the bindless trick), so mixed
        # scenes share one pipeline. NOTE: the atlases snapshot the scene's
        # textures at renderer construction; swap an object's texture →
        # rebuild the renderer.
        objs = scene.objects
        self.textured = any(
            o.base_color_texture is not None or o.normal_texture is not None
            or o.mra_texture is not None or o.emissive_texture is not None
            for o in objs
        )
        self.use_normal = any(o.normal_texture is not None for o in objs)
        self.use_mra = any(o.mra_texture is not None for o in objs)
        self.use_emissive = any(o.emissive_texture is not None for o in objs)
        self._atlases: dict = {}
        if self.textured:
            from zenith.rhi.atlas import build_atlas

            self._atlases["BaseAtlas"] = build_atlas(
                "atlas.base", [o.base_color_texture for o in objs],
                fallback=(1.0, 1.0, 1.0, 1.0),
            )
            if self.use_normal:
                self._atlases["NormalAtlas"] = build_atlas(
                    "atlas.normal", [o.normal_texture for o in objs],
                    fallback=(0.5, 0.5, 1.0, 1.0), mip_levels=1,
                )
            if self.use_mra:
                self._atlases["MraAtlas"] = build_atlas(
                    "atlas.mra", [o.mra_texture for o in objs],
                    fallback=(1.0, 1.0, 1.0, 1.0),
                )
            if self.use_emissive:
                self._atlases["EmissiveAtlas"] = build_atlas(
                    "atlas.emissive", [o.emissive_texture for o in objs],
                    fallback=(0.0, 0.0, 0.0, 1.0),
                )
        from zenith.rhi import texture2d

        fs_bindings = [uniform("BaseColor"), uniform("MatParams")]
        if self.id_buffer:
            fs_bindings.append(uniform("ObjectId"))
        if self.textured:
            fs_bindings.extend(texture2d(name) for name in self._atlases)
            fs_bindings.extend(
                uniform(_UVX_NAME[name]) for name in self._atlases
            )
        vel = self.velocity
        _prev_u = [uniform("PrevModel")] if vel else []
        self.gbuffer_vs = Shader.vertex(
            "gbuffer.vel.vs" if vel else "gbuffer.vs",
            _make_gbuffer_vs(vel) if vel else _gbuffer_vs,
            bindings=[uniform("Model"), uniform("ViewProj")] + _prev_u,
            inputs=[attr("position", 3), attr("normal", 3), attr("tex_coord", 2)],
        )
        self.gbuffer_fs = Shader.fragment(
            "gbuffer.vel.fs" if vel else "gbuffer.fs",
            _make_gbuffer_fs(self.textured, self.use_normal, self.use_mra,
                             self.use_emissive, id_out=self.id_buffer,
                             prev_out=vel),
            bindings=fs_bindings,
        )
        # Per-object id constants (1-based), built once: they are trace
        # constants inside the record closures, so per-frame cost is a
        # list index.
        self._oid_consts = [
            np.asarray([i + 1.0], np.float32)
            for i in range(len(objs))
        ]
        from zenith.renderer.forward import ForwardShadowRenderer

        self.shadow_vs = Shader.vertex(
            "shadow.vs", _shadow_vs,
            bindings=[uniform("Model"), uniform("LightViewProj")],
            inputs=[attr("position", 3)],
        )
        # Instanced variants (only used when a SceneObject carries
        # instance_offsets): same stages plus the inst_offset attribute.
        self.gbuffer_inst_vs = Shader.vertex(
            "gbuffer.inst.vel.vs" if vel else "gbuffer.inst.vs",
            _make_gbuffer_inst_vs(vel) if vel else _gbuffer_inst_vs,
            bindings=[uniform("Model"), uniform("ViewProj")] + _prev_u,
            inputs=[attr("position", 3), attr("normal", 3), attr("tex_coord", 2),
                    attr("inst_offset", 3, per_instance=True)]
            + ([attr("prev_inst_offset", 3, per_instance=True)] if vel
               else []),
        )
        self.shadow_inst_vs = Shader.vertex(
            "shadow.inst.vs", _shadow_inst_vs,
            bindings=[uniform("Model"), uniform("LightViewProj")],
            inputs=[attr("position", 3),
                    attr("inst_offset", 3, per_instance=True)],
        )
        # Skinned variants (SceneObject.skin): SkinnedVertex layout
        # (+joints/weights) and a (J,4,4) palette uniform; the fragment
        # stage is the plain untextured G-buffer FS (same varyings).
        self.has_skinned = any(o.skin is not None for o in objs)
        if self.has_skinned:
            assert not any(
                o.skin is not None and (
                    o.instance_offsets is not None or o.translucent
                    or o.base_color_texture is not None
                )
                for o in objs
            ), "skinned objects: plain opaque untextured only"
            self.gbuffer_skin_vs = Shader.vertex(
                "gbuffer.skin.vel.vs" if vel else "gbuffer.skin.vs",
                _make_gbuffer_skin_vs(vel) if vel else _gbuffer_skin_vs,
                bindings=[uniform("Model"), uniform("ViewProj"),
                          uniform("Joints")]
                + (_prev_u + [uniform("PrevJoints")] if vel else []),
                inputs=[attr("position", 3), attr("normal", 3),
                        attr("tex_coord", 2), attr("joints", 4),
                        attr("weights", 4)],
            )
            self.shadow_skin_vs = Shader.vertex(
                "shadow.skin.vs", _shadow_skin_vs,
                bindings=[uniform("Model"), uniform("LightViewProj"),
                          uniform("Joints")],
                inputs=[attr("position", 3), attr("normal", 3),
                        attr("joints", 4), attr("weights", 4)],
            )
            self.gbuffer_skin_fs = Shader.fragment(
                "gbuffer.skin.vel.fs" if vel else "gbuffer.skin.fs",
                _make_gbuffer_fs(False, id_out=self.id_buffer, prev_out=vel),
                bindings=[uniform("BaseColor"), uniform("MatParams")]
                + ([uniform("ObjectId")] if self.id_buffer else []),
            )
        # Morph-target variants (SceneObject.morph_deltas): plain layout,
        # a (T,N,3) delta storage buffer + (T,) weight dynamic.
        self.has_morphs = any(o.morph_deltas is not None for o in objs)
        if self.has_morphs:
            from zenith.rhi import storage

            assert not any(
                o.morph_deltas is not None and (
                    o.skin is not None or o.instance_offsets is not None
                    or o.translucent or o.base_color_texture is not None
                )
                for o in objs
            ), "morphed objects: plain opaque untextured only"
            self.gbuffer_morph_vs = Shader.vertex(
                "gbuffer.morph.vel.vs" if vel else "gbuffer.morph.vs",
                _make_gbuffer_morph_vs(vel) if vel else _gbuffer_morph_vs,
                bindings=[uniform("Model"), uniform("ViewProj"),
                          uniform("MorphWeights"), storage("MorphDeltas")]
                + (_prev_u + [uniform("PrevMorphWeights")] if vel else []),
                inputs=[attr("position", 3), attr("normal", 3),
                        attr("tex_coord", 2)],
            )
            self.shadow_morph_vs = Shader.vertex(
                "shadow.morph.vs", _shadow_morph_vs,
                bindings=[uniform("Model"), uniform("LightViewProj"),
                          uniform("MorphWeights"), storage("MorphDeltas")],
                inputs=[attr("position", 3)],
            )
            self.gbuffer_morph_fs = Shader.fragment(
                "gbuffer.morph.vel.fs" if vel else "gbuffer.morph.fs",
                _make_gbuffer_fs(False, id_out=self.id_buffer, prev_out=vel),
                bindings=[uniform("BaseColor"), uniform("MatParams")]
                + ([uniform("ObjectId")] if self.id_buffer else []),
            )
        # Frame-invariant pipeline inputs, built ONCE: render_to runs every
        # frame (the graph is rebuilt per frame), and reusing the same desc
        # objects makes the structure key / pipeline-cache probes hit the
        # per-instance hash memos and identity fast paths.
        from dataclasses import replace as _dc_replace

        self._shadow_si = GraphicShaderInput(self.shadow_vs, None, VERTEX_LAYOUT)
        self._shadow_inst_si = GraphicShaderInput(
            self.shadow_inst_vs, None, VERTEX_LAYOUT
        )
        self._gbuffer_si = GraphicShaderInput(
            self.gbuffer_vs, self.gbuffer_fs, VERTEX_LAYOUT
        )
        self._gbuffer_inst_si = GraphicShaderInput(
            self.gbuffer_inst_vs, self.gbuffer_fs, VERTEX_LAYOUT
        )
        if self.has_skinned:
            from zenith.asset.render_types import (
                SkinnedVertex as SKINNED_LAYOUT,
            )

            self._shadow_skin_si = GraphicShaderInput(
                self.shadow_skin_vs, None, SKINNED_LAYOUT
            )
            self._gbuffer_skin_si = GraphicShaderInput(
                self.gbuffer_skin_vs, self.gbuffer_skin_fs, SKINNED_LAYOUT
            )
        if self.has_morphs:
            self._shadow_morph_si = GraphicShaderInput(
                self.shadow_morph_vs, None, VERTEX_LAYOUT
            )
            self._gbuffer_morph_si = GraphicShaderInput(
                self.gbuffer_morph_vs, self.gbuffer_morph_fs, VERTEX_LAYOUT
            )
        self._shadow_state = GraphicPipelineState(
            rasterization=RasterizationState(
                cull_mode=CullMode.NONE, front_face=FrontFace.CLOCKWISE
            )
        )
        # Wireframe debug view: LINE polygon mode on the G-buffer pass (the
        # shadow pass keeps FILL — shadows stay solid); wire fragments write
        # normals/albedo as usual and receive full deferred lighting.
        from zenith.rhi.state import PolygonMode

        # winding_flip: cube-face probe cameras are REFLECTIONS (the
        # Vulkan face uv basis is left-handed from the cube center, det
        # −1), which inverts screen-space winding — the probe capture
        # flips the front face so back-face culling still works.
        self._gbuffer_state = GraphicPipelineState(
            rasterization=RasterizationState(
                cull_mode=CullMode.BACK,
                front_face=(
                    FrontFace.CLOCKWISE if winding_flip
                    else FrontFace.COUNTER_CLOCKWISE
                ),
                polygon_mode=(
                    PolygonMode.LINE if wireframe else PolygonMode.FILL
                ),
            )
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
        self._gbuffer_depth = DepthStencilDesc().reverse_z()
        self._gbuffer_depth_load = _dc_replace(
            self._gbuffer_depth, depth_load_op=LoadOp.LOAD
        )
        self._ca_clear0 = ColorAttachmentDesc(clear_value=(0, 0, 0, 0))
        self._ca_clear01 = ColorAttachmentDesc(clear_value=(0, 0, 0, 1))
        self._ca_load = ColorAttachmentDesc(load_op=LoadOp.LOAD)
        # Translucent (glass) pass: draws AFTER the lighting resolve via the
        # in-order blend kernel (kernel-safe fragment shader), standard
        # src-alpha-over blending, depth-tested against the G-buffer depth
        # with writes off (the standard translucent pipeline).
        from zenith.rhi.state import BlendFactor as _BF

        self.has_translucents = any(o.translucent for o in objs)
        if self.has_translucents:
            # Two translucency paths (reference parity: pipeline.rs:337-412
            # translucent() composes freely with sampling shaders):
            #   "kernel" — the per-tile in-order blend kernel. Exact
            #     submission-order blending for ANY overlap depth, but its
            #     kernel-safe FS cannot gather: texture content arrives
            #     vertex-rate (Gouraud, _make_glass_vs) — wrong for texture
            #     frequencies above the mesh tessellation.
            #   "peel" — depth peeling (ops.draw peel_layers): K bounded
            #     winner-resolve passes shaded at FULL fragment rate
            #     (per-pixel atlas sampling) and composited back-to-front.
            #     Exact for ≤K overlapping translucent fragments per pixel
            #     (dropped deeper layers count into bin overflow).
            # "auto" picks peel for TEXTURED glass (per-pixel-correct
            # textures) and kernel otherwise (cheaper; untextured glass is
            # exact there at any depth).
            from zenith.rhi import texture2d

            self.glass_textured = any(
                o.translucent and o.base_color_texture is not None
                for o in objs
            )
            self.glass_instanced = any(
                o.translucent and o.instance_offsets is not None
                for o in objs
            )
            assert glass_mode in ("auto", "kernel", "peel"), glass_mode
            self.glass_peel = (
                glass_mode == "peel"
                or (glass_mode == "auto" and self.glass_textured)
            )
            self.glass_peel_layers = int(glass_peel_layers)
            gt, gi = self.glass_textured, self.glass_instanced
            if self.glass_peel:
                from zenith.rhi.atlas import build_atlas

                self._glass_atlas = build_atlas(
                    "atlas.glass",
                    [o.base_color_texture for o in objs if o.translucent],
                    fallback=(1.0, 1.0, 1.0, 1.0),
                )
                g_inputs = [attr("position", 3), attr("normal", 3),
                            attr("tex_coord", 2)]
                if gi:
                    g_inputs.append(
                        attr("inst_offset", 3, per_instance=True)
                    )
                self.glass_vs = Shader.vertex(
                    f"glass.peel{'.inst' if gi else ''}.vs",
                    _make_glass_peel_vs(gi),
                    bindings=[uniform("Model"), uniform("ViewProj")],
                    inputs=g_inputs,
                )
                self.glass_fs = Shader.fragment(
                    "glass.peel.fs",
                    _glass_peel_fs,
                    bindings=[uniform("BaseColor"), uniform("SunDir"),
                              uniform("UvxGlass"),
                              texture2d("GlassAtlas")],
                )
            else:
                if gt and _validate.enabled():
                    logger.warning(
                        "[validate] textured glass on the blend-KERNEL path "
                        "samples at VERTEX rate (Gouraud) — wrong for "
                        "texture frequencies above the mesh tessellation. "
                        "Use DeferredRenderer(glass_mode='peel') (the "
                        "'auto' default) for per-pixel-correct sampling."
                    )
                self.glass_vs = Shader.vertex(
                    f"glass{'.tex' if gt else ''}{'.inst' if gi else ''}.vs",
                    _make_glass_vs(gt, gi) if (gt or gi) else _glass_vs,
                    bindings=[uniform("Model"), uniform("ViewProj")]
                    + ([texture2d("GlassTex")] if gt else []),
                    inputs=[attr("position", 3), attr("normal", 3)]
                    + ([attr("tex_coord", 2)] if gt else [])
                    + ([attr("inst_offset", 3, per_instance=True)]
                       if gi else []),
                )
                self.glass_fs = Shader.fragment(
                    "glass.tex.fs" if gt else "glass.fs",
                    _make_glass_fs(gt) if gt else _glass_fs,
                    bindings=[uniform("BaseColor"), uniform("SunDir")],
                    kernel_safe=True,
                )
            self._glass_si = GraphicShaderInput(
                self.glass_vs, self.glass_fs, VERTEX_LAYOUT
            )
            self._glass_state = GraphicPipelineState(
                rasterization=RasterizationState(cull_mode=CullMode.NONE),
            )
            self._glass_over = ColorAttachmentDesc(
                blend_enable=True,
                src_color_blend=_BF.SRC_ALPHA,
                dst_color_blend=_BF.ONE_MINUS_SRC_ALPHA,
                src_alpha_blend=_BF.ONE,
                dst_alpha_blend=_BF.ONE_MINUS_SRC_ALPHA,
                load_op=LoadOp.LOAD,
            )
            self._glass_depth = _dc_replace(
                DepthStencilDesc(
                    depth_test_enable=True,
                    depth_write_enable=False,
                    depth_compare_op=CompareOp.GREATER,
                ),
                depth_load_op=LoadOp.LOAD,
            )

    def invalidate_partition(self) -> None:
        """Drop the cached draw-class partition (call after mutating an
        object's classifying fields in place: translucent, skin,
        morph_deltas, instance_offsets None-ness — the cache keys on
        element identity only; see also Scene.invalidate_light_cache)."""
        self.__dict__.pop("_obj_partition", None)

    @staticmethod
    def _motion_same(a, b) -> bool:
        """Value equality for one motion entry. Device arrays (GPU-sim
        particle offsets) compare by IDENTITY — np.array_equal on a
        jax.Array would force a device sync per frame); the particle path replaces the array object each step,
        so identity is exactly the change signal."""
        if a is b:
            return True
        if isinstance(a, jax.Array) or isinstance(b, jax.Array):
            return False
        return a.shape == b.shape and np.array_equal(a, b)

    def _observe_motion(self) -> dict:
        """Roll prev ← last ← current per-draw transforms (velocity mode):
        the stacked model matrices plus each skinned object's joint
        palette, each morphed object's weights and each instanced object's
        offsets. Value-keyed and IDEMPOTENT within a frame (the
        _observe_camera protocol, taa.py:199-211) — update_dynamics
        followed by a rebuild cannot double-roll. Returns {key: prev
        value} over the same keys as the current observation; a key whose
        shape changed (object list edits) falls back to its current value
        (zero velocity for one frame)."""
        from zenith.renderer.scene import stacked_models

        objs = self.scene.objects
        cur = {"models": stacked_models(objs)}
        for o in objs:
            if o.skin is not None:
                cur[f"joints.{o.name}"] = _joint_palette(o)
            if o.morph_deltas is not None:
                cur[f"mweights.{o.name}"] = _morph_weights(o)
            if o.instance_offsets is not None:
                cur[f"inst.{o.name}"] = o.instance_offsets
        last = self._last_motion
        if last is None:
            self._last_motion = cur
            self._prev_motion = cur
        elif set(cur) != set(last) or any(
            not self._motion_same(cur[k], last[k]) for k in cur
        ):
            self._prev_motion = last
            self._last_motion = cur
        prev = self._prev_motion
        out = {}
        for k, v in cur.items():
            pv = prev.get(k, v)
            if tuple(getattr(pv, "shape", ())) != tuple(
                getattr(v, "shape", ())
            ):
                pv = v
            out[k] = pv
        return out

    def _motion_dynamics(self) -> dict:
        """Velocity-mode dynamics ({dyn name: prev value}) — shared by
        render_to (rebuild path) and frame_dynamics (retained path)."""
        mo = self._observe_motion()
        d = {"def.prev_models": mo["models"]}
        for k, v in mo.items():
            if k == "models":
                continue
            kind, name = k.split(".", 1)
            d[f"def.prev_{kind}.{name}"] = (
                v if isinstance(v, jax.Array)
                else np.asarray(v, np.float32)
            )
        return d

    def reset_motion(self) -> None:
        """Drop the previous-transform history (scene cut / teleport):
        the next frame renders with zero per-draw velocity."""
        self._prev_motion = None
        self._last_motion = None

    def frame_dynamics(self, camera: Camera,
                       include_models: bool = False) -> dict:
        """Per-frame dynamic values for RETAINED execution (everything else
        this renderer declares is static per scene). Pass
        ``include_models=True`` when objects move or toggle
        ``SceneObject.visible`` between retained frames — both ride the
        stacked model-matrix dynamic."""
        from zenith.renderer.forward import _camera_dynamics

        atmo = self.scene.atmosphere if (
            self.scene.skybox is None and self.scene.environment is None
        ) else None
        d = _camera_dynamics(
            "def", camera,
            want_inv_vp=(self.scene.skybox is not None
                         or self.scene.environment is not None
                         or atmo is not None),
        )
        if atmo is not None:
            d["def.atmo"] = atmo.packed(float(camera.location[2]))
        sun = self.scene.sun
        if self.shadows and sun is not None and sun.cascades > 1:
            # Cascade fits follow the camera — per-frame values.
            from zenith.renderer.csm import fit_cascades

            vps, splits, noffs = fit_cascades(sun, camera, int(sun.cascades))
            d["def.light_vp"] = vps
            d["def.casc_splits"] = splits
            d["def.camera_fwd"] = camera.forward
            d["def.shadow_noffs"] = noffs
        for o in self.scene.objects:
            if o.skin is not None:
                # Animation = per-frame palette values.
                d[f"def.joints.{o.name}"] = _joint_palette(o)
            if o.morph_deltas is not None:
                d[f"def.mweights.{o.name}"] = _morph_weights(o)
        omni = [pl for pl in self.scene.point_lights if pl.cast_shadows]
        if omni:
            # Shadow-casting point lights may move between retained frames:
            # refresh their face matrices + position/color values.
            from zenith.renderer.omni import omni_face_matrices

            for li, pl in enumerate(omni):
                d[f"def.omni{li}.vps"] = omni_face_matrices(
                    pl.position, pl.shadow_near, pl.radius
                )
                d[f"def.omni{li}.pos"] = np.asarray(pl.position, np.float32)
                d[f"def.omni{li}.col"] = (
                    np.asarray(pl.color, np.float32) * pl.intensity
                )
        if include_models:
            from zenith.renderer.scene import stacked_models

            d["def.models"] = stacked_models(self.scene.objects)
        if self.velocity:
            d.update(self._motion_dynamics())
            if include_models or any(
                o.instance_offsets is not None for o in self.scene.objects
            ):
                # Moving objects/instances in retained mode: the CURRENT
                # offsets ride dynamics too (models already do via
                # include_models).
                for o in self.scene.objects:
                    if o.instance_offsets is not None:
                        d[f"def.inst.{o.name}"] = (
                            o.instance_offsets
                            if isinstance(o.instance_offsets, jax.Array)
                            else np.asarray(o.instance_offsets, np.float32)
                        )
        return d

    def pick(self, id_plane, x: int, y: int) -> "object | None":
        """Map one pixel of the object-id plane back to its SceneObject.

        ``id_plane`` is a readback of ``self.id_resource`` (shape (H, W, 1)
        or (H, W)); (x, y) are framebuffer coordinates (y=0 top, matching
        Vulkan). Returns None for background pixels and ids that fell
        outside the scene (translucent objects never write the plane).
        Requires the renderer to have been built with ``id_buffer=True``.
        """
        assert self.id_buffer, "pick() needs DeferredRenderer(id_buffer=True)"
        arr = np.asarray(id_plane)
        if arr.ndim == 3:
            arr = arr[..., 0]
        v = int(round(float(arr[int(y), int(x)])))
        if 1 <= v <= len(self.scene.objects):
            return self.scene.objects[v - 1]
        return None

    def render_to(
        self,
        builder: RenderGraphBuilder,
        output: RenderGraphResource,
        camera: Camera,
        width: int,
        height: int,
        background=(0.02, 0.025, 0.035),
    ) -> None:
        scene = self.scene
        sun = scene.sun
        env = scene.environment
        # Shadow-casting point lights leave the tiled-kernel table and
        # shade through the dense path with cube-PCF visibility
        # (renderer/omni.py); the split is identity-cached on the scene.
        pl_pos, pl_col, pl_rad, omni_lights = scene.light_partition()
        sl_pos, sl_col, sl_rad, sl_params = scene.spot_light_arrays()
        has_spots = sl_pos.shape[0] > 0
        if has_spots:
            # One merged table through ONE tiled-culling kernel pass:
            # points first (zero cone params = point), spots appended.
            spot_params = np.concatenate([
                np.zeros((pl_pos.shape[0], 5), np.float32), sl_params
            ])
            pl_pos = np.concatenate([pl_pos, sl_pos])
            pl_col = np.concatenate([pl_col, sl_col])
            pl_rad = np.concatenate([pl_rad, sl_rad])
            builder.set_dynamic("def.sl_params", spot_params)

        atmo = scene.atmosphere if (scene.skybox is None and env is None) \
            else None
        builder.set_dynamic("def.view_proj", camera.render_view_projection)
        builder.set_dynamic("def.camera_pos", camera.location)
        if scene.skybox is not None or env is not None or atmo is not None:
            builder.set_dynamic(
                "def.inv_vp", camera.render_inv_view_projection
            )
        if atmo is not None:
            builder.set_dynamic(
                "def.atmo", atmo.packed(float(camera.location[2]))
            )
            if sun is None:
                # The sky still needs a sun direction to scatter from.
                builder.set_dynamic(
                    "def.sun_dir", np.asarray([0.0, 0.0, 1.0], np.float32)
                )
        if env is not None:
            # SH coefficients are host-resident by construction
            # (ops.ibl.irradiance_sh9_host) — no device readback.
            builder.set_dynamic("def.env_sh", env.sh9)
        else:
            builder.set_dynamic(
                "def.ambient", np.asarray(scene.ambient, np.float32)
            )
        builder.set_dynamic("def.background", np.asarray(background, np.float32))
        if pl_pos.shape[0]:
            builder.set_dynamic("def.pl_pos", pl_pos)
            builder.set_dynamic("def.pl_col", pl_col)
            builder.set_dynamic("def.pl_rad", pl_rad)
        if sun is not None:
            builder.set_dynamic(
                "def.sun_dir", m.normalize(np.asarray(sun.direction, np.float32))
            )
            builder.set_dynamic(
                "def.sun_color", np.asarray(sun.color, np.float32) * sun.intensity
            )
        if omni_lights:
            from zenith.renderer.omni import omni_face_matrices

            for li, pl in enumerate(omni_lights):
                builder.set_dynamic(
                    f"def.omni{li}.vps",
                    omni_face_matrices(pl.position, pl.shadow_near, pl.radius),
                )
                builder.set_dynamic(
                    f"def.omni{li}.pos", np.asarray(pl.position, np.float32)
                )
                builder.set_dynamic(
                    f"def.omni{li}.col",
                    np.asarray(pl.color, np.float32) * pl.intensity,
                )
        n_casc = max(1, int(sun.cascades)) if (self.shadows and sun) else 1
        if self.shadows:
            builder.set_dynamic("def.shadow_bias", np.float32(sun.shadow_bias))
            if n_casc > 1:
                # Cascaded shadow maps (renderer/csm.py): camera-frustum-fit
                # light VPs are PER-FRAME values (the camera moves) — all of
                # them ride dynamics, zero recompiles.
                from zenith.renderer.csm import fit_cascades

                vps, splits, noffs = fit_cascades(sun, camera, n_casc)
                builder.set_dynamic("def.light_vp", vps)  # (N, 4, 4)
                builder.set_dynamic("def.casc_splits", splits)  # (N,)
                builder.set_dynamic("def.camera_fwd", camera.forward)
                builder.set_dynamic("def.shadow_noffs", noffs)  # (N,)
            else:
                builder.set_dynamic("def.light_vp", sun_view_projection(sun))
                builder.set_dynamic(
                    "def.shadow_noffs", np.float32(sun.effective_normal_offset)
                )
        # ONE dynamic per FIELD, not per object×field: N objects previously
        # declared 3N dynamics — 3N set_dynamic calls, 3N pack metas and 3N
        # per-frame capture/key entries, ~50 µs/object of host time at 64
        # objects. Stacked (N, ...) arrays collapse that to 3 dynamics;
        # record closures slice their draw's row at trace time (static
        # index, zero runtime cost).
        from zenith.renderer.scene import stacked_models

        builder.set_dynamic("def.models", stacked_models(scene.objects))
        if self.velocity:
            for k, v in self._motion_dynamics().items():
                builder.set_dynamic(k, v)
        builder.set_dynamic("def.base_colors", np.stack(
            [o.base_color_array() for o in scene.objects]
        ))
        builder.set_dynamic("def.mats", np.stack(
            [o.mat_params_array() for o in scene.objects]
        ))
        if self.textured:
            for aname, a in self._atlases.items():
                builder.set_dynamic(f"def.uvx.{aname}", a.transforms)
        for obj in scene.objects:
            if obj.instance_offsets is not None:
                builder.set_dynamic(
                    f"def.inst.{obj.name}",
                    # Device-resident offsets (GPU-sim particles) pass through
                    # untouched — np.asarray on a jax.Array would
                    # force a device sync + download per frame.
                    obj.instance_offsets
                    if isinstance(obj.instance_offsets, jax.Array)
                    else np.asarray(obj.instance_offsets, np.float32),
                )
        # Instanced objects draw through their own nodes (one pipeline per
        # node; the instanced vertex stage differs); translucent objects
        # skip the opaque passes (shadow + G-buffer) and draw in the glass
        # node after lighting.
        # Draw-class partition, identity-cached (five attribute scans over
        # every object per frame measured on the host path at high object
        # counts; replacing an element of scene.objects invalidates).
        # Mutating a CLASSIFYING field in place (translucent, skin,
        # morph_deltas, instance_offsets None-ness) does NOT — call
        # invalidate_partition() then, like the lights' escape hatch.
        part_key = tuple(map(id, scene.objects))
        part = self.__dict__.get("_obj_partition")
        if part is None or part[0] != part_key:
            plain_ix = [i for i, o in enumerate(scene.objects)
                        if o.instance_offsets is None and not o.translucent
                        and o.skin is None and o.morph_deltas is None]
            inst_ix = [i for i, o in enumerate(scene.objects)
                       if o.instance_offsets is not None and not o.translucent]
            trans_ix = [i for i, o in enumerate(scene.objects)
                        if o.translucent]
            skin_ix = [i for i, o in enumerate(scene.objects)
                       if o.skin is not None]
            morph_ix = [i for i, o in enumerate(scene.objects)
                        if o.morph_deltas is not None]
            part = (part_key,
                    (plain_ix, inst_ix, trans_ix, skin_ix, morph_ix),
                    list(scene.objects))
            self.__dict__["_obj_partition"] = part
        plain_ix, inst_ix, trans_ix, skin_ix, morph_ix = part[1]
        for i in skin_ix:
            obj = scene.objects[i]
            builder.set_dynamic(
                f"def.joints.{obj.name}", _joint_palette(obj)
            )
        for i in morph_ix:
            obj = scene.objects[i]
            builder.set_dynamic(
                f"def.mweights.{obj.name}", _morph_weights(obj)
            )
        morph_handles = {
            i: builder.import_resource(scene.objects[i].morph_deltas)
            for i in morph_ix
        }

        # Static batching (renderer/static_batch.py): all plain opaque
        # draws share ONE concatenated vertex/index buffer pair, imported
        # once per node — per-frame host cost is O(1) in object count
        # (records slice their range at trace time). Instanced and
        # translucent objects keep per-object buffers (their draw paths
        # differ per object anyway).
        static_geo = self._static_cache.get(scene.objects, plain_ix)
        per_obj_ix = (
            inst_ix + trans_ix + skin_ix + morph_ix
            if static_geo is not None
            else plain_ix + inst_ix + trans_ix + skin_ix + morph_ix
        )
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
        # Material atlases: imported ONCE, shared by every draw (rhi.atlas).
        atlas_handles = {
            name: builder.import_resource(a.texture)
            for name, a in self._atlases.items()
        } if self.textured else {}
        objects = scene.objects

        g_id = None
        if self.id_buffer:
            g_id = builder.create(
                TextureDesc.color("g.id", width, height, Format.R32F)
            )
            # Exported so apps can pull it back each frame
            # (context.request_output) or read it from the compiled graph
            # (compiled.value) — the readback IS the pick buffer.
            builder.export(g_id)
            self.id_resource = g_id
        g_albedo = builder.create(TextureDesc.color("g.albedo", width, height))
        g_normal = builder.create(TextureDesc.color("g.normal", width, height))
        g_pos = builder.create(TextureDesc.color("g.pos", width, height))
        g_prev = (
            builder.create(TextureDesc.color("g.prev", width, height))
            if self.velocity else None
        )
        g_depth = builder.create(TextureDesc.depth("g.depth", width, height))

        # -- optional shadow node(s) ----------------------------------------------
        # n_casc == 1: one fixed-extent map (reference-style). n_casc > 1:
        # one depth ARRAY texture, one render-to-layer node per cascade
        # (texture.rs:536-559 sub-resource views; fit in renderer/csm.py).
        sm_handle = None
        if self.shadows:
            smsz = sun.shadow_map_size
            if n_casc > 1:
                sm_handle = builder.create(TextureDesc.new_2d_array(
                    "sun.shadow", smsz, smsz, n_casc, Format.D32F
                ))
            else:
                sm_handle = builder.create(
                    TextureDesc.depth("sun.shadow", smsz, smsz)
                )
            for k in range(n_casc):
                node = builder.add_graphic_node(
                    "shadow" if n_casc == 1 else f"shadow.c{k}"
                )
                if static_geo is None:
                    accesses = {
                        i: (node.read(handles[i][0]), node.read(handles[i][1]))
                        for i in plain_ix
                    }
                    s_acc = None
                else:
                    accesses = None
                    s_acc = (node.read(s_vb_h), node.read(s_ib_h))
                sm = (
                    node.write(sm_handle) if n_casc == 1
                    else node.write(sm_handle, layer=k)
                )
                with node.pipeline(self._shadow_si, self._shadow_state) as binder:
                    binder.set_depth(sm, self._shadow_depth)

                def record_shadow(ctx, k=k, accesses=accesses, s_acc=s_acc):
                    lvp = ctx.dynamic("def.light_vp")
                    ctx.bind("LightViewProj", lvp if n_casc == 1 else lvp[k])
                    models = ctx.dynamic("def.models")
                    if not plain_ix:  # all-instanced scenes: clear-only node
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
                            (accesses[i][0], accesses[i][1],
                             {"Model": models[i]})
                            for i in plain_ix
                        ]
                    ctx.draw_indexed_batch(draws)

                node.execute(record_shadow)

                if inst_ix:
                    node = builder.add_graphic_node(
                        "shadow.inst" if n_casc == 1 else f"shadow.inst.c{k}"
                    )
                    inst_accesses = {
                        i: (node.read(handles[i][0]), node.read(handles[i][1]))
                        for i in inst_ix
                    }
                    node.read(sm_handle)
                    sm2 = (
                        node.write(sm_handle) if n_casc == 1
                        else node.write(sm_handle, layer=k)
                    )
                    with node.pipeline(
                        self._shadow_inst_si, self._shadow_state
                    ) as binder:
                        binder.set_depth(sm2, self._shadow_depth_load)

                    def record_shadow_inst(ctx, k=k,
                                           inst_accesses=inst_accesses):
                        lvp = ctx.dynamic("def.light_vp")
                        ctx.bind(
                            "LightViewProj", lvp if n_casc == 1 else lvp[k]
                        )
                        models = ctx.dynamic("def.models")
                        for i in inst_ix:
                            obj = objects[i]
                            vba, iba = inst_accesses[i]
                            ctx.draw_indexed(
                                vba, iba,
                                {"Model": models[i]},
                                instance_count=obj.instance_count,
                                instance_data={
                                    "inst_offset": ctx.dynamic(f"def.inst.{obj.name}")
                                },
                            )

                    node.execute(record_shadow_inst)

                if skin_ix:
                    node = builder.add_graphic_node(
                        "shadow.skin" if n_casc == 1 else f"shadow.skin.c{k}"
                    )
                    skin_accesses = {
                        i: (node.read(handles[i][0]), node.read(handles[i][1]))
                        for i in skin_ix
                    }
                    node.read(sm_handle)
                    sm3 = (
                        node.write(sm_handle) if n_casc == 1
                        else node.write(sm_handle, layer=k)
                    )
                    with node.pipeline(
                        self._shadow_skin_si, self._shadow_state
                    ) as binder:
                        binder.set_depth(sm3, self._shadow_depth_load)

                    def record_shadow_skin(ctx, k=k,
                                           skin_accesses=skin_accesses):
                        lvp = ctx.dynamic("def.light_vp")
                        ctx.bind(
                            "LightViewProj", lvp if n_casc == 1 else lvp[k]
                        )
                        models = ctx.dynamic("def.models")
                        draws = []
                        for i in skin_ix:
                            obj = objects[i]
                            vba, iba = skin_accesses[i]
                            draws.append((vba, iba, {
                                "Model": models[i],
                                "Joints": ctx.dynamic(
                                    f"def.joints.{obj.name}"
                                ),
                            }))
                        ctx.draw_indexed_batch(draws)

                    node.execute(record_shadow_skin)

                if morph_ix:
                    node = builder.add_graphic_node(
                        "shadow.morph" if n_casc == 1
                        else f"shadow.morph.c{k}"
                    )
                    morph_accesses = {
                        i: (node.read(handles[i][0]), node.read(handles[i][1]),
                            node.read(morph_handles[i]))
                        for i in morph_ix
                    }
                    node.read(sm_handle)
                    sm4 = (
                        node.write(sm_handle) if n_casc == 1
                        else node.write(sm_handle, layer=k)
                    )
                    with node.pipeline(
                        self._shadow_morph_si, self._shadow_state
                    ) as binder:
                        binder.set_depth(sm4, self._shadow_depth_load)

                    def record_shadow_morph(ctx, k=k,
                                            morph_accesses=morph_accesses):
                        lvp = ctx.dynamic("def.light_vp")
                        ctx.bind(
                            "LightViewProj", lvp if n_casc == 1 else lvp[k]
                        )
                        models = ctx.dynamic("def.models")
                        draws = []
                        for i in morph_ix:
                            obj = objects[i]
                            vba, iba, mda = morph_accesses[i]
                            draws.append((vba, iba, {
                                "Model": models[i],
                                "MorphWeights": ctx.dynamic(
                                    f"def.mweights.{obj.name}"
                                ),
                                "MorphDeltas": ctx.get(mda),
                            }))
                        ctx.draw_indexed_batch(draws)

                    node.execute(record_shadow_morph)

        # -- omni (cube) shadow faces for shadow-casting point lights --------------
        # Six render-to-layer depth nodes per light (renderer/omni.py face
        # matrices); casters are the plain opaque set (the static batch) —
        # the usual local-light scope.
        omni_handles = []
        for li, pl in enumerate(omni_lights):
            cube = builder.create(TextureDesc.new_cube(
                f"omni{li}.shadow", pl.shadow_map_size, Format.D32F
            ))
            for fk in range(6):
                node = builder.add_graphic_node(f"omni{li}.f{fk}")
                if static_geo is None:
                    o_acc = {
                        i: (node.read(handles[i][0]), node.read(handles[i][1]))
                        for i in plain_ix
                    }
                    so_acc = None
                else:
                    o_acc = None
                    so_acc = (node.read(s_vb_h), node.read(s_ib_h))
                dsw = node.write(cube, layer=fk)
                with node.pipeline(
                    self._shadow_si, self._shadow_state
                ) as binder:
                    binder.set_depth(dsw, self._shadow_depth)

                def record_face(ctx, li=li, fk=fk, o_acc=o_acc,
                                so_acc=so_acc):
                    ctx.bind(
                        "LightViewProj", ctx.dynamic(f"def.omni{li}.vps")[fk]
                    )
                    models = ctx.dynamic("def.models")
                    if not plain_ix:
                        return
                    if static_geo is not None:
                        vb_all = ctx.get(so_acc[0])
                        ib_all = ctx.get(so_acc[1])
                        draws = [
                            (vb_all[vo:vo + vc], ib_all[io_:io_ + ic],
                             {"Model": models[i]})
                            for i, (vo, vc, io_, ic)
                            in zip(plain_ix, static_geo.ranges)
                        ]
                    else:
                        draws = [
                            (o_acc[i][0], o_acc[i][1], {"Model": models[i]})
                            for i in plain_ix
                        ]
                    ctx.draw_indexed_batch(draws)

                node.execute(record_face)
            omni_handles.append(cube)

        # -- node: G-buffer (MRT) -------------------------------------------------
        node = builder.add_graphic_node("gbuffer")
        # SPMD auto-decomposition hint (CompileOptions parallel="auto"):
        # lazy — the AABB projections run only when compile is in auto
        # mode, keeping the rebuild path's host cost untouched otherwise.
        node.set_band_hint(
            lambda objs=scene.objects, ixs=tuple(plain_ix), cam=camera:
            _band_hint_for(objs, ixs, cam)
        )
        if static_geo is None:
            accesses = {
                i: (node.read(handles[i][0]), node.read(handles[i][1]))
                for i in plain_ix
            }
            s_acc = None
        else:
            accesses = None
            s_acc = (node.read(s_vb_h), node.read(s_ib_h))
        atlas_accesses = {
            name: node.read(h) for name, h in atlas_handles.items()
        }
        a_rt = node.write(g_albedo)
        n_rt = node.write(g_normal)
        p_rt = node.write(g_pos)
        v_rt = node.write(g_prev) if g_prev is not None else None
        i_rt = node.write(g_id) if g_id is not None else None
        ds = node.write(g_depth)
        with node.pipeline(self._gbuffer_si, self._gbuffer_state) as binder:
            binder.push_color(a_rt, self._ca_clear0)
            binder.push_color(n_rt, self._ca_clear01)
            binder.push_color(p_rt, self._ca_clear0)
            if v_rt is not None:
                binder.push_color(v_rt, self._ca_clear0)
            if i_rt is not None:
                binder.push_color(i_rt, self._ca_clear0)
            binder.set_depth(ds, self._gbuffer_depth)

        textured = self.textured
        id_buffer = self.id_buffer
        velocity = self.velocity
        oid_consts = self._oid_consts

        def record_gbuffer(ctx):
            ctx.bind("ViewProj", ctx.dynamic("def.view_proj"))
            for name, acc in atlas_accesses.items():
                ctx.bind(name, ctx.get(acc))
            models = ctx.dynamic("def.models")
            prevs = ctx.dynamic("def.prev_models") if velocity else None
            bcs = ctx.dynamic("def.base_colors")
            mats = ctx.dynamic("def.mats")
            uvx = {
                aname: ctx.dynamic(f"def.uvx.{aname}")
                for aname in atlas_accesses
            }
            draws = []
            if static_geo is not None:
                vb_all, ib_all = ctx.get(s_acc[0]), ctx.get(s_acc[1])
            for k, i in enumerate(plain_ix):
                if static_geo is not None:
                    vo, vc, io_, ic = static_geo.ranges[k]
                    vba, iba = vb_all[vo:vo + vc], ib_all[io_:io_ + ic]
                else:
                    vba, iba = accesses[i]
                res = {
                    "Model": models[i],
                    "BaseColor": bcs[i],
                    "MatParams": mats[i],
                }
                if velocity:
                    res["PrevModel"] = prevs[i]
                if textured:
                    for aname in atlas_accesses:
                        res[_UVX_NAME[aname]] = uvx[aname][i]
                if id_buffer:
                    res["ObjectId"] = oid_consts[i]
                draws.append((vba, iba, res))
            per_draw = ("BaseColor", "MatParams") + tuple(
                _UVX_NAME[aname] for aname in atlas_accesses
            )
            if id_buffer:
                per_draw = per_draw + ("ObjectId",)
            if draws:  # all-instanced scenes: clear-only G-buffer node
                ctx.draw_indexed_batch(draws, per_draw_uniforms=per_draw)

        node.execute(record_gbuffer)

        if inst_ix:
            node = builder.add_graphic_node("gbuffer.inst")
            inst_acc = {
                i: (node.read(handles[i][0]), node.read(handles[i][1]))
                for i in inst_ix
            }
            inst_atlas = {
                name: node.read(h) for name, h in atlas_handles.items()
            }
            for h in (g_albedo, g_normal, g_pos, g_depth):
                node.read(h)
            a2 = node.write(g_albedo)
            n2 = node.write(g_normal)
            p2 = node.write(g_pos)
            if g_prev is not None:
                node.read(g_prev)
                v2 = node.write(g_prev)
            if g_id is not None:
                node.read(g_id)
                i2 = node.write(g_id)
            d2 = node.write(g_depth)
            with node.pipeline(
                self._gbuffer_inst_si, self._gbuffer_state
            ) as binder:
                binder.push_color(a2, self._ca_load)
                binder.push_color(n2, self._ca_load)
                binder.push_color(p2, self._ca_load)
                if g_prev is not None:
                    binder.push_color(v2, self._ca_load)
                if g_id is not None:
                    binder.push_color(i2, self._ca_load)
                binder.set_depth(d2, self._gbuffer_depth_load)

            def record_gbuffer_inst(ctx):
                ctx.bind("ViewProj", ctx.dynamic("def.view_proj"))
                for name, acc in inst_atlas.items():
                    ctx.bind(name, ctx.get(acc))
                models = ctx.dynamic("def.models")
                prevs = ctx.dynamic("def.prev_models") if velocity else None
                bcs = ctx.dynamic("def.base_colors")
                mats = ctx.dynamic("def.mats")
                uvx = {
                    aname: ctx.dynamic(f"def.uvx.{aname}")
                    for aname in inst_atlas
                }
                for i in inst_ix:
                    obj = objects[i]
                    vba, iba = inst_acc[i]
                    res = {
                        "Model": models[i],
                        "BaseColor": bcs[i],
                        "MatParams": mats[i],
                    }
                    if velocity:
                        res["PrevModel"] = prevs[i]
                    if textured:
                        for aname in inst_atlas:
                            res[_UVX_NAME[aname]] = uvx[aname][i]
                    if id_buffer:
                        res["ObjectId"] = oid_consts[i]
                    idata = {
                        "inst_offset": ctx.dynamic(f"def.inst.{obj.name}")
                    }
                    if velocity:
                        idata["prev_inst_offset"] = ctx.dynamic(
                            f"def.prev_inst.{obj.name}"
                        )
                    ctx.draw_indexed(
                        vba, iba, res,
                        instance_count=obj.instance_count,
                        instance_data=idata,
                    )

            node.execute(record_gbuffer_inst)

        if skin_ix:
            node = builder.add_graphic_node("gbuffer.skin")
            skin_acc = {
                i: (node.read(handles[i][0]), node.read(handles[i][1]))
                for i in skin_ix
            }
            for h in (g_albedo, g_normal, g_pos, g_depth):
                node.read(h)
            a3 = node.write(g_albedo)
            n3 = node.write(g_normal)
            p3 = node.write(g_pos)
            if g_prev is not None:
                node.read(g_prev)
                v3 = node.write(g_prev)
            if g_id is not None:
                node.read(g_id)
                i3 = node.write(g_id)
            d3 = node.write(g_depth)
            with node.pipeline(
                self._gbuffer_skin_si, self._gbuffer_state
            ) as binder:
                binder.push_color(a3, self._ca_load)
                binder.push_color(n3, self._ca_load)
                binder.push_color(p3, self._ca_load)
                if g_prev is not None:
                    binder.push_color(v3, self._ca_load)
                if g_id is not None:
                    binder.push_color(i3, self._ca_load)
                binder.set_depth(d3, self._gbuffer_depth_load)

            def record_gbuffer_skin(ctx):
                ctx.bind("ViewProj", ctx.dynamic("def.view_proj"))
                models = ctx.dynamic("def.models")
                prevs = ctx.dynamic("def.prev_models") if velocity else None
                bcs = ctx.dynamic("def.base_colors")
                mats = ctx.dynamic("def.mats")
                draws = []
                for i in skin_ix:
                    obj = objects[i]
                    vba, iba = skin_acc[i]
                    res = {
                        "Model": models[i],
                        "BaseColor": bcs[i],
                        "MatParams": mats[i],
                        "Joints": ctx.dynamic(f"def.joints.{obj.name}"),
                    }
                    if velocity:
                        res["PrevModel"] = prevs[i]
                        res["PrevJoints"] = ctx.dynamic(
                            f"def.prev_joints.{obj.name}"
                        )
                    if id_buffer:
                        res["ObjectId"] = oid_consts[i]
                    draws.append((vba, iba, res))
                per_draw = ("BaseColor", "MatParams") + (
                    ("ObjectId",) if id_buffer else ()
                )
                ctx.draw_indexed_batch(draws, per_draw_uniforms=per_draw)

            node.execute(record_gbuffer_skin)

        if morph_ix:
            node = builder.add_graphic_node("gbuffer.morph")
            morph_acc = {
                i: (node.read(handles[i][0]), node.read(handles[i][1]),
                    node.read(morph_handles[i]))
                for i in morph_ix
            }
            for h in (g_albedo, g_normal, g_pos, g_depth):
                node.read(h)
            a4 = node.write(g_albedo)
            n4 = node.write(g_normal)
            p4 = node.write(g_pos)
            if g_prev is not None:
                node.read(g_prev)
                v4 = node.write(g_prev)
            if g_id is not None:
                node.read(g_id)
                i4 = node.write(g_id)
            d4 = node.write(g_depth)
            with node.pipeline(
                self._gbuffer_morph_si, self._gbuffer_state
            ) as binder:
                binder.push_color(a4, self._ca_load)
                binder.push_color(n4, self._ca_load)
                binder.push_color(p4, self._ca_load)
                if g_prev is not None:
                    binder.push_color(v4, self._ca_load)
                if g_id is not None:
                    binder.push_color(i4, self._ca_load)
                binder.set_depth(d4, self._gbuffer_depth_load)

            def record_gbuffer_morph(ctx):
                ctx.bind("ViewProj", ctx.dynamic("def.view_proj"))
                models = ctx.dynamic("def.models")
                prevs = ctx.dynamic("def.prev_models") if velocity else None
                bcs = ctx.dynamic("def.base_colors")
                mats = ctx.dynamic("def.mats")
                draws = []
                for i in morph_ix:
                    obj = objects[i]
                    vba, iba, mda = morph_acc[i]
                    res = {
                        "Model": models[i],
                        "BaseColor": bcs[i],
                        "MatParams": mats[i],
                        "MorphWeights": ctx.dynamic(
                            f"def.mweights.{obj.name}"
                        ),
                        "MorphDeltas": ctx.get(mda),
                    }
                    if velocity:
                        res["PrevModel"] = prevs[i]
                        res["PrevMorphWeights"] = ctx.dynamic(
                            f"def.prev_mweights.{obj.name}"
                        )
                    if id_buffer:
                        res["ObjectId"] = oid_consts[i]
                    draws.append((vba, iba, res))
                per_draw = ("BaseColor", "MatParams") + (
                    ("ObjectId",) if id_buffer else ()
                )
                ctx.draw_indexed_batch(draws, per_draw_uniforms=per_draw)

            node.execute(record_gbuffer_morph)

        # -- node: decals (lambda; renderer.decal) ---------------------------------
        # Projected decals rewrite the G-buffer albedo BEFORE SSAO/lighting,
        # so they receive full PBR shading and shadows. Pure elementwise per
        # pixel (one 3x4 transform + optional texture sample per decal) —
        # XLA fuses the whole chain into the frame program; under a row-band
        # mesh it shards trivially (no cross-row taps).
        if scene.decals:
            from zenith.renderer.decal import (
                apply_decal,
                stacked_decal_colors,
                stacked_decal_mats,
            )

            builder.set_dynamic(
                "def.decal_mats", stacked_decal_mats(scene.decals)
            )
            builder.set_dynamic(
                "def.decal_cols", stacked_decal_colors(scene.decals)
            )
            dnode = builder.add_lambda_node("decals")
            d_tex_acc = [
                dnode.read(builder.import_resource(d.texture))
                if d.texture is not None else None
                for d in scene.decals
            ]
            da_in = dnode.read(g_albedo)
            dp_in = dnode.read(g_pos)
            dn_in = dnode.read(g_normal)
            da_out = dnode.write(g_albedo)
            d_fades = [float(d.normal_fade) for d in scene.decals]

            def record_decals(ctx):
                am = ctx.get(da_in)
                pos = ctx.get(dp_in)[..., :3]
                nrm = ctx.get(dn_in)[..., :3]
                mats = ctx.dynamic("def.decal_mats")
                cols = ctx.dynamic("def.decal_cols")
                rgb = am[..., :3]
                for k, acc in enumerate(d_tex_acc):
                    tex = ctx.get(acc) if acc is not None else None
                    rgb = apply_decal(
                        rgb, pos, nrm, mats[k], cols[k], tex, d_fades[k]
                    )
                ctx.set(da_out, jnp.concatenate([rgb, am[..., 3:]], axis=-1))

            dnode.execute(record_decals)

        # -- node: SSAO (lambda, full-screen; ops.ssao) -----------------------------
        ao_handle = None
        if self.ssao is not None:
            from zenith.ops.ssao import (
                hemisphere_kernel,
                ssao_blur,
                ssao_occlusion,
            )

            opts = self.ssao
            kern = hemisphere_kernel(opts.samples)  # tiny (K, 3) constant
            ao_handle = builder.create(
                TextureDesc.color("ssao.ao", width, height, Format.R32F)
            )
            anode = builder.add_lambda_node("ssao")
            ao_n_in = anode.read(g_normal)
            ao_p_in = anode.read(g_pos)
            ao_d_in = anode.read(g_depth)
            ao_w = anode.write(ao_handle)

            def record_ssao(ctx):
                normal = ctx.get(ao_n_in)[..., :3]
                wpos = ctx.get(ao_p_in)[..., :3]
                dep = ctx.get(ao_d_in)
                tap_pos = tap_depth = None
                row0 = 0
                if ctx.sharded:
                    # Taps land anywhere on screen; gather from the full
                    # surfaces.
                    tap_pos = ctx.get_full(ao_p_in)[..., :3]
                    tap_depth = ctx.get_full(ao_d_in)
                    s_axis, s_n, _ = ctx._shard_ctx
                    row0 = jax.lax.axis_index(s_axis) * dep.shape[0]
                raw = ssao_occlusion(
                    wpos, normal, dep, ctx.dynamic("def.view_proj"), kern,
                    radius=opts.radius, bias=opts.bias,
                    intensity=opts.intensity,
                    tap_pos=tap_pos, tap_depth=tap_depth, row0=row0,
                )
                taps = opts.blur_taps
                if ctx.sharded and dep.shape[0] >= taps:
                    # Vertical blur taps cross band boundaries: ring halo
                    # exchange (same scheme as bloom), then crop — output
                    # bit-equal to single-device.
                    from zenith.parallel.sharding import (
                        halo_exchange_rows,
                    )

                    s_axis, _, _ = ctx._shard_ctx
                    bh = dep.shape[0]
                    ext = ssao_blur(
                        halo_exchange_rows(raw, s_axis, taps),
                        halo_exchange_rows(dep, s_axis, taps),
                        taps=taps, depth_tol=opts.depth_tol,
                    )[taps:taps + bh]
                    ctx.set(ao_w, ext[..., None])
                else:
                    ctx.set(
                        ao_w,
                        ssao_blur(raw, dep, taps=taps,
                                  depth_tol=opts.depth_tol)[..., None],
                    )

            anode.execute(record_ssao)

        # -- node: lighting resolve (lambda, full-screen) ---------------------------
        # The environment's prefiltered cube doubles as the skybox unless the
        # scene overrides it; when both are the same Texture the import is
        # shared (one graph resource, two reads).
        env_handle = (
            builder.import_resource(env.texture) if env is not None else None
        )
        if scene.skybox is not None:
            sky_handle = builder.import_resource(scene.skybox)
        else:
            sky_handle = env_handle
        node = builder.add_lambda_node("lighting")
        a_in = node.read(g_albedo)
        n_in = node.read(g_normal)
        p_in = node.read(g_pos)
        d_in = node.read(g_depth)
        sm_in = node.read(sm_handle) if sm_handle is not None else None
        omni_in = [node.read(h) for h in omni_handles]
        omni_params = [
            (float(pl.shadow_near), float(pl.radius), float(pl.shadow_bias))
            for pl in omni_lights
        ]
        ao_in = node.read(ao_handle) if ao_handle is not None else None
        env_in = node.read(env_handle) if env_handle is not None else None
        if sky_handle is None:
            sky_in = None
        elif sky_handle is env_handle:
            sky_in = env_in  # shared Texture → shared access
        else:
            sky_in = node.read(sky_handle)
        out_w = node.write(output)
        num_lights = pl_pos.shape[0]
        shadows = self.shadows
        has_sun = sun is not None
        soft_shadows = bool(
            shadows and n_casc == 1 and getattr(sun, "soft_shadows", False)
        )
        vsm_blur = int(sun.vsm_blur) if soft_shadows else 0
        vsm_bleed = float(sun.vsm_bleed_reduction) if soft_shadows else 0.0
        contact_cfg = (
            (float(sun.contact_strength), float(sun.contact_distance),
             float(sun.contact_thickness), int(sun.contact_steps))
            if has_sun and getattr(sun, "contact_shadows", False) else None
        )

        def record_lighting(ctx):
            albedo_metal = ctx.get(a_in)
            normal_rough = ctx.get(n_in)
            pos_emi = ctx.get(p_in)
            depth = ctx.get(d_in)

            albedo = albedo_metal[..., :3]
            metallic = albedo_metal[..., 3:4]
            n = normal_rough[..., :3]
            roughness = normal_rough[..., 3:4]
            world = pos_emi[..., :3]
            emissive = pos_emi[..., 3:4]
            covered = (depth > 0.0)[..., None]

            cam_pos = ctx.dynamic("def.camera_pos")
            v = cam_pos - world
            v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-8)

            # SSAO attenuates AMBIENT visibility only (flat ambient or IBL);
            # direct sun/point light keeps its shadow-map visibility.
            ao = (
                ctx.get(ao_in)[..., 0:1] if ao_in is not None
                else jnp.float32(1.0)
            )
            if env_in is not None:
                # Split-sum IBL (ops.ibl): SH diffuse + prefiltered GGX
                # specular with the analytic env-BRDF — replaces the flat
                # ambient term.
                from zenith.ops.ibl import (
                    env_brdf_approx,
                    eval_irradiance_sh9,
                )
                from zenith.ops.sampling import sample_cube_lod

                levels = ctx.get(env_in)
                if not isinstance(levels, (tuple, list)):
                    levels = (levels,)
                irr = eval_irradiance_sh9(ctx.dynamic("def.env_sh"), n)
                f0 = 0.04 * (1.0 - metallic) + albedo * metallic
                ndv = jnp.maximum(
                    jnp.sum(n * v, axis=-1, keepdims=True), 1e-4
                )
                refl = 2.0 * ndv * n - v
                lod = roughness[..., 0] * (len(levels) - 1)
                pre = sample_cube_lod(levels, refl, lod)[..., :3]
                scale, bias = env_brdf_approx(ndv, roughness)
                color = (
                    albedo * (1.0 - metallic) * irr
                    + pre * (f0 * scale + bias)
                ) * ao + emissive * albedo
            else:
                color = (
                    ctx.dynamic("def.ambient") * albedo * ao
                    + emissive * albedo
                )

            if has_sun:
                l = ctx.dynamic("def.sun_dir")
                sun_c = ctx.dynamic("def.sun_color")
                contrib = _ggx_brdf(n, v, jnp.broadcast_to(l, n.shape),
                                    albedo, metallic, roughness) * sun_c
                if shadows and n_casc > 1:
                    # Cascade select: view distance vs split edges (a sum of
                    # compares), per-pixel VP via static-N where-accumulate,
                    # per-pixel layer in the PCF gather (csm.py docstring).
                    lvps = ctx.dynamic("def.light_vp")  # (N, 4, 4)
                    splits = ctx.dynamic("def.casc_splits")  # (N,)
                    noffs = ctx.dynamic("def.shadow_noffs")  # (N,)
                    fwd = ctx.dynamic("def.camera_fwd")
                    dist = jnp.sum((world - cam_pos) * fwd, axis=-1)
                    k_idx = jnp.zeros(dist.shape, jnp.int32)
                    for i in range(n_casc - 1):
                        k_idx = k_idx + (dist > splits[i]).astype(jnp.int32)
                    noff_px = jnp.take(noffs, k_idx)[..., None]
                    sample_pos = world + n * noff_px
                    hom = jnp.concatenate(
                        [sample_pos, jnp.ones_like(world[..., :1])], axis=-1
                    )
                    lclip = jnp.zeros(hom.shape, jnp.float32)
                    for i in range(n_casc):
                        lclip = jnp.where(
                            (k_idx == i)[..., None], hom @ lvps[i].T, lclip
                        )
                    uv = jnp.stack(
                        [(lclip[..., 0] + 1) * 0.5, (lclip[..., 1] + 1) * 0.5], -1
                    )
                    ref = lclip[..., 2] - ctx.dynamic("def.shadow_bias")
                    from zenith.ops.sampling import (
                        sample_shadow_pcf_layered,
                    )

                    # ctx.get (not get_full): layered attachments are
                    # single-chip by construction — render-to-layer writes
                    # reject SPMD meshes at compile time, so this read can
                    # never see a row band.
                    lit = sample_shadow_pcf_layered(
                        ctx.get(sm_in), k_idx, uv, ref, _SHADOW_SAMPLER
                    )
                    # Beyond the last split (or off every map): lit.
                    inside = (
                        (uv[..., 0] >= 0) & (uv[..., 0] <= 1)
                        & (uv[..., 1] >= 0) & (uv[..., 1] <= 1)
                        & (dist <= splits[n_casc - 1])
                    )
                    contrib = contrib * jnp.where(inside, lit, 1.0)[..., None]
                elif shadows:
                    sample_pos = world + n * ctx.dynamic("def.shadow_noffs")
                    hom = jnp.concatenate(
                        [sample_pos, jnp.ones_like(world[..., :1])], axis=-1
                    )
                    lclip = hom @ ctx.dynamic("def.light_vp").T
                    uv = jnp.stack(
                        [(lclip[..., 0] + 1) * 0.5, (lclip[..., 1] + 1) * 0.5], -1
                    )
                    ref = lclip[..., 2] - ctx.dynamic("def.shadow_bias")
                    if soft_shadows:
                        # VSM soft shadows (ops/vsm.py): moments derived +
                        # blurred from the depth map right here — no extra
                        # pass; rolls only; one bilinear fetch.
                        from zenith.ops.vsm import (
                            depth_to_moments,
                            sample_vsm,
                        )

                        moments = depth_to_moments(
                            ctx.get_full(sm_in), taps=vsm_blur
                        )
                        lit = sample_vsm(
                            moments, uv, ref,
                            bleed_reduction=vsm_bleed,
                        )
                    else:
                        lit = sample_shadow_pcf(
                            ctx.get_full(sm_in), uv, ref, _SHADOW_SAMPLER
                        )
                    inside = (
                        (uv[..., 0] >= 0) & (uv[..., 0] <= 1)
                        & (uv[..., 1] >= 0) & (uv[..., 1] <= 1)
                    )
                    contrib = contrib * jnp.where(inside, lit, 1.0)[..., None]
                if contact_cfg is not None:
                    # Contact shadows: short G-buffer march toward the sun
                    # (ops/contact.py) closes the shadow-map bias leak at
                    # geometry-ground contacts.
                    from zenith.ops.contact import contact_shadow_factor

                    c_str, c_dist, c_thick, c_steps = contact_cfg
                    row0 = 0
                    tap_p, tap_d = world, depth
                    if ctx.sharded and ctx.num_shards > 1:
                        row0 = jax.lax.axis_index(ctx.shard_axis) \
                            * depth.shape[0]
                        tap_p = ctx.get_full(p_in)[..., :3]
                        tap_d = ctx.get_full(d_in)
                    cvis = contact_shadow_factor(
                        world, depth, tap_p, tap_d, l, cam_pos,
                        ctx.dynamic("def.view_proj"),
                        strength=c_str, max_dist=c_dist,
                        thickness=c_thick, steps=c_steps, row0=row0,
                    )
                    contrib = contrib * cvis[..., None]
                color = color + contrib

            if num_lights:
                # Tiled light culling (ops.lighting): per-tile world AABB +
                # scalar sphere tests skip the ~40-op BRDF for lights that
                # cannot touch the tile — the L-dense fori_loop version this
                # replaces dominated the whole frame at 100 lights.
                from zenith.ops.lighting import accumulate_point_lights

                color = color + accumulate_point_lights(
                    albedo_metal,
                    normal_rough,
                    pos_emi,
                    depth,
                    cam_pos,
                    ctx.dynamic("def.pl_pos"),
                    ctx.dynamic("def.pl_col"),
                    ctx.dynamic("def.pl_rad"),
                    spot_params=(
                        ctx.dynamic("def.sl_params") if has_spots else None
                    ),
                )

            # Shadow-casting point lights: dense BRDF (same distance window
            # as the kernel) times cube-PCF visibility (renderer/omni.py).
            if omni_in:
                from zenith.ops.sampling import (
                    cube_direction_to_face_uv,
                    sample_shadow_pcf_layered,
                )
                from zenith.renderer.omni import omni_reference_z

                for li, (o_near, o_far, o_bias) in enumerate(omni_params):
                    lp = ctx.dynamic(f"def.omni{li}.pos")
                    lcol = ctx.dynamic(f"def.omni{li}.col")
                    to_l = lp - world
                    d2 = jnp.maximum(jnp.sum(to_l * to_l, axis=-1), 1e-8)
                    dist = jnp.sqrt(d2)
                    ldir = to_l / dist[..., None]
                    qq = dist / o_far
                    win = jnp.clip(1.0 - qq ** 4, 0.0, 1.0) ** 2
                    contrib = _ggx_brdf(
                        n, v, ldir, albedo, metallic, roughness
                    ) * lcol * (win / d2)[..., None]
                    l2f = -to_l
                    axis_d = jnp.max(jnp.abs(l2f), axis=-1)
                    face, uv = cube_direction_to_face_uv(l2f)
                    zref = omni_reference_z(axis_d - o_bias, o_near, o_far)
                    # ctx.get: cube faces are render-to-layer writes —
                    # single-chip by compile-time assertion (see CSM note).
                    vis = sample_shadow_pcf_layered(
                        ctx.get(omni_in[li]), face, uv, zref, _SHADOW_SAMPLER
                    )
                    vis = jnp.where(dist < o_far, vis, 1.0)
                    color = color + contrib * vis[..., None]

            if sky_in is not None or atmo is not None:
                # Per-pixel view rays for the background: cube-sample them
                # (skybox/environment; texture.rs:94-105) or feed the
                # procedural atmosphere march (ops.atmosphere).
                from zenith.ops.sampling import sample_cube

                hh, ww = depth.shape
                full_h, row0 = hh, 0
                if ctx.sharded:
                    s_axis, s_n, _ = ctx._shard_ctx
                    full_h = hh * s_n
                    row0 = jax.lax.axis_index(s_axis) * hh
                ndc_x = (jnp.arange(ww, dtype=jnp.float32) + 0.5) / ww * 2 - 1
                ndc_y = (
                    (row0 + jnp.arange(hh, dtype=jnp.float32) + 0.5)
                    / full_h * 2 - 1
                )
                px = jnp.broadcast_to(ndc_x[None, :], (hh, ww))
                py = jnp.broadcast_to(ndc_y[:, None], (hh, ww))
                ndc = jnp.stack(
                    [px, py, jnp.full_like(px, 0.5), jnp.ones_like(px)], -1
                )
                p = ndc @ ctx.dynamic("def.inv_vp").T
                dirs = p[..., :3] / p[..., 3:4] - cam_pos
                if sky_in is not None:
                    sky = ctx.get(sky_in)
                    if isinstance(sky, (tuple, list)):
                        sky = sky[0]  # mipped env cube → raw env level
                    bg = sample_cube(sky, dirs)[..., :3]
                else:
                    from zenith.ops.atmosphere import sky_radiance

                    rays = dirs / jnp.linalg.norm(
                        dirs, axis=-1, keepdims=True
                    )
                    bg = sky_radiance(
                        rays, ctx.dynamic("def.sun_dir"),
                        ctx.dynamic("def.atmo"), atmo,
                    )
            else:
                bg = jnp.broadcast_to(ctx.dynamic("def.background"), color.shape)
            rgb = jnp.where(covered, color, bg)
            out = jnp.concatenate([rgb, jnp.ones_like(rgb[..., :1])], axis=-1)
            ctx.set(out_w, out)

        node.execute(record_lighting)

        # -- node: glass (translucent forward pass over the lit HDR) -----------
        if trans_ix:
            gnode = builder.add_graphic_node("glass")
            g_acc = {
                i: (gnode.read(handles[i][0]), gnode.read(handles[i][1]))
                for i in trans_ix
            }
            glass_tex_acc = {}
            glass_atlas_acc = None
            if self.glass_peel:
                glass_atlas_acc = gnode.read(
                    builder.import_resource(self._glass_atlas.texture)
                )
                glass_uvx = self._glass_atlas.transforms  # (Nt, 4) np
            elif self.glass_textured:
                white = _white_glass_texture()
                for i in trans_ix:
                    t = objects[i].base_color_texture or white
                    glass_tex_acc[i] = gnode.read(builder.import_resource(t))
            gnode.read(output)
            gnode.read(g_depth)
            out_rt = gnode.write(output)
            out_ds = gnode.write(g_depth)
            with gnode.pipeline(self._glass_si, self._glass_state) as binder:
                binder.push_color(out_rt, self._glass_over)
                binder.set_depth(out_ds, self._glass_depth)
            glass_textured = self.glass_textured
            glass_instanced = self.glass_instanced
            glass_peel = self.glass_peel
            peel_layers = self.glass_peel_layers

            def record_glass(ctx):
                ctx.bind("ViewProj", ctx.dynamic("def.view_proj"))
                sun_dir = (
                    ctx.dynamic("def.sun_dir") if has_sun
                    else jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
                )
                models = ctx.dynamic("def.models")
                bcs = ctx.dynamic("def.base_colors")
                atlas_val = (
                    ctx.get(glass_atlas_acc) if glass_peel else None
                )
                draws = []
                for k, i in enumerate(trans_ix):
                    obj = objects[i]
                    vba, iba = g_acc[i]
                    res = {
                        "Model": models[i],
                        "ViewProj": ctx.dynamic("def.view_proj"),
                        "BaseColor": bcs[i],
                        "SunDir": sun_dir,
                    }
                    if glass_peel:
                        # Atlas cell transform for this translucent (k-th
                        # in scene order — the atlas was built over the
                        # same filtered order).
                        res["GlassAtlas"] = atlas_val
                        res["UvxGlass"] = glass_uvx[k]
                    elif glass_textured:
                        res["GlassTex"] = ctx.get(glass_tex_acc[i])
                    if glass_instanced:
                        # One pipeline for the whole batch: non-instanced
                        # translucents draw as a single zero-offset
                        # instance.
                        if obj.instance_offsets is not None:
                            inst = {
                                "instance_count": obj.instance_count,
                                "instance_data": {
                                    "inst_offset": ctx.dynamic(
                                        f"def.inst.{obj.name}"
                                    )
                                },
                            }
                        else:
                            inst = {
                                "instance_count": 1,
                                "instance_data": {
                                    "inst_offset": np.zeros(
                                        (1, 3), np.float32
                                    )
                                },
                            }
                        draws.append((vba, iba, res, inst))
                    else:
                        draws.append((vba, iba, res))
                if glass_peel:
                    ctx.draw_indexed_batch(
                        draws,
                        per_draw_uniforms=("BaseColor", "UvxGlass"),
                        peel_layers=peel_layers,
                    )
                else:
                    ctx.draw_indexed_batch(draws)

            gnode.execute(record_glass)

        # Screen-space consumers declared AFTER this renderer (TAA history
        # reprojection, debug views) read this frame's G-buffer planes
        # through these handles — valid for THIS builder only.
        self.gbuffer_handles = GBufferHandles({
            "albedo": g_albedo,
            "normal": g_normal,
            "pos": g_pos,
            "depth": g_depth,
        })
        self.gbuffer_handles.animated_without_velocity = (
            self.scene_animated and not self.velocity
        )
        if g_prev is not None:
            # Per-draw velocity plane (previous-frame world positions):
            # TAA and motion blur reproject with THIS instead of "pos" —
            # correct under animated content.
            self.gbuffer_handles["prev_pos"] = g_prev
        if self.shadows and n_casc == 1:
            # Volumetric shafts (renderer/volumetric.py) march this map;
            # its VP/bias ride the graph-global "def.light_vp" /
            # "def.shadow_bias" dynamics set above — consistent with the
            # map's contents by construction. Cascaded maps are not
            # published (per-cascade marching isn't worth the gathers).
            self.gbuffer_handles["sun_shadow"] = sm_handle
