"""Render-facing asset data types (reference zenith-asset/src/render.rs).

- ``Vertex`` (render.rs:10-26): position + normal + tex_coord, 8 f32 —
  matching the reference's #[repr(C)] layout, as a (N, 8) float32 array
  (dense layout; VertexLayout slices named fields).
- ``Mesh`` (render.rs:28-70), ``TextureAsset`` (render.rs:110-133),
  ``Material`` (render.rs:135-176, PBR factors + textures embedded inline),
  ``MeshCollection`` (render.rs:178-223, parallel mesh/material url lists).
"""

from __future__ import annotations

import enum
from typing import Any, Dict, Optional

import numpy as np

from zenith.asset import Asset, AssetType, AssetUrl
from zenith.rhi.formats import Format
from zenith.rhi.state import VertexLayout

# The engine-wide static vertex layout (render.rs:10-26).
Vertex = VertexLayout.from_fields(("position", 3), ("normal", 3), ("tex_coord", 2))
VERTEX_FLOATS = Vertex.stride_floats  # 8

# Skinned variant: + 4 joint indices (stored as f32, cast in the vertex
# stage) and 4 weights — glTF JOINTS_0/WEIGHTS_0. The reference's loader
# has no skin support at all (gltf_loader.rs reads positions/normals/uvs
# only); this is a framework extension.
SkinnedVertex = VertexLayout.from_fields(
    ("position", 3), ("normal", 3), ("tex_coord", 2),
    ("joints", 4), ("weights", 4),
)
SKINNED_VERTEX_FLOATS = SkinnedVertex.stride_floats  # 16


class TextureFormat(enum.Enum):
    """(render.rs:72-108) — R8G8B8A8 maps to sRGB like the reference."""

    R8 = "r8"
    RG8 = "rg8"
    RGBA8 = "rgba8"  # sRGB content

    @property
    def bytes_per_pixel(self) -> int:
        return {"r8": 1, "rg8": 2, "rgba8": 4}[self.value]

    @property
    def channels(self) -> int:
        return self.bytes_per_pixel

    @property
    def device_format(self) -> Format:
        return {
            TextureFormat.R8: Format.R8_UNORM,
            TextureFormat.RG8: Format.RG8_UNORM,
            TextureFormat.RGBA8: Format.RGBA8_SRGB,  # render.rs:95-99
        }[self]


class Skin:
    """Joint hierarchy + bind data (glTF `skins`). ``parents`` must be
    topologically ordered (parent index < child index; -1 = root) — the
    glTF baker reindexes joints to guarantee it.

    ``pre`` (J,4,4) carries the CONSTANT transform between each joint and
    its joint-parent (or the scene root): non-joint intermediate nodes and
    the classic transformed "Armature" node above the root joint. Joint
    world = parent_world @ pre @ TRS(joint); dropping these (identity pre)
    desyncs the hierarchy from the inverse binds, which DO include them.
    """

    def __init__(self, inverse_bind: np.ndarray, parents: np.ndarray,
                 rest_t: np.ndarray, rest_r: np.ndarray, rest_s: np.ndarray,
                 pre: "Optional[np.ndarray]" = None):
        self.inverse_bind = np.ascontiguousarray(inverse_bind, np.float32)
        self.parents = np.ascontiguousarray(parents, np.int32).reshape(-1)
        self.rest_t = np.ascontiguousarray(rest_t, np.float32)
        self.rest_r = np.ascontiguousarray(rest_r, np.float32)  # xyzw quats
        self.rest_s = np.ascontiguousarray(rest_s, np.float32)
        j = self.parents.shape[0]
        if pre is None:
            pre = np.broadcast_to(np.eye(4, dtype=np.float32), (j, 4, 4))
        self.pre = np.ascontiguousarray(pre, np.float32)
        assert self.inverse_bind.shape == (j, 4, 4)
        assert self.pre.shape == (j, 4, 4)
        assert self.rest_t.shape == (j, 3) and self.rest_s.shape == (j, 3)
        assert self.rest_r.shape == (j, 4)
        assert all(p < i for i, p in enumerate(self.parents)), (
            "skin joints must be parent-before-child ordered"
        )

    @property
    def num_joints(self) -> int:
        return self.parents.shape[0]


class AnimationChannel:
    """One animated TRS component of one joint (glTF channel+sampler,
    linear interpolation)."""

    def __init__(self, joint: int, path: str, times: np.ndarray,
                 values: np.ndarray, interpolation: str = "LINEAR"):
        assert path in ("translation", "rotation", "scale", "weights")
        assert interpolation in ("LINEAR", "STEP")
        self.joint = int(joint)  # -1 for mesh-targeted "weights" channels
        self.path = path
        self.interpolation = interpolation
        self.times = np.ascontiguousarray(times, np.float32).reshape(-1)
        self.values = np.ascontiguousarray(values, np.float32)
        if path == "weights":
            # (K, T) morph-target weight rows.
            assert self.values.ndim == 2
            assert self.values.shape[0] == self.times.shape[0]
        else:
            want = 4 if path == "rotation" else 3
            assert self.values.shape == (self.times.shape[0], want)


class AnimationClip:
    """A named set of channels (glTF `animations[i]`)."""

    def __init__(self, name: str, channels: "list[AnimationChannel]",
                 duration: "float | None" = None):
        self.name = name
        self.channels = list(channels)
        self.duration = float(
            duration if duration is not None
            else max((float(c.times[-1]) for c in self.channels), default=0.0)
        )


class Mesh(Asset):
    """(render.rs:28-70) + optional skin extension (joints/weights vertex
    data, Skin hierarchy, AnimationClips) the reference loader lacks."""

    asset_type = AssetType.MESH

    def __init__(self, url: AssetUrl, vertices: np.ndarray, indices: np.ndarray,
                 material_index: int = 0,
                 skin_vertex_data: "Optional[np.ndarray]" = None,
                 skin: "Optional[Skin]" = None,
                 clips: "Optional[list[AnimationClip]]" = None,
                 morph_deltas: "Optional[np.ndarray]" = None):
        super().__init__(url)
        assert vertices.ndim == 2 and vertices.shape[1] == VERTEX_FLOATS
        self.vertices = np.ascontiguousarray(vertices, dtype=np.float32)
        self.indices = np.ascontiguousarray(indices, dtype=np.int32).reshape(-1)
        self.material_index = int(material_index)
        # (N, 8) float32: 4 joint indices + 4 normalized weights per vertex.
        self.skin_vertex_data = (
            None if skin_vertex_data is None
            else np.ascontiguousarray(skin_vertex_data, np.float32)
        )
        if self.skin_vertex_data is not None:
            assert self.skin_vertex_data.shape == (self.vertices.shape[0], 8)
        self.skin = skin
        self.clips = list(clips) if clips else []
        # Morph targets (glTF primitive `targets`): (T, N, 3) POSITION
        # deltas; base normals are kept (small-deformation approximation).
        self.morph_deltas = (
            None if morph_deltas is None
            else np.ascontiguousarray(morph_deltas, np.float32)
        )
        if self.morph_deltas is not None:
            assert self.morph_deltas.ndim == 3
            assert self.morph_deltas.shape[1] == self.vertices.shape[0]
            assert self.morph_deltas.shape[2] == 3

    @property
    def num_morph_targets(self) -> int:
        return 0 if self.morph_deltas is None else self.morph_deltas.shape[0]

    @property
    def is_skinned(self) -> bool:
        return self.skin is not None and self.skin_vertex_data is not None

    def skinned_vertices(self) -> np.ndarray:
        """(N, 16) SkinnedVertex-layout buffer (position+normal+uv+joints+
        weights) for upload."""
        assert self.is_skinned
        return np.concatenate([self.vertices, self.skin_vertex_data], axis=1)

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0] // 3

    def arrays(self) -> "Dict[str, np.ndarray]":
        out = {"vertices": self.vertices, "indices": self.indices}
        if self.is_skinned:
            out["skin.jw"] = self.skin_vertex_data
            out["skin.inverse_bind"] = self.skin.inverse_bind
            out["skin.parents"] = self.skin.parents
            out["skin.rest_t"] = self.skin.rest_t
            out["skin.rest_r"] = self.skin.rest_r
            out["skin.rest_s"] = self.skin.rest_s
            out["skin.pre"] = self.skin.pre
        if self.morph_deltas is not None:
            out["morph.deltas"] = self.morph_deltas
        for ci, clip in enumerate(self.clips):
            for hi, ch in enumerate(clip.channels):
                out[f"anim{ci}.ch{hi}.t"] = ch.times
                out[f"anim{ci}.ch{hi}.v"] = ch.values
        return out

    def metadata(self) -> "Dict[str, Any]":
        meta: "Dict[str, Any]" = {"material_index": self.material_index}
        if self.clips:
            meta["clips"] = [
                {
                    "name": clip.name,
                    "duration": clip.duration,
                    "channels": [
                        {"joint": ch.joint, "path": ch.path,
                         "interp": ch.interpolation}
                        for ch in clip.channels
                    ],
                }
                for clip in self.clips
            ]
        return meta

    @classmethod
    def from_parts(cls, url, arrays, metadata):
        skin = None
        jw = arrays.get("skin.jw")
        if jw is not None:
            skin = Skin(
                arrays["skin.inverse_bind"], arrays["skin.parents"],
                arrays["skin.rest_t"], arrays["skin.rest_r"],
                arrays["skin.rest_s"],
                pre=arrays.get("skin.pre"),  # absent in old caches → identity
            )
        clips = []
        for ci, cm in enumerate(metadata.get("clips", [])):
            channels = [
                AnimationChannel(
                    chm["joint"], chm["path"],
                    arrays[f"anim{ci}.ch{hi}.t"],
                    arrays[f"anim{ci}.ch{hi}.v"],
                    interpolation=chm.get("interp", "LINEAR"),
                )
                for hi, chm in enumerate(cm["channels"])
            ]
            clips.append(AnimationClip(cm["name"], channels,
                                       cm.get("duration")))
        return cls(url, arrays["vertices"], arrays["indices"],
                   metadata.get("material_index", 0),
                   skin_vertex_data=jw, skin=skin, clips=clips,
                   morph_deltas=arrays.get("morph.deltas"))


class TextureAsset(Asset):
    """CPU-side pixels at rest (render.rs:110-133)."""

    asset_type = AssetType.TEXTURE

    def __init__(self, url: AssetUrl, pixels: np.ndarray,
                 format: TextureFormat = TextureFormat.RGBA8):
        super().__init__(url)
        if pixels.ndim == 2:
            pixels = pixels[..., None]
        self.pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
        self.format = format

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    def arrays(self):
        return {"pixels": self.pixels}

    def metadata(self):
        return {"format": self.format.value}

    @classmethod
    def from_parts(cls, url, arrays, metadata):
        return cls(url, arrays["pixels"], TextureFormat(metadata["format"]))


class Material(Asset):
    """PBR material with factors + textures embedded inline
    (render.rs:135-176 embeds texture payloads in the material)."""

    asset_type = AssetType.MATERIAL

    def __init__(
        self,
        url: AssetUrl,
        base_color_factor=(1.0, 1.0, 1.0, 1.0),
        metallic_factor: float = 1.0,
        roughness_factor: float = 1.0,
        emissive_factor=(0.0, 0.0, 0.0),
        base_color_texture: "Optional[TextureAsset]" = None,
        metallic_roughness_texture: "Optional[TextureAsset]" = None,
        normal_texture: "Optional[TextureAsset]" = None,
        emissive_texture: "Optional[TextureAsset]" = None,
    ):
        super().__init__(url)
        self.base_color_factor = tuple(float(c) for c in base_color_factor)
        self.metallic_factor = float(metallic_factor)
        self.roughness_factor = float(roughness_factor)
        self.emissive_factor = tuple(float(c) for c in emissive_factor)
        self.base_color_texture = base_color_texture
        self.metallic_roughness_texture = metallic_roughness_texture
        self.normal_texture = normal_texture
        self.emissive_texture = emissive_texture

    _TEX_SLOTS = (
        "base_color_texture",
        "metallic_roughness_texture",
        "normal_texture",
        "emissive_texture",
    )

    def arrays(self):
        out = {}
        for slot in self._TEX_SLOTS:
            tex = getattr(self, slot)
            if tex is not None:
                out[f"{slot}.pixels"] = tex.pixels
        return out

    def metadata(self):
        meta: Dict[str, Any] = {
            "base_color_factor": list(self.base_color_factor),
            "metallic_factor": self.metallic_factor,
            "roughness_factor": self.roughness_factor,
            "emissive_factor": list(self.emissive_factor),
        }
        for slot in self._TEX_SLOTS:
            tex = getattr(self, slot)
            if tex is not None:
                meta[f"{slot}.format"] = tex.format.value
        return meta

    @classmethod
    def from_parts(cls, url, arrays, metadata):
        kwargs: Dict[str, Any] = {}
        for slot in cls._TEX_SLOTS:
            key = f"{slot}.pixels"
            if key in arrays:
                kwargs[slot] = TextureAsset(
                    url.sibling(f"{url.path}.{slot}"),
                    arrays[key],
                    TextureFormat(metadata[f"{slot}.format"]),
                )
        return cls(
            url,
            base_color_factor=metadata["base_color_factor"],
            metallic_factor=metadata["metallic_factor"],
            roughness_factor=metadata["roughness_factor"],
            emissive_factor=metadata["emissive_factor"],
            **kwargs,
        )


class MeshCollection(Asset):
    """Parallel mesh/material url lists (render.rs:178-223)."""

    asset_type = AssetType.MESH_COLLECTION

    def __init__(self, url: AssetUrl, mesh_urls: "list[str]",
                 material_urls: "list[str]"):
        super().__init__(url)
        assert len(mesh_urls) == len(material_urls), (
            "mesh/material lists must pair 1:1 (gltf_loader.rs:343)"
        )
        self.mesh_urls = list(mesh_urls)
        self.material_urls = list(material_urls)

    def arrays(self):
        return {}

    def metadata(self):
        return {"mesh_urls": self.mesh_urls, "material_urls": self.material_urls}

    @classmethod
    def from_parts(cls, url, arrays, metadata):
        return cls(url, metadata["mesh_urls"], metadata["material_urls"])
