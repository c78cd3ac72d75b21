"""glTF 2.0 loader + baker (reference zenith-asset/src/gltf_loader.rs).

Pure-Python glTF parse (the reference uses the `gltf` crate): JSON document
or GLB binary container, buffer resolution (external .bin via mmap, data:
URIs, or the GLB BIN chunk), image resolution (data URI / bufferView /
external file decoded by PIL, forced RGBA8 — gltf_loader.rs:398-473),
accessor reading with component types and strides.

Baking (RawGltfProcessor::bake, gltf_loader.rs:54-359): recursive scene-node
walk → per-primitive Mesh assets (flat normals generated when missing,
gltf_loader.rs:150-171; UVs default 0), per-material Material assets with
inline textures, and a MeshCollection manifest pairing meshes↔materials 1:1.

Divergences from the reference (improvements): node transforms (matrix or
TRS) are applied to baked positions/normals — the reference drops them; GLB
containers load — the reference rejects GLB bin-chunk buffers with
`unimplemented!` (gltf_loader.rs:372-396).
"""

from __future__ import annotations

import base64
import io
import json
import urllib.parse
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from zenith.asset import AssetUrl, registry
from zenith.asset.render_types import (
    Material,
    Mesh,
    MeshCollection,
    TextureAsset,
    TextureFormat,
    VERTEX_FLOATS,
)
from zenith.core import log
from zenith.core.fileio import load_with_memory_mapping

logger = log.get(__name__)

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


_GLB_CHUNK_JSON = 0x4E4F534A  # 'JSON'
_GLB_CHUNK_BIN = 0x004E4942   # 'BIN\0'


def _parse_glb(raw: bytes) -> "tuple[Dict[str, Any], Optional[bytes]]":
    """Parse a GLB binary container → (JSON document, BIN chunk or None).

    The glTF 2.0 binary layout: 12-byte header (magic 'glTF', version,
    total length), then 4-byte-aligned chunks of (length, type, data).
    Unknown chunk types are skipped per spec. The reference rejects this
    container entirely (gltf_loader.rs:372-396); supporting it is a
    divergence-as-improvement.
    """
    import struct

    if len(raw) < 12:
        raise ValueError("GLB container truncated: missing 12-byte header")
    _magic, version, length = struct.unpack_from("<III", raw, 0)
    if version != 2:
        raise ValueError(f"GLB version {version} not supported (glTF 2.0 only)")
    doc: "Optional[Dict[str, Any]]" = None
    bin_chunk: "Optional[bytes]" = None
    off = 12
    end = min(length, len(raw))
    while off + 8 <= end:
        clen, ctype = struct.unpack_from("<II", raw, off)
        data = raw[off + 8 : off + 8 + clen]
        if len(data) < clen:
            raise ValueError("GLB chunk truncated: declared length runs past EOF")
        if ctype == _GLB_CHUNK_JSON:
            # Spec pads the JSON chunk with trailing spaces to 4-byte align.
            doc = json.loads(data.decode("utf-8"))
        elif ctype == _GLB_CHUNK_BIN and bin_chunk is None:
            bin_chunk = bytes(data)
        off += 8 + clen + (-clen % 4)
    if doc is None:
        raise ValueError("GLB container has no JSON chunk")
    return doc, bin_chunk


class RawGltf:
    """Parsed glTF document + resolved buffers/images
    (reference RawGltf, gltf_loader.rs:9-52)."""

    def __init__(self, doc: "Dict[str, Any]", buffers: "List[bytes]",
                 base_dir: Path):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    # -- accessors -------------------------------------------------------------

    def read_accessor(self, index: int) -> np.ndarray:
        acc = self.doc["accessors"][index]
        count = acc["count"]
        n_comp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        if "bufferView" not in acc:
            data = np.zeros((count, n_comp), dtype=dtype)
        else:
            bv = self.doc["bufferViews"][acc["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            elem_size = np.dtype(dtype).itemsize * n_comp
            stride = bv.get("byteStride", elem_size)
            if stride == elem_size:
                data = np.frombuffer(
                    buf, dtype=dtype, count=count * n_comp, offset=offset
                ).reshape(count, n_comp)
            else:
                raw = np.frombuffer(
                    buf, dtype=np.uint8,
                    count=stride * (count - 1) + elem_size, offset=offset,
                )
                strided = np.lib.stride_tricks.as_strided(
                    raw, shape=(count, elem_size), strides=(stride, 1)
                )
                data = strided.reshape(-1).view(dtype).reshape(count, n_comp)
        if acc.get("normalized") and np.issubdtype(dtype, np.integer):
            info = np.iinfo(dtype)
            data = data.astype(np.float32) / float(info.max)
        return np.array(data)

    def read_image(self, index: int) -> np.ndarray:
        """Decode an image to RGBA8 (gltf_loader.rs:398-473). Needs PIL,
        which only loading uncached glTF textures does (baked assets in the
        cache load without it)."""
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                "decoding glTF images needs Pillow (PIL); bake the asset "
                "where Pillow is installed, or install it"
            ) from e

        img = self.doc["images"][index]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                payload = base64.b64decode(uri.split(",", 1)[1])
                pil = Image.open(io.BytesIO(payload))
            else:
                pil = Image.open(self.base_dir / urllib.parse.unquote(uri))
        else:
            bv = self.doc["bufferViews"][img["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            off = bv.get("byteOffset", 0)
            pil = Image.open(io.BytesIO(bytes(buf[off : off + bv["byteLength"]])))
        return np.asarray(pil.convert("RGBA"), dtype=np.uint8)


class GltfLoader:
    """(gltf_loader.rs:9-52, 361-473)"""

    @staticmethod
    def load(path: "Path | str") -> RawGltf:
        path = Path(path)
        raw = bytes(load_with_memory_mapping(path))
        bin_chunk: "Optional[bytes]" = None
        if raw[:4] == b"glTF":
            doc, bin_chunk = _parse_glb(raw)
        else:
            doc = json.loads(raw.decode("utf-8"))
        buffers: List[bytes] = []
        for buf in doc.get("buffers", []):
            uri = buf.get("uri")
            if uri is None:
                # glTF spec: only buffer 0 may be uri-less, referring to the
                # container's BIN chunk.
                if bin_chunk is None:
                    raise ValueError(
                        "buffer without uri outside a GLB container (no BIN "
                        "chunk to resolve it against)"
                    )
                buffers.append(bin_chunk)
            elif uri.startswith("data:"):
                buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                buffers.append(
                    bytes(load_with_memory_mapping(path.parent / urllib.parse.unquote(uri)))
                )
        return RawGltf(doc, buffers, path.parent)


def _node_matrix(node: "Dict[str, Any]") -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T  # column-major in file
    from zenith.core import mathtypes as m

    mat = np.eye(4, dtype=np.float32)
    if "scale" in node:
        mat = m.mat4_scale(np.asarray(node["scale"], np.float32)) @ mat
    if "rotation" in node:
        q = np.asarray(node["rotation"], np.float32)  # x, y, z, w
        mat = m.mat4_from_quat(q) @ mat
    if "translation" in node:
        mat = m.mat4_translation(np.asarray(node["translation"], np.float32)) @ mat
    return mat


def _generate_flat_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Per-vertex flat normals (gltf_loader.rs:151-170 — the reference
    requires unindexed data; we scatter per-face normals to vertices)."""
    normals = np.zeros_like(positions)
    tris = indices.reshape(-1, 3)
    v0, v1, v2 = (positions[tris[:, k]] for k in range(3))
    face_n = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(face_n, axis=1, keepdims=True)
    face_n = face_n / np.where(norm > 0, norm, 1.0)
    for k in range(3):
        np.add.at(normals, tris[:, k], face_n)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.where(norm > 0, norm, 1.0)).astype(np.float32)


class RawGltfProcessor:
    """Bakes a RawGltf into registered + cached assets
    (gltf_loader.rs:54-359)."""

    def __init__(self, raw: RawGltf, asset_url: AssetUrl, cache_dir: Path):
        self.raw = raw
        self.asset_url = asset_url
        self.cache_dir = cache_dir
        self._mesh_urls: List[str] = []
        self._material_urls: List[str] = []
        self._materials_baked: Dict[int, str] = {}
        self._skins_built: Dict[int, tuple] = {}

    def bake(self) -> MeshCollection:
        doc = self.raw.doc
        scene = doc.get("scenes", [{}])[doc.get("scene", 0)]
        for node_index in scene.get("nodes", []):
            self._process_node(node_index, np.eye(4, dtype=np.float32))
        manifest_url = self.asset_url.with_extension("mscl")
        collection = MeshCollection(manifest_url, self._mesh_urls, self._material_urls)
        collection.save(self.cache_dir / manifest_url.path)
        registry().register(collection)
        logger.info(
            "baked %s: %d meshes, %d materials",
            self.asset_url, len(self._mesh_urls), len(set(self._material_urls)),
        )
        return collection

    # -- nodes (gltf_loader.rs process_node) ------------------------------------

    def _process_node(self, node_index: int, parent: np.ndarray) -> None:
        node = self.raw.doc["nodes"][node_index]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            self._bake_mesh(node["mesh"], world, node.get("skin"),
                            node_index)
        for child in node.get("children", []):
            self._process_node(child, world)

    # -- skins + animations (framework extension; the reference loader has
    # no skin support at all) -----------------------------------------------

    def _build_skin(self, skin_index: int):
        """doc['skins'][i] → (render_types.Skin, old→new joint remap array,
        node-index→new-joint map). Joints are reindexed parent-before-child
        (the Skin contract; glTF permits any order)."""
        from zenith.asset.render_types import Skin

        cached = self._skins_built.get(skin_index)
        if cached is not None:
            return cached
        doc = self.raw.doc
        skin = doc["skins"][skin_index]
        joints = list(skin["joints"])
        jset = {n: i for i, n in enumerate(joints)}
        parent_of: "Dict[int, int]" = {}
        for ni, node in enumerate(doc["nodes"]):
            for c in node.get("children", []):
                parent_of[c] = ni
        order: "List[int]" = []
        seen: set = set()

        def visit(n):
            if n in seen:
                return
            seen.add(n)
            p = parent_of.get(n)
            if p is not None and p in jset:
                visit(p)
            order.append(n)

        for n in joints:
            visit(n)
        remap = np.empty((len(joints),), np.int32)
        for new_i, n in enumerate(order):
            remap[jset[n]] = new_i
        inv_raw = self.raw.read_accessor(
            skin["inverseBindMatrices"]
        ).astype(np.float32)
        j = len(joints)
        inv = np.empty((j, 4, 4), np.float32)
        rest_t = np.zeros((j, 3), np.float32)
        rest_r = np.tile(np.asarray([0, 0, 0, 1], np.float32), (j, 1))
        rest_s = np.ones((j, 3), np.float32)
        pre = np.tile(np.eye(4, dtype=np.float32), (j, 1, 1))
        parents = np.full((j,), -1, np.int32)
        for new_i, n in enumerate(order):
            # MAT4 accessors are column-major in the file.
            inv[new_i] = inv_raw[jset[n]].reshape(4, 4).T
            node = doc["nodes"][n]
            if "matrix" in node:
                logger.warning(
                    "joint node %d uses a matrix transform; only its "
                    "translation is honored as the rest pose", n
                )
                rest_t[new_i] = np.asarray(
                    node["matrix"], np.float32
                ).reshape(4, 4).T[:3, 3]
            else:
                rest_t[new_i] = node.get("translation", (0.0, 0.0, 0.0))
                rest_r[new_i] = node.get("rotation", (0.0, 0.0, 0.0, 1.0))
                rest_s[new_i] = node.get("scale", (1.0, 1.0, 1.0))
            # Constant transforms BETWEEN this joint and its joint-parent
            # (non-joint intermediates, or everything up to the scene root
            # for root joints — the classic transformed Armature node):
            # composed into a per-joint pre-matrix; the inverse binds
            # include these, so dropping them offsets the bind pose.
            p = parent_of.get(n)
            chain = np.eye(4, dtype=np.float64)
            while p is not None and p not in jset:
                chain = _node_matrix(doc["nodes"][p]).astype(np.float64) @ chain
                p = parent_of.get(p)
            pre[new_i] = chain.astype(np.float32)
            if p is not None:
                parents[new_i] = remap[jset[p]]
        node_to_joint = {n: int(remap[jset[n]]) for n in joints}
        built = (
            Skin(inv, parents, rest_t, rest_r, rest_s, pre=pre),
            remap, node_to_joint,
        )
        self._skins_built[skin_index] = built
        return built

    def _bake_animations(self, node_to_joint: "Dict[int, int]"):
        """All document animations whose channels target this skin's
        joints (linear interpolation; CUBICSPLINE channels are skipped
        with a warning)."""
        from zenith.asset.render_types import (
            AnimationChannel,
            AnimationClip,
        )

        clips = []
        for ai, anim in enumerate(self.raw.doc.get("animations", [])):
            channels = []
            for ch in anim.get("channels", []):
                tgt = ch.get("target", {})
                node = tgt.get("node")
                path = tgt.get("path")
                if node not in node_to_joint or path not in (
                    "translation", "rotation", "scale"
                ):
                    continue
                smp = anim["samplers"][ch["sampler"]]
                interp = smp.get("interpolation", "LINEAR")
                if interp == "CUBICSPLINE":
                    logger.warning(
                        "animation %d: CUBICSPLINE channel skipped "
                        "(linear/step only)", ai
                    )
                    continue
                times = self.raw.read_accessor(smp["input"]).astype(
                    np.float32
                ).reshape(-1)
                values = self.raw.read_accessor(smp["output"]).astype(
                    np.float32
                )
                channels.append(AnimationChannel(
                    node_to_joint[node], path, times, values,
                    interpolation=(
                        "STEP" if interp == "STEP" else "LINEAR"
                    ),
                ))
            if channels:
                clips.append(
                    AnimationClip(anim.get("name", f"anim{ai}"), channels)
                )
        return clips

    def _bake_weight_clips(self, node_index: int, n_targets: int):
        """Morph-weight animations: glTF path "weights" channels targeting
        this mesh's node. The output accessor is a flat scalar stream of
        K·T values → (K, T) rows."""
        from zenith.asset.render_types import (
            AnimationChannel,
            AnimationClip,
        )

        clips = []
        for ai, anim in enumerate(self.raw.doc.get("animations", [])):
            channels = []
            for ch in anim.get("channels", []):
                tgt = ch.get("target", {})
                if tgt.get("node") != node_index or tgt.get("path") != "weights":
                    continue
                smp = anim["samplers"][ch["sampler"]]
                if smp.get("interpolation", "LINEAR") == "CUBICSPLINE":
                    logger.warning(
                        "animation %d: CUBICSPLINE weights channel skipped",
                        ai,
                    )
                    continue
                times = self.raw.read_accessor(smp["input"]).astype(
                    np.float32
                ).reshape(-1)
                values = self.raw.read_accessor(smp["output"]).astype(
                    np.float32
                ).reshape(times.shape[0], n_targets)
                channels.append(AnimationChannel(
                    -1, "weights", times, values,
                    interpolation=(
                        "STEP"
                        if smp.get("interpolation") == "STEP" else "LINEAR"
                    ),
                ))
            if channels:
                clips.append(
                    AnimationClip(anim.get("name", f"anim{ai}"), channels)
                )
        return clips

    def _bake_mesh(self, mesh_index: int, world: np.ndarray,
                   skin_index: "Optional[int]" = None,
                   node_index: "Optional[int]" = None) -> None:
        mesh = self.raw.doc["meshes"][mesh_index]
        for prim_index, prim in enumerate(mesh.get("primitives", [])):
            attrs = prim["attributes"]
            positions = self.raw.read_accessor(attrs["POSITION"]).astype(np.float32)
            n = positions.shape[0]

            if "indices" in prim:
                indices = self.raw.read_accessor(prim["indices"]).reshape(-1)
            else:
                indices = np.arange(n, dtype=np.uint32)
            indices = indices.astype(np.int32)

            skinned = skin_index is not None and "JOINTS_0" in attrs
            if skinned:
                # glTF §skins: a skinned mesh ignores its node's transform —
                # vertices stay in bind space; joints place them.
                normal_mat = np.eye(3, dtype=np.float32)
            else:
                # Apply the node's world transform (improvement over the
                # reference, which drops transforms).
                positions = positions @ world[:3, :3].T + world[:3, 3]
                normal_mat = np.linalg.inv(world[:3, :3]).T

            if "NORMAL" in attrs:
                normals = self.raw.read_accessor(attrs["NORMAL"]).astype(np.float32)
                normals = normals @ normal_mat.T
                ln = np.linalg.norm(normals, axis=1, keepdims=True)
                normals = normals / np.where(ln > 0, ln, 1.0)
            else:
                normals = _generate_flat_normals(positions, indices)

            if "TEXCOORD_0" in attrs:
                uvs = self.raw.read_accessor(attrs["TEXCOORD_0"]).astype(np.float32)
            else:
                uvs = np.zeros((n, 2), np.float32)  # gltf_loader.rs: default 0

            vertices = np.concatenate([positions, normals, uvs], axis=1)
            assert vertices.shape[1] == VERTEX_FLOATS

            skin_obj = None
            jw = None
            clips: "List" = []
            if skinned:
                skin_obj, remap, node_to_joint = self._build_skin(skin_index)
                joints_raw = self.raw.read_accessor(
                    attrs["JOINTS_0"]
                ).astype(np.int64)  # integer indices (never normalized)
                weights = self.raw.read_accessor(
                    attrs["WEIGHTS_0"]
                ).astype(np.float32)  # normalized u8/u16 handled upstream
                wsum = weights.sum(axis=1, keepdims=True)
                weights = weights / np.where(wsum > 1e-8, wsum, 1.0)
                jw = np.concatenate([
                    remap[joints_raw].astype(np.float32), weights
                ], axis=1)
                clips = clips + self._bake_animations(node_to_joint)

            # Morph targets (primitive `targets`): POSITION deltas only;
            # delta vectors rotate with the baked world transform (they are
            # directions, not points).
            morph_deltas = None
            targets = prim.get("targets") or []
            if targets:
                tds = []
                for tgt in targets:
                    if "POSITION" not in tgt:
                        tds.append(np.zeros((n, 3), np.float32))
                        continue
                    d = self.raw.read_accessor(
                        tgt["POSITION"]
                    ).astype(np.float32)
                    if not skinned:
                        d = d @ world[:3, :3].T
                    tds.append(d)
                morph_deltas = np.stack(tds)
                if node_index is not None:
                    clips = clips + self._bake_weight_clips(
                        node_index, len(targets)
                    )

            material_index = prim.get("material", 0)
            material_url = self._bake_material(material_index)

            mesh_url = self.asset_url.sibling(
                f"{Path(self.asset_url.path).stem}_{mesh_index}_{prim_index}.mesh"
            )
            asset = Mesh(mesh_url, vertices, indices, material_index,
                         skin_vertex_data=jw, skin=skin_obj, clips=clips,
                         morph_deltas=morph_deltas)
            asset.save(self.cache_dir / mesh_url.path)
            registry().register(asset)
            self._mesh_urls.append(mesh_url.path)
            self._material_urls.append(material_url)

    # -- materials (gltf_loader.rs:173-307) --------------------------------------

    def _texture_from_info(self, info: "Optional[Dict[str, Any]]",
                           slot: str) -> "Optional[TextureAsset]":
        if info is None:
            return None
        try:
            tex = self.raw.doc["textures"][info["index"]]
            pixels = self.raw.read_image(tex["source"])
        except (FileNotFoundError, KeyError) as e:
            # cerberus's PNGs are stripped from the checkout
            # (.MISSING_LARGE_BLOBS) — degrade to no texture, like a missing
            # optional slot.
            logger.warning("texture for %s unavailable (%s); skipping", slot, e)
            return None
        url = self.asset_url.sibling(f"{slot}_{info['index']}.tex")
        return TextureAsset(url, pixels, TextureFormat.RGBA8)

    def _bake_material(self, material_index: int) -> str:
        if material_index in self._materials_baked:
            return self._materials_baked[material_index]
        materials = self.raw.doc.get("materials", [])
        mat = materials[material_index] if material_index < len(materials) else {}
        pbr = mat.get("pbrMetallicRoughness", {})

        url = self.asset_url.sibling(
            f"{Path(self.asset_url.path).stem}_mat_{material_index}.mat"
        )
        asset = Material(
            url,
            base_color_factor=pbr.get("baseColorFactor", (1, 1, 1, 1)),
            metallic_factor=pbr.get("metallicFactor", 1.0),
            roughness_factor=pbr.get("roughnessFactor", 1.0),
            emissive_factor=mat.get("emissiveFactor", (0, 0, 0)),
            base_color_texture=self._texture_from_info(
                pbr.get("baseColorTexture"), "base_color"
            ),
            metallic_roughness_texture=self._texture_from_info(
                pbr.get("metallicRoughnessTexture"), "mra"
            ),
            normal_texture=self._texture_from_info(
                mat.get("normalTexture"), "normal"
            ),
            emissive_texture=self._texture_from_info(
                mat.get("emissiveTexture"), "emissive"
            ),
        )
        asset.save(self.cache_dir / url.path)
        registry().register(asset)
        self._materials_baked[material_index] = url.path
        return url.path
