"""Asset pipeline tests: registry, serialization roundtrips, bake-cache
mtime invalidation, glTF loading (synthetic data-URI document + the real
cerberus when the reference content is mounted)."""

import base64
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest

from zenith import asset as asset_mod
from zenith.asset import (
    AssetManager,
    AssetUrl,
    Material,
    Mesh,
    MeshCollection,
    TextureAsset,
    TextureFormat,
    registry,
)


@pytest.fixture(autouse=True)
def fresh_registry():
    asset_mod.initialize()
    registry().clear()
    yield
    registry().clear()


class TestRegistry:
    def test_register_get_handle(self):
        mesh = Mesh(
            AssetUrl("m/a.mesh"),
            np.zeros((3, 8), np.float32),
            np.array([0, 1, 2], np.int32),
        )
        handle = registry().register(mesh)
        assert handle.get().num_vertices == 3
        assert registry().get(AssetUrl("m/a.mesh"), Mesh) is mesh
        registry().unregister(AssetUrl("m/a.mesh"), Mesh)
        assert registry().get(AssetUrl("m/a.mesh"), Mesh) is None
        with pytest.raises(KeyError):
            handle.get()

    def test_url_semantics(self):
        url = AssetUrl("mesh/cerberus/scene.gltf")
        assert url.with_extension("mscl").path == "mesh/cerberus/scene.mscl"
        assert url.sibling("tex.png").path == "mesh/cerberus/tex.png"
        with pytest.raises(AssertionError):
            AssetUrl("/absolute/banned")


class TestSerialization:
    def test_mesh_roundtrip(self, tmp_path):
        verts = np.random.default_rng(0).uniform(size=(10, 8)).astype(np.float32)
        idx = np.arange(9, dtype=np.int32)
        mesh = Mesh(AssetUrl("m.mesh"), verts, idx, material_index=2)
        mesh.save(tmp_path / "m.mesh")
        back = Mesh.load(AssetUrl("m.mesh"), tmp_path / "m.mesh")
        np.testing.assert_array_equal(back.vertices, verts)
        np.testing.assert_array_equal(back.indices, idx)
        assert back.material_index == 2

    def test_material_with_inline_texture_roundtrip(self, tmp_path):
        px = np.random.default_rng(1).integers(0, 255, (4, 4, 4)).astype(np.uint8)
        mat = Material(
            AssetUrl("m.mat"),
            base_color_factor=(0.5, 0.25, 1.0, 1.0),
            metallic_factor=0.7,
            roughness_factor=0.3,
            base_color_texture=TextureAsset(AssetUrl("t.tex"), px),
        )
        mat.save(tmp_path / "m.mat")
        back = Material.load(AssetUrl("m.mat"), tmp_path / "m.mat")
        assert back.base_color_factor == (0.5, 0.25, 1.0, 1.0)
        assert back.metallic_factor == pytest.approx(0.7)
        np.testing.assert_array_equal(back.base_color_texture.pixels, px)
        assert back.normal_texture is None

    def test_collection_pairing_enforced(self):
        with pytest.raises(AssertionError):
            MeshCollection(AssetUrl("c.mscl"), ["a"], ["x", "y"])


def make_synthetic_gltf(path: Path):
    """A one-triangle glTF with a data-URI buffer (positions + indices)."""
    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    indices = np.array([0, 1, 2], np.uint16)
    blob = positions.tobytes() + indices.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [1.0, 2.0, 3.0]}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1, "material": 0,
        }]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.1, 0.2, 1.0],
            "metallicFactor": 0.4, "roughnessFactor": 0.6,
        }}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 6},
        ],
        "buffers": [{
            "byteLength": len(blob),
            "uri": "data:application/octet-stream;base64,"
                   + base64.b64encode(blob).decode(),
        }],
    }
    path.write_text(json.dumps(doc))


class TestGltfAndManager:
    def test_synthetic_gltf_bake_and_cache(self, tmp_path):
        content = tmp_path / "content" / "tri"
        content.mkdir(parents=True)
        make_synthetic_gltf(content / "tri.gltf")
        mgr = AssetManager(root=tmp_path)

        handle = mgr.request_load("tri/tri.gltf")
        col = handle.get()
        assert len(col.mesh_urls) == 1
        mesh = registry().get(AssetUrl(col.mesh_urls[0]), Mesh)
        # Node translation (1,2,3) applied (improvement over the reference).
        np.testing.assert_allclose(mesh.vertices[0, :3], [1, 2, 3], atol=1e-6)
        # Flat normals generated (+Z for this CCW triangle in the XY plane).
        np.testing.assert_allclose(mesh.vertices[:, 3:6], [[0, 0, 1]] * 3, atol=1e-6)
        mat = registry().get(AssetUrl(col.material_urls[0]), Material)
        assert mat.base_color_factor == (0.9, 0.1, 0.2, 1.0)

        # Cache hit: loading again must NOT rebake (cache mtimes unchanged).
        manifest = tmp_path / "cache" / "tri" / "tri.mscl"
        mtime = manifest.stat().st_mtime_ns
        registry().clear()
        mgr.request_load("tri/tri.gltf")
        assert manifest.stat().st_mtime_ns == mtime
        assert registry().get(AssetUrl(col.mesh_urls[0]), Mesh) is not None

        # Touch the source → stale cache → rebake (manager.rs:80-115).
        time.sleep(0.01)
        os.utime(content / "tri.gltf")
        registry().clear()
        mgr.request_load("tri/tri.gltf")
        assert manifest.stat().st_mtime_ns > mtime

    @pytest.mark.skipif(
        not Path("/root/reference/content/mesh/cerberus/scene.gltf").exists(),
        reason="reference content not mounted",
    )
    def test_cerberus_bake(self, tmp_path):
        mgr = AssetManager(root="/root/reference", cache_dir=tmp_path / "cache")
        col = mgr.request_load("mesh/cerberus/scene.gltf").get()
        mesh = registry().get(AssetUrl(col.mesh_urls[0]), Mesh)
        # SURVEY.md/BASELINE.md: 27,420 vertices, indexed.
        assert mesh.num_vertices == 27420
        assert mesh.num_triangles == 33543
        assert np.isfinite(mesh.vertices).all()
        # Normals are unit length.
        n = np.linalg.norm(mesh.vertices[:, 3:6], axis=1)
        np.testing.assert_allclose(n, 1.0, atol=1e-3)


class TestHotReload:
    def test_watch_and_poll_rebakes_on_touch(self, tmp_path):
        """watch() + poll_hot_reload(): touching the source triggers a
        rebake and fires the callback with the fresh handle."""
        import os
        import shutil
        import time

        from zenith.asset.manager import AssetManager
        from zenith.sandbox.mesh import default_content_root

        src_root = default_content_root()
        gltf_dir = os.path.join(src_root, "content", "mesh", "cerberus")
        if not os.path.isdir(gltf_dir):
            import pytest

            pytest.skip("cerberus content unavailable")
        root = tmp_path / "ws"
        dst = root / "content" / "mesh" / "cerberus"
        dst.parent.mkdir(parents=True)
        shutil.copytree(gltf_dir, dst)

        mgr = AssetManager(root=root, cache_dir=root / "cache")
        url = "mesh/cerberus/scene.gltf"
        mgr.request_load(url)

        seen = []
        mgr.watch(url, on_reload=seen.append)
        assert mgr.poll_hot_reload() == []  # unchanged → no work

        src = dst / "scene.gltf"
        os.utime(src, (time.time() + 5, time.time() + 5))
        reloaded = mgr.poll_hot_reload()
        assert [str(u) for u in reloaded] == [url]
        assert len(seen) == 1 and seen[0].get() is not None
        assert mgr.poll_hot_reload() == []  # settles


def make_synthetic_glb(path: Path):
    """The same one-triangle scene as make_synthetic_gltf, packed as a GLB
    container: JSON chunk + BIN chunk, buffer 0 uri-less (resolved against
    the BIN chunk, which the reference refuses — gltf_loader.rs:372-396)."""
    import struct

    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    indices = np.array([0, 1, 2], np.uint16)
    blob = positions.tobytes() + indices.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [1.0, 2.0, 3.0]}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1, "material": 0,
        }]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.1, 0.2, 1.0],
            "metallicFactor": 0.4, "roughnessFactor": 0.6,
        }}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 6},
        ],
        "buffers": [{"byteLength": len(blob)}],  # uri-less → BIN chunk
    }
    json_bytes = json.dumps(doc).encode()
    json_bytes += b" " * (-len(json_bytes) % 4)  # spec: space-padded
    bin_bytes = blob + b"\x00" * (-len(blob) % 4)
    total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
    payload = (
        struct.pack("<III", 0x46546C67, 2, total)
        + struct.pack("<II", len(json_bytes), 0x4E4F534A) + json_bytes
        + struct.pack("<II", len(bin_bytes), 0x004E4942) + bin_bytes
    )
    path.write_bytes(payload)


class TestGlbContainer:
    def test_glb_bakes_identically_to_gltf(self, tmp_path):
        """Divergence-as-improvement: GLB containers load (the reference
        rejects GLB bin-chunk buffers, gltf_loader.rs:372-396). The packed
        scene must bake to the same geometry as its .gltf twin."""
        content = tmp_path / "content" / "tri"
        content.mkdir(parents=True)
        make_synthetic_glb(content / "tri.glb")
        mgr = AssetManager(root=tmp_path)

        col = mgr.request_load("tri/tri.glb").get()
        assert len(col.mesh_urls) == 1
        mesh = registry().get(AssetUrl(col.mesh_urls[0]), Mesh)
        np.testing.assert_allclose(mesh.vertices[0, :3], [1, 2, 3], atol=1e-6)
        np.testing.assert_allclose(mesh.vertices[:, 3:6], [[0, 0, 1]] * 3,
                                   atol=1e-6)
        np.testing.assert_array_equal(mesh.indices, [0, 1, 2])
        mat = registry().get(AssetUrl(col.material_urls[0]), Material)
        assert mat.base_color_factor == (0.9, 0.1, 0.2, 1.0)

    def test_malformed_glb_named_errors(self, tmp_path):
        from zenith.asset.gltf_loader import GltfLoader

        bad_version = tmp_path / "v1.glb"
        bad_version.write_bytes(b"glTF" + b"\x01\x00\x00\x00" + b"\x00" * 32)
        with pytest.raises(ValueError, match="version"):
            GltfLoader.load(str(bad_version))

        truncated = tmp_path / "trunc.glb"
        truncated.write_bytes(b"glTF\x02\x00")
        with pytest.raises(ValueError, match="truncated"):
            GltfLoader.load(str(truncated))

        no_json = tmp_path / "nojson.glb"
        import struct
        no_json.write_bytes(struct.pack("<III", 0x46546C67, 2, 12))
        with pytest.raises(ValueError, match="JSON"):
            GltfLoader.load(str(no_json))
