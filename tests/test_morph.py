"""Morph targets: weight sampling, the vertex-stage blend, asset round-trip,
glTF target parsing, and the deferred morph pipeline end-to-end."""

import base64
import json
import math

import numpy as np

from zenith.asset import AssetUrl
from zenith.asset.render_types import (
    AnimationChannel,
    AnimationClip,
    Mesh,
)
from zenith.renderer.animation import sample_morph_weights


class TestWeightSampling:
    def test_interpolates_and_loops(self):
        times = np.array([0.0, 1.0, 2.0], np.float32)
        values = np.array([[0, 0], [1, 0.5], [0, 0]], np.float32)
        clip = AnimationClip("pulse", [
            AnimationChannel(-1, "weights", times, values)
        ], 2.0)
        np.testing.assert_allclose(
            sample_morph_weights(clip, 0.5, 2), [0.5, 0.25]
        )
        np.testing.assert_allclose(
            sample_morph_weights(clip, 2.5, 2),
            sample_morph_weights(clip, 0.5, 2),
        )

    def test_no_weights_channel_is_zero(self):
        clip = AnimationClip("empty", [])
        np.testing.assert_array_equal(sample_morph_weights(clip, 1.0, 3),
                                      np.zeros(3, np.float32))


class TestMorphBlend:
    def test_matches_numpy_oracle(self, rng):
        import jax.numpy as jnp

        from zenith.renderer.deferred import _morphed_position

        n, t = 48, 3
        pos = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        deltas = rng.normal(size=(t, n, 3)).astype(np.float32)
        w = rng.uniform(0, 1, (t,)).astype(np.float32)
        got = _morphed_position(
            {"position": jnp.asarray(pos)},
            {"MorphWeights": jnp.asarray(w), "MorphDeltas": jnp.asarray(deltas)},
        )
        want = pos + np.einsum("t,tnc->nc", w, deltas)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


class TestRoundTrip:
    def test_morph_mesh_save_load(self, tmp_path):
        from zenith.sandbox.scene import morphing_blob

        mesh = morphing_blob(rings=6, sides=8)
        assert mesh.num_morph_targets == 2
        mesh.save(tmp_path / "b.mesh")
        back = Mesh.load(AssetUrl("procedural/blob"), tmp_path / "b.mesh")
        np.testing.assert_array_equal(back.morph_deltas, mesh.morph_deltas)
        assert len(back.clips) == 1
        ch = back.clips[0].channels[0]
        assert ch.path == "weights" and ch.values.shape[1] == 2


class TestGltfTargets:
    def test_bake_targets_and_weights_animation(self, tmp_path):
        import zenith.asset as asset_mod
        from zenith.asset import AssetManager, registry

        asset_mod.initialize()
        pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        idx = np.array([0, 1, 2], np.uint16)
        delta = np.array([[0, 0, 1], [0, 0, 2], [0, 0, 3]], np.float32)
        anim_t = np.array([0.0, 1.0], np.float32)
        anim_w = np.array([0.0, 1.0], np.float32)  # K*T flat (T=1)
        chunks = [pos.tobytes(), idx.tobytes(), delta.tobytes(),
                  anim_t.tobytes(), anim_w.tobytes()]
        offsets = []
        off = 0
        for chk in chunks:
            off = (off + 3) & ~3
            offsets.append(off)
            off += len(chk)
        blob = bytearray(off)
        for o, chk in zip(offsets, chunks):
            blob[o:o + len(chk)] = chk
        doc = {
            "asset": {"version": "2.0"},
            "scene": 0,
            "scenes": [{"nodes": [0]}],
            "nodes": [{"mesh": 0, "translation": [5, 0, 0]}],
            "meshes": [{"primitives": [{
                "attributes": {"POSITION": 0},
                "indices": 1,
                "targets": [{"POSITION": 2}],
            }]}],
            "animations": [{
                "name": "pulse",
                "samplers": [{"input": 3, "output": 4}],
                "channels": [{"sampler": 0,
                              "target": {"node": 0, "path": "weights"}}],
            }],
            "accessors": [
                {"bufferView": 0, "componentType": 5126, "count": 3,
                 "type": "VEC3"},
                {"bufferView": 1, "componentType": 5123, "count": 3,
                 "type": "SCALAR"},
                {"bufferView": 2, "componentType": 5126, "count": 3,
                 "type": "VEC3"},
                {"bufferView": 3, "componentType": 5126, "count": 2,
                 "type": "SCALAR"},
                {"bufferView": 4, "componentType": 5126, "count": 2,
                 "type": "SCALAR"},
            ],
            "bufferViews": [
                {"buffer": 0, "byteOffset": o, "byteLength": len(chk)}
                for o, chk in zip(offsets, chunks)
            ],
            "buffers": [{
                "byteLength": len(blob),
                "uri": "data:application/octet-stream;base64,"
                       + base64.b64encode(bytes(blob)).decode(),
            }],
        }
        content = tmp_path / "content" / "mo"
        content.mkdir(parents=True)
        (content / "mo.gltf").write_text(json.dumps(doc))
        mgr = AssetManager(root=tmp_path)
        col = mgr.request_load("mo/mo.gltf").get()
        mesh = registry().get(AssetUrl(col.mesh_urls[0]), Mesh)
        assert mesh.num_morph_targets == 1
        # Node translation baked into base verts; deltas are DIRECTIONS —
        # rotation applies (identity here), translation does not.
        np.testing.assert_allclose(mesh.vertices[0, :3], [5, 0, 0])
        np.testing.assert_allclose(mesh.morph_deltas[0], delta)
        assert len(mesh.clips) == 1
        ch = mesh.clips[0].channels[0]
        assert ch.path == "weights"
        np.testing.assert_allclose(ch.values, [[0.0], [1.0]])


class TestMorphPipeline:
    def _render(self, weights):
        from zenith.core.camera import Camera
        from zenith.core.mathtypes import Degree, Radians
        from zenith.renderer import DeferredRenderer, Scene, SceneObject
        from zenith.renderer.scene import DirectionalLight
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import Format, PipelineCache, RhiCore, TextureDesc
        from zenith.sandbox.scene import morphing_blob

        core = RhiCore()
        device = core.create_render_device()
        blob = morphing_blob(rings=10, sides=12)
        obj = SceneObject.from_mesh(device, blob, "blob",
                                    base_color=(0.8, 0.5, 0.3, 1.0))
        if weights is not None:
            obj.morph_weights = np.asarray(weights, np.float32)
        scene = Scene(objects=[obj],
                      sun=DirectionalLight(cast_shadows=True),
                      point_lights=[], ambient=(0.1, 0.1, 0.12))
        renderer = DeferredRenderer(scene)
        w, h = 128, 64
        camera = Camera(fov_y=Degree(35.0), aspect_ratio=w / h)
        camera.set_position(np.array([0.0, -60.0, 8.0], np.float32))
        camera.set_yaw_pitch(Radians(0.0), Radians(-0.1))
        builder = RenderGraphBuilder()
        out = builder.create(TextureDesc.color("out", w, h, Format.RGBA32F))
        builder.export(out)
        renderer.render_to(builder, out, camera, w, h)
        compiled = builder.build().compile(
            device, PipelineCache(), CompileOptions(tile_h=8)
        )
        compiled.execute(device)
        return (np.asarray(compiled.value(out)),
                (renderer, compiled, camera, device, obj, out))

    def test_zero_weights_then_deform_and_retained(self):
        base, _ = self._render(None)
        assert base[..., :3].std() > 0.01
        spike, (renderer, compiled, camera, device, obj, out) = self._render(
            [1.0, 0.0]
        )
        assert np.abs(spike - base).max() > 0.05
        # Retained re-execute with new weights: dynamic-only change.
        obj.morph_weights = np.asarray([0.0, 1.0], np.float32)
        compiled.execute(device, dynamics=renderer.frame_dynamics(camera))
        bulge = np.asarray(compiled.value(out))
        assert np.abs(bulge - spike).max() > 0.05
