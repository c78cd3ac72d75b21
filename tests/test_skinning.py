"""Skeletal skinning: animation sampling, device LBS vs NumPy oracle,
asset round-trip, and the deferred skinned pipeline end-to-end."""

import numpy as np

from zenith.asset import AssetUrl
from zenith.asset.render_types import (
    AnimationChannel,
    AnimationClip,
    Mesh,
    Skin,
)
from zenith.renderer.animation import AnimationPlayer


def _two_bone_skin(seg=2.0):
    inv_bind = np.stack([np.eye(4, dtype=np.float32)] * 2)
    inv_bind[1, 2, 3] = -seg  # joint 1 binds at (0,0,seg)
    rest_t = np.array([[0, 0, 0], [0, 0, seg]], np.float32)
    rest_r = np.tile(np.array([0, 0, 0, 1], np.float32), (2, 1))
    rest_s = np.ones((2, 3), np.float32)
    return Skin(inv_bind, np.array([-1, 0], np.int32),
                rest_t, rest_r, rest_s)


def _rot_x_quat(angle):
    return np.array(
        [np.sin(angle / 2), 0.0, 0.0, np.cos(angle / 2)], np.float32
    )


class TestAnimationPlayer:
    def test_bind_pose_is_identity_palette(self):
        skin = _two_bone_skin()
        clip = AnimationClip("idle", [])
        pal = AnimationPlayer(skin, clip).joint_matrices(0.0)
        assert pal.shape == (2, 4, 4)
        np.testing.assert_allclose(pal, np.stack([np.eye(4)] * 2), atol=1e-6)

    def test_rotation_channel_and_hierarchy(self):
        """90° X rotation on joint 1: a point at the tip (0,0,2·seg) swings
        to (0,-seg... ) — verify against the hand-composed transform."""
        seg = 2.0
        skin = _two_bone_skin(seg)
        times = np.array([0.0, 1.0], np.float32)
        quats = np.stack([_rot_x_quat(0.0), _rot_x_quat(np.pi / 2)])
        clip = AnimationClip(
            "bend", [AnimationChannel(1, "rotation", times, quats)]
        )
        player = AnimationPlayer(skin, clip, loop=False)
        pal = player.joint_matrices(1.0)
        # Joint 0 untouched.
        np.testing.assert_allclose(pal[0], np.eye(4), atol=1e-6)
        # Tip point fully bound to joint 1: world = T(0,0,seg)·Rx(90°)·
        # invbind·p. p=(0,0,2s): invbind→(0,0,s); Rx90: (0,-s,0)... y'=-z.
        p = np.array([0.0, 0.0, 2 * seg, 1.0], np.float32)
        out = pal[1] @ p
        np.testing.assert_allclose(
            out[:3], [0.0, -seg, seg], atol=1e-5
        )

    def test_keyframe_interpolation_midpoint(self):
        skin = _two_bone_skin()
        times = np.array([0.0, 1.0], np.float32)
        tr = np.array([[0, 0, 0], [4.0, 0, 0]], np.float32)
        clip = AnimationClip(
            "slide", [AnimationChannel(0, "translation", times, tr)]
        )
        pal = AnimationPlayer(skin, clip, loop=False).joint_matrices(0.5)
        np.testing.assert_allclose(pal[0][:3, 3], [2.0, 0, 0], atol=1e-6)
        # nlerp at the midpoint of a 0→90° X rotation is exactly 45°.
        quats = np.stack([_rot_x_quat(0.0), _rot_x_quat(np.pi / 2)])
        clip = AnimationClip(
            "bend", [AnimationChannel(0, "rotation", times, quats)]
        )
        pal = AnimationPlayer(skin, clip, loop=False).joint_matrices(0.5)
        c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
        np.testing.assert_allclose(
            pal[0][:3, :3],
            [[1, 0, 0], [0, c, -s], [0, s, c]], atol=1e-5,
        )

    def test_looping(self):
        skin = _two_bone_skin()
        times = np.array([0.0, 2.0], np.float32)
        tr = np.array([[0, 0, 0], [4.0, 0, 0]], np.float32)
        clip = AnimationClip(
            "slide", [AnimationChannel(0, "translation", times, tr)]
        )
        player = AnimationPlayer(skin, clip, loop=True)
        np.testing.assert_allclose(
            player.joint_matrices(2.5)[0][:3, 3],
            player.joint_matrices(0.5)[0][:3, 3], atol=1e-6,
        )


class TestDeviceLBS:
    def test_skin_blend_matches_numpy_oracle(self, rng):
        import jax.numpy as jnp

        from zenith.renderer.deferred import _skin_blend

        n, j = 64, 6
        pos = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        jidx = rng.integers(0, j, size=(n, 4)).astype(np.float32)
        w = rng.uniform(0.01, 1.0, size=(n, 4)).astype(np.float32)
        w /= w.sum(axis=1, keepdims=True)
        mats = rng.normal(size=(j, 4, 4)).astype(np.float32)

        got_p, got_n = _skin_blend(
            {
                "position": jnp.asarray(pos),
                "normal": jnp.asarray(nrm),
                "joints": jnp.asarray(jidx),
                "weights": jnp.asarray(w),
            },
            {"Joints": jnp.asarray(mats)},
        )
        hom = np.concatenate([pos, np.ones((n, 1), np.float32)], axis=1)
        want_p = np.zeros((n, 4), np.float64)
        want_n = np.zeros((n, 3), np.float64)
        for k in range(4):
            mk = mats[jidx[:, k].astype(int)]
            want_p += w[:, k:k + 1] * np.einsum("nij,nj->ni", mk, hom)
            want_n += w[:, k:k + 1] * np.einsum(
                "nij,nj->ni", mk[:, :3, :3], nrm
            )
        np.testing.assert_allclose(np.asarray(got_p), want_p, atol=1e-4)
        np.testing.assert_allclose(np.asarray(got_n), want_n, atol=1e-4)


class TestAssetRoundTrip:
    def test_mesh_skin_save_load(self, tmp_path):
        from zenith.sandbox.scene import skinned_tube

        mesh = skinned_tube(bones=3, rings=4, sides=6)
        assert mesh.is_skinned
        path = tmp_path / "tube.mesh"
        mesh.save(path)
        back = Mesh.load(AssetUrl("procedural/tentacle"), path)
        assert back.is_skinned
        np.testing.assert_array_equal(back.vertices, mesh.vertices)
        np.testing.assert_array_equal(back.skin_vertex_data,
                                      mesh.skin_vertex_data)
        np.testing.assert_array_equal(back.skin.inverse_bind,
                                      mesh.skin.inverse_bind)
        np.testing.assert_array_equal(back.skin.parents, mesh.skin.parents)
        assert len(back.clips) == 1
        assert back.clips[0].name == "wave"
        assert back.clips[0].duration == mesh.clips[0].duration
        assert len(back.clips[0].channels) == len(mesh.clips[0].channels)
        np.testing.assert_array_equal(
            back.clips[0].channels[0].values,
            mesh.clips[0].channels[0].values,
        )


class TestSkinnedPipeline:
    def _render(self, *, animate, skinned=True):
        import math

        from zenith.core.camera import Camera
        from zenith.core.mathtypes import Degree, Radians
        from zenith.renderer import DeferredRenderer, Scene, SceneObject
        from zenith.renderer.scene import DirectionalLight
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import Format, PipelineCache, RhiCore, TextureDesc
        from zenith.sandbox.scene import skinned_tube

        core = RhiCore()
        device = core.create_render_device()
        tube = skinned_tube(bones=4, rings=12, sides=10)
        if skinned:
            obj = SceneObject.from_mesh(device, tube, "tube",
                                        base_color=(0.3, 0.8, 0.4, 1.0))
        else:
            # Same geometry drawn through the PLAIN pipeline.
            plain = Mesh(AssetUrl("plain/tube"), tube.vertices, tube.indices)
            obj = SceneObject.from_mesh(device, plain, "tube",
                                        base_color=(0.3, 0.8, 0.4, 1.0))
        scene = Scene(objects=[obj],
                      sun=DirectionalLight(cast_shadows=True),
                      point_lights=[], ambient=(0.1, 0.1, 0.12))
        renderer = DeferredRenderer(scene)
        w, h = 128, 64
        camera = Camera(fov_y=Degree(35.0), aspect_ratio=w / h)
        camera.set_position(np.array([0.0, -120.0, 25.0], np.float32))
        camera.set_yaw_pitch(Radians(0.0), Radians(-0.1))
        if animate:
            player = AnimationPlayer(obj.skin, obj.clips[0])
            obj.joint_matrices = player.joint_matrices(0.6)
        builder = RenderGraphBuilder()
        out = builder.create(TextureDesc.color("out", w, h, Format.RGBA32F))
        builder.export(out)
        renderer.render_to(builder, out, camera, w, h)
        compiled = builder.build().compile(
            device, PipelineCache(), CompileOptions(tile_h=8)
        )
        compiled.execute(device)
        img = np.asarray(compiled.value(out))
        return img, (renderer, compiled, camera, device, obj, out)

    def test_bind_pose_matches_plain_pipeline(self):
        """Identity palette = bind pose: the skinned draw must produce the
        SAME image as the plain (unskinned) pipeline on the same mesh."""
        img_s, _ = self._render(animate=False, skinned=True)
        img_p, _ = self._render(animate=False, skinned=False)
        np.testing.assert_allclose(img_s, img_p, atol=1e-5)
        assert img_s[..., :3].std() > 0.01  # tube is on screen

    def test_animation_deforms_and_retained_matches(self):
        img0, _ = self._render(animate=False)
        img1, (renderer, compiled, camera, device, obj, out) = self._render(
            animate=True
        )
        # The pose change moved pixels.
        assert np.abs(img1 - img0).max() > 0.05
        # Retained re-execute with a NEW pose: accepts the palette dynamic
        # and changes the image (animation without recompiles).
        player = AnimationPlayer(obj.skin, obj.clips[0])
        obj.joint_matrices = player.joint_matrices(1.4)
        compiled.execute(device, dynamics=renderer.frame_dynamics(camera))
        img2 = np.asarray(compiled.value(out))
        assert np.abs(img2 - img1).max() > 0.01

class TestGltfSkin:
    def _make_skinned_gltf(self, path):
        """Minimal skinned glTF: a 2-triangle quad, bottom verts bound to
        joint 0 (node 1), top verts to joint 1 (node 2 at z=1), plus a
        rotation animation on joint 1 (identity → 90° about X at t=1)."""
        import base64
        import json

        pos = np.array([
            [-0.5, 0, 0], [0.5, 0, 0], [-0.5, 0, 1], [0.5, 0, 1],
        ], np.float32)
        idx = np.array([0, 1, 2, 1, 3, 2], np.uint16)
        joints = np.array([[0, 0, 0, 0]] * 2 + [[1, 0, 0, 0]] * 2, np.uint8)
        weights = np.array([[1, 0, 0, 0]] * 4, np.float32)
        # Column-major MAT4s: identity and translation z=-1.
        ib0 = np.eye(4, dtype=np.float32)
        ib1 = np.eye(4, dtype=np.float32)
        ib1[2, 3] = -1.0
        inv = np.stack([ib0.T.reshape(-1), ib1.T.reshape(-1)])
        anim_t = np.array([0.0, 1.0], np.float32)
        s, c = np.sin(np.pi / 4), np.cos(np.pi / 4)
        anim_q = np.array([[0, 0, 0, 1], [s, 0, 0, c]], np.float32)

        chunks = [pos.tobytes(), idx.tobytes(), joints.tobytes(),
                  weights.tobytes(), inv.astype(np.float32).tobytes(),
                  anim_t.tobytes(), anim_q.tobytes()]
        offsets = []
        off = 0
        for chk in chunks:
            off = (off + 3) & ~3
            offsets.append(off)
            off += len(chk)
        blob = bytearray(off)
        for o, chk in zip(offsets, chunks):
            blob[o:o + len(chk)] = chk
        blob = bytes(blob)
        doc = {
            "asset": {"version": "2.0"},
            "scene": 0,
            "scenes": [{"nodes": [0, 1]}],
            "nodes": [
                {"mesh": 0, "skin": 0},
                {"children": [2]},
                {"translation": [0, 0, 1]},
            ],
            "skins": [{"joints": [1, 2], "inverseBindMatrices": 4}],
            "meshes": [{"primitives": [{
                "attributes": {"POSITION": 0, "JOINTS_0": 2, "WEIGHTS_0": 3},
                "indices": 1,
            }]}],
            "animations": [{
                "name": "bend",
                "samplers": [{"input": 5, "output": 6,
                              "interpolation": "LINEAR"}],
                "channels": [{"sampler": 0,
                              "target": {"node": 2, "path": "rotation"}}],
            }],
            "accessors": [
                {"bufferView": 0, "componentType": 5126, "count": 4,
                 "type": "VEC3"},
                {"bufferView": 1, "componentType": 5123, "count": 6,
                 "type": "SCALAR"},
                {"bufferView": 2, "componentType": 5121, "count": 4,
                 "type": "VEC4"},
                {"bufferView": 3, "componentType": 5126, "count": 4,
                 "type": "VEC4"},
                {"bufferView": 4, "componentType": 5126, "count": 2,
                 "type": "MAT4"},
                {"bufferView": 5, "componentType": 5126, "count": 2,
                 "type": "SCALAR"},
                {"bufferView": 6, "componentType": 5126, "count": 2,
                 "type": "VEC4"},
            ],
            "bufferViews": [
                {"buffer": 0, "byteOffset": o, "byteLength": len(chk)}
                for o, chk in zip(offsets, chunks)
            ],
            "buffers": [{
                "byteLength": len(blob),
                "uri": "data:application/octet-stream;base64,"
                       + base64.b64encode(blob).decode(),
            }],
        }
        path.write_text(json.dumps(doc))

    def test_bake_skin_and_animation(self, tmp_path):
        import zenith.asset as asset_mod
        from zenith.asset import AssetManager, registry

        asset_mod.initialize()
        content = tmp_path / "content" / "sk"
        content.mkdir(parents=True)
        self._make_skinned_gltf(content / "sk.gltf")
        mgr = AssetManager(root=tmp_path)
        col = mgr.request_load("sk/sk.gltf").get()
        mesh = registry().get(AssetUrl(col.mesh_urls[0]), Mesh)
        assert mesh.is_skinned
        assert mesh.skin.num_joints == 2
        np.testing.assert_array_equal(mesh.skin.parents, [-1, 0])
        np.testing.assert_allclose(mesh.skin.rest_t[1], [0, 0, 1])
        # Row-major inverse binds recovered from the column-major file.
        np.testing.assert_allclose(mesh.skin.inverse_bind[1][2, 3], -1.0)
        # Node transform NOT baked into skinned positions (bind space).
        np.testing.assert_allclose(mesh.vertices[0, :3], [-0.5, 0, 0])
        # Weights: bottom verts joint 0, top verts joint 1.
        np.testing.assert_allclose(mesh.skin_vertex_data[0, 0], 0.0)
        np.testing.assert_allclose(mesh.skin_vertex_data[2, 0], 1.0)
        np.testing.assert_allclose(mesh.skin_vertex_data[:, 4], 1.0)
        assert len(mesh.clips) == 1 and mesh.clips[0].name == "bend"

        # The baked clip animates exactly as authored: at t=1 the top verts
        # (bound to joint 1 at rest (0,0,1)) swing 90° about X → (x,-? ...).
        player = AnimationPlayer(mesh.skin, mesh.clips[0], loop=False)
        pal = player.joint_matrices(1.0)
        p = np.array([-0.5, 0.0, 1.0, 1.0], np.float32)
        out = pal[1] @ p
        # invbind → (x,0,0); Rx90 → (x,0,0); +T(0,0,1) → (x,0,1)... the
        # bind point lies ON the joint: unchanged. Take the far corner
        # instead: a point at z=2 would map to (x,-1,1).
        np.testing.assert_allclose(out[:3], [-0.5, 0, 1], atol=1e-5)
        out2 = pal[1] @ np.array([-0.5, 0.0, 2.0, 1.0], np.float32)
        np.testing.assert_allclose(out2[:3], [-0.5, -1, 1], atol=1e-5)


class TestArmatureTransforms:
    def test_transformed_non_joint_ancestor_preserved(self, tmp_path):
        """The classic exporter shape: a transformed non-joint 'Armature'
        node above the root joint. Its transform is in the inverse binds,
        so the joint hierarchy must include it (Skin.pre) — at bind pose
        the palette must be identity."""
        import base64
        import json

        import zenith.asset as asset_mod
        from zenith.asset import AssetManager, registry

        asset_mod.initialize()
        pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        idx = np.array([0, 1, 2], np.uint16)
        joints = np.zeros((3, 4), np.uint8)
        weights = np.tile(np.array([1, 0, 0, 0], np.float32), (3, 1))
        # Armature at (10, 0, 0); joint at local (0, 0, 2) → world (10,0,2).
        ib = np.eye(4, dtype=np.float32)
        ib[0, 3] = -10.0
        ib[2, 3] = -2.0
        inv = ib.T.reshape(1, -1)  # column-major in the file
        chunks = [pos.tobytes(), idx.tobytes(), joints.tobytes(),
                  weights.tobytes(), inv.tobytes()]
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
            "scenes": [{"nodes": [0, 1]}],
            "nodes": [
                {"mesh": 0, "skin": 0},
                {"name": "Armature", "translation": [10, 0, 0],
                 "children": [2]},
                {"translation": [0, 0, 2]},  # the (only) joint
            ],
            "skins": [{"joints": [2], "inverseBindMatrices": 4}],
            "meshes": [{"primitives": [{
                "attributes": {"POSITION": 0, "JOINTS_0": 2, "WEIGHTS_0": 3},
                "indices": 1,
            }]}],
            "accessors": [
                {"bufferView": 0, "componentType": 5126, "count": 3,
                 "type": "VEC3"},
                {"bufferView": 1, "componentType": 5123, "count": 3,
                 "type": "SCALAR"},
                {"bufferView": 2, "componentType": 5121, "count": 3,
                 "type": "VEC4"},
                {"bufferView": 3, "componentType": 5126, "count": 3,
                 "type": "VEC4"},
                {"bufferView": 4, "componentType": 5126, "count": 1,
                 "type": "MAT4"},
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
        content = tmp_path / "content" / "arm"
        content.mkdir(parents=True)
        (content / "arm.gltf").write_text(json.dumps(doc))
        mgr = AssetManager(root=tmp_path)
        col = mgr.request_load("arm/arm.gltf").get()
        mesh = registry().get(AssetUrl(col.mesh_urls[0]), Mesh)
        # The pre-matrix carries the Armature translation...
        np.testing.assert_allclose(mesh.skin.pre[0][:3, 3], [10, 0, 0])
        # ... so the bind pose reproduces the identity palette exactly.
        pal = AnimationPlayer(mesh.skin, AnimationClip("idle", []),
                              loop=False).joint_matrices(0.0)
        np.testing.assert_allclose(pal[0], np.eye(4), atol=1e-5)

    def test_step_interpolation_holds_pose(self):
        skin = _two_bone_skin()
        times = np.array([0.0, 1.0], np.float32)
        tr = np.array([[0, 0, 0], [4.0, 0, 0]], np.float32)
        clip = AnimationClip("snap", [
            AnimationChannel(0, "translation", times, tr,
                             interpolation="STEP")
        ])
        pal = AnimationPlayer(skin, clip, loop=False).joint_matrices(0.5)
        # STEP: hold the previous key, no glide.
        np.testing.assert_allclose(pal[0][:3, 3], [0, 0, 0], atol=1e-6)
        pal = AnimationPlayer(skin, clip, loop=False).joint_matrices(1.0)
        np.testing.assert_allclose(pal[0][:3, 3], [4.0, 0, 0], atol=1e-6)
