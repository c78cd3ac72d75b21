"""Static scene batching (renderer/static_batch.py): plain opaque draws
ride ONE concatenated vertex/index buffer pair, making the rebuild path's
per-frame host cost O(1) in object count. The batched output must equal
the per-object path exactly (same draws, same order, unrebased indices)."""

import math

import numpy as np
import pytest

from test_renderers import (
    H,
    OPTS,
    W,
    build_test_scene,
    device,  # noqa: F401  (fixture)
    make_camera,
    make_cube,
    run_graph,
)
from zenith.renderer import (
    DeferredRenderer,
    DirectionalLight,
    ForwardShadowRenderer,
    Scene,
    SceneObject,
)
from zenith.renderer.static_batch import StaticGeometryCache
from zenith.rhi import Format, TextureDesc


class _NoStatic:
    def get(self, *a, **k):
        return None


def _disable_static(renderer):
    renderer._static_cache = _NoStatic()
    return renderer


def _render_deferred(device, renderer):
    cam = make_camera()

    def build(builder):
        out = builder.create(TextureDesc.color("out", W, H))
        renderer.render_to(builder, out, cam, W, H)
        return out

    return run_graph(device, build)


def _render_forward(device, renderer):
    cam = make_camera()

    def build(builder):
        out = builder.create(TextureDesc.color("out", W, H))
        depth = builder.create(TextureDesc.depth("depth", W, H))
        renderer.render_to(builder, out, depth, cam)
        return out

    return run_graph(device, build)


class TestStaticGeometryCache:
    def test_ranges_and_concat(self, device):
        scene = build_test_scene(device)
        cache = StaticGeometryCache()
        geo = cache.get(scene.objects, [0, 1])
        assert geo is not None
        (v0, vc0, i0, ic0), (v1, vc1, i1, ic1) = geo.ranges
        assert (v0, i0) == (0, 0)
        assert v1 == vc0 and i1 == ic0
        assert geo.vb.desc.shape[0] == vc0 + vc1
        assert geo.ib.desc.shape[0] == ic0 + ic1
        # Slices reproduce the originals exactly (indices unrebased).
        np.testing.assert_array_equal(
            np.asarray(geo.vb.array[v1:v1 + vc1]),
            np.asarray(scene.objects[1].vertex_buffer.array),
        )
        np.testing.assert_array_equal(
            np.asarray(geo.ib.array[i1:i1 + ic1]),
            np.asarray(scene.objects[1].index_buffer.array),
        )

    def test_single_draw_skips_batching(self, device):
        scene = build_test_scene(device)
        assert StaticGeometryCache().get(scene.objects, [0]) is None

    def test_memo_and_identity_invalidation(self, device):
        scene = build_test_scene(device)
        cache = StaticGeometryCache()
        geo1 = cache.get(scene.objects, [0, 1])
        assert cache.get(scene.objects, [0, 1]) is geo1  # memo hit
        # Swapping a buffer identity (hot-reload analog) rebuilds.
        obj = scene.objects[0]
        obj.vertex_buffer = obj.vertex_buffer.with_array(
            obj.vertex_buffer.array
        )
        geo2 = cache.get(scene.objects, [0, 1])
        assert geo2 is not geo1

    def test_mixed_stride_falls_back(self, device):
        from zenith.rhi.resource import Buffer, BufferDesc, BufferUsage

        scene = build_test_scene(device)
        odd = SceneObject(
            name="odd",
            vertex_buffer=Buffer(
                BufferDesc("odd.vb", (3, 4), "float32", BufferUsage.VERTEX)
            ),
            index_buffer=Buffer(
                BufferDesc("odd.ib", (3,), "int32", BufferUsage.INDEX)
            ),
            model_matrix=np.eye(4, dtype=np.float32),
        )
        objects = scene.objects + [odd]
        assert StaticGeometryCache().get(objects, [0, 1, 2]) is None


class TestBatchedEqualsPerObject:
    def test_deferred_scene_identical(self, device):
        scene = build_test_scene(device, num_lights=4)
        batched = _render_deferred(device, DeferredRenderer(scene))
        per_obj = _render_deferred(
            device, _disable_static(DeferredRenderer(scene))
        )
        np.testing.assert_allclose(batched, per_obj, atol=1e-6)

    def test_forward_scene_identical(self, device):
        scene = build_test_scene(device)
        batched = _render_forward(device, ForwardShadowRenderer(scene))
        per_obj = _render_forward(
            device, _disable_static(ForwardShadowRenderer(scene))
        )
        np.testing.assert_allclose(batched, per_obj, atol=1e-6)

    def test_many_objects_identical(self, device):
        """A ring of cubes + ground: every record slices a distinct range of
        the mega buffers and lands in its own spot."""
        objs = []
        for k in range(6):
            a = 2 * math.pi * k / 6
            cube = SceneObject.from_mesh(
                device, make_cube(size=8.0, z0=6.0), f"cube{k}",
                base_color=(0.3 + 0.1 * k, 0.9 - 0.1 * k, 0.3, 1.0),
                bin_capacity=64,
            )
            cube.model_matrix = np.asarray(
                [[1, 0, 0, 24 * math.cos(a)],
                 [0, 1, 0, 24 * math.sin(a)],
                 [0, 0, 1, 0],
                 [0, 0, 0, 1]], np.float32,
            )
            objs.append(cube)
        objs.append(SceneObject.quad(
            device, "ground", size=200.0, z=0.0,
            base_color=(0.4, 0.4, 0.4, 1.0), roughness=0.9,
        ))
        scene = Scene(
            objects=objs,
            sun=DirectionalLight(direction=(0.05, -0.05, 1.0),
                                 shadow_map_size=128, shadow_extent=60.0),
        )
        batched = _render_deferred(device, DeferredRenderer(scene))
        per_obj = _render_deferred(
            device, _disable_static(DeferredRenderer(scene))
        )
        np.testing.assert_allclose(batched, per_obj, atol=1e-6)
        # The batch actually engaged (cache holds a 7-draw table).
        r = DeferredRenderer(scene)
        geo = r._static_cache.get(scene.objects, list(range(7)))
        assert geo is not None and len(geo.ranges) == 7
