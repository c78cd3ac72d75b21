"""Object picking via the deferred renderer's id plane.

DeferredRenderer(id_buffer=True) writes a 4th R32F G-buffer attachment
holding the 1-based scene-object index per pixel (background = 0). The
plane is exported; pick() maps a readback pixel to the SceneObject. The
reference has no picking — this is an engine-grade selection feature the
build adds on top of the per-draw-uniform machinery (no second
geometry pass).
"""

import numpy as np
import pytest

from zenith.core.camera import Camera
from zenith.core.mathtypes import Degree, Radians
from zenith.rendergraph import RenderGraphBuilder
from zenith.rendergraph.graph import CompileOptions
from zenith.renderer import (
    DeferredRenderer,
    DirectionalLight,
    Scene,
    SceneObject,
)
from zenith.rhi import PipelineCache, RhiCore, TextureDesc

from test_renderers import make_cube

W, H = 128, 64
OPTS = CompileOptions(tile_h=8, tile_w=128)


@pytest.fixture
def device():
    return RhiCore().create_render_device()


def make_camera():
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -60.0, 25.0], np.float32))
    cam.set_yaw_pitch(Radians(0.0), Radians(-0.25))
    return cam


def px_of(cam, world):
    clip = cam.render_view_projection @ np.array([*world, 1.0], np.float32)
    ndc = clip[:3] / clip[3]
    return int((ndc[1] + 1) * 0.5 * H), int((ndc[0] + 1) * 0.5 * W)


def run_with_ids(device, scene, **renderer_kw):
    renderer = DeferredRenderer(scene, shadows=False, id_buffer=True,
                                **renderer_kw)
    cam = make_camera()
    builder = RenderGraphBuilder()
    color = builder.create(TextureDesc.color("rt", W, H))
    renderer.render_to(builder, color, cam, W, H)
    builder.export(color)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    ids = np.asarray(compiled.value(renderer.id_resource))
    return renderer, cam, ids


class TestPicking:
    def test_ids_and_pick_roundtrip(self, device):
        cube = SceneObject.from_mesh(
            device, make_cube(size=14.0, z0=8.0), "cube",
            base_color=(0.8, 0.2, 0.2, 1.0), bin_capacity=64,
        )
        ground = SceneObject.quad(
            device, "ground", size=200.0, z=0.0,
            base_color=(0.4, 0.4, 0.4, 1.0),
        )
        scene = Scene(
            objects=[cube, ground],
            sun=DirectionalLight(direction=(0.05, -0.05, 1.0), intensity=1.0,
                                 cast_shadows=False),
            ambient=(0.05, 0.05, 0.05),
        )
        renderer, cam, ids = run_with_ids(device, scene)
        assert ids.shape[:2] == (H, W)

        cy, cx = px_of(cam, (0.0, 0.0, 15.0))   # on the floating cube
        gy, gx = px_of(cam, (40.0, 0.0, 0.0))   # open ground
        assert ids[cy, cx, 0] == 1.0, ids[cy, cx]
        assert ids[gy, gx, 0] == 2.0, ids[gy, gx]
        # Sky: top corner is above the ground plane horizon.
        assert ids[1, 1, 0] == 0.0

        assert renderer.pick(ids, cx, cy) is cube
        assert renderer.pick(ids, gx, gy) is ground
        assert renderer.pick(ids, 1, 1) is None

    def test_instanced_objects_share_their_id(self, device):
        inst = SceneObject.from_mesh(
            device, make_cube(size=8.0, z0=4.0), "posts",
            base_color=(0.2, 0.8, 0.2, 1.0), bin_capacity=64,
            instance_offsets=np.asarray(
                [[-20.0, 0.0, 0.0], [20.0, 0.0, 0.0]], np.float32
            ),
        )
        ground = SceneObject.quad(
            device, "ground", size=200.0, z=0.0,
            base_color=(0.4, 0.4, 0.4, 1.0),
        )
        scene = Scene(
            objects=[inst, ground],
            sun=DirectionalLight(direction=(0.05, -0.05, 1.0), intensity=1.0,
                                 cast_shadows=False),
        )
        renderer, cam, ids = run_with_ids(device, scene)
        for ix in (-20.0, 20.0):
            y, x = px_of(cam, (ix, 0.0, 8.0))
            assert ids[y, x, 0] == 1.0, (ix, ids[y, x])
            assert renderer.pick(ids, x, y) is inst

    def test_depth_resolves_occlusion(self, device):
        """Two overlapping cubes: the nearer one owns the shared pixels."""
        near = SceneObject.from_mesh(
            device, make_cube(size=10.0, z0=8.0), "near",
            base_color=(1, 0, 0, 1), bin_capacity=64,
        )
        far = SceneObject.from_mesh(
            device, make_cube(size=30.0, z0=5.0), "far",
            base_color=(0, 0, 1, 1), bin_capacity=64,
        )
        far.model_matrix = np.array(
            [[1, 0, 0, 0], [0, 1, 0, 40.0], [0, 0, 1, 0], [0, 0, 0, 1]],
            np.float32,
        )  # pushed back +y: behind 'near' from this camera
        scene = Scene(
            objects=[near, far],
            sun=DirectionalLight(direction=(0.05, -0.05, 1.0), intensity=1.0,
                                 cast_shadows=False),
        )
        renderer, cam, ids = run_with_ids(device, scene)
        y, x = px_of(cam, (0.0, 0.0, 12.0))  # center of the near cube
        assert renderer.pick(ids, x, y) is near

    def test_disabled_by_default(self, device):
        ground = SceneObject.quad(
            device, "ground", size=200.0, z=0.0,
            base_color=(0.4, 0.4, 0.4, 1.0),
        )
        scene = Scene(objects=[ground], sun=None)
        renderer = DeferredRenderer(scene, shadows=False)
        assert renderer.id_resource is None
        with pytest.raises(AssertionError):
            renderer.pick(np.zeros((H, W, 1)), 0, 0)
