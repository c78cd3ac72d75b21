"""Deferred decals (renderer.decal): G-buffer albedo rewrite before
lighting. The reference has no decal system; these tests pin this
build's semantics — unit-box clipping, texture/procedural blends, normal
fade, and dynamics-only animation (no recompile when a decal moves).
"""

import numpy as np
import pytest

from zenith.core.camera import Camera
from zenith.core.mathtypes import Degree, Radians
from zenith.rendergraph import RenderGraphBuilder
from zenith.rendergraph.graph import CompileOptions
from zenith.renderer import (
    Decal,
    DeferredRenderer,
    DirectionalLight,
    Scene,
    SceneObject,
)
from zenith.renderer.decal import stacked_decal_mats
from zenith.rhi import Format, PipelineCache, RhiCore, Texture, TextureDesc

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


def ground_scene(device, decals):
    ground = SceneObject.quad(
        device, "ground", size=200.0, z=0.0,
        base_color=(0.5, 0.5, 0.5, 1.0),
    )
    return Scene(
        objects=[ground],
        sun=DirectionalLight(direction=(0.05, -0.05, 1.0), intensity=2.0,
                             cast_shadows=False),
        ambient=(0.1, 0.1, 0.1),
        decals=decals,
    )


def render(device, scene):
    renderer = DeferredRenderer(scene, shadows=False)
    cam = make_camera()
    builder = RenderGraphBuilder()
    color = builder.create(TextureDesc.color("rt", W, H))
    renderer.render_to(builder, color, cam, W, H)
    builder.export(color)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    return np.asarray(compiled.value(color)), cam


def px_of(cam, world):
    clip = cam.render_view_projection @ np.array([*world, 1.0], np.float32)
    ndc = clip[:3] / clip[3]
    return int((ndc[1] + 1) * 0.5 * H), int((ndc[0] + 1) * 0.5 * W)


class TestWorldToDecal:
    def test_unit_box_mapping(self):
        d = Decal("d", position=(10.0, 5.0, 0.0), size=(4.0, 8.0, 2.0))
        m = d.world_to_decal()
        assert m.shape == (3, 4)

        def local(p):
            return m @ np.array([*p, 1.0], np.float32)

        np.testing.assert_allclose(local((10.0, 5.0, 0.0)), 0.0, atol=1e-6)
        # +2 world x = half the 4-wide box = +0.5 u (default frame:
        # right = up × forward = (1,0,0)).
        np.testing.assert_allclose(
            local((12.0, 5.0, 0.0)), [0.5, 0.0, 0.0], atol=1e-6
        )
        # forward (0,0,-1): +z world = -local w... depth extent 2 → -0.5.
        np.testing.assert_allclose(
            local((10.0, 5.0, 1.0)), [0.0, 0.0, -0.5], atol=1e-6
        )

    def test_degenerate_up_recovers(self):
        d = Decal("d", forward=(0.0, 1.0, 0.0), up=(0.0, 1.0, 0.0))
        m = d.world_to_decal()
        assert np.all(np.isfinite(m))


class TestDecalRendering:
    def test_solid_decal_tints_ground_inside_only(self, device):
        decal = Decal("mark", position=(0.0, 0.0, 0.0), size=(20.0, 20.0, 4.0),
                      color=(1.0, 0.0, 0.0, 1.0))
        img, cam = render(device, ground_scene(device, [decal]))
        iy, ix = px_of(cam, (0.0, 0.0, 0.0))       # decal center
        oy, ox = px_of(cam, (40.0, 0.0, 0.0))      # open ground
        c_in, c_out = img[iy, ix, :3], img[oy, ox, :3]
        # Inside: red dominates. Outside: untouched gray (r≈g≈b).
        assert c_in[0] > c_in[1] * 2.0, c_in
        np.testing.assert_allclose(c_out[0], c_out[1], rtol=0.05)

    def test_textured_decal_alpha_masks(self, device):
        # Left half opaque green, right half fully transparent.
        texels = np.zeros((8, 8, 4), np.float32)
        texels[:, :4] = (0.0, 1.0, 0.0, 1.0)
        tex = Texture.from_numpy("decal.tex", texels, Format.RGBA32F)
        decal = Decal("stripe", position=(0.0, 0.0, 0.0),
                      size=(40.0, 40.0, 4.0), texture=tex,
                      up=(0.0, 1.0, 0.0))
        img, cam = render(device, ground_scene(device, [decal]))
        # u < 0.5 (world x < 0): green. u > 0.5: gray ground.
        gy, gx = px_of(cam, (-10.0, 0.0, 0.0))
        ny, nx = px_of(cam, (10.0, 0.0, 0.0))
        assert img[gy, gx, 1] > img[gy, gx, 0] * 2.0, img[gy, gx]
        np.testing.assert_allclose(img[ny, nx, 0], img[ny, nx, 1], rtol=0.05)

    def test_normal_fade_rejects_perpendicular_surface(self, device):
        # A decal projecting along -x onto the ground (normal +z):
        # alignment = 0 → fully faded, ground untouched.
        decal = Decal("side", position=(0.0, 0.0, 0.0),
                      size=(30.0, 30.0, 30.0), forward=(-1.0, 0.0, 0.0),
                      up=(0.0, 0.0, 1.0), color=(1.0, 0.0, 0.0, 1.0))
        img, cam = render(device, ground_scene(device, [decal]))
        iy, ix = px_of(cam, (0.0, 0.0, 0.0))
        c = img[iy, ix, :3]
        np.testing.assert_allclose(c[0], c[1], rtol=0.05)

    def test_moving_decal_is_a_dynamic(self, device):
        """Moving a decal changes only dynamics: same frame program."""
        from zenith.rendergraph import graph as G

        decal = Decal("mark", position=(0.0, 0.0, 0.0),
                      size=(16.0, 16.0, 4.0), color=(0.0, 0.0, 1.0, 1.0))
        scene = ground_scene(device, [decal])
        renderer = DeferredRenderer(scene, shadows=False)
        cam = make_camera()
        cache = PipelineCache()

        def one_frame():
            builder = RenderGraphBuilder()
            color = builder.create(TextureDesc.color("rt", W, H))
            renderer.render_to(builder, color, cam, W, H)
            builder.export(color)
            compiled = builder.build().compile(device, cache, OPTS)
            compiled.execute(device)
            return np.asarray(compiled.value(color))

        img0 = one_frame()
        n_programs = len(G._FRAME_PROGRAM_CACHE)
        decal.position = (20.0, 0.0, 0.0)
        img1 = one_frame()
        assert len(G._FRAME_PROGRAM_CACHE) == n_programs, "decal move recompiled"
        # The blue mark moved with it.
        y0, x0 = px_of(cam, (0.0, 0.0, 0.0))
        y1, x1 = px_of(cam, (20.0, 0.0, 0.0))
        assert img0[y0, x0, 2] > img0[y0, x0, 0] * 1.5
        assert img1[y1, x1, 2] > img1[y1, x1, 0] * 1.5
        assert img1[y0, x0, 2] < img1[y0, x0, 0] * 1.5  # old spot clean

    def test_stacked_mats_shape(self):
        ds = [Decal("a"), Decal("b", position=(1, 2, 3))]
        assert stacked_decal_mats(ds).shape == (2, 3, 4)
