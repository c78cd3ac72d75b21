"""Screen-space contact shadows (ops.contact): the march math on
hand-built G-buffer planes, the deferred integration, and SPMD routing."""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from zenith.ops.contact import contact_shadow_factor


def _flat_ground_planes(h=32, w=64):
    """An analytic G-buffer: camera above a ground plane at z=0 looking
    +y/down; positions fan out so screen rows map to increasing ground
    distance. Returns (world_pos, depth, cam_pos, view_proj)."""
    from zenith.core.camera import Camera
    from zenith.core.mathtypes import Degree, Radians

    cam = Camera(fov_y=Degree(45.0), aspect_ratio=w / h)
    cam.set_position(np.array([0.0, -30.0, 12.0], np.float32))
    cam.set_yaw_pitch(Radians(0.0), Radians(-0.35))
    vp = np.asarray(cam.render_view_projection, np.float32)
    inv_vp = np.asarray(cam.render_inv_view_projection, np.float64)
    # Ray-cast every pixel against z=0.
    ys = (np.arange(h) + 0.5) / h * 2 - 1
    xs = (np.arange(w) + 0.5) / w * 2 - 1
    px, py = np.meshgrid(xs, ys)
    ndc = np.stack([px, py, np.full_like(px, 0.5), np.ones_like(px)], -1)
    p = ndc @ inv_vp.T
    dirs = p[..., :3] / p[..., 3:4] - cam.location
    t = -cam.location[2] / dirs[..., 2]
    hit = (t > 0) & (dirs[..., 2] < 0)
    world = cam.location + dirs * t[..., None]
    world = np.where(hit[..., None], world, 0.0).astype(np.float32)
    clip = np.concatenate([world, np.ones_like(world[..., :1])], -1) @ vp.T
    depth = np.where(hit, clip[..., 2] / np.maximum(clip[..., 3], 1e-6),
                     0.0).astype(np.float32)
    return world, depth, np.asarray(cam.location, np.float32), vp


class TestMarch:
    def test_open_ground_is_fully_lit(self):
        """No occluder anywhere: the march must not self-shadow."""
        world, depth, cam, vp = _flat_ground_planes()
        vis = np.asarray(contact_shadow_factor(
            jnp.asarray(world), jnp.asarray(depth),
            jnp.asarray(world), jnp.asarray(depth),
            jnp.asarray([0.3, -0.3, 0.9], jnp.float32) / np.sqrt(0.99),
            jnp.asarray(cam), jnp.asarray(vp),
            strength=1.0, max_dist=3.0, thickness=1.0, steps=8,
        ))
        np.testing.assert_allclose(vis, 1.0)

    def test_raised_strip_occludes_upwind_pixels(self):
        """Deterministic orthographic setup: pixels ARE the z=0 plane
        (identity-style projection, camera 10 above), and the tap plane
        has a strip of columns raised 0.5 toward the camera. Marching
        toward a sun lying along +x, pixels just left of the strip tap
        into it (gap ≈ 0.48 < thickness) and go dark; pixels out of range
        or downwind stay lit."""
        h, w = 32, 64
        xs = (np.arange(w) + 0.5) / w * 2 - 1
        ys = (np.arange(h) + 0.5) / h * 2 - 1
        px, py = np.meshgrid(xs, ys)
        world = np.stack([px, py, np.zeros_like(px)], -1).astype(np.float32)
        depth = np.full((h, w), 0.5, np.float32)
        cam = np.array([0.0, 0.0, 10.0], np.float32)
        vp = np.eye(4, dtype=np.float32)  # ndc = world xy, w = 1
        tap = world.copy()
        c0, c1 = 40, 48
        tap[:, c0:c1, 2] = 0.5  # strip raised toward the camera
        vis = np.asarray(contact_shadow_factor(
            jnp.asarray(world), jnp.asarray(depth),
            jnp.asarray(tap), jnp.asarray(depth),
            jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
            jnp.asarray(cam), jnp.asarray(vp),
            strength=1.0, max_dist=0.3, thickness=1.0, steps=8,
        ))
        px_w = 2.0 / w  # world units per pixel column
        reach = int(0.3 / px_w)  # columns the march can cover
        # Just-left-of-strip pixels are occluded...
        assert vis[:, c0 - reach + 2:c0].max() < 0.5
        # ... far-left pixels (outside the march range) are lit ...
        assert vis[:, :c0 - reach - 2].min() > 0.99
        # ... and pixels right of the strip (marching away from it) too.
        assert vis[:, c1 + 1:].min() > 0.99

    def test_strength_bounds_the_darkening(self):
        world, depth, cam, vp = _flat_ground_planes()
        vis = np.asarray(contact_shadow_factor(
            jnp.asarray(world), jnp.asarray(depth),
            jnp.asarray(world), jnp.asarray(depth),
            jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
            jnp.asarray(cam), jnp.asarray(vp),
            strength=0.6, max_dist=3.0, thickness=1.0, steps=4,
        ))
        assert vis.min() >= 0.4 - 1e-6


class TestSceneContact:
    def _render(self, contact, options=None):
        from dataclasses import replace

        from zenith.core.camera import Camera
        from zenith.core.mathtypes import Degree, Radians
        from zenith.renderer import DeferredRenderer
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import Format, PipelineCache, RhiCore, TextureDesc
        from zenith.sandbox.scene import build_scene
        from zenith import asset

        asset.initialize()
        core = RhiCore()
        device = core.create_render_device()
        scene = build_scene(device, 0, np.random.default_rng(3), skybox=False)
        if contact:
            scene.sun = replace(scene.sun, contact_shadows=True,
                                contact_distance=6.0, contact_steps=8)
        renderer = DeferredRenderer(scene)
        w, h = 256, 128
        camera = Camera(fov_y=Degree(35.0), aspect_ratio=w / h)
        camera.set_position(np.array([0.0, -170.0, 25.0], np.float32))
        camera.set_yaw_pitch(Radians(0.0), Radians(-math.atan2(20.0, 170.0)))
        builder = RenderGraphBuilder()
        out = builder.create(TextureDesc.color("out", w, h, Format.RGBA32F))
        builder.export(out)
        renderer.render_to(builder, out, camera, w, h)
        compiled = builder.build().compile(
            device, PipelineCache(),
            options or CompileOptions(tile_h=8)
        )
        compiled.execute(device)
        return np.asarray(compiled.value(out))

    def test_contact_only_darkens(self):
        base = self._render(False)
        contact = self._render(True)
        assert np.isfinite(contact).all()
        diff = contact[..., :3] - base[..., :3]
        assert diff.max() <= 1e-5  # never brightens
        assert (diff < -0.01).sum() > 20  # real contact darkening
        # And it's localized, not a global dimming.
        assert (np.abs(diff) < 1e-5).mean() > 0.5

    def test_spmd_contact_delta_matches_single_device(self, cpu_devices):
        """The full-scene raster has a known tiny band-edge divergence
        under SPMD (pre-existing, feature-independent), so compare the
        contact-shadow DELTA: (on - off) must match across mesh sizes —
        the march's global-row dither and gathered-full tap planes make
        the feature itself band-invariant."""
        from zenith.parallel.sharding import default_mesh
        from zenith.rendergraph import CompileOptions

        delta1 = self._render(True) - self._render(False)
        mesh = default_mesh(8, backend="cpu")
        opt = CompileOptions(tile_h=8, mesh=mesh)
        delta8 = self._render(True, opt) - self._render(False, opt)
        assert np.abs(delta1).max() > 0.01  # the feature did something
        np.testing.assert_allclose(delta8, delta1, atol=1e-4)
