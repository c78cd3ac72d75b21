"""Image-based lighting (ops.ibl + renderer.environment).

Math checked against closed forms (constant environments, solid-angle
totals, SH round trips) plus a semantic end-to-end: a deferred scene lit
only by the environment picks up its color, and the background defaults to
the environment cube.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from zenith.ops.ibl import (
    cube_face_directions,
    cube_texel_solid_angles,
    env_brdf_approx,
    eval_irradiance_sh9,
    irradiance_sh9,
    irradiance_sh9_host,
    prefilter_ggx,
)
from zenith.ops.sampling import (
    SamplerConfig,
    cube_direction_to_face_uv,
    sample_cube,
    sample_cube_lod,
)


def constant_cube(size, value, chans=4):
    c = np.zeros((6, size, size, chans), np.float32)
    c[..., :3] = value
    c[..., 3:] = 1.0
    return c


class TestCubeGeometry:
    def test_face_directions_round_trip(self):
        """cube_face_directions is the exact inverse of the sampler's
        direction→(face, uv) mapping at texel centers."""
        size = 8
        dirs = cube_face_directions(size)
        face, uv = cube_direction_to_face_uv(jnp.asarray(dirs.reshape(-1, 3)))
        face = np.asarray(face).reshape(6, size, size)
        uv = np.asarray(uv).reshape(6, size, size, 2)
        expect_face = np.broadcast_to(
            np.arange(6)[:, None, None], (6, size, size)
        )
        np.testing.assert_array_equal(face, expect_face)
        centers = (np.arange(size) + 0.5) / size
        np.testing.assert_allclose(
            uv[..., 0],
            np.broadcast_to(centers[None, None, :], uv[..., 0].shape),
            atol=1e-5,
        )
        np.testing.assert_allclose(
            uv[..., 1],
            np.broadcast_to(centers[None, :, None], uv[..., 1].shape),
            atol=1e-5,
        )

    def test_directions_unit_norm(self):
        d = cube_face_directions(16)
        np.testing.assert_allclose(
            np.linalg.norm(d, axis=-1), 1.0, atol=1e-6
        )

    def test_solid_angles_total_sphere(self):
        w = cube_texel_solid_angles(16)
        assert w.shape == (16, 16)
        np.testing.assert_allclose(6.0 * w.sum(), 4.0 * np.pi, rtol=1e-5)


class TestIrradianceSH:
    def test_constant_environment_round_trip(self):
        """SH projection of a constant environment evaluates back to the
        constant (the Lambertian radiance factor equals the radiance)."""
        sh = irradiance_sh9_host(constant_cube(16, (0.25, 0.5, 1.0)))
        rng = np.random.default_rng(0)
        n = rng.normal(size=(64, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        e = np.asarray(eval_irradiance_sh9(jnp.asarray(sh), jnp.asarray(n)))
        np.testing.assert_allclose(
            e, np.broadcast_to([0.25, 0.5, 1.0], e.shape), rtol=2e-3
        )

    def test_host_and_device_projections_agree(self):
        rng = np.random.default_rng(1)
        cube = rng.uniform(0.0, 2.0, size=(6, 8, 8, 4)).astype(np.float32)
        a = irradiance_sh9_host(cube)
        b = np.asarray(irradiance_sh9(jnp.asarray(cube)))
        np.testing.assert_allclose(a, b, atol=1e-4)

    def test_directional_environment_prefers_facing_normals(self):
        """Bright +Z face only: normals toward +Z receive more irradiance
        than normals toward −Z (which see it only at grazing angles)."""
        cube = constant_cube(16, (0.0, 0.0, 0.0))
        cube[4, ..., :3] = 5.0  # +Z face
        sh = irradiance_sh9_host(cube)
        up = np.asarray(
            eval_irradiance_sh9(jnp.asarray(sh), jnp.asarray([[0.0, 0.0, 1.0]]))
        )
        down = np.asarray(
            eval_irradiance_sh9(jnp.asarray(sh), jnp.asarray([[0.0, 0.0, -1.0]]))
        )
        assert up[0, 0] > 4.0 * max(down[0, 0], 1e-6)


class TestPrefilter:
    def test_constant_environment_all_mips_constant(self):
        mips = prefilter_ggx(constant_cube(32, (0.3, 0.6, 0.9)), num_mips=4,
                             samples=32)
        assert len(mips) == 4
        for m, mip in enumerate(mips):
            assert mip.shape == (6, 32 >> m, 32 >> m, 4)
            np.testing.assert_allclose(
                np.asarray(mip)[..., :3],
                np.broadcast_to([0.3, 0.6, 0.9], mip.shape[:-1] + (3,)),
                rtol=1e-3,
            )

    def test_mip0_is_mirror(self):
        rng = np.random.default_rng(2)
        cube = rng.uniform(size=(6, 16, 16, 4)).astype(np.float32)
        mips = prefilter_ggx(cube, num_mips=3, samples=16)
        np.testing.assert_allclose(np.asarray(mips[0]), cube, atol=1e-6)

    def test_rough_mips_blur_but_keep_direction(self):
        """One bright face: the roughest mip still peaks toward that face,
        but with far less contrast than the mirror level (energy spread)."""
        cube = constant_cube(32, (0.05, 0.05, 0.05))
        cube[0, ..., :3] = 4.0  # +X face
        mips = prefilter_ggx(cube, num_mips=4, samples=128)
        rough = np.asarray(mips[-1])
        # Face-averaged luminance at the roughest level.
        lum = rough[..., :3].mean(axis=(1, 2, 3))
        assert lum[0] > lum[1]  # +X still brightest vs -X
        contrast_rough = lum[0] / lum[1]
        sharp = np.asarray(mips[0])
        lum0 = sharp[..., :3].mean(axis=(1, 2, 3))
        contrast_sharp = lum0[0] / lum0[1]
        assert contrast_rough < contrast_sharp * 0.5


class TestEnvBrdf:
    def test_mirror_limit(self):
        scale, bias = env_brdf_approx(jnp.asarray(1.0), jnp.asarray(0.0))
        assert abs(float(scale) - 1.0) < 0.02
        assert abs(float(bias)) < 0.02

    def test_bounded(self):
        ndv = jnp.linspace(0.02, 1.0, 32)[:, None]
        r = jnp.linspace(0.0, 1.0, 16)[None, :]
        scale, bias = env_brdf_approx(ndv, r)
        total = np.asarray(scale + bias)
        assert (total <= 1.2).all() and (np.asarray(bias) >= -1e-3).all()


class TestSampleCubeLod:
    def test_lod_endpoints_match_levels(self):
        rng = np.random.default_rng(3)
        levels = [
            jnp.asarray(rng.uniform(size=(6, 8 >> m, 8 >> m, 4)), jnp.float32)
            for m in range(3)
        ]
        dirs = jnp.asarray(cube_face_directions(4).reshape(-1, 3))
        lin = SamplerConfig.linear()
        at0 = sample_cube_lod(levels, dirs, jnp.zeros(dirs.shape[0]), lin)
        ref0 = sample_cube(levels[0], dirs, lin)
        np.testing.assert_allclose(np.asarray(at0), np.asarray(ref0), atol=1e-6)
        at2 = sample_cube_lod(levels, dirs, jnp.full(dirs.shape[0], 2.0), lin)
        ref2 = sample_cube(levels[2], dirs, lin)
        np.testing.assert_allclose(np.asarray(at2), np.asarray(ref2), atol=1e-6)

    def test_fractional_lod_blends(self):
        levels = [
            jnp.full((6, 8, 8, 4), 1.0),
            jnp.full((6, 4, 4, 4), 3.0),
        ]
        dirs = jnp.asarray([[1.0, 0.1, 0.2]])
        out = sample_cube_lod(levels, dirs, jnp.asarray([0.5]))
        np.testing.assert_allclose(np.asarray(out), 2.0, atol=1e-5)


class TestEnvironmentLight:
    def test_build_shapes(self):
        from zenith.renderer import EnvironmentLight

        env = EnvironmentLight.from_cube_pixels(
            "env", constant_cube(32, (1.0, 1.0, 1.0)), num_mips=3, samples=16
        )
        assert env.sh9.shape == (9, 3) and env.sh9.dtype == np.float32
        assert env.num_mips == 3
        assert env.texture.desc.array_layers == 6
        assert len(env.texture.mips) == 3
        assert env.texture.mips[2].shape == (6, 8, 8, 4)

    def test_intensity_scales(self):
        from zenith.renderer import EnvironmentLight

        base = EnvironmentLight.from_cube_pixels(
            "e1", constant_cube(16, (0.5, 0.5, 0.5)), num_mips=2, samples=8
        )
        twice = EnvironmentLight.from_cube_pixels(
            "e2", constant_cube(16, (0.5, 0.5, 0.5)), num_mips=2, samples=8,
            intensity=2.0,
        )
        np.testing.assert_allclose(twice.sh9, base.sh9 * 2.0, rtol=1e-5)


class TestDeferredEnvironment:
    """End-to-end: environment-only lighting through the deferred resolve."""

    def _render(self, device, scene, W=96, H=48):
        from zenith.core.camera import Camera
        from zenith.core.mathtypes import Degree, Radians
        from zenith.renderer import DeferredRenderer
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import PipelineCache, TextureDesc

        cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
        cam.set_position(np.array([0.0, -60.0, 25.0], np.float32))
        cam.set_yaw_pitch(Radians(0.0), Radians(-0.25))
        renderer = DeferredRenderer(scene, shadows=False)
        builder = RenderGraphBuilder()
        color = builder.create(TextureDesc.color("rt", W, H))
        builder.export(color)
        renderer.render_to(builder, color, cam, W, H)
        compiled = builder.build().compile(
            device, PipelineCache(), CompileOptions(tile_h=8, tile_w=96)
        )
        compiled.execute(device)
        return np.asarray(compiled.value(color))

    @pytest.fixture
    def device(self):
        from zenith.rhi import RhiCore

        return RhiCore().create_render_device()

    def _scene(self, device, **obj_kwargs):
        from test_renderers import make_cube
        from zenith.renderer import Scene, SceneObject

        cube = SceneObject.from_mesh(
            device, make_cube(size=14.0, z0=8.0), "cube", bin_capacity=64,
            **obj_kwargs,
        )
        return Scene(objects=[cube], sun=None, point_lights=[])

    def test_env_tints_diffuse_and_background(self, device):
        from zenith.renderer import EnvironmentLight

        scene = self._scene(
            device, base_color=(1.0, 1.0, 1.0, 1.0), roughness=0.9
        )
        green = constant_cube(32, (0.05, 1.2, 0.05))
        scene.environment = EnvironmentLight.from_cube_pixels(
            "green", green, num_mips=3, samples=16
        )
        img = self._render(device, scene)
        # Background = the environment cube (skybox defaulting).
        np.testing.assert_allclose(img[2, 2, :3], [0.05, 1.2, 0.05], atol=1e-2)
        # The white cube is lit green (no other lights in the scene).
        center = img[img.shape[0] // 2, img.shape[1] // 2, :3]
        assert center[1] > 4.0 * center[0] and center[1] > 0.1, center

    def test_metal_reflects_environment_hotspot(self, device):
        """A smooth metal surface reflects the bright face; a rough one
        spreads it — mirror specular must exceed rough specular at the
        reflected direction's pixel."""
        from zenith.renderer import EnvironmentLight

        # Camera sits at -Y looking at the cube's front (-Y-normal) face,
        # which mirror-reflects the -Y region of the environment.
        env_pixels = constant_cube(32, (0.02, 0.02, 0.02))
        env_pixels[3, ..., :3] = 6.0  # -Y face bright

        def render(roughness):
            scene = self._scene(
                device, base_color=(1.0, 1.0, 1.0, 1.0), metallic=1.0,
                roughness=roughness,
            )
            scene.environment = EnvironmentLight.from_cube_pixels(
                "probe", env_pixels, num_mips=4, samples=32
            )
            return self._render(device, scene)

        mirror = render(0.05)[..., :3]
        rough = render(1.0)[..., :3]
        assert mirror.max() > rough.max() * 1.3, (mirror.max(), rough.max())

    def test_explicit_skybox_overrides_env_background(self, device):
        from zenith.renderer import EnvironmentLight
        from zenith.rhi import Texture as RhiTexture
        from zenith.rhi import Format

        scene = self._scene(device, base_color=(1.0, 1.0, 1.0, 1.0))
        scene.environment = EnvironmentLight.from_cube_pixels(
            "env", constant_cube(16, (1.0, 0.0, 0.0)), num_mips=2, samples=8
        )
        scene.skybox = RhiTexture.from_numpy_layers(
            "sky", constant_cube(16, (0.0, 0.0, 1.0)), Format.RGBA32F,
            cube=True,
        )
        img = self._render(device, scene)
        np.testing.assert_allclose(img[2, 2, :3], [0.0, 0.0, 1.0], atol=1e-2)
