"""Cube / 2D-array / 3D textures (reference texture.rs:81-114) — ctors,
device layout, and sampling vs direct NumPy formulas."""

import jax.numpy as jnp
import numpy as np
import pytest

from zenith.ops.sampling import (
    cube_direction_to_face_uv,
    sample_2d_array,
    sample_3d,
    sample_cube,
)
from zenith.rhi.formats import Format
from zenith.rhi.resource import Texture, TextureDesc
from zenith.rhi.sampler import Filter, SamplerConfig


class TestDescsAndUpload:
    def test_3d_desc_shape(self):
        d = TextureDesc.new_3d("vol", 16, 8, 4, Format.RGBA32F)
        assert d.device_shape() == (4, 8, 16, 4)

    def test_cube_desc_shape(self):
        d = TextureDesc.new_cube("sky", 32, Format.RGBA32F)
        assert d.array_layers == 6
        assert d.device_shape() == (6, 32, 32, 4)

    def test_array_desc_shape(self):
        d = TextureDesc.new_2d_array("arr", 16, 8, 5, Format.RGBA32F)
        assert d.device_shape() == (5, 8, 16, 4)

    def test_upload_layers_and_volume(self, rng):
        stack = rng.uniform(0, 1, (5, 8, 16, 4)).astype(np.float32)
        t = Texture.from_numpy_layers("arr", stack, Format.RGBA32F)
        assert t.array.shape == (5, 8, 16, 4)
        np.testing.assert_allclose(np.asarray(t.array), stack)

        cube = rng.uniform(0, 1, (6, 8, 8, 4)).astype(np.float32)
        t = Texture.from_numpy_layers("sky", cube, Format.RGBA32F, cube=True)
        assert t.desc.array_layers == 6

        vol = rng.uniform(0, 1, (4, 8, 16, 4)).astype(np.float32)
        t = Texture.from_numpy_3d("vol", vol, Format.RGBA32F)
        assert t.desc.depth == 4


class TestArraySampling:
    def test_nearest_layer_texel(self, rng):
        tex = rng.uniform(0, 1, (4, 8, 16, 3)).astype(np.float32)
        # Sample the center of each texel of each layer → exact texels.
        u = (np.arange(16) + 0.5) / 16
        v = (np.arange(8) + 0.5) / 8
        uv = np.stack(np.meshgrid(u, v), axis=-1)  # (8, 16, 2)
        for layer in range(4):
            got = sample_2d_array(
                jnp.asarray(tex), jnp.asarray(uv),
                jnp.full((8, 16), float(layer)),
                SamplerConfig.nearest(),
            )
            np.testing.assert_allclose(np.asarray(got), tex[layer], atol=1e-6)

    def test_layer_rounds_and_clamps(self, rng):
        tex = rng.uniform(0, 1, (3, 4, 4, 1)).astype(np.float32)
        uv = jnp.asarray([[0.5, 0.5]])
        lo = sample_2d_array(jnp.asarray(tex), uv, jnp.asarray([-2.0]),
                             SamplerConfig.nearest())
        hi = sample_2d_array(jnp.asarray(tex), uv, jnp.asarray([9.0]),
                             SamplerConfig.nearest())
        r1 = sample_2d_array(jnp.asarray(tex), uv, jnp.asarray([1.4]),
                             SamplerConfig.nearest())
        assert np.allclose(np.asarray(lo)[0], tex[0, 2, 2])
        assert np.allclose(np.asarray(hi)[0], tex[2, 2, 2])
        assert np.allclose(np.asarray(r1)[0], tex[1, 2, 2])

    def test_bilinear_within_layer(self):
        # 2×2 layer: sampling dead center averages all four texels.
        tex = np.zeros((2, 2, 2, 1), np.float32)
        tex[1, :, :, 0] = [[0.0, 1.0], [1.0, 0.0]]
        got = sample_2d_array(
            jnp.asarray(tex), jnp.asarray([[0.5, 0.5]]), jnp.asarray([1.0]),
            SamplerConfig.linear().clamped(),
        )
        np.testing.assert_allclose(np.asarray(got)[0, 0], 0.5, atol=1e-6)


class TestCubeSampling:
    def test_face_selection_axes(self):
        dirs = jnp.asarray([
            [1, 0, 0], [-1, 0, 0],
            [0, 1, 0], [0, -1, 0],
            [0, 0, 1], [0, 0, -1],
        ], jnp.float32)
        face, uv = cube_direction_to_face_uv(dirs)
        np.testing.assert_array_equal(np.asarray(face), [0, 1, 2, 3, 4, 5])
        # Axis-aligned directions hit every face dead center.
        np.testing.assert_allclose(np.asarray(uv), 0.5, atol=1e-6)

    def test_face_colors_roundtrip(self):
        s = 8
        tex = np.zeros((6, s, s, 3), np.float32)
        for f in range(6):
            tex[f, :, :, :] = 0.0
            tex[f, :, :, f % 3] = (f // 3) + 1.0  # unique per face
        dirs = jnp.asarray([
            [1, 0.1, -0.2], [-1, 0.2, 0.1],
            [0.1, 1, 0.2], [-0.2, -1, 0.1],
            [0.2, 0.1, 1], [0.1, -0.2, -1],
        ], jnp.float32)
        got = np.asarray(sample_cube(jnp.asarray(tex), dirs))
        for f in range(6):
            expected = np.zeros(3)
            expected[f % 3] = (f // 3) + 1.0
            np.testing.assert_allclose(got[f], expected, atol=1e-5)

    def test_continuity_across_edge(self):
        """A smooth function baked into the cube reads back smoothly across
        a face boundary (no seam discontinuity beyond filter error)."""
        s = 32
        # Bake f(d) = d (the direction itself) into each face.
        faces = []
        for f in range(6):
            u = (np.arange(s) + 0.5) / s * 2 - 1
            v = (np.arange(s) + 0.5) / s * 2 - 1
            uu, vv = np.meshgrid(u, v)
            if f == 0:
                d = np.stack([np.ones_like(uu), -vv, -uu], -1)
            elif f == 1:
                d = np.stack([-np.ones_like(uu), -vv, uu], -1)
            elif f == 2:
                d = np.stack([uu, np.ones_like(uu), vv], -1)
            elif f == 3:
                d = np.stack([uu, -np.ones_like(uu), -vv], -1)
            elif f == 4:
                d = np.stack([uu, -vv, np.ones_like(uu)], -1)
            else:
                d = np.stack([-uu, -vv, -np.ones_like(uu)], -1)
            d = d / np.linalg.norm(d, axis=-1, keepdims=True)
            faces.append(d.astype(np.float32))
        tex = np.stack(faces)

        # March a great arc crossing from +X into +Z.
        ts = np.linspace(-0.3, 0.3, 64)
        dirs = np.stack(
            [np.cos(ts + np.pi / 4), np.zeros_like(ts), np.sin(ts + np.pi / 4)], -1
        ).astype(np.float32)
        got = np.asarray(sample_cube(jnp.asarray(tex), jnp.asarray(dirs)))
        err = np.linalg.norm(got - dirs, axis=-1)
        assert err.max() < 0.05  # smooth: only filtering error


class TestVolumeSampling:
    def test_trilinear_between_slices(self):
        tex = np.zeros((2, 4, 4, 1), np.float32)
        tex[1] = 1.0
        uvw = jnp.asarray([[0.5, 0.5, 0.5]])  # halfway between slices
        got = sample_3d(jnp.asarray(tex), uvw, SamplerConfig.linear().clamped())
        np.testing.assert_allclose(np.asarray(got)[0, 0], 0.5, atol=1e-6)

    def test_nearest_slice(self, rng):
        vol = rng.uniform(0, 1, (4, 4, 8, 2)).astype(np.float32)
        for zi in range(4):
            w = (zi + 0.5) / 4
            got = sample_3d(
                jnp.asarray(vol), jnp.asarray([[0.5 / 8 * 1, 0.5 / 4 * 1, w]])
                * 0 + jnp.asarray([[(3 + 0.5) / 8, (1 + 0.5) / 4, w]]),
                SamplerConfig.nearest(),
            )
            np.testing.assert_allclose(
                np.asarray(got)[0], vol[zi, 1, 3], atol=1e-6
            )
