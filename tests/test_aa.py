"""Post AA (ops.aa.post_aa) — gather-free FXAA-class edge smoothing.

Closed-form expectations: flat regions untouched, hard edges blend along
the edge (not across it), low-contrast detail below the threshold is
preserved, and the banded post chain stays bit-equal under SPMD.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from zenith.ops.aa import post_aa

H, W = 32, 32


def img(fill=0.0):
    return np.full((H, W, 3), fill, np.float32)


class TestPostAA:
    def test_flat_image_unchanged(self):
        x = jnp.asarray(img(0.5))
        np.testing.assert_allclose(np.asarray(post_aa(x)), 0.5)

    def test_vertical_edge_blends_pixels_on_the_edge(self):
        a = img(0.0)
        a[:, W // 2:] = 1.0
        out = np.asarray(post_aa(jnp.asarray(a)))
        # Rows interior to each side stay put…
        np.testing.assert_allclose(out[:, 4], 0.0, atol=1e-6)
        np.testing.assert_allclose(out[:, -4], 1.0, atol=1e-6)
        # …a straight vertical edge has zero subpixel factor on the bright
        # column? No: the column at the edge departs from its neighborhood
        # average, so it must move toward the mean (smoothing).
        edge_cols = out[:, W // 2 - 1 : W // 2 + 1]
        assert edge_cols.min() > 0.0 - 1e-6
        assert not np.allclose(edge_cols[:, 0], 0.0)  # left edge col rose
        assert not np.allclose(edge_cols[:, 1], 1.0)  # right edge col fell

    def test_diagonal_staircase_smooths(self):
        a = img(0.0)
        for y in range(H):
            a[y, : y + 1] = 1.0  # 45-degree staircase
        out = np.asarray(post_aa(jnp.asarray(a)))
        # The stair-step corner pixels move toward intermediate values.
        changed = np.abs(out - a).max(axis=-1)
        assert (changed > 0.05).sum() >= H - 2  # along the whole diagonal
        # Interior far from the edge is untouched.
        np.testing.assert_allclose(out[H - 4, 2], 1.0, atol=1e-6)
        np.testing.assert_allclose(out[2, W - 4], 0.0, atol=1e-6)

    def test_low_contrast_preserved(self):
        rng = np.random.default_rng(0)
        a = 0.5 + rng.uniform(-0.01, 0.01, (H, W, 3)).astype(np.float32)
        out = np.asarray(post_aa(jnp.asarray(a)))
        np.testing.assert_array_equal(out, a)  # below threshold: untouched

    def test_alpha_passthrough(self):
        a = np.concatenate(
            [img(0.3), np.full((H, W, 1), 0.7, np.float32)], axis=-1
        )
        out = np.asarray(post_aa(jnp.asarray(a)))
        np.testing.assert_allclose(out[..., 3], 0.7)


class TestPostChainFXAA:
    def test_tone_and_bloom_fxaa_applies(self):
        from zenith.renderer.post import tone_and_bloom

        hdr = np.zeros((64, 64, 4), np.float32)
        hdr[:, 32:, :3] = 4.0  # hard bright edge
        hdr[..., 3] = 1.0
        plain = np.asarray(tone_and_bloom(jnp.asarray(hdr)))
        aa = np.asarray(tone_and_bloom(jnp.asarray(hdr), fxaa=True))
        assert not np.allclose(plain[:, 31, :3], aa[:, 31, :3])
        np.testing.assert_allclose(plain[..., 3], aa[..., 3])

    def test_banded_fxaa_bit_equal(self, ):
        import jax

        if len(jax.devices("cpu")) < 8:
            pytest.skip("needs 8 virtual cpu devices")
        from functools import partial

        from jax.sharding import Mesh, PartitionSpec as P
        from jax.experimental.shard_map import shard_map

        from zenith.renderer.post import (
            tone_and_bloom,
            tone_and_bloom_banded,
        )

        rng = np.random.default_rng(1)
        hdr = rng.uniform(0.0, 3.0, (128, 64, 4)).astype(np.float32)
        single = np.asarray(tone_and_bloom(jnp.asarray(hdr), fxaa=True))

        mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("rows",))
        fn = shard_map(
            partial(tone_and_bloom_banded, axis_name="rows", fxaa=True),
            mesh=mesh, in_specs=P("rows"), out_specs=P("rows"),
        )
        banded = np.asarray(jax.jit(fn)(jnp.asarray(hdr)))
        # Same math either way; XLA fuses the two programs differently, so
        # allow float reassociation at the last ulp.
        np.testing.assert_allclose(banded, single, atol=2e-5, rtol=1e-6)
