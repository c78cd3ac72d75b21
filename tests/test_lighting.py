"""Tiled point-light kernel vs a dense per-light reference loop.

The kernel culls lights per tile (sphere-vs-world-AABB); the reference
evaluates every light at every pixel with the renderer's own BRDF — the
results must agree everywhere, proving culling never drops a contributing
light.
"""

import jax.numpy as jnp
import numpy as np

from zenith.ops.lighting import accumulate_point_lights
from zenith.renderer.deferred import _ggx_brdf

H, W = 64, 256


def dense_reference(am, nr, pe, depth, cam, lp, lc, lr):
    albedo = am[..., :3]
    metallic = am[..., 3:4]
    n = nr[..., :3]
    rough = nr[..., 3:4]
    world = pe[..., :3]
    v = cam - world
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-8)
    acc = jnp.zeros(albedo.shape, jnp.float32)
    for i in range(lp.shape[0]):
        to_l = lp[i] - world
        dist = jnp.maximum(jnp.linalg.norm(to_l, axis=-1, keepdims=True), 1e-4)
        l = to_l / dist
        att = 1.0 / (dist * dist)
        win = jnp.clip(1.0 - (dist / lr[i]) ** 4, 0.0, 1.0) ** 2
        acc = acc + _ggx_brdf(n, v, l, albedo, metallic, rough) * lc[i] * att * win
    # Kernel only shades covered pixels; reference masks to match.
    return np.where(np.asarray(depth)[..., None] > 0, np.asarray(acc), 0.0)


def make_gbuffer(rng):
    nrm = rng.normal(size=(H, W, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    am = np.concatenate(
        [rng.uniform(0.1, 1.0, (H, W, 3)), rng.uniform(0, 1, (H, W, 1))], -1
    ).astype(np.float32)
    nr = np.concatenate(
        [nrm, rng.uniform(0.05, 1.0, (H, W, 1))], -1
    ).astype(np.float32)
    world = rng.uniform(-20, 20, (H, W, 3))
    pe = np.concatenate(
        [world, rng.uniform(0, 1, (H, W, 1))], -1
    ).astype(np.float32)
    depth = (rng.uniform(0, 1, (H, W)) > 0.2).astype(np.float32) * 0.5
    return am, nr, pe, depth


class TestTiledLights:
    def test_matches_dense_reference(self, rng):
        am, nr, pe, depth = make_gbuffer(rng)
        cam = np.array([0.0, -30.0, 10.0], np.float32)
        nl = 12
        lp = rng.uniform(-25, 25, (nl, 3)).astype(np.float32)
        lc = rng.uniform(0.5, 8.0, (nl, 3)).astype(np.float32)
        lr = rng.uniform(3.0, 15.0, (nl,)).astype(np.float32)

        got = np.asarray(
            accumulate_point_lights(
                jnp.asarray(am), jnp.asarray(nr), jnp.asarray(pe),
                jnp.asarray(depth), jnp.asarray(cam),
                jnp.asarray(lp), jnp.asarray(lc), jnp.asarray(lr),
                tile_h=16, tile_w=128,
            )
        )
        ref = dense_reference(
            jnp.asarray(am), jnp.asarray(nr), jnp.asarray(pe), depth,
            jnp.asarray(cam), lp, lc, lr,
        )
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)
        assert got.max() > 0.01  # lights actually landed

    def test_far_lights_contribute_nothing_and_cull(self, rng):
        am, nr, pe, depth = make_gbuffer(rng)
        cam = np.array([0.0, -30.0, 10.0], np.float32)
        # All lights far outside every tile's AABB + radius.
        lp = (rng.uniform(500, 600, (8, 3))).astype(np.float32)
        lc = np.ones((8, 3), np.float32)
        lr = np.full((8,), 5.0, np.float32)
        got = np.asarray(
            accumulate_point_lights(
                jnp.asarray(am), jnp.asarray(nr), jnp.asarray(pe),
                jnp.asarray(depth), jnp.asarray(cam),
                jnp.asarray(lp), jnp.asarray(lc), jnp.asarray(lr),
            )
        )
        np.testing.assert_array_equal(got, 0.0)

    def test_zero_lights(self, rng):
        am, nr, pe, depth = make_gbuffer(rng)
        got = accumulate_point_lights(
            jnp.asarray(am), jnp.asarray(nr), jnp.asarray(pe),
            jnp.asarray(depth), jnp.asarray(np.zeros(3, np.float32)),
            jnp.zeros((0, 3)), jnp.zeros((0, 3)), jnp.zeros((0,)),
        )
        assert got.shape == (H, W, 3)
        np.testing.assert_array_equal(np.asarray(got), 0.0)


def dense_spot_reference(am, nr, pe, depth, cam, lp, lc, lr, params):
    """Dense per-light loop with the cone-edge factor (the spot contract)."""
    albedo = am[..., :3]
    metallic = am[..., 3:4]
    n = nr[..., :3]
    rough = nr[..., 3:4]
    world = pe[..., :3]
    v = cam - world
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-8)
    acc = jnp.zeros(albedo.shape, jnp.float32)
    for i in range(lp.shape[0]):
        to_l = lp[i] - world
        dist = jnp.maximum(jnp.linalg.norm(to_l, axis=-1, keepdims=True), 1e-4)
        l = to_l / dist
        att = 1.0 / (dist * dist)
        win = jnp.clip(1.0 - (dist / lr[i]) ** 4, 0.0, 1.0) ** 2
        d = params[i, :3]
        if np.linalg.norm(d) > 1e-6:
            cosang = -jnp.sum(l * d, axis=-1, keepdims=True)
            t = jnp.clip(
                (cosang - params[i, 4]) / max(params[i, 3] - params[i, 4], 1e-4),
                0.0, 1.0,
            )
            cone = t * t
        else:
            cone = 1.0
        acc = acc + (
            _ggx_brdf(n, v, l, albedo, metallic, rough)
            * lc[i] * att * win * cone
        )
    return np.where(np.asarray(depth)[..., None] > 0, np.asarray(acc), 0.0)


class TestSpotLights:
    def test_spot_matches_dense_reference(self, rng):
        am, nr, pe, depth = make_gbuffer(rng)
        cam = np.array([0.0, -30.0, 10.0], np.float32)
        nl = 8
        lp = rng.uniform(-25, 25, (nl, 3)).astype(np.float32)
        lc = rng.uniform(0.5, 8.0, (nl, 3)).astype(np.float32)
        lr = rng.uniform(5.0, 18.0, (nl,)).astype(np.float32)
        params = np.zeros((nl, 5), np.float32)
        for i in range(nl):
            if i % 2 == 0:  # half spots, half points — one merged table
                d = rng.normal(size=3)
                d /= np.linalg.norm(d)
                params[i, :3] = d
                params[i, 3] = np.cos(np.radians(15.0))
                params[i, 4] = np.cos(np.radians(28.0))
        got = np.asarray(accumulate_point_lights(
            jnp.asarray(am), jnp.asarray(nr), jnp.asarray(pe),
            jnp.asarray(depth), jnp.asarray(cam),
            jnp.asarray(lp), jnp.asarray(lc), jnp.asarray(lr),
            tile_h=16, tile_w=128, spot_params=jnp.asarray(params),
        ))
        ref = dense_spot_reference(
            jnp.asarray(am), jnp.asarray(nr), jnp.asarray(pe), depth,
            jnp.asarray(cam), lp, lc, lr, params,
        )
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)
        assert got.max() > 0.01

    def test_point_rows_in_spot_table_match_pure_points(self, rng):
        """Zero cone params = point light: the spot-enabled table must
        reproduce the pure-point kernel exactly."""
        am, nr, pe, depth = make_gbuffer(rng)
        cam = np.array([0.0, -30.0, 10.0], np.float32)
        lp = rng.uniform(-25, 25, (6, 3)).astype(np.float32)
        lc = rng.uniform(0.5, 8.0, (6, 3)).astype(np.float32)
        lr = rng.uniform(5.0, 18.0, (6,)).astype(np.float32)
        pure = np.asarray(accumulate_point_lights(
            jnp.asarray(am), jnp.asarray(nr), jnp.asarray(pe),
            jnp.asarray(depth), jnp.asarray(cam),
            jnp.asarray(lp), jnp.asarray(lc), jnp.asarray(lr),
        ))
        tabled = np.asarray(accumulate_point_lights(
            jnp.asarray(am), jnp.asarray(nr), jnp.asarray(pe),
            jnp.asarray(depth), jnp.asarray(cam),
            jnp.asarray(lp), jnp.asarray(lc), jnp.asarray(lr),
            spot_params=jnp.zeros((6, 5)),
        ))
        np.testing.assert_array_equal(tabled, pure)

    def test_outside_cone_is_dark(self):
        """A tight down-pointing spot: pixels behind the light get zero."""
        h, w = 16, 128
        world = np.zeros((h, w, 3), np.float32)
        world[..., 0] = np.linspace(-10, 10, w)[None, :]
        world[..., 2] = 0.0
        pe = np.concatenate([world, np.zeros((h, w, 1), np.float32)], -1)
        nr = np.zeros((h, w, 4), np.float32)
        nr[..., 2] = 1.0
        nr[..., 3] = 0.5
        am = np.full((h, w, 4), 0.5, np.float32)
        depth = np.full((h, w), 0.5, np.float32)
        cam = np.array([0, -5, 5], np.float32)
        lp = np.array([[0, 0, 6.0]], np.float32)
        lc = np.array([[50, 50, 50]], np.float32)
        lr = np.array([40.0], np.float32)
        params = np.array(
            [[0, 0, -1, np.cos(np.radians(10)), np.cos(np.radians(20))]],
            np.float32,
        )
        got = np.asarray(accumulate_point_lights(
            jnp.asarray(am), jnp.asarray(nr), jnp.asarray(pe),
            jnp.asarray(depth), jnp.asarray(cam),
            jnp.asarray(lp), jnp.asarray(lc), jnp.asarray(lr),
            spot_params=jnp.asarray(params),
        ))
        mid = got[:, w // 2 - 2 : w // 2 + 2]
        edge = got[:, :8]
        assert mid.max() > 0.05  # inside the cone: lit
        np.testing.assert_array_equal(edge, 0.0)  # far outside: dark
