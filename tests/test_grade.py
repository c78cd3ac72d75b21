"""Color grading: knob analytics, identity transparency, SPMD vignette."""

import jax
import jax.numpy as jnp
import numpy as np

from zenith.renderer.post import (
    ColorGrade,
    apply_grade_post,
    apply_grade_pre,
    tone_and_bloom,
)

H, W = 64, 128


def _flat(rgb):
    img = np.zeros((H, W, 4), np.float32)
    img[..., :3] = rgb
    img[..., 3] = 1.0
    return img


class TestKnobs:
    def test_identity_grade_is_transparent(self):
        hdr = _flat((0.3, 0.5, 0.2))
        base = np.asarray(tone_and_bloom(jnp.asarray(hdr)))
        graded = np.asarray(tone_and_bloom(
            jnp.asarray(hdr), grade=jnp.asarray(ColorGrade().pack())
        ))
        np.testing.assert_allclose(graded, base, atol=1e-5)

    def test_exposure_doubles_linear_input(self):
        g = jnp.asarray(ColorGrade(exposure_ev=1.0).pack())
        rgb = jnp.full((4, 4, 3), 0.25, jnp.float32)
        out = np.asarray(apply_grade_pre(rgb, g))
        np.testing.assert_allclose(out, 0.5, atol=1e-6)

    def test_contrast_pivot_fixed_point(self):
        g = jnp.asarray(ColorGrade(contrast=1.5).pack())
        rgb = jnp.full((2, 2, 3), 0.18, jnp.float32)
        out = np.asarray(apply_grade_pre(rgb, g))
        np.testing.assert_allclose(out, 0.18, atol=1e-5)  # pivot unchanged
        hi = np.asarray(apply_grade_pre(
            jnp.full((2, 2, 3), 0.5, jnp.float32), g
        ))
        assert np.all(hi > 0.5)  # above pivot pushed up
        lo = np.asarray(apply_grade_pre(
            jnp.full((2, 2, 3), 0.05, jnp.float32), g
        ))
        assert np.all(lo < 0.05)  # below pivot pushed down

    def test_temperature_warms(self):
        g = jnp.asarray(ColorGrade(temperature=0.8).pack())
        out = np.asarray(apply_grade_pre(
            jnp.full((2, 2, 3), 0.3, jnp.float32), g
        ))
        assert np.all(out[..., 0] > out[..., 2])  # red up, blue down

    def test_saturation_zero_is_grayscale(self):
        g = jnp.asarray(ColorGrade(saturation=0.0).pack())
        mapped = jnp.asarray(_flat((0.8, 0.2, 0.4))[..., :3])
        out = np.asarray(apply_grade_post(mapped, g))
        np.testing.assert_allclose(out[..., 0], out[..., 1], atol=1e-6)
        np.testing.assert_allclose(out[..., 1], out[..., 2], atol=1e-6)

    def test_vignette_darkens_corners_not_center(self):
        g = jnp.asarray(ColorGrade(vignette=0.8).pack())
        mapped = jnp.full((H, W, 3), 0.6, jnp.float32)
        out = np.asarray(apply_grade_post(mapped, g))
        assert out[0, 0, 0] < 0.45  # corner darkened
        np.testing.assert_allclose(
            out[H // 2, W // 2], 0.6, atol=0.02  # center ~untouched
        )


class TestSPMD:
    def test_banded_vignette_matches_single(self, cpu_devices):
        """The vignette's radial falloff uses GLOBAL rows under a mesh —
        bands must concatenate to the single-device image exactly."""
        from jax.sharding import PartitionSpec as P

        from zenith.parallel.sharding import default_mesh
        from zenith.renderer.post import tone_and_bloom_banded

        h2, w2 = 256, 128
        rng = np.random.default_rng(7)
        hdr = rng.uniform(0.0, 2.0, size=(h2, w2, 4)).astype(np.float32)
        grade = ColorGrade(exposure_ev=0.3, contrast=1.1, saturation=1.2,
                           temperature=0.4, vignette=0.6).pack()
        ref = np.asarray(tone_and_bloom(
            jnp.asarray(hdr), grade=jnp.asarray(grade)
        ))
        mesh = default_mesh(8, backend="cpu")
        banded = jax.jit(
            jax.shard_map(
                lambda x: tone_and_bloom_banded(
                    x, "rows", grade=jnp.asarray(grade)
                ),
                mesh=mesh,
                in_specs=P("rows"),
                out_specs=P("rows"),
            )
        )
        out = np.asarray(banded(jnp.asarray(hdr)))
        np.testing.assert_allclose(out, ref, atol=1e-5)
