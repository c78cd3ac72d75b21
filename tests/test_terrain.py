"""Terrain sandbox (sandbox.terrain): heightmap/mesh/albedo generation
and the end-to-end flyover frame."""

import numpy as np

from zenith.sandbox.terrain import (
    fbm_heightmap,
    terrain_albedo,
    terrain_mesh,
)


class TestGeneration:
    def test_heightmap_range_and_determinism(self):
        h = fbm_heightmap(96, seed=3)
        assert h.shape == (96, 96) and h.dtype == np.float32
        assert h.min() >= 0.0 and h.max() <= 1.0
        assert h.std() > 0.05  # actual relief
        np.testing.assert_array_equal(h, fbm_heightmap(96, seed=3))
        assert np.abs(h - fbm_heightmap(96, seed=4)).max() > 0.05

    def test_mesh_counts_and_normals(self):
        h = fbm_heightmap(64, seed=1)
        verts, tris = terrain_mesh(h, extent=100.0, zscale=30.0)
        assert verts.shape == (64 * 64, 8)
        assert tris.shape == (2 * 63 * 63, 3)
        assert tris.min() >= 0 and tris.max() < len(verts)
        n = verts[:, 3:6]
        np.testing.assert_allclose(
            np.linalg.norm(n, axis=-1), 1.0, atol=1e-5
        )
        assert (n[:, 2] > 0).all()  # terrain never overhangs
        uv = verts[:, 6:8]
        assert uv.min() >= 0.0 and uv.max() <= 1.0

    def test_albedo_height_slope_zones(self):
        h = np.zeros((64, 64), np.float32)
        h[:32] = 1.0  # a high plateau over a low plain, cliff between
        tex = terrain_albedo(h, zscale=50.0, size=64)
        assert tex.shape == (64, 64, 4) and tex.dtype == np.uint8
        # Plateau rows are snow (bright), plain rows grass (green-dominant).
        snow = tex[8:24, :, :3].mean(axis=(0, 1))
        grass = tex[40:56, :, :3].mean(axis=(0, 1))
        assert snow.min() > 150
        assert grass[1] > grass[0] and grass[1] > grass[2]


class TestEndToEnd:
    def test_flyover_renders_finite(self):
        from zenith.launch import launch
        from zenith.window import Window

        window = Window(width=128, height=64, title="t")
        loop = launch(
            __import__("zenith.sandbox.terrain",
                       fromlist=["TerrainApp"]).TerrainApp,
            argv=["--", "--grid", "48"],
            window=window,
            max_frames=2,
        )
        assert loop.app.tri_count == 2 * 47 * 47
        frame = np.asarray(window.last_frame)
        assert np.isfinite(frame.astype(np.float64)).all()
        assert frame[..., :3].std() > 1.0  # terrain + sky, not a clear
