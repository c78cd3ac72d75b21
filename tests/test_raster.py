"""Rasterizer correctness vs the independent NumPy oracle.

The segmented raster kernel runs in the Pallas interpreter on the CPU test
platform; the same kernel compiles through Triton on the GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from np_reference import render_reference
from zenith.ops import (
    TileGrid,
    bin_segmented,
    raster_segmented,
    setup_triangles,
)
from zenith.ops.geometry import clip_near_w
from zenith.ops.shade import resolve_varyings
from zenith.rhi.state import CompareOp, CullMode, FrontFace

W, H = 128, 32
GRID = TileGrid(width=W, height=H, tile_h=8, tile_w=128)


def slot_corner_data(records):
    """Corner data whose one attribute is the record index: per corner
    [slot·iw, iw], so acc[0] / acc[1] recovers the winning record."""
    r = records.rast16.shape[0]
    iw = records.shade16[:, 0:3]  # SHADE_IW0..2: per-corner 1/w
    slot = jnp.arange(r, dtype=jnp.float32)[:, None]
    return jnp.stack([slot * iw, iw], axis=-1).reshape(r, 6)


def run_raster(
    clip,
    indices,
    cull=CullMode.NONE,
    front=FrontFace.COUNTER_CLOCKWISE,
    compare=CompareOp.GREATER,
    depth_test=True,
    depth_write=True,
    depth_clear=0.0,
    grid=GRID,
    entry_budget=None,
):
    records = setup_triangles(
        jnp.asarray(clip, jnp.float32),
        jnp.asarray(indices, jnp.int32),
        grid.width,
        grid.height,
        cull_mode=cull,
        front_face=front,
    )
    bins = bin_segmented(
        records, slot_corner_data(records), grid, entry_budget=entry_budget
    )
    init_z = jnp.full((grid.height, grid.width), depth_clear, jnp.float32)
    z, acc = raster_segmented(
        bins, grid, init_z,
        depth_test=depth_test, depth_write=depth_write, compare_op=compare,
    )
    covered = acc[1] > 0.0
    slot = jnp.where(
        covered, jnp.round(acc[0] / jnp.where(covered, acc[1], 1.0)), -1
    ).astype(jnp.int32)
    # Map record slot → original triangle id for oracle comparison.
    tri = jnp.where(slot >= 0, jnp.take(records.tri_id, jnp.maximum(slot, 0)), -1)
    return np.asarray(z), np.asarray(tri), np.asarray(slot), records


def ndc_tri(verts2d, z=0.5, w=1.0):
    """Build clip coords from NDC xy pairs at constant depth/w."""
    return np.array([[x * w, y * w, z * w, w] for x, y in verts2d], np.float32)


class TestCoverage:
    def test_single_triangle_matches_oracle(self):
        clip = ndc_tri([(0.0, -0.8), (0.7, 0.7), (-0.7, 0.7)], z=0.5)
        idx = np.array([[0, 1, 2]])
        z, tri, _, _ = run_raster(clip, idx)
        ref = render_reference(clip, idx, W, H, cull="none")
        np.testing.assert_array_equal(tri, ref["tri"])
        np.testing.assert_allclose(z, ref["z"], atol=1e-5)
        assert (tri >= 0).sum() > 50  # sanity: nontrivial coverage

    def test_shared_edge_no_double_no_gap(self):
        # Quad split along a diagonal: every covered pixel owned exactly once.
        quad = ndc_tri([(-0.8, -0.8), (0.8, -0.8), (0.8, 0.8), (-0.8, 0.8)], z=0.5)
        idx = np.array([[0, 1, 2], [0, 2, 3]])
        # Same z for both: if the shared edge double-rasterized, the later
        # tri would win EQUAL-compare pixels; with GREATER, double coverage
        # is invisible — so draw with compare ALWAYS and check ownership.
        z, tri, _, _ = run_raster(quad, idx, compare=CompareOp.ALWAYS)
        ref = render_reference(quad, idx, W, H, cull="none", compare="always")
        np.testing.assert_array_equal(tri, ref["tri"])
        # The union must be a solid axis-aligned rectangle: no gaps on the
        # diagonal.
        covered = tri >= 0
        ys, xs = np.where(covered)
        solid = np.zeros_like(covered)
        solid[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1] = True
        np.testing.assert_array_equal(covered, solid)

    def test_top_left_rule_matches_oracle_on_pixel_center_edges(self):
        # Construct edges passing exactly through pixel centers: NDC steps of
        # 2/W place vertices on integer pixel coords; +1/W offsets hit centers.
        px = 2.0 / W
        py = 2.0 / H
        quad = ndc_tri(
            [
                (-1 + 8 * px + px / 2, -1 + 4 * py + py / 2),
                (-1 + 40 * px + px / 2, -1 + 4 * py + py / 2),
                (-1 + 40 * px + px / 2, -1 + 20 * py + py / 2),
                (-1 + 8 * px + px / 2, -1 + 20 * py + py / 2),
            ],
            z=0.5,
        )
        idx = np.array([[0, 1, 2], [0, 2, 3]])
        z, tri, _, _ = run_raster(quad, idx, compare=CompareOp.ALWAYS)
        ref = render_reference(quad, idx, W, H, cull="none", compare="always")
        np.testing.assert_array_equal(tri, ref["tri"])


class TestDepth:
    def test_reverse_z_greater_near_wins(self):
        # Two overlapping tris; reverse-Z: larger z = closer. Draw far first
        # and near second, then near first and far second — near wins both.
        near = ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)], z=0.8)
        far = ndc_tri([(0.0, -0.6), (0.6, 0.6), (-0.6, 0.6)], z=0.2)
        for order, near_id in (([0, 1], 1), ([1, 0], 0)):
            clip = np.concatenate([[far, near][i] for i in order])
            idx = np.array([[0, 1, 2], [3, 4, 5]])
            z, tri, _, _ = run_raster(clip, idx)
            ref = render_reference(clip, idx, W, H, cull="none")
            np.testing.assert_array_equal(tri, ref["tri"])
            center = tri[H // 2, W // 2]
            assert center == near_id

    def test_equal_z_later_submission_wins(self):
        a = ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)], z=0.5)
        clip = np.concatenate([a, a])
        idx = np.array([[0, 1, 2], [3, 4, 5]])
        z, tri, _, _ = run_raster(clip, idx, compare=CompareOp.GREATER_OR_EQUAL)
        assert tri[H // 2, W // 2] == 1

    def test_depth_write_off_tests_against_initial(self):
        near = ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)], z=0.8)
        far = ndc_tri([(0.0, -0.6), (0.6, 0.6), (-0.6, 0.6)], z=0.2)
        clip = np.concatenate([near, far])
        idx = np.array([[0, 1, 2], [3, 4, 5]])
        # Write off: far tri still passes (tested vs clear 0.0), drawn last →
        # wins ownership even though nearer tri came first.
        z, tri, _, _ = run_raster(clip, idx, depth_write=False)
        ref = render_reference(clip, idx, W, H, cull="none", depth_write=False)
        np.testing.assert_array_equal(tri, ref["tri"])
        assert tri[H // 2, W // 2] == 1
        np.testing.assert_array_equal(z, np.zeros_like(z))  # never written

    def test_depth_test_disabled_never_writes(self):
        tri_ = ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)], z=0.8)
        idx = np.array([[0, 1, 2]])
        z, tri, _, _ = run_raster(tri_, idx, depth_test=False, depth_clear=0.25)
        assert (tri >= 0).any()
        np.testing.assert_allclose(z, 0.25)


class TestCulling:
    def test_back_face_culled(self):
        # This triangle is CW on screen (det > 0) → back-facing under CCW.
        cw = ndc_tri([(0.0, 0.5), (-0.5, -0.5), (0.5, -0.5)], z=0.5)
        idx = np.array([[0, 1, 2]])
        _, tri, _, _ = run_raster(cw, idx, cull=CullMode.BACK)
        assert (tri == -1).all()
        _, tri, _, _ = run_raster(
            cw, idx, cull=CullMode.BACK, front=FrontFace.CLOCKWISE
        )
        assert (tri >= 0).any()

    def test_front_face_culled(self):
        cw = ndc_tri([(0.0, 0.5), (-0.5, -0.5), (0.5, -0.5)], z=0.5)
        idx = np.array([[0, 1, 2]])
        _, tri, _, _ = run_raster(
            cw, idx, cull=CullMode.FRONT, front=FrontFace.CLOCKWISE
        )
        assert (tri == -1).all()


class TestRandomScenes:
    def test_many_random_triangles_match_oracle(self, rng):
        nv = 60
        pos = rng.uniform(-1.2, 1.2, size=(nv, 2))
        zz = rng.uniform(0.05, 0.95, size=(nv, 1))
        clip = np.concatenate(
            [pos, zz, np.ones((nv, 1))], axis=1
        ).astype(np.float32)
        idx = rng.integers(0, nv, size=(40, 3)).astype(np.int32)
        z, tri, _, _ = run_raster(clip, idx)
        ref = render_reference(clip, idx, W, H, cull="none")
        np.testing.assert_array_equal(tri, ref["tri"])
        np.testing.assert_allclose(z, ref["z"], atol=1e-4)

    def test_binning_capacity_independence(self, rng):
        nv = 30
        pos = rng.uniform(-1, 1, size=(nv, 2))
        clip = np.concatenate(
            [pos, np.full((nv, 1), 0.5), np.ones((nv, 1))], axis=1
        ).astype(np.float32)
        idx = rng.integers(0, nv, size=(16, 3)).astype(np.int32)
        z1, tri1, _, _ = run_raster(clip, idx, entry_budget=64)
        z2, tri2, _, _ = run_raster(clip, idx, entry_budget=4096)
        np.testing.assert_array_equal(tri1, tri2)
        np.testing.assert_array_equal(z1, z2)

    def test_binning_overflow_reported(self, rng):
        # 20 coincident full-screen triangles with capacity 8 → overflow.
        tri_xy = [(-2, -2), (4, -2), (-2, 4)]
        clips = []
        for _ in range(20):
            clips.append(ndc_tri(tri_xy, z=0.5))
        clip = np.concatenate(clips)
        idx = np.arange(60).reshape(20, 3)
        records = setup_triangles(
            jnp.asarray(clip), jnp.asarray(idx, jnp.int32), W, H,
            cull_mode=CullMode.NONE,
        )
        bins = bin_segmented(
            records, slot_corner_data(records), GRID, entry_budget=8
        )
        assert int(bins.overflow) > 0


class TestClipping:
    def test_behind_camera_triangle_clipped(self):
        # One vertex far behind the eye (w < 0): without clipping this would
        # wrap around; with near clip the visible part stays sane.
        clip = np.array(
            [
                [0.0, -0.5, 0.5, 1.0],
                [0.5, 0.5, 0.5, 1.0],
                [0.0, 0.0, -0.5, -1.0],  # behind camera
            ],
            np.float32,
        )
        idx = np.array([[0, 1, 2]])
        z, tri, slot, records = run_raster(clip, idx)
        assert (tri >= 0).any()  # visible part survives
        zc = z[np.asarray(tri) >= 0]
        assert np.isfinite(zc).all() and (zc >= 0).all() and (zc <= 1).all()

    def test_fully_inside_unchanged_by_clip_expansion(self):
        corners = jnp.asarray(
            ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)], z=0.5)
        )[None, :, :]
        obary = jnp.eye(3)[None]
        out_c, out_b, valid = clip_near_w(corners, obary)
        assert bool(valid[0]) and not bool(valid[1])
        np.testing.assert_allclose(out_c[0], corners[0], atol=1e-6)

    def test_fully_behind_dropped(self):
        corners = jnp.asarray(
            [[[0, 0, 0, -1.0], [1, 0, 0, -1.0], [0, 1, 0, -1.0]]], jnp.float32
        )
        out_c, out_b, valid = clip_near_w(corners, jnp.eye(3)[None])
        assert not bool(valid[0]) and not bool(valid[1])


class TestForwardInterp:
    """The production path: raster_segmented + finalize_attrs (gather-free)."""

    def _run(self, clip, idx, vary, compare=CompareOp.GREATER):
        import jax.numpy as jnp
        from zenith.ops import corner_attributes, finalize_attrs

        records = setup_triangles(
            jnp.asarray(clip, jnp.float32), jnp.asarray(idx, jnp.int32),
            W, H, cull_mode=CullMode.NONE,
        )
        flat = jnp.concatenate(
            [jnp.asarray(v, jnp.float32) for v in vary.values()], axis=1
        )
        corner = corner_attributes(records, jnp.asarray(idx, jnp.int32), flat)
        bins = bin_segmented(records, corner, GRID)
        z, acc = raster_segmented(
            bins, GRID, jnp.zeros((H, W), jnp.float32), compare_op=compare,
        )
        layout = [(k, v.shape[1]) for k, v in vary.items()] + [("__front", 1)]
        out, mask, builtins = finalize_attrs(z, acc, layout)
        return np.asarray(z), {k: np.asarray(v) for k, v in out.items()}, np.asarray(mask)

    def test_matches_oracle_full(self, rng):
        nv = 24
        pos = rng.uniform(-1.1, 1.1, size=(nv, 2))
        zz = rng.uniform(0.1, 0.9, size=(nv, 1))
        ww = rng.uniform(0.8, 3.0, size=(nv, 1))
        clip = np.concatenate([pos * ww, zz * ww, ww], axis=1).astype(np.float32)
        idx = rng.integers(0, nv, size=(12, 3)).astype(np.int32)
        vary = {"c": rng.uniform(0, 1, size=(nv, 3)).astype(np.float32)}
        z, out, mask = self._run(clip, idx, vary)
        ref = render_reference(clip, idx, W, H, cull="none", varyings=vary)
        np.testing.assert_array_equal(mask, ref["tri"] >= 0)
        np.testing.assert_allclose(z, ref["z"], atol=1e-4)
        np.testing.assert_allclose(out["c"][mask], ref["c"][mask], atol=2e-3)

    def test_depth_occlusion_with_interp(self):
        near = ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)], z=0.8)
        far = ndc_tri([(0.0, -0.6), (0.6, 0.6), (-0.6, 0.6)], z=0.2)
        clip = np.concatenate([far, near])
        idx = np.array([[0, 1, 2], [3, 4, 5]])
        vary = {"c": np.array([[1, 0, 0]] * 3 + [[0, 1, 0]] * 3, np.float32)}
        z, out, mask = self._run(clip, idx, vary)
        # Center pixel: near (green) wins.
        np.testing.assert_allclose(out["c"][H // 2, W // 2], [0, 1, 0], atol=1e-5)


class TestSegmented:
    """The segmented (uncapped) production path vs the oracle."""

    def _run(self, clip, idx, vary, compare=CompareOp.GREATER):
        import jax.numpy as jnp
        from zenith.ops import (
            bin_segmented,
            corner_attributes,
            raster_segmented,
            finalize_attrs,
        )

        records = setup_triangles(
            jnp.asarray(clip, jnp.float32), jnp.asarray(idx, jnp.int32),
            W, H, cull_mode=CullMode.NONE,
        )
        flat = jnp.concatenate(
            [jnp.asarray(v, jnp.float32) for v in vary.values()], axis=1
        )
        corner = corner_attributes(records, jnp.asarray(idx, jnp.int32), flat)
        bins = bin_segmented(records, corner, GRID)
        z, acc = raster_segmented(
            bins, GRID, jnp.zeros((H, W), jnp.float32), compare_op=compare
        )
        layout = [(k, v.shape[1]) for k, v in vary.items()] + [("__front", 1)]
        out, mask, builtins = finalize_attrs(z, acc, layout)
        return (
            np.asarray(z),
            {k: np.asarray(v) for k, v in out.items()},
            np.asarray(mask),
            np.asarray(bins.overflow),
        )

    def test_matches_oracle(self, rng):
        nv = 24
        pos = rng.uniform(-1.1, 1.1, size=(nv, 2))
        zz = rng.uniform(0.1, 0.9, size=(nv, 1))
        ww = rng.uniform(0.8, 3.0, size=(nv, 1))
        clip = np.concatenate([pos * ww, zz * ww, ww], axis=1).astype(np.float32)
        idx = rng.integers(0, nv, size=(12, 3)).astype(np.int32)
        vary = {"c": rng.uniform(0, 1, size=(nv, 3)).astype(np.float32)}
        z, out, mask, overflow = self._run(clip, idx, vary)
        ref = render_reference(clip, idx, W, H, cull="none", varyings=vary)
        assert overflow == 0
        np.testing.assert_array_equal(mask, ref["tri"] >= 0)
        np.testing.assert_allclose(z, ref["z"], atol=1e-4)
        np.testing.assert_allclose(out["c"][mask], ref["c"][mask], atol=2e-3)

    def _records(self, rng, n_tris=12):
        nv = 24
        pos = rng.uniform(-1.1, 1.1, size=(nv, 2))
        zz = rng.uniform(0.1, 0.9, size=(nv, 1))
        ww = rng.uniform(0.8, 3.0, size=(nv, 1))
        clip = np.concatenate([pos * ww, zz * ww, ww], axis=1).astype(np.float32)
        idx = rng.integers(0, nv, size=(n_tris, 3)).astype(np.int32)
        vary = rng.uniform(0, 1, size=(nv, 3)).astype(np.float32)
        records = setup_triangles(
            jnp.asarray(clip, jnp.float32), jnp.asarray(idx, jnp.int32),
            W, H, cull_mode=CullMode.NONE,
        )
        from zenith.ops import corner_attributes

        corner = corner_attributes(
            records, jnp.asarray(idx, jnp.int32), jnp.asarray(vary)
        )
        return records, corner

    def test_segments_cover_every_entry_exactly(self, rng):
        """The per-tile segment table partitions the live rows: segments are
        contiguous, in tile order, and each tile's rows are exactly the
        records whose AABB overlaps it, in submission order."""
        from zenith.ops import bin_segmented

        records, corner = self._records(rng)
        bins = bin_segmented(records, corner, GRID)
        start = np.asarray(bins.tile_start)
        count = np.asarray(bins.tile_count)
        assert int(bins.overflow) == 0
        np.testing.assert_array_equal(start[1:], start[:-1] + count[:-1])
        assert start[0] == 0
        rows = np.asarray(bins.rows)
        rast = np.asarray(records.rast16)
        aabb = np.asarray(records.aabb)
        valid = np.asarray(records.valid)
        for t in range(GRID.num_tiles):
            ty, tx = divmod(t, GRID.tiles_x)
            x0, y0 = tx * GRID.tile_w, ty * GRID.tile_h
            hits = [
                r for r in range(rast.shape[0])
                if valid[r]
                and min(max(int(np.floor(aabb[r, 0] / GRID.tile_w)), 0), GRID.tiles_x - 1) <= tx
                and min(max(int(np.floor(aabb[r, 2] / GRID.tile_w)), 0), GRID.tiles_x - 1) >= tx
                and min(max(int(np.floor(aabb[r, 1] / GRID.tile_h)), 0), GRID.tiles_y - 1) <= ty
                and min(max(int(np.floor(aabb[r, 3] / GRID.tile_h)), 0), GRID.tiles_y - 1) >= ty
            ]
            assert count[t] == len(hits), (t, x0, y0)
            seg = rows[start[t]:start[t] + count[t], :16]
            np.testing.assert_array_equal(seg, rast[hits])

    def test_empty_tiles_keep_init_content(self):
        """A tile with no entries runs zero loop steps and writes its init
        depth (and zero attribute planes)."""
        from zenith.ops import bin_segmented, corner_attributes

        # One small triangle in the top-left tile only.
        px, py = 2.0 / W, 2.0 / H
        clip = ndc_tri([(-1 + 2 * px, -1 + 2 * py), (-1 + 6 * px, -1 + 2 * py),
                        (-1 + 2 * px, -1 + 6 * py)], z=0.5)
        idx = np.array([[0, 1, 2]], np.int32)
        records = setup_triangles(
            jnp.asarray(clip), jnp.asarray(idx), W, H, cull_mode=CullMode.NONE
        )
        corner = corner_attributes(records, jnp.asarray(idx),
                                   jnp.zeros((3, 0), jnp.float32))
        grid = TileGrid(width=W, height=H, tile_h=8, tile_w=32)
        bins = bin_segmented(records, corner, grid)
        count = np.asarray(bins.tile_count)
        assert count[0] == 1 and count[1:].sum() == 0
        init = jnp.asarray(
            np.random.default_rng(3).uniform(0.6, 0.9, (H, W)).astype(np.float32)
        )
        z, acc = raster_segmented(bins, grid, init, compare_op=CompareOp.ALWAYS)
        z, acc = np.asarray(z), np.asarray(acc)
        np.testing.assert_array_equal(z[:, 32:], np.asarray(init)[:, 32:])
        np.testing.assert_array_equal(acc[:, :, 32:], 0.0)
        assert (acc[-1, :8, :32] > 0).any()

    @pytest.mark.parametrize(
        "budget,tile",
        [(None, (8, 128)), (4096, (8, 128)), (None, (16, 16)),
         (None, (8, 32)), (None, (32, 64))],
    )
    def test_raster_identical_across_budgets_and_tiles(self, rng, budget, tile):
        """Raster output is bit-identical for any entry budget that holds
        every entry and any tile shape: tiles only partition the work."""
        from zenith.ops import bin_segmented

        records, corner = self._records(rng)
        base = bin_segmented(records, corner, GRID)
        z0, acc0 = raster_segmented(base, GRID, jnp.zeros((H, W), jnp.float32))
        grid = TileGrid(width=W, height=H, tile_h=tile[0], tile_w=tile[1])
        bins = bin_segmented(records, corner, grid, entry_budget=budget)
        z1, acc1 = raster_segmented(bins, grid, jnp.zeros((H, W), jnp.float32))
        assert int(base.overflow) == 0 and int(bins.overflow) == 0
        np.testing.assert_array_equal(np.asarray(z0), np.asarray(z1))
        np.testing.assert_array_equal(np.asarray(acc0), np.asarray(acc1))

    def test_huge_record_dense_path(self):
        # A screen-covering triangle takes the huge path (span > span_cap);
        # must still rasterize everywhere, in correct submission order with a
        # small tri drawn after at equal z.
        big = ndc_tri([(-4, -4), (8, -4), (-4, 8)], z=0.5)
        small = ndc_tri([(0.0, -0.5), (0.5, 0.5), (-0.5, 0.5)], z=0.5)
        clip = np.concatenate([big, small])
        idx = np.array([[0, 1, 2], [3, 4, 5]])
        vary = {"c": np.array([[1, 0, 0]] * 3 + [[0, 1, 0]] * 3, np.float32)}
        z, out, mask, overflow = self._run(
            clip, idx, vary, compare=CompareOp.GREATER_OR_EQUAL
        )
        assert overflow == 0
        assert mask.all()  # big tri covers every pixel
        np.testing.assert_allclose(out["c"][0, 0], [1, 0, 0], atol=1e-5)
        # Later small tri wins the EQUAL tie at the center.
        np.testing.assert_allclose(out["c"][H // 2, W // 2], [0, 1, 0], atol=1e-5)

    def test_dense_single_tile_no_cap(self, rng):
        # 300 triangles crammed into one tile: the capped binner dropped
        # these; segmented must keep all (validated via oracle equality).
        nv = 120
        pos = rng.uniform(-0.1, 0.1, size=(nv, 2))  # all in one tile
        zz = rng.uniform(0.1, 0.9, size=(nv, 1))
        clip = np.concatenate(
            [pos, zz, np.ones((nv, 1))], axis=1
        ).astype(np.float32)
        idx = rng.integers(0, nv, size=(300, 3)).astype(np.int32)
        vary = {"c": rng.uniform(0, 1, size=(nv, 3)).astype(np.float32)}
        z, out, mask, overflow = self._run(clip, idx, vary)
        ref = render_reference(clip, idx, W, H, cull="none", varyings=vary)
        assert overflow == 0
        np.testing.assert_array_equal(mask, ref["tri"] >= 0)
        np.testing.assert_allclose(z, ref["z"], atol=1e-4)


class TestInterpolation:
    def test_perspective_correct_varying(self):
        # A "floor" quad receding in depth: w differs per vertex; the
        # interpolated varying must follow the perspective-correct formula,
        # which the oracle implements independently.
        clip = np.array(
            [
                [-0.9, 0.9, 0.5, 1.0],
                [0.9, 0.9, 0.5, 1.0],
                [3.6, -3.6, 2.0, 4.0],
                [-3.6, -3.6, 2.0, 4.0],
            ],
            np.float32,
        )
        idx = np.array([[0, 1, 2], [0, 2, 3]])
        vary = {"t": np.array([[0.0], [0.0], [1.0], [1.0]], np.float32)}
        z, tri, slot, records = run_raster(clip, idx)
        out, mask, builtins = resolve_varyings(
            jnp.asarray(slot),
            records.rast16,
            records.shade16,
            records.tri_id,
            jnp.asarray(idx, jnp.int32),
            {k: jnp.asarray(v) for k, v in vary.items()},
        )
        ref = render_reference(clip, idx, W, H, cull="none", varyings=vary)
        m = np.asarray(mask)
        np.testing.assert_array_equal(m, ref["tri"] >= 0)
        np.testing.assert_allclose(
            np.asarray(out["t"])[m], ref["t"][m], atol=1e-4
        )
        # Perspective correctness: at the screen-space midpoint the value is
        # pulled toward the near (low-w) end — well below the affine 0.5.
        # Analytic: (0.5·0/1 + 0.5·1/4) / (0.5/1 + 0.5/4) = 0.2.
        mid = np.asarray(out["t"])[:, W // 2, 0]
        rows = np.where(m[:, W // 2])[0]
        midrow = rows[len(rows) // 2]
        assert mid[midrow] < 0.45


class TestFusedSetup:
    """setup_with_attrs (production) ≡ setup_triangles + corner_attributes."""

    def test_equivalent_to_split_path(self, rng):
        import jax.numpy as jnp
        from zenith.ops import corner_attributes, setup_with_attrs

        nv = 40
        pos = rng.uniform(-1.3, 1.3, size=(nv, 2))
        zz = rng.uniform(-0.2, 1.1, size=(nv, 1))  # some beyond depth range
        ww = rng.uniform(0.5, 3.0, size=(nv, 1))
        clip = np.concatenate([pos * ww, zz * ww, ww], axis=1).astype(np.float32)
        # a vertex behind the near plane to exercise clipping
        clip[0] = [0.1, 0.1, 2.0, 1.0]  # z > w → clipped
        idx = rng.integers(0, nv, size=(25, 3)).astype(np.int32)
        vary = rng.uniform(0, 1, size=(nv, 5)).astype(np.float32)

        rec_old = setup_triangles(
            jnp.asarray(clip), jnp.asarray(idx), W, H, cull_mode=CullMode.NONE
        )
        corner_old = corner_attributes(rec_old, jnp.asarray(idx), jnp.asarray(vary))
        rec_new, corner_new = setup_with_attrs(
            jnp.asarray(clip), jnp.asarray(idx), jnp.asarray(vary),
            W, H, cull_mode=CullMode.NONE,
        )
        np.testing.assert_array_equal(np.asarray(rec_old.valid), np.asarray(rec_new.valid))
        np.testing.assert_allclose(
            np.asarray(rec_old.rast16), np.asarray(rec_new.rast16), atol=1e-4, rtol=1e-4
        )
        v = np.asarray(rec_new.valid)
        np.testing.assert_allclose(
            np.asarray(corner_old)[v], np.asarray(corner_new)[v], atol=1e-4, rtol=1e-3
        )
