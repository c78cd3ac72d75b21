"""Property sweep: random fixed-function state combinations vs the oracle.

Each dimension (cull, compare op, depth write, strip decode) has its own
focused suite; this sweep exercises random COMBINATIONS on random geometry
— the interactions are where rasterizers rot. (Near clipping is excluded:
the oracle drops rather than clips w<=0 triangles; test_raster covers it.)
"""

import numpy as np
import pytest

import jax.numpy as jnp

from np_reference import render_reference
from zenith.ops import (
    TileGrid,
    bin_segmented,
    corner_attributes,
    raster_segmented,
    setup_triangles,
)
from zenith.ops.draw import assemble_triangles
from zenith.rhi.state import (
    CompareOp,
    CullMode,
    FrontFace,
    InputAssemblyState,
    PrimitiveTopology,
)

W, H = 128, 64
GRID = TileGrid(width=W, height=H, tile_h=8, tile_w=128)

CULLS = [
    (CullMode.NONE, "none"),
    (CullMode.BACK, "back"),
    (CullMode.FRONT, "front"),
]
COMPARES = [
    (CompareOp.GREATER, "greater"),
    (CompareOp.LESS, "less"),
    (CompareOp.GREATER_OR_EQUAL, "greater_or_equal"),
    (CompareOp.ALWAYS, "always"),
]


def _oracle_compare_name(name):
    # np_reference uses slightly different spellings — map if needed.
    return name


@pytest.mark.parametrize("seed", range(8))
def test_random_state_combination_matches_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    cull, cull_name = CULLS[seed % len(CULLS)]
    compare, compare_name = COMPARES[(seed * 3) % len(COMPARES)]
    depth_write = bool(seed % 2)
    use_strip = seed % 4 == 3
    front = FrontFace.COUNTER_CLOCKWISE

    nv = 36
    # Geometry stays strictly in front (w = 1, z in (0, 1)): the NumPy
    # oracle drops any triangle touching w <= 0 rather than clipping it,
    # so near-clip interactions are covered by the dedicated clip tests
    # (test_raster), not this sweep.
    pos = rng.uniform(-1.2, 1.2, size=(nv, 2))
    zz = rng.uniform(0.05, 0.95, size=(nv, 1))
    w_coord = np.ones((nv, 1))
    clip = np.concatenate([pos, zz, w_coord], axis=1).astype(np.float32)
    vary = rng.uniform(0, 1, size=(nv, 3)).astype(np.float32)

    if use_strip:
        strip = rng.integers(0, nv, size=(20,)).astype(np.int32)
        ia = InputAssemblyState(topology=PrimitiveTopology.TRIANGLE_STRIP)
        tris = np.asarray(assemble_triangles(jnp.asarray(strip), ia))
    else:
        tris = rng.integers(0, nv, size=(14, 3)).astype(np.int32)

    records = setup_triangles(
        jnp.asarray(clip), jnp.asarray(tris), W, H,
        cull_mode=cull, front_face=front,
    )
    corner = corner_attributes(records, jnp.asarray(tris), jnp.asarray(vary))
    bins = bin_segmented(records, corner, GRID)
    z, acc = raster_segmented(
        bins, GRID, jnp.zeros((H, W), jnp.float32),
        depth_test=True, depth_write=depth_write, compare_op=compare,
    )
    z = np.asarray(z)
    acc = np.asarray(acc)

    ref = render_reference(
        clip, tris, W, H,
        cull=cull_name, front_face="ccw",
        depth_test=True, depth_write=depth_write,
        compare=_oracle_compare_name(compare_name),
        varyings={"c": vary},
    )
    np.testing.assert_allclose(z, ref["z"], atol=1e-4, err_msg=(
        f"depth mismatch: cull={cull_name} cmp={compare_name} "
        f"write={depth_write} strip={use_strip}"
    ))
    covered = ref["tri"] >= 0
    iw = acc[-1]
    # Coverage must agree exactly where the oracle is covered/uncovered.
    np.testing.assert_array_equal(iw > 0, covered)
    if covered.any():
        interp = acc[:3] / np.maximum(iw, 1e-12)
        got = np.moveaxis(interp, 0, -1)[covered]
        np.testing.assert_allclose(got, ref["c"][covered], atol=2e-3)
