"""Widened property-based oracle matrix (VERDICT r4 next #7): ≥5
ORTHOGONAL randomized dimensions drawn independently per seed —

  1. topology          triangle list / strip / strip + primitive restart
  2. facing            cull mode × front-face winding
  3. depth             all 8 compare ops × write on/off
  4. stencil           off / one-face / two-face with random ops, reference,
                       compare & write masks
  5. sample position   pixel center or a random MSAA-style offset
                       (quantized to 1/16 — the Vulkan standard-position
                       lattice), oracle evaluated at the same offset
  6. varyings          random per-vertex attributes, perspective-checked

Every drawn value is derived from ONE printed seed; a failure reproduces
with `pytest "tests/test_property_matrix.py::test_matrix[<seed>]"` and the
assertion message carries the full drawn configuration (shrink by editing
the dims dict). The oracle is tests/np_reference.py — an independent
brute-force rasterizer."""

from __future__ import annotations

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
    StencilOp,
    StencilOpState,
)

W, H = 128, 64
GRID = TileGrid(width=W, height=H, tile_h=8, tile_w=128)

CULLS = {CullMode.NONE: "none", CullMode.BACK: "back",
         CullMode.FRONT: "front"}
FRONTS = {FrontFace.COUNTER_CLOCKWISE: "ccw", FrontFace.CLOCKWISE: "cw"}
COMPARES = list(CompareOp)
STENCIL_OPS = list(StencilOp)
STENCIL_COMPARES = [CompareOp.ALWAYS, CompareOp.EQUAL, CompareOp.NOT_EQUAL,
                    CompareOp.LESS, CompareOp.GREATER_OR_EQUAL,
                    CompareOp.NEVER]


def _rand_face(rng) -> StencilOpState:
    return StencilOpState(
        fail_op=STENCIL_OPS[rng.integers(len(STENCIL_OPS))],
        pass_op=STENCIL_OPS[rng.integers(len(STENCIL_OPS))],
        depth_fail_op=STENCIL_OPS[rng.integers(len(STENCIL_OPS))],
        compare_op=STENCIL_COMPARES[rng.integers(len(STENCIL_COMPARES))],
        compare_mask=int(rng.integers(0, 256)),
        write_mask=int(rng.integers(1, 256)),
        reference=int(rng.integers(0, 256)),
    )


def _face_dict(st: StencilOpState) -> dict:
    return {
        "compare": st.compare_op.value,
        "reference": st.reference,
        "compare_mask": st.compare_mask,
        "write_mask": st.write_mask,
        "fail_op": st.fail_op.value,
        "pass_op": st.pass_op.value,
        "depth_fail_op": st.depth_fail_op.value,
    }


def _draw_config(seed: int):
    rng = np.random.default_rng(seed)
    dims = {
        "topology": ["list", "strip", "strip_restart"][rng.integers(3)],
        "cull": list(CULLS)[rng.integers(3)],
        "front": list(FRONTS)[rng.integers(2)],
        "compare": COMPARES[rng.integers(len(COMPARES))],
        "depth_write": bool(rng.integers(2)),
        "stencil": ["off", "one_face", "two_face"][rng.integers(3)],
        "offset": (
            (0.5, 0.5) if rng.integers(2) == 0
            else (float(rng.integers(1, 16)) / 16.0,
                  float(rng.integers(1, 16)) / 16.0)
        ),
    }
    return rng, dims


@pytest.mark.parametrize("seed", range(24))
def test_matrix(seed):
    rng, dims = _draw_config(3000 + seed)
    label = f"seed={3000 + seed} dims={dims}"

    nv = 36
    pos = rng.uniform(-1.2, 1.2, size=(nv, 2))
    zz = rng.uniform(0.05, 0.95, size=(nv, 1))
    clip = np.concatenate(
        [pos, zz, np.ones((nv, 1))], axis=1
    ).astype(np.float32)
    vary = rng.uniform(0, 1, size=(nv, 3)).astype(np.float32)

    if dims["topology"] == "list":
        tris = rng.integers(0, nv, size=(14, 3)).astype(np.int32)
    else:
        strip = rng.integers(0, nv, size=(22,)).astype(np.int32)
        restart = dims["topology"] == "strip_restart"
        if restart:
            strip[rng.integers(3, 19, size=2)] = -1
        ia = InputAssemblyState(
            topology=PrimitiveTopology.TRIANGLE_STRIP,
            primitive_restart=restart,
        )
        tris = np.asarray(assemble_triangles(jnp.asarray(strip), ia))

    front_st = back_st = None
    stencil_init = int(rng.integers(0, 256))
    if dims["stencil"] != "off":
        front_st = _rand_face(rng)
        back_st = _rand_face(rng) if dims["stencil"] == "two_face" \
            else front_st

    records = setup_triangles(
        jnp.asarray(clip), jnp.asarray(tris), W, H,
        cull_mode=dims["cull"], front_face=dims["front"],
    )
    corner = corner_attributes(records, jnp.asarray(tris),
                               jnp.asarray(vary))
    bins = bin_segmented(records, corner, GRID)
    kwargs = dict(
        depth_test=True, depth_write=dims["depth_write"],
        compare_op=dims["compare"], sample_offset=dims["offset"],
    )
    if front_st is not None:
        z, acc, sten = raster_segmented(
            bins, GRID, jnp.zeros((H, W), jnp.float32),
            init_stencil=jnp.full((H, W), stencil_init, jnp.int32),
            stencil_front=front_st, stencil_back=back_st, **kwargs,
        )
        sten = np.asarray(sten)
    else:
        z, acc = raster_segmented(
            bins, GRID, jnp.zeros((H, W), jnp.float32), **kwargs,
        )
        sten = None
    z = np.asarray(z)
    acc = np.asarray(acc)

    ref = render_reference(
        clip, tris, W, H,
        cull=CULLS[dims["cull"]], front_face=FRONTS[dims["front"]],
        depth_test=True, depth_write=dims["depth_write"],
        compare=dims["compare"].value,
        varyings={"c": vary},
        sample_offset=dims["offset"],
        stencil=(
            None if front_st is None else {
                "front": _face_dict(front_st),
                "back": _face_dict(back_st),
                "init": stencil_init,
            }
        ),
    )
    np.testing.assert_allclose(z, ref["z"], atol=1e-4,
                               err_msg=f"depth mismatch: {label}")
    covered = ref["tri"] >= 0
    iw = acc[-1]
    np.testing.assert_array_equal(
        iw > 0, covered, err_msg=f"coverage mismatch: {label}"
    )
    if sten is not None:
        np.testing.assert_array_equal(
            sten, ref["stencil"], err_msg=f"stencil mismatch: {label}"
        )
    if covered.any():
        interp = acc[:3] / np.maximum(iw, 1e-12)
        got = np.moveaxis(interp, 0, -1)[covered]
        np.testing.assert_allclose(
            got, ref["c"][covered], atol=2e-3,
            err_msg=f"varying mismatch: {label}",
        )


# -- dimension 7: random blend equations vs an independent numpy oracle ------

_FACTORS = None  # populated lazily from the enum


def _np_factor(name, src, dst, consts):
    s_a = src[..., 3:4]
    d_a = dst[..., 3:4]
    return {
        "zero": np.zeros_like(src),
        "one": np.ones_like(src),
        "src_color": src,
        "one_minus_src_color": 1.0 - src,
        "dst_color": dst,
        "one_minus_dst_color": 1.0 - dst,
        "src_alpha": np.broadcast_to(s_a, src.shape),
        "one_minus_src_alpha": np.broadcast_to(1.0 - s_a, src.shape),
        "dst_alpha": np.broadcast_to(d_a, src.shape),
        "one_minus_dst_alpha": np.broadcast_to(1.0 - d_a, src.shape),
    }[name]


def _np_blend_op(name, a, b):
    return {
        "add": a + b,
        "subtract": a - b,
        "reverse_subtract": b - a,
        "min": np.minimum(a, b),
        "max": np.maximum(a, b),
    }[name]


@pytest.mark.parametrize("seed", range(12))
def test_random_blend_equation(seed):
    """Random (factors × ops × write mask) through apply_color_output vs an
    independent numpy statement of the Vulkan blend equation (spec 28.1)."""
    from zenith.ops.blend import apply_color_output
    from zenith.rhi.state import BlendFactor, BlendOp, ColorAttachmentDesc

    rng = np.random.default_rng(7000 + seed)
    factors = list(BlendFactor)
    ops = list(BlendOp)
    desc = ColorAttachmentDesc(
        blend_enable=True,
        src_color_blend=factors[rng.integers(len(factors))],
        dst_color_blend=factors[rng.integers(len(factors))],
        src_alpha_blend=factors[rng.integers(len(factors))],
        dst_alpha_blend=factors[rng.integers(len(factors))],
        color_blend_op=ops[rng.integers(len(ops))],
        alpha_blend_op=ops[rng.integers(len(ops))],
        write_mask=tuple(bool(b) for b in rng.integers(0, 2, size=4)),
    )
    label = f"seed={7000 + seed} desc={desc}"
    src = rng.uniform(0, 1, size=(8, 16, 4)).astype(np.float32)
    dst = rng.uniform(0, 1, size=(8, 16, 4)).astype(np.float32)
    mask = rng.integers(0, 2, size=(8, 16)).astype(bool)

    got = np.asarray(apply_color_output(
        jnp.asarray(dst), jnp.asarray(src), jnp.asarray(mask), desc,
        (0.0, 0.0, 0.0, 0.0),
    ))

    scf = _np_factor(desc.src_color_blend.value, src, dst, None)
    dcf = _np_factor(desc.dst_color_blend.value, src, dst, None)
    saf = _np_factor(desc.src_alpha_blend.value, src, dst, None)
    daf = _np_factor(desc.dst_alpha_blend.value, src, dst, None)
    rgb = _np_blend_op(desc.color_blend_op.value,
                       src[..., :3] * scf[..., :3],
                       dst[..., :3] * dcf[..., :3])
    alpha = _np_blend_op(desc.alpha_blend_op.value,
                         src[..., 3:4] * saf[..., 3:4],
                         dst[..., 3:4] * daf[..., 3:4])
    ref = np.concatenate([rgb, alpha], axis=-1)
    for k in range(4):
        if not desc.write_mask[k]:
            ref[..., k] = dst[..., k]
    ref = np.where(mask[..., None], ref, dst)
    np.testing.assert_allclose(got, ref, atol=1e-5,
                               err_msg=f"blend mismatch: {label}")
