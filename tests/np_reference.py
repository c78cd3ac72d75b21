"""Independent NumPy reference rasterizer — the test oracle.

Implements the same conventions as zenith.ops (Vulkan viewport transform,
y-down framebuffer, pixel centers at +0.5, top-left fill rule, submission-
order depth updates, perspective-correct interpolation) with a deliberately
different, brute-force structure: a per-triangle loop over the full
framebuffer with no binning, no clipping, no tiling. Agreement between the
two is evidence the kernels implement the spec, not that two copies of the
same code agree.
"""

from __future__ import annotations

import numpy as np

_EPS_W = 1e-5

_COMPARES = {
    "never": lambda n, c: np.zeros_like(n, dtype=bool),
    "less": lambda n, c: n < c,
    "equal": lambda n, c: n == c,
    "less_or_equal": lambda n, c: n <= c,
    "greater": lambda n, c: n > c,
    "not_equal": lambda n, c: n != c,
    "greater_or_equal": lambda n, c: n >= c,
    "always": lambda n, c: np.ones_like(n, dtype=bool),
}


def _stencil_apply(op: str, s: np.ndarray, reference: int) -> np.ndarray:
    """One VkStencilOp over a uint stencil plane (8-bit semantics)."""
    if op == "keep":
        return s
    if op == "zero":
        return np.zeros_like(s)
    if op == "replace":
        return np.full_like(s, reference & 0xFF)
    if op == "increment_and_clamp":
        return np.minimum(s + 1, 255)
    if op == "decrement_and_clamp":
        return np.maximum(s - 1, 0)
    if op == "invert":
        return ~s & 0xFF
    if op == "increment_and_wrap":
        return (s + 1) & 0xFF
    if op == "decrement_and_wrap":
        return (s - 1) & 0xFF
    raise ValueError(op)


def render_reference(
    clip: np.ndarray,  # (Nv, 4) clip-space positions
    indices: np.ndarray,  # (T, 3)
    width: int,
    height: int,
    cull: str = "back",  # none|back|front
    front_face: str = "ccw",  # ccw|cw
    depth_test: bool = True,
    depth_write: bool = True,
    compare: str = "greater",
    depth_clear: float = 0.0,
    varyings: "dict[str, np.ndarray] | None" = None,  # name → (Nv, C)
    stencil: "dict | None" = None,
    # stencil = {"front": face, "back": face, "init": (H,W) int or scalar}
    # face = {"compare": str, "reference": int, "compare_mask": int,
    #         "write_mask": int, "fail_op"/"pass_op"/"depth_fail_op": str}
    sample_offset: "tuple[float, float]" = (0.5, 0.5),
):
    """Returns dict with 'z' (H,W), 'tri' (H,W) int32 (-1 background), and
    perspective-correct interpolated varyings (H,W,C); plus 'stencil' (H,W)
    int32 when stencil is enabled (Vulkan order: stencil test → depth test;
    sfail/dpfail/dppass ops per face, masked writes)."""
    varyings = varyings or {}
    clip = np.asarray(clip, np.float64)
    z_buf = np.full((height, width), depth_clear, np.float64)
    tri_buf = np.full((height, width), -1, np.int32)
    s_buf = None
    if stencil is not None:
        init = stencil.get("init", 0)
        s_buf = (
            np.array(init, np.int32).copy()
            if isinstance(init, np.ndarray)
            else np.full((height, width), int(init), np.int32)
        )
    vary_buf = {
        k: np.zeros((height, width, v.shape[1]), np.float64) for k, v in varyings.items()
    }

    xs = np.arange(width, dtype=np.float64)[None, :] + float(sample_offset[0])
    ys = np.arange(height, dtype=np.float64)[:, None] + float(sample_offset[1])
    X = np.broadcast_to(xs, (height, width))
    Y = np.broadcast_to(ys, (height, width))

    cmp_fn = _COMPARES[compare if depth_test else "always"]
    do_write = depth_write and depth_test

    for t, (i0, i1, i2) in enumerate(np.asarray(indices, np.int64)):
        v = clip[[i0, i1, i2]]
        w = v[:, 3]
        if np.any(w <= _EPS_W):
            continue  # the oracle does not clip; tests keep geometry in front
        iw = 1.0 / w
        sx = (v[:, 0] * iw + 1.0) * 0.5 * width
        sy = (v[:, 1] * iw + 1.0) * 0.5 * height
        sz = v[:, 2] * iw

        det = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sx[2] - sx[0]) * (sy[1] - sy[0])
        if det == 0.0:
            continue
        is_cw = det > 0
        front = is_cw if front_face == "cw" else not is_cw
        if cull == "back" and not front:
            continue
        if cull == "front" and front:
            continue
        s = 1.0 if is_cw else -1.0

        cov = np.ones((height, width), dtype=bool)
        evals = []
        for a, b in ((0, 1), (1, 2), (2, 0)):
            A = (sy[a] - sy[b]) * s
            B = (sx[b] - sx[a]) * s
            C = -(A * sx[a] + B * sy[a])
            dx = (sx[b] - sx[a]) * s
            dy = (sy[b] - sy[a]) * s
            tl = (dy < 0) or (dy == 0 and dx > 0)
            e = A * X + B * Y + C
            cov &= (e > 0) | ((e == 0) & tl)
            evals.append(e)
        e01, e12, e20 = evals

        inv_det = 1.0 / abs(det)
        w0 = e12 * inv_det
        w1 = e20 * inv_det
        w2 = e01 * inv_det
        z = w0 * sz[0] + w1 * sz[1] + w2 * sz[2]
        cov &= (z >= 0.0) & (z <= 1.0)

        if s_buf is not None:
            face = stencil["front"] if front else stencil["back"]
            cmask = face.get("compare_mask", 0xFF)
            wmask = face.get("write_mask", 0xFF)
            ref = face.get("reference", 0)
            scmp = _COMPARES[face.get("compare", "never")]
            ref_m = np.full_like(s_buf, ref & cmask)
            spass = cov & scmp(ref_m, s_buf & cmask)
            passed = spass & cmp_fn(z, z_buf)
            snew = s_buf.copy()
            sfail_px = cov & ~spass
            dfail_px = spass & ~passed
            snew[sfail_px] = _stencil_apply(
                face.get("fail_op", "keep"), s_buf, ref
            )[sfail_px]
            snew[dfail_px] = _stencil_apply(
                face.get("depth_fail_op", "keep"), s_buf, ref
            )[dfail_px]
            snew[passed] = _stencil_apply(
                face.get("pass_op", "keep"), s_buf, ref
            )[passed]
            s_buf = (s_buf & ~wmask) | (snew & wmask)
        else:
            passed = cov & cmp_fn(z, z_buf)
        if do_write:
            z_buf[passed] = z[passed]
        tri_buf[passed] = t

        if varyings:
            pw0 = w0 * iw[0]
            pw1 = w1 * iw[1]
            pw2 = w2 * iw[2]
            denom = pw0 + pw1 + pw2
            denom[denom == 0] = 1.0
            a_ = pw0 / denom
            b_ = pw1 / denom
            c_ = pw2 / denom
            for k, vv in varyings.items():
                val = (
                    a_[..., None] * vv[i0][None, None, :]
                    + b_[..., None] * vv[i1][None, None, :]
                    + c_[..., None] * vv[i2][None, None, :]
                )
                vary_buf[k][passed] = val[passed]

    out = {"z": z_buf.astype(np.float32), "tri": tri_buf}
    if s_buf is not None:
        out["stencil"] = s_buf.astype(np.int32)
    for k, v in vary_buf.items():
        out[k] = v.astype(np.float32)
    return out
