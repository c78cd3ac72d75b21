"""Vertex transform, near clipping, and triangle setup.

This is the geometry front-end of the software rasterizer — the part of the
Vulkan fixed-function pipeline (vertex fetch → clip → viewport → triangle
setup) that the reference gets from the GPU driver. Everything here is dense
vectorized jnp over all triangles at once (the vertex transform itself is
one matmul).

Outputs are static-shape *triangle records* consumed by binning and the
raster kernel (ops.raster):

- ``rast16``  (R, 16) f32 — the raster core record (see RAST_* indices):
  three oriented edge equations (inside > 0), top-left flags, 1/|det|, and
  per-corner NDC depth. This is the only data the Pass-A kernel streams.
- ``shade16`` (R, 16) f32 — the shading record (SHADE_* indices): per-corner
  1/w and barycentric coordinates w.r.t. the ORIGINAL triangle (identity for
  unclipped triangles; blended for near-clipped sub-triangles), plus the
  front-facing flag. Gathered per-pixel in Pass B.
- ``tri_id``  (R,) i32 — original triangle index (for vertex-attribute
  gather in Pass B).
- ``valid``   (R,) bool, ``aabb`` (R, 4) f32 — for binning.

R = 2 × number of input triangles: near clipping uses a static 2× expansion
(a triangle crossing the near plane yields up to 2 sub-triangles; fully
inside/outside triangles leave the second slot invalid).

Rasterization conventions (for per-pixel parity with Vulkan):
- framebuffer coords: x right, y down, pixel centers at (px+0.5, py+0.5);
- winding: det = (x1-x0)(y2-y0)-(x2-x0)(y1-y0) > 0 ⇔ clockwise on screen;
  front-facing per RasterizationState.front_face (Vulkan spec 27.x).
- fill rule: top-left (edge e == 0 counts iff top or left edge).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from zenith.rhi.state import CullMode, FrontFace

# rast16 column indices.
RAST_A01, RAST_B01, RAST_C01 = 0, 1, 2
RAST_A12, RAST_B12, RAST_C12 = 3, 4, 5
RAST_A20, RAST_B20, RAST_C20 = 6, 7, 8
RAST_TL01, RAST_TL12, RAST_TL20 = 9, 10, 11
RAST_INV_DET = 12
RAST_Z0, RAST_Z1, RAST_Z2 = 13, 14, 15

# shade16 column indices.
SHADE_IW0, SHADE_IW1, SHADE_IW2 = 0, 1, 2
SHADE_B0X, SHADE_B0Y = 3, 4
SHADE_B1X, SHADE_B1Y = 5, 6
SHADE_B2X, SHADE_B2Y = 7, 8
SHADE_FRONT = 9

NEAR_W_EPS = 1e-5


class TriangleRecords(NamedTuple):
    rast16: jnp.ndarray  # (R, 16) f32
    shade16: jnp.ndarray  # (R, 16) f32
    tri_id: jnp.ndarray  # (R,) i32
    valid: jnp.ndarray  # (R,) bool
    aabb: jnp.ndarray  # (R, 4) f32: xmin, ymin, xmax, ymax (pixels)


def setup_with_attrs(
    clip_positions: jnp.ndarray,  # (Nv, 4)
    indices: jnp.ndarray,  # (T, 3)
    varyings: jnp.ndarray,  # (Nv, A) flattened vertex-stage outputs
    width: int,
    height: int,
    cull_mode: CullMode = CullMode.BACK,
    front_face: FrontFace = FrontFace.COUNTER_CLOCKWISE,
    viewport: "tuple | None" = None,
    depth_bias: "tuple[float, float] | None" = None,  # (constant, slope)
    depth_clamp: bool = False,
) -> "tuple[TriangleRecords, jnp.ndarray]":
    """Fused triangle setup + corner-attribute production.

    The production path: gathers (clip | varyings) per corner ONCE and
    carries the full payload through the near clipper (lerping attributes
    directly instead of barycentric bookkeeping), then builds both the
    raster records and the (R, 3, A+2) corner-interpolation data
    [attr·iw …, front·iw, iw] in one pass. Compared to setup_triangles +
    corner_attributes this removes one gather per stage.
    """
    indices = indices.astype(jnp.int32)
    t = indices.shape[0]
    a = varyings.shape[1]
    combined = jnp.concatenate(
        [clip_positions.astype(jnp.float32), varyings.astype(jnp.float32)], axis=1
    )
    corners = jnp.take(combined, indices.reshape(-1), axis=0).reshape(t, 3, 4 + a)

    # depth_clamp disables near/far z clipping (Vulkan 27.4: primitives are
    # not clipped against the z planes when depthClampEnable is set); only
    # the w > 0 clip remains, which keeps screen coordinates finite.
    corners2, valid = _clip_payload(corners, clamp_z=depth_clamp)
    tri_id = jnp.concatenate(
        [jnp.arange(t, dtype=jnp.int32), jnp.arange(t, dtype=jnp.int32)]
    )

    records = _records_from_corners(
        corners2[..., :4], valid, tri_id, width, height,
        cull_mode, front_face, viewport,
        depth_bias=depth_bias, depth_clamp=depth_clamp,
    )

    # Corner interpolation data, FLAT 2D corner-major (R, 3·(A+2)):
    # per corner, [attr·iw…, front·iw, iw]. Built (and materialized) 2D
    # deliberately: the 2D flat form is exactly the
    # layout every consumer reshapes to anyway (binning's merged stream,
    # the raster kernels' 3 corner blocks of A+2 columns).
    w = jnp.maximum(corners2[..., 3], NEAR_W_EPS)  # (R, 3)
    iw = 1.0 / w
    front = records.shade16[:, SHADE_FRONT][:, None]  # (R, 1)
    blocks = []
    for c in range(3):
        iw_c = iw[:, c][:, None]
        blocks.append(corners2[:, c, 4:] * iw_c)  # (R, A)
        blocks.append(front * iw_c)
        blocks.append(iw_c)
    corner_flat = jnp.concatenate(blocks, axis=1)
    return records, corner_flat.astype(jnp.float32)


def setup_lines_with_attrs(
    clip_positions: jnp.ndarray,  # (Nv, 4)
    segments: jnp.ndarray,  # (L, 2) endpoint indices
    varyings: jnp.ndarray,  # (Nv, A)
    width: int,
    height: int,
    line_width: float = 1.0,
    viewport: "tuple | None" = None,
    depth_clamp: bool = False,
    seg_valid: "jnp.ndarray | None" = None,  # (L,) extra mask (wireframe cull)
) -> "tuple[TriangleRecords, jnp.ndarray]":
    """Line setup: each segment expands to a screen-space rectangle of
    ``line_width`` pixels (two triangles sharing a diagonal; the top-left
    rule keeps the seam single-covered), which then rides the ordinary
    triangle binning/raster/shade path — no line-specific kernels.

    Matches Vulkan *rectangular* line rasterization (spec 27.6, strictLines):
    a lineWidth-wide rectangle centered on the segment with butt caps.
    Attributes and depth are carried per endpoint and duplicated across the
    width, so interpolation is perspective-correct along the line and
    constant across it — exactly the line interpolation equations. Lines are
    never culled and always front-facing. Returns (records, corner_data)
    with R = 2L, shaped like ``setup_with_attrs`` output.
    """
    segments = segments.astype(jnp.int32)
    l = segments.shape[0]
    a = varyings.shape[1]
    combined = jnp.concatenate(
        [clip_positions.astype(jnp.float32), varyings.astype(jnp.float32)],
        axis=1,
    )
    ends = jnp.take(combined, segments.reshape(-1), axis=0).reshape(l, 2, 4 + a)

    # Near clip (z ≤ w, or w > 0 only under depth clamp) — a clipped segment
    # stays one segment, so no expansion slot is needed.
    if depth_clamp:
        d = ends[..., 3]
    else:
        d = ends[..., 3] - ends[..., 2]
    inside = d > NEAR_W_EPS  # (L, 2)
    valid = inside[:, 0] | inside[:, 1]
    if seg_valid is not None:
        valid = valid & seg_valid
    denom = d[:, 0] - d[:, 1]
    denom = jnp.where(jnp.abs(denom) > 1e-20, denom, 1.0)
    t = jnp.clip((d[:, 0] - NEAR_W_EPS) / denom, 0.0, 1.0)[:, None]
    crossing = ends[:, 0] + (ends[:, 1] - ends[:, 0]) * t
    e0 = jnp.where(inside[:, 0, None], ends[:, 0], crossing)
    e1 = jnp.where(inside[:, 1, None], ends[:, 1], crossing)

    # Perspective divide + viewport (same mapping as _records_from_corners).
    pts = jnp.stack([e0, e1], axis=1)  # (L, 2, 4+A)
    w = jnp.maximum(pts[..., 3], NEAR_W_EPS)
    iw2 = 1.0 / w  # (L, 2)
    ndc = pts[..., :3] * iw2[..., None]
    if viewport is not None:
        vx0, vy0, full_w, full_h = viewport
    else:
        vx0, vy0, full_w, full_h = 0, 0, width, height
    px = (ndc[..., 0] + 1.0) * (0.5 * full_w) - vx0  # (L, 2)
    py = (ndc[..., 1] + 1.0) * (0.5 * full_h) - vy0
    pz = ndc[..., 2]

    # Rectangle expansion: offset ±(line_width/2) along the screen normal.
    dx = px[:, 1] - px[:, 0]
    dy = py[:, 1] - py[:, 0]
    ln = jnp.sqrt(dx * dx + dy * dy)
    ok = ln > 1e-6  # zero-length lines produce no fragments (Vulkan 27.6)
    valid = valid & ok
    hw = 0.5 * float(line_width)
    inv_ln = jnp.where(ok, 1.0 / jnp.where(ok, ln, 1.0), 0.0)
    nx = -dy * inv_ln * hw
    ny = dx * inv_ln * hw

    # Quad corners: A_e = endpoint e shifted +n, B_e = shifted −n.
    # Triangles (A0, B0, B1) and (A0, B1, A1); each record corner carries its
    # source endpoint's z / 1/w / attributes.
    def corner(e, sign):
        return px[:, e] + sign * nx, py[:, e] + sign * ny

    ax0, ay0 = corner(0, 1.0)
    bx0, by0 = corner(0, -1.0)
    ax1, ay1 = corner(1, 1.0)
    bx1, by1 = corner(1, -1.0)

    sx = jnp.concatenate([
        jnp.stack([ax0, bx0, bx1], axis=1),
        jnp.stack([ax0, bx1, ax1], axis=1),
    ])
    sy = jnp.concatenate([
        jnp.stack([ay0, by0, by1], axis=1),
        jnp.stack([ay0, by1, ay1], axis=1),
    ])
    # Source endpoint per corner: tri 1 → (0, 0, 1), tri 2 → (0, 1, 1).
    def per_endpoint(vals):  # (L, 2) → (2L, 3)
        return jnp.concatenate([
            jnp.stack([vals[:, 0], vals[:, 0], vals[:, 1]], axis=1),
            jnp.stack([vals[:, 0], vals[:, 1], vals[:, 1]], axis=1),
        ])

    sz = per_endpoint(pz)
    iw = per_endpoint(iw2)
    valid2 = jnp.concatenate([valid, valid])
    tri_id = jnp.concatenate(
        [jnp.arange(l, dtype=jnp.int32), jnp.arange(l, dtype=jnp.int32)]
    )
    records = _edge_setup(
        sx, sy, sz, iw, valid2, tri_id, width, height,
        CullMode.NONE, FrontFace.COUNTER_CLOCKWISE,
        depth_clamp=depth_clamp, force_front=True,
    )

    attrs2 = pts[..., 4:]  # (L, 2, A)
    # Flat 2D corner-major (2L, 3·(A+2)) — see setup_with_attrs for why
    # rank-3 corner data must never materialize. Corner k of rect-triangle
    # 0 carries endpoint (0, 0, 1); of triangle 1, endpoint (0, 1, 1).
    l0 = attrs2.shape[0]
    halves = []
    for j, ends_idx in enumerate(((0, 0, 1), (0, 1, 1))):
        iw_j = iw[j * l0:(j + 1) * l0]
        blocks = []
        for c, e in enumerate(ends_idx):
            iw_c = iw_j[:, c][:, None]
            blocks.append(attrs2[:, e, :] * iw_c)
            blocks.append(iw_c)  # front ≡ 1 → front·iw = iw
            blocks.append(iw_c)
        halves.append(jnp.concatenate(blocks, axis=1))
    corner_flat = jnp.concatenate(halves, axis=0)
    return records, corner_flat.astype(jnp.float32)


def setup_points_with_attrs(
    clip_positions: jnp.ndarray,  # (Nv, 4)
    point_indices: jnp.ndarray,  # (P,) vertex indices
    varyings: jnp.ndarray,  # (Nv, A)
    width: int,
    height: int,
    point_sizes: "jnp.ndarray | None" = None,  # (Nv,) pixels (PointSize)
    viewport: "tuple | None" = None,
    depth_clamp: bool = False,
    pt_valid: "jnp.ndarray | None" = None,  # (P,) extra mask (polygon cull)
) -> "tuple[TriangleRecords, jnp.ndarray]":
    """Point setup: each point expands to a pointSize × pointSize screen-
    space square centered on the vertex (Vulkan 27.5), as two triangles on
    the ordinary raster path. ``point_sizes`` is the per-vertex PointSize
    builtin (vertex shaders emit ``point_size``); defaults to 1.0.
    Returns (records, corner_data) with R = 2P."""
    point_indices = point_indices.reshape(-1).astype(jnp.int32)
    p = point_indices.shape[0]
    a = varyings.shape[1]
    combined = jnp.concatenate(
        [clip_positions.astype(jnp.float32), varyings.astype(jnp.float32)],
        axis=1,
    )
    pts = jnp.take(combined, point_indices, axis=0)  # (P, 4+A)
    if point_sizes is not None:
        sizes = jnp.take(
            point_sizes.reshape(-1).astype(jnp.float32), point_indices, axis=0
        )
    else:
        sizes = jnp.ones((p,), jnp.float32)

    if depth_clamp:
        d = pts[:, 3]
    else:
        d = pts[:, 3] - pts[:, 2]
    valid = d > NEAR_W_EPS  # points are not clipped partially — in or out
    if pt_valid is not None:
        valid = valid & pt_valid

    w = jnp.maximum(pts[:, 3], NEAR_W_EPS)
    iw1 = 1.0 / w
    ndc = pts[:, :3] * iw1[:, None]
    if viewport is not None:
        vx0, vy0, full_w, full_h = viewport
    else:
        vx0, vy0, full_w, full_h = 0, 0, width, height
    cx = (ndc[:, 0] + 1.0) * (0.5 * full_w) - vx0
    cy = (ndc[:, 1] + 1.0) * (0.5 * full_h) - vy0
    cz = ndc[:, 2]
    h = 0.5 * jnp.maximum(sizes, 1e-3)

    # Square corners CW on screen: (−,−) (+,−) (+,+) (−,+); triangles
    # (c0, c1, c2) and (c0, c2, c3).
    xs = (cx - h, cx + h, cx + h, cx - h)
    ys = (cy - h, cy - h, cy + h, cy + h)
    sx = jnp.concatenate([
        jnp.stack([xs[0], xs[1], xs[2]], axis=1),
        jnp.stack([xs[0], xs[2], xs[3]], axis=1),
    ])
    sy = jnp.concatenate([
        jnp.stack([ys[0], ys[1], ys[2]], axis=1),
        jnp.stack([ys[0], ys[2], ys[3]], axis=1),
    ])

    def dup(v):  # (P,) → (2P, 3) constant across corners
        v3 = jnp.broadcast_to(v[:, None], (p, 3))
        return jnp.concatenate([v3, v3])

    sz = dup(cz)
    iw = dup(iw1)
    valid2 = jnp.concatenate([valid, valid])
    tri_id = jnp.concatenate(
        [jnp.arange(p, dtype=jnp.int32), jnp.arange(p, dtype=jnp.int32)]
    )
    records = _edge_setup(
        sx, sy, sz, iw, valid2, tri_id, width, height,
        CullMode.NONE, FrontFace.COUNTER_CLOCKWISE,
        depth_clamp=depth_clamp, force_front=True,
    )

    # Flat 2D corner-major (2P, 3·(A+2)) — see setup_with_attrs for why
    # rank-3 corner data must never materialize. Attributes, 1/w and the
    # front flag (≡1) are constant across a point's corners.
    iw1c = iw1[:, None]  # (P, 1)
    attr_iw = pts[:, 4:] * iw1c  # (P, A)
    one_tri = jnp.concatenate([attr_iw, iw1c, iw1c] * 3, axis=1)
    corner_flat = jnp.concatenate([one_tri, one_tri], axis=0)
    return records, corner_flat.astype(jnp.float32)


def triangle_facing(
    clip_positions: jnp.ndarray,  # (Nv, 4)
    indices: jnp.ndarray,  # (T, 3)
    front_face: FrontFace,
) -> "tuple[jnp.ndarray, jnp.ndarray]":
    """(front, degenerate) facing classification per triangle in NDC — used
    by wireframe/point polygon modes, where Vulkan culls by the POLYGON's
    facing before decomposing it into lines/points (spec 27.7.1). Sign of
    the screen determinant equals the NDC determinant (the viewport scale is
    positive); triangles with a vertex behind w ≈ 0 are classified from the
    guarded divide — acceptable for a cull decision on a debug draw mode."""
    indices = indices.astype(jnp.int32)
    t = indices.shape[0]
    corners = jnp.take(
        clip_positions.astype(jnp.float32), indices.reshape(-1), axis=0
    ).reshape(t, 3, 4)
    w = jnp.maximum(corners[..., 3], NEAR_W_EPS)
    nx = corners[..., 0] / w
    ny = corners[..., 1] / w
    det = (nx[:, 1] - nx[:, 0]) * (ny[:, 2] - ny[:, 0]) - (
        nx[:, 2] - nx[:, 0]
    ) * (ny[:, 1] - ny[:, 0])
    is_cw = det > 0.0
    front = is_cw if front_face == FrontFace.CLOCKWISE else ~is_cw
    return front, det == 0.0


def _clip_payload(corners: jnp.ndarray, w_eps: float = NEAR_W_EPS,
                  clamp_z: bool = False):
    """clip_near_w generalized to an arbitrary per-corner payload
    (xyzw | attrs…): lerp everything across the z ≤ w plane (or, with
    ``clamp_z``, across w > 0 only — depth clamp disables z clipping)."""
    if clamp_z:
        d = corners[..., 3]
    else:
        d = corners[..., 3] - corners[..., 2]
    inside = d > w_eps
    c = inside.sum(axis=1)

    rot1 = jnp.argmax(inside, axis=1)
    rot2 = (jnp.argmin(inside, axis=1) + 1) % 3
    rot = jnp.where(c == 1, rot1, jnp.where(c == 2, rot2, 0))
    idx = (rot[:, None] + jnp.arange(3)[None, :]) % 3
    v = jnp.take_along_axis(corners, idx[:, :, None], axis=1)
    dv = v[..., 3] if clamp_z else v[..., 3] - v[..., 2]

    def isect(i, j):
        denom = dv[:, i] - dv[:, j]
        denom = jnp.where(jnp.abs(denom) > 1e-20, denom, 1.0)
        tt = jnp.clip((dv[:, i] - w_eps) / denom, 0.0, 1.0)[:, None]
        return v[:, i] + (v[:, j] - v[:, i]) * tt

    p01 = isect(0, 1)
    p12 = isect(1, 2)
    p02 = isect(0, 2)

    full = jnp.stack([v[:, 0], v[:, 1], v[:, 2]], 1)
    one = jnp.stack([v[:, 0], p01, p02], 1)
    two_a = jnp.stack([v[:, 0], v[:, 1], p12], 1)
    two_b = jnp.stack([v[:, 0], p12, p02], 1)

    c_ = c[:, None, None]
    out1 = jnp.where(c_ == 3, full, jnp.where(c_ == 2, two_a, one))
    corners2 = jnp.concatenate([out1, two_b], axis=0)
    valid = jnp.concatenate([c >= 1, c == 2], axis=0)
    return corners2, valid


def _records_from_corners(
    corners: jnp.ndarray,  # (R, 3, 4) clipped clip-space positions
    valid: jnp.ndarray,
    tri_id: jnp.ndarray,
    width: int,
    height: int,
    cull_mode: CullMode,
    front_face: FrontFace,
    viewport: "tuple | None",
    depth_bias: "tuple[float, float] | None" = None,
    depth_clamp: bool = False,
) -> TriangleRecords:
    """Viewport transform + edge setup shared by both setup paths.

    ``depth_bias`` = (constant, slope) applies the fixed-function polygon
    offset (reference RasterizationState, pipeline.rs:520-523; Vulkan spec
    27.7.3): o = constant·r + slope·m, with m = max(|dz/dx|, |dz/dy|) from
    the triangle's z plane and r = one ULP at the triangle's depth range
    (float depth buffer). ``depth_clamp`` disables the whole-triangle
    depth-range cull (the per-fragment clamp happens in the raster kernel).
    """
    w = jnp.maximum(corners[..., 3], NEAR_W_EPS)
    iw = 1.0 / w
    ndc = corners[..., :3] * iw[..., None]
    if viewport is not None:
        vx0, vy0, full_w, full_h = viewport
    else:
        vx0, vy0, full_w, full_h = 0, 0, width, height
    sx = (ndc[..., 0] + 1.0) * (0.5 * full_w) - vx0
    sy = (ndc[..., 1] + 1.0) * (0.5 * full_h) - vy0
    sz = ndc[..., 2]
    return _edge_setup(
        sx, sy, sz, iw, valid, tri_id, width, height,
        cull_mode, front_face, depth_bias=depth_bias, depth_clamp=depth_clamp,
    )


def _edge_setup(
    sx: jnp.ndarray,  # (R, 3) screen-space corner x (pixels)
    sy: jnp.ndarray,
    sz: jnp.ndarray,  # (R, 3) NDC depth
    iw: jnp.ndarray,  # (R, 3) 1/w per corner
    valid: jnp.ndarray,
    tri_id: jnp.ndarray,
    width: int,
    height: int,
    cull_mode: CullMode,
    front_face: FrontFace,
    depth_bias: "tuple[float, float] | None" = None,
    depth_clamp: bool = False,
    force_front: bool = False,
) -> TriangleRecords:
    """Edge-equation setup from screen-space corners — the back half of
    triangle setup, also fed directly by the line/point quad expansion
    (``force_front`` = line/point primitives: never culled, always
    front-facing per Vulkan 27.5/27.6; edge orientation still follows the
    actual winding)."""
    x0, x1, x2 = sx[:, 0], sx[:, 1], sx[:, 2]
    y0, y1, y2 = sy[:, 0], sy[:, 1], sy[:, 2]

    det = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    is_cw = det > 0.0
    if force_front:
        front = jnp.ones_like(is_cw)
    else:
        front = is_cw if front_face == FrontFace.CLOCKWISE else ~is_cw

    valid = valid & (det != 0.0)
    if not force_front:
        if cull_mode == CullMode.BACK:
            valid = valid & front
        elif cull_mode == CullMode.FRONT:
            valid = valid & ~front

    s = jnp.where(is_cw, 1.0, -1.0).astype(jnp.float32)

    def edge(xi, yi, xj, yj):
        aa = (yi - yj) * s
        bb = (xj - xi) * s
        cc = -(aa * xi + bb * yi)
        dx = (xj - xi) * s
        dy = (yj - yi) * s
        tl = (dy < 0.0) | ((dy == 0.0) & (dx > 0.0))
        return aa, bb, cc, tl.astype(jnp.float32)

    a01, b01, c01, tl01 = edge(x0, y0, x1, y1)
    a12, b12, c12, tl12 = edge(x1, y1, x2, y2)
    a20, b20, c20, tl20 = edge(x2, y2, x0, y0)

    abs_det = jnp.abs(det)
    inv_det = jnp.where(abs_det > 0.0, 1.0 / jnp.where(abs_det > 0, abs_det, 1.0), 0.0)

    if depth_bias is not None and (depth_bias[0] or depth_bias[1]):
        bias_c, bias_s = float(depth_bias[0]), float(depth_bias[1])
        # z-plane gradient from the edge equations (w_i are affine in x, y):
        # dz/dx = inv_det·(a12·z0 + a20·z1 + a01·z2), likewise dz/dy with b.
        dzdx = inv_det * (a12 * sz[:, 0] + a20 * sz[:, 1] + a01 * sz[:, 2])
        dzdy = inv_det * (b12 * sz[:, 0] + b20 * sz[:, 1] + b01 * sz[:, 2])
        m = jnp.maximum(jnp.abs(dzdx), jnp.abs(dzdy))
        # r = one float32 ULP at the triangle's max |z| (Vulkan 27.7.3 for
        # floating-point depth: 2^(e-23) with e the max depth exponent).
        zmax_abs = jnp.max(jnp.abs(sz), axis=1)
        r = jnp.exp2(jnp.floor(jnp.log2(jnp.maximum(zmax_abs, 1e-30))) - 23.0)
        o = bias_c * r + bias_s * m
        sz = sz + o[:, None]

    rast16 = jnp.stack(
        [a01, b01, c01, a12, b12, c12, a20, b20, c20,
         tl01, tl12, tl20, inv_det, sz[:, 0], sz[:, 1], sz[:, 2]],
        axis=1,
    ).astype(jnp.float32)

    zeros = jnp.zeros_like(det)
    shade16 = jnp.stack(
        [iw[:, 0], iw[:, 1], iw[:, 2],
         jnp.ones_like(det), zeros, zeros, jnp.ones_like(det), zeros, zeros,
         front.astype(jnp.float32),
         zeros, zeros, zeros, zeros, zeros, zeros],
        axis=1,
    ).astype(jnp.float32)

    xmin = jnp.minimum(jnp.minimum(x0, x1), x2)
    xmax = jnp.maximum(jnp.maximum(x0, x1), x2)
    ymin = jnp.minimum(jnp.minimum(y0, y1), y2)
    ymax = jnp.maximum(jnp.maximum(y0, y1), y2)
    valid = valid & (xmax > 0) & (xmin < width) & (ymax > 0) & (ymin < height)
    if not depth_clamp:
        zmin = jnp.minimum(jnp.minimum(sz[:, 0], sz[:, 1]), sz[:, 2])
        zmax = jnp.maximum(jnp.maximum(sz[:, 0], sz[:, 1]), sz[:, 2])
        valid = valid & (zmax >= 0.0) & (zmin <= 1.0)

    aabb = jnp.stack([xmin, ymin, xmax, ymax], axis=1).astype(jnp.float32)
    rast16 = jnp.where(valid[:, None], rast16, 0.0)
    return TriangleRecords(rast16, shade16, tri_id, valid, aabb)


def corner_attributes(
    records: "TriangleRecords",
    indices: jnp.ndarray,  # (T, 3) i32 original index buffer
    varyings: jnp.ndarray,  # (Nv, A) flattened vertex-stage outputs
) -> jnp.ndarray:
    """Per-record per-corner interpolation data for the forward-interpolating
    raster kernel, FLAT 2D corner-major (R, 3·(A+1)): per corner,
    [varying·(1/w)… (premultiplied for perspective-correct attr/w
    interpolation), 1/w]. Kept 2D like setup_with_attrs.

    Clipped sub-triangle corners blend the ORIGINAL corners' varyings by the
    obary weights recorded at clip time, so clipping is invisible downstream.
    This costs R-sized gathers (thousands) — never per-pixel gathers.
    """
    r = records.rast16.shape[0]
    tri = jnp.take(indices.astype(jnp.int32), records.tri_id, axis=0)  # (R, 3)
    v = jnp.take(varyings.astype(jnp.float32), tri.reshape(-1), axis=0)
    v = v.reshape(r, 3, -1)  # original corner varyings

    sh = records.shade16
    front = sh[:, SHADE_FRONT][:, None]  # (R, 1) — one more varying channel
    corner_cols = (
        (SHADE_B0X, SHADE_B0Y, SHADE_IW0),
        (SHADE_B1X, SHADE_B1Y, SHADE_IW1),
        (SHADE_B2X, SHADE_B2Y, SHADE_IW2),
    )
    blocks = []
    for bxcol, bycol, iwcol in corner_cols:
        # obary of record-corner c w.r.t. original corners (x, y, 1-x-y).
        bx = sh[:, bxcol][:, None]
        by = sh[:, bycol][:, None]
        bz = 1.0 - bx - by
        attr = bx * v[:, 0, :] + by * v[:, 1, :] + bz * v[:, 2, :]  # (R, A)
        iw_c = sh[:, iwcol][:, None]
        blocks.append(attr * iw_c)
        blocks.append(front * iw_c)
        blocks.append(iw_c)
    return jnp.concatenate(blocks, axis=1).astype(jnp.float32)


def transform_vertices(positions: jnp.ndarray, mvp: jnp.ndarray) -> jnp.ndarray:
    """Model/world positions (N, 3) → clip space (N, 4): the vertex-stage
    fixed part. One (N,4)@(4,4) matmul in full float32 (not TF32)."""
    n = positions.shape[0]
    hom = jnp.concatenate(
        [positions.astype(jnp.float32), jnp.ones((n, 1), jnp.float32)], axis=1
    )
    return jnp.matmul(hom, mvp.T.astype(jnp.float32),
                      precision=jax.lax.Precision.HIGHEST)


def _lerp(a, b, t):
    return a + (b - a) * t


def clip_near_w(
    corners: jnp.ndarray, obary: jnp.ndarray, w_eps: float = NEAR_W_EPS
) -> "tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]":
    """Clip triangles against the Vulkan near plane z_clip ≤ w_clip, with
    static 2× expansion.

    For the engine's infinite-reverse-Z perspective (z_clip ≡ near) this is
    exactly the true near plane w ≥ near; for orthographic projections it is
    a no-op inside the depth range. Clipping at the REAL near plane (rather
    than w > ε) is a float32 requirement, not a nicety: ε-clipped vertices
    land at ~1e7-pixel screen coordinates, and edge-equation coefficients at
    that magnitude lose all sub-pixel precision — coverage survives but
    barycentric attribute interpolation breaks badly.

    corners: (T, 3, 4) clip-space; obary: (T, 3, 3) barycentrics w.r.t. the
    original triangle (one-hot on entry). Returns (corners2, obary2, valid2)
    with leading dim 2T: slots [0:T] and [T:2T] are the two output slots per
    input triangle. Winding is preserved (cyclic rotation + Sutherland-
    Hodgman ordering).
    """
    # Signed distance to the clip plane (positive = inside).
    d = corners[..., 3] - corners[..., 2]  # (T, 3): w - z
    inside = d > w_eps
    c = inside.sum(axis=1)  # (T,)

    # Rotate each triangle so the canonical pattern holds:
    #   c==1 → the inside vertex sits at slot 0
    #   c==2 → the outside vertex sits at slot 2 (inside at 0, 1)
    rot1 = jnp.argmax(inside, axis=1)
    rot2 = (jnp.argmin(inside, axis=1) + 1) % 3
    rot = jnp.where(c == 1, rot1, jnp.where(c == 2, rot2, 0))

    idx = (rot[:, None] + jnp.arange(3)[None, :]) % 3  # (T, 3)
    v = jnp.take_along_axis(corners, idx[:, :, None], axis=1)  # rotated corners
    b = jnp.take_along_axis(obary, idx[:, :, None], axis=1)
    dv = v[..., 3] - v[..., 2]

    def isect(i, j):
        denom = dv[:, i] - dv[:, j]
        denom = jnp.where(jnp.abs(denom) > 1e-20, denom, 1.0)
        t = (dv[:, i] - w_eps) / denom
        t = jnp.clip(t, 0.0, 1.0)[:, None]
        return _lerp(v[:, i], v[:, j], t), _lerp(b[:, i], b[:, j], t)

    p01, b01 = isect(0, 1)
    p12, b12 = isect(1, 2)
    p02, b02 = isect(0, 2)

    def tri(c0, c1, c2):
        return jnp.stack(c0, axis=1), jnp.stack(c1, axis=1)

    # Case tensors, each (T, 3, 4) / (T, 3, 3).
    full_v, full_b = jnp.stack([v[:, 0], v[:, 1], v[:, 2]], 1), jnp.stack(
        [b[:, 0], b[:, 1], b[:, 2]], 1
    )
    one_v = jnp.stack([v[:, 0], p01, p02], 1)
    one_b = jnp.stack([b[:, 0], b01, b02], 1)
    twoA_v = jnp.stack([v[:, 0], v[:, 1], p12], 1)
    twoA_b = jnp.stack([b[:, 0], b[:, 1], b12], 1)
    twoB_v = jnp.stack([v[:, 0], p12, p02], 1)
    twoB_b = jnp.stack([b[:, 0], b12, b02], 1)

    c_ = c[:, None, None]
    out1_v = jnp.where(c_ == 3, full_v, jnp.where(c_ == 2, twoA_v, one_v))
    out1_b = jnp.where(c_ == 3, full_b, jnp.where(c_ == 2, twoA_b, one_b))
    out2_v = twoB_v
    out2_b = twoB_b
    valid1 = c >= 1
    valid2 = c == 2

    corners2 = jnp.concatenate([out1_v, out2_v], axis=0)
    obary2 = jnp.concatenate([out1_b, out2_b], axis=0)
    valid = jnp.concatenate([valid1, valid2], axis=0)
    return corners2, obary2, valid


def setup_triangles(
    clip_positions: jnp.ndarray,
    indices: jnp.ndarray,
    width: int,
    height: int,
    cull_mode: CullMode = CullMode.BACK,
    front_face: FrontFace = FrontFace.COUNTER_CLOCKWISE,
    near_clip: bool = True,
    viewport: "tuple[int, int, int, int] | None" = None,
) -> TriangleRecords:
    """Full triangle setup: gather → near clip → viewport → edge equations.

    clip_positions: (Nv, 4) clip-space vertex positions (vertex-shader
    output); indices: (T, 3) int. Returns TriangleRecords with R = 2T
    (near_clip) or T.

    ``viewport`` = (x0, y0, full_w, full_h) renders a sub-rectangle of a
    larger logical surface: NDC maps to the FULL surface, then (x0, y0)
    shifts into local coordinates. This is how SPMD multi-chip rendering
    shards the framebuffer across a device mesh (each chip owns a row band)
    — x0/y0 may be traced values (e.g. derived from jax.lax.axis_index).
    """
    indices = indices.astype(jnp.int32)
    t = indices.shape[0]
    corners = jnp.take(clip_positions, indices.reshape(-1), axis=0).reshape(t, 3, 4)
    obary = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32)[None], (t, 3, 3))

    if near_clip:
        corners, obary, valid = clip_near_w(corners, obary)
        tri_id = jnp.concatenate(
            [jnp.arange(t, dtype=jnp.int32), jnp.arange(t, dtype=jnp.int32)]
        )
    else:
        valid = jnp.all(corners[..., 3] > NEAR_W_EPS, axis=1)
        tri_id = jnp.arange(t, dtype=jnp.int32)

    w = jnp.maximum(corners[..., 3], NEAR_W_EPS)  # (R, 3); invalid slots guarded
    iw = 1.0 / w
    ndc = corners[..., :3] * iw[..., None]
    # Vulkan viewport transform (y down, depth passthrough [0, 1]).
    if viewport is not None:
        vx0, vy0, full_w, full_h = viewport
    else:
        vx0, vy0, full_w, full_h = 0, 0, width, height
    sx = (ndc[..., 0] + 1.0) * (0.5 * full_w) - vx0
    sy = (ndc[..., 1] + 1.0) * (0.5 * full_h) - vy0
    sz = ndc[..., 2]

    x0, x1, x2 = sx[:, 0], sx[:, 1], sx[:, 2]
    y0, y1, y2 = sy[:, 0], sy[:, 1], sy[:, 2]

    det = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    is_cw = det > 0.0
    front = is_cw if front_face == FrontFace.CLOCKWISE else ~is_cw

    valid = valid & (det != 0.0)
    if cull_mode == CullMode.BACK:
        valid = valid & front
    elif cull_mode == CullMode.FRONT:
        valid = valid & ~front

    s = jnp.where(is_cw, 1.0, -1.0).astype(jnp.float32)

    def edge(xi, yi, xj, yj):
        a = (yi - yj) * s
        bb = (xj - xi) * s
        cc = -(a * xi + bb * yi)
        # Top-left classification of the oriented (inside-positive) edge:
        # d' = s*(xj-xi, yj-yi); top: dy'==0 ∧ dx'>0; left: dy'<0.
        dx = (xj - xi) * s
        dy = (yj - yi) * s
        tl = (dy < 0.0) | ((dy == 0.0) & (dx > 0.0))
        return a, bb, cc, tl.astype(jnp.float32)

    a01, b01, c01, tl01 = edge(x0, y0, x1, y1)
    a12, b12, c12, tl12 = edge(x1, y1, x2, y2)
    a20, b20, c20, tl20 = edge(x2, y2, x0, y0)

    abs_det = jnp.abs(det)
    inv_det = jnp.where(abs_det > 0.0, 1.0 / jnp.where(abs_det > 0, abs_det, 1.0), 0.0)

    rast16 = jnp.stack(
        [a01, b01, c01, a12, b12, c12, a20, b20, c20,
         tl01, tl12, tl20, inv_det, sz[:, 0], sz[:, 1], sz[:, 2]],
        axis=1,
    ).astype(jnp.float32)

    shade16 = jnp.stack(
        [iw[:, 0], iw[:, 1], iw[:, 2],
         obary[:, 0, 0], obary[:, 0, 1],
         obary[:, 1, 0], obary[:, 1, 1],
         obary[:, 2, 0], obary[:, 2, 1],
         front.astype(jnp.float32),
         jnp.zeros_like(det), jnp.zeros_like(det), jnp.zeros_like(det),
         jnp.zeros_like(det), jnp.zeros_like(det), jnp.zeros_like(det)],
        axis=1,
    ).astype(jnp.float32)

    xmin = jnp.minimum(jnp.minimum(x0, x1), x2)
    xmax = jnp.maximum(jnp.maximum(x0, x1), x2)
    ymin = jnp.minimum(jnp.minimum(y0, y1), y2)
    ymax = jnp.maximum(jnp.maximum(y0, y1), y2)
    # Clip-reject triangles entirely outside the viewport.
    valid = valid & (xmax > 0) & (xmin < width) & (ymax > 0) & (ymin < height)
    # Entirely outside the [0, 1] depth range (per-pixel test handles partial).
    zmin = jnp.minimum(jnp.minimum(sz[:, 0], sz[:, 1]), sz[:, 2])
    zmax = jnp.maximum(jnp.maximum(sz[:, 0], sz[:, 1]), sz[:, 2])
    valid = valid & (zmax >= 0.0) & (zmin <= 1.0)

    aabb = jnp.stack([xmin, ymin, xmax, ymax], axis=1).astype(jnp.float32)

    # Zero out invalid records so garbage coefficients can never cover pixels
    # (all-zero edges ⇒ e == 0 with tl == 0 ⇒ no coverage).
    rast16 = jnp.where(valid[:, None], rast16, 0.0)

    return TriangleRecords(rast16, shade16, tri_id, valid, aabb)
