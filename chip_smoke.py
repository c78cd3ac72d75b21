#!/usr/bin/env python3
"""Smoke test of the render path on one NVIDIA GPU, in one process.

Run from a checkout of the repository::

    python chip_smoke.py            # every phase, one GPU
    python chip_smoke.py --four     # the 4-GPU path and its reference only

Phases (one process, one card):

1. device: require a GPU default device; print the card's name and power
   limit, the JAX version and the compile-cache directory;
2. parity: every raster variant (opaque, stencil, peel, blend,
   blend+stencil) and the tiled-lights kernel compiled on the card at
   1920x1080 against the plain-XLA reference; watertightness and the
   top-left rule against the NumPy oracle; proof each kernel lowered
   through Triton;
3. timing: each kernel against its plain-XLA version at the scene's shapes
   (and the raster tile shapes), plus the cost of float32 matmuls;
4. main_path: the sandbox scene through EngineLoop at 1080p for 120 frames
   on the rebuild and the auto-retained paths, the same frame at 480x270 on
   the GPU and on the CPU (interpreter), and the triangle demo;
5. dispatch: dispatch cost before and after one device→host fetch;
6. tests: the ``gpu``-marked tests, in this process.

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``; any failed phase exits non-zero without
it. There is no CPU fallback: without a GPU the script fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("parity", "timing", "main_path", "dispatch", "tests")

# Comparison tolerances (kernel vs the plain-XLA reference, both on the card
# at float32 "highest" matmul precision).
DEPTH_ATOL = 1e-5
PLANE_RTOL = 1e-4
PLANE_ATOL = 1e-6  # attr·(1/w) planes near zero
LIGHTS_RTOL = 1e-4
LIGHTS_ATOL = 1e-5
# GPU vs CPU (interpreter) render of the same 480x270 frame: 8-bit sRGB
# output, so agreement is counted in code values.
XDEV_MAX_LEVELS = 2
XDEV_MAX_FRACTION = 1e-3
# Single card vs four cards: same 8-bit comparison.
MULTI_MAX_LEVELS = 2
MULTI_MAX_FRACTION = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# -- helpers -------------------------------------------------------------------


def time_call(fn, *args, reps: int = 10, warmup: int = 2) -> float:
    """Median seconds of ``fn(*args)`` to completion (block_until_ready)."""
    import jax
    import numpy as np

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def scene_camera(w: int, h: int, orbit: float = 0.0):
    """The sandbox scene's orbit camera (zenith.sandbox.scene)."""
    import numpy as np

    from zenith.core.camera import Camera
    from zenith.core.mathtypes import Degree, Radians

    cam = Camera(fov_y=Degree(35.0), aspect_ratio=w / h)
    cam.set_position(np.array([math.sin(orbit) * 170.0,
                               -math.cos(orbit) * 170.0, 25.0], np.float32))
    cam.set_yaw_pitch(Radians(orbit), Radians(-math.atan2(20.0, 170.0)))
    return cam


def cerberus():
    """(vertices (N, 8), triangles (T, 3), model matrix, ground z) of the
    sandbox scene's main mesh, placed as sandbox.scene.build_scene does."""
    import numpy as np

    from zenith import asset
    from zenith.asset import AssetManager, AssetUrl, Mesh, registry
    from zenith.core import mathtypes as m
    from zenith.sandbox.mesh import YUP_TO_ZUP, default_content_root

    asset.initialize()
    mgr = AssetManager(root=default_content_root(),
                       cache_dir=os.path.join(HERE, "cache"))
    collection = mgr.request_load("mesh/cerberus/scene.gltf").get()
    mesh = registry().get(AssetUrl(collection.mesh_urls[0]), Mesh)
    verts = mesh.vertices
    bmin, bmax = verts[:, :3].min(0), verts[:, :3].max(0)
    model = YUP_TO_ZUP @ m.mat4_translation(-0.5 * (bmin + bmax))
    corners = np.stack(np.meshgrid(*zip(bmin, bmax), indexing="ij"), -1)
    z_min = min(float(m.transform_point(model, c)[2])
                for c in corners.reshape(-1, 3))
    return verts, mesh.indices.reshape(-1, 3), model, z_min, bmax - bmin


def scene_draw(w: int, h: int, n_random: int, seed: int = 0, max_tris=None):
    """Clip-space vertices, triangles and varyings of the scene's main draw
    (cerberus, the scene's model transform, the orbit camera) followed in
    submission order by ``n_random`` random triangles. Varyings are the
    G-buffer's: normal (3), uv (2), world position (3)."""
    import numpy as np

    verts, idx, model, _, _ = cerberus()
    if max_tris is not None:
        idx = idx[:max_tris]
    hom = np.concatenate([verts[:, :3], np.ones((len(verts), 1))], 1)
    world = (hom @ model.T)[:, :3]
    vp = scene_camera(w, h).render_view_projection_unjittered
    clip = np.concatenate([world, np.ones((len(verts), 1))], 1) @ vp.T
    vary = np.concatenate([verts[:, 3:8], world], 1)

    # Mostly small triangles, a few screen-sized ones (the huge tier).
    rng = np.random.default_rng(seed)
    n_rv = 3 * n_random
    centers = rng.uniform(-1.0, 1.0, (n_random, 1, 2))
    sizes = rng.uniform(0.005, 0.25, (n_random, 1, 1)) ** 2
    sizes[: max(n_random // 200, 1)] = 0.6
    offs = rng.uniform(-1, 1, (n_random, 3, 2)) * sizes
    ndc = (centers + offs).reshape(n_rv, 2)
    z = rng.uniform(0.05, 0.95, (n_rv, 1))
    wv = rng.uniform(0.5, 4.0, (n_rv, 1))
    rclip = np.concatenate([ndc * wv, z * wv, wv], 1)
    rvary = rng.uniform(-1, 1, (n_rv, vary.shape[1]))
    ridx = np.arange(n_rv).reshape(-1, 3) + len(verts)
    return (
        np.concatenate([clip, rclip]).astype(np.float32),
        np.concatenate([idx, ridx]).astype(np.int32),
        np.concatenate([vary, rvary]).astype(np.float32),
    )


def bin_draw(clip, idx, vary, grid, cull=None):
    """Setup + segmented binning of one draw (jitted at the call site)."""
    from zenith.ops import bin_segmented, setup_with_attrs
    from zenith.rhi.state import CullMode

    rec, corner = setup_with_attrs(
        clip, idx, vary, grid.width, grid.height,
        cull_mode=CullMode.NONE if cull is None else cull,
    )
    return bin_segmented(rec, corner, grid)


def _blend_fn(planes, passed, x, y, zpx, c):
    """A kernel-safe fragment shader + 'over' blend: varyings 0-2 as color
    at alpha 0.4."""
    import jax.numpy as jnp

    iw = jnp.maximum(planes[-1], 1e-20)
    a = 0.4
    out = [jnp.where(passed, a * (planes[i] / iw) + (1 - a) * c[i], c[i])
           for i in range(3)]
    out.append(jnp.where(passed, a + (1 - a) * c[3], c[3]))
    return tuple(out)


def compare(name, got, ref, *, atol, rtol=0.0, exact=False):
    """Print and check one kernel-vs-reference comparison."""
    import numpy as np

    got = np.asarray(got)
    ref = np.asarray(ref)
    check(got.shape == ref.shape, f"{name}: shape {got.shape} != {ref.shape}")
    check(np.isfinite(got).all(), f"{name}: non-finite values")
    if exact:
        bad = int((got != ref).sum())
        log(f"  {name}: exact, {bad} differing values of {got.size}")
    else:
        err = np.abs(got.astype(np.float64) - ref)
        bad = int((err > atol + rtol * np.abs(ref)).sum())
        log(f"  {name}: max abs err {err.max():.3e} (atol {atol:g}, "
            f"rtol {rtol:g}), {bad} of {got.size} outside")
    check(bad == 0, f"{name}: {bad} values outside tolerance")


def raster_variants(grid, interpret):
    """{name: (kernel fn, reference fn)}, each a function of one draw's
    bins: every static variant of the raster kernel."""
    import jax.numpy as jnp

    from zenith.ops.raster import (
        raster_segmented,
        raster_segmented_blend,
        raster_segmented_xla,
    )
    from zenith.rhi.state import CompareOp, StencilOp, StencilOpState

    h, w = grid.height, grid.width
    z0 = jnp.zeros((h, w), jnp.float32)
    s0 = jnp.zeros((h, w), jnp.int32)
    c0 = jnp.zeros((h, w, 4), jnp.float32).at[..., 3].set(1.0)
    front = StencilOpState(pass_op=StencilOp.INCREMENT_AND_WRAP,
                           depth_fail_op=StencilOp.INVERT,
                           compare_op=CompareOp.ALWAYS)
    back = StencilOpState(pass_op=StencilOp.REPLACE, fail_op=StencilOp.ZERO,
                          compare_op=CompareOp.LESS_OR_EQUAL, reference=1)
    bound = jnp.full((h, w), 0.5, jnp.float32)

    def make(kw, blend=False):
        def kern(bins):
            if blend:
                return raster_segmented_blend(
                    bins, grid, z0, c0, _blend_fn, depth_write=True,
                    interpret=interpret, **kw)
            return raster_segmented(bins, grid, z0, interpret=interpret, **kw)

        def ref(bins):
            extra = dict(init_color=c0, shade_blend=_blend_fn,
                         depth_write=True) if blend else {}
            return raster_segmented_xla(bins, grid, z0, **kw, **extra)

        return kern, ref

    return {
        "opaque": make({}),
        "stencil": make(dict(init_stencil=s0, stencil_front=front,
                             stencil_back=back)),
        "peel": make(dict(z_bound=bound)),
        "blend": make({}, blend=True),
        "blend_stencil": make(dict(init_stencil=s0, stencil_front=front),
                              blend=True),
    }


def check_triton(name, fn, *args):
    """The kernel lowered to a Triton custom call, with no interpreter
    loop around it."""
    import jax

    lowered = jax.jit(fn).lower(*args)
    text = lowered.as_text()
    n = text.count("xla.gpu.triton")
    check(n >= 1, f"{name}: no Triton custom call in the lowered program")
    check("stablehlo.while" not in text, f"{name}: an interpreter loop remains")
    check("triton" in lowered.compile().as_text().lower(),
          f"{name}: no Triton kernel in the compiled HLO")
    log(f"  {name}: lowered through Triton ({n} custom call(s), no "
        f"interpreter loop)")


def ground_gbuffer(w: int, h: int):
    """A scene-shaped G-buffer: the orbit camera's view of the scene's
    ground plane (world position, +Z normal, striped albedo), depth > 0
    where the ray hits the ground."""
    import numpy as np

    _, _, _, z_min, _ = cerberus()
    cam = scene_camera(w, h)
    inv = np.linalg.inv(cam.render_view_projection_unjittered.astype(np.float64))
    xs = (np.arange(w) + 0.5) / w * 2 - 1
    ys = (np.arange(h) + 0.5) / h * 2 - 1
    gx, gy = np.meshgrid(xs, ys)
    p = np.stack([gx, gy, np.full_like(gx, 0.5), np.ones_like(gx)], -1) @ inv.T
    p = p[..., :3] / p[..., 3:]
    eye = np.asarray(cam.location, np.float64)
    d = p - eye
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z_ground = z_min - 2.0
    t = (z_ground - eye[2]) / np.where(np.abs(d[..., 2]) > 1e-9, d[..., 2], -1e-9)
    hit = t > 0
    world = eye + d * np.where(hit, t, 0)[..., None]
    stripe = (np.floor(world[..., 0] / 8) % 2)[..., None]
    am = np.concatenate([0.4 + 0.4 * stripe * np.ones((h, w, 3)),
                         0.2 * stripe], -1)
    nr = np.concatenate([np.zeros((h, w, 2)), np.ones((h, w, 1)),
                         0.3 + 0.4 * stripe], -1)
    pe = np.concatenate([world, np.zeros((h, w, 1))], -1)
    depth = np.where(hit, 0.5, 0.0)
    return [np.asarray(a, np.float32) for a in (am, nr, pe, depth)], eye


def scene_lights(n: int = 100, seed: int = 42):
    """The sandbox scene's point-light layout (sandbox.scene.build_scene)."""
    import numpy as np

    _, _, _, z_min, extent = cerberus()
    rng = np.random.default_rng(seed)
    radius_xy = float(np.linalg.norm(extent)) * 0.7
    pos, col = [], []
    for i in range(n):
        ang = 2 * math.pi * i / n
        r = radius_xy * (0.4 + 0.6 * rng.uniform())
        hue = rng.uniform(0, 1)
        pos.append([r * math.cos(ang), r * math.sin(ang),
                    z_min + 4.0 + 20.0 * rng.uniform()])
        c = [abs(math.sin((hue + k / 3) * math.pi * 2)) for k in range(3)]
        col.append([ci * (400.0 + 600.0 * rng.uniform()) for ci in c])
    return (np.asarray(pos, np.float32), np.asarray(col, np.float32),
            np.full((n,), 60.0, np.float32))


# -- phases --------------------------------------------------------------------


def phase_parity(w=1920, h=1080, n_random=2000, max_tris=None,
                 check_lowering=True, interpret=False):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from zenith.ops import TileGrid
    from zenith.ops.lighting import (
        accumulate_point_lights,
        accumulate_point_lights_dense,
    )

    grid = TileGrid(width=w, height=h)
    clip, idx, vary = (jnp.asarray(a) for a in
                       scene_draw(w, h, n_random, max_tris=max_tris))
    log(f"parity at {w}x{h}, tile {grid.tile_h}x{grid.tile_w}: cerberus + "
        f"{n_random} random triangles ({idx.shape[0]} in all), "
        f"matmul precision 'highest'")
    with jax.default_matmul_precision("highest"):
        bins = jax.jit(lambda c, i, v: bin_draw(c, i, v, grid))(clip, idx, vary)
        check(int(bins.overflow) == 0, "parity draw overflowed its bins")
        for name, (kern, ref) in raster_variants(grid, interpret).items():
            got = jax.jit(kern)(bins)
            want = jax.jit(ref)(bins)
            if check_lowering:
                check_triton(name, kern, bins)
            compare(f"{name} depth", got[0], want[0], atol=DEPTH_ATOL)
            if name.startswith("blend"):
                compare(f"{name} color", got[1], want[1],
                        atol=PLANE_ATOL, rtol=PLANE_RTOL)
            else:
                compare(f"{name} attribute planes", got[1], want[1],
                        atol=PLANE_ATOL, rtol=PLANE_RTOL)
            if len(got) == 3:
                compare(f"{name} stencil", got[2], want[2], atol=0, exact=True)
            log(f"  {name}: covered px {int((np.asarray(got[0]) > 0).sum())}")

        (am, nr, pe, depth), eye = ground_gbuffer(w, h)
        lp, lc, lr = scene_lights()
        largs = [jnp.asarray(a) for a in
                 (am, nr, pe, depth, eye.astype(np.float32), lp, lc, lr)]
        lk = lambda *a: accumulate_point_lights(*a, interpret=interpret)
        got = jax.jit(lk)(*largs)
        want = jax.jit(accumulate_point_lights_dense)(*largs)
        if check_lowering:
            check_triton("lights", lk, *largs)
        compare("lights (100, 1080p-shaped G-buffer)", got, want,
                atol=LIGHTS_ATOL, rtol=LIGHTS_RTOL)
    phase_oracle(interpret)


def phase_oracle(interpret=False):
    """Watertightness and the top-left rule, compiled, against the NumPy
    oracle on a small grid."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from np_reference import render_reference

    from zenith.ops import TileGrid, bin_segmented, raster_segmented, setup_triangles
    from zenith.rhi.state import CompareOp, CullMode

    W, H = 128, 64
    grid = TileGrid(width=W, height=H)

    def slots(clip, idx):
        clip, idx = jnp.asarray(clip), jnp.asarray(idx)

        def f(clip, idx):
            rec = setup_triangles(clip, idx, W, H, cull_mode=CullMode.NONE)
            r = rec.rast16.shape[0]
            iw = rec.shade16[:, 0:3]
            s = jnp.arange(r, dtype=jnp.float32)[:, None]
            corner = jnp.stack([s * iw, iw], -1).reshape(r, 6)
            bins = bin_segmented(rec, corner, grid)
            _, acc = raster_segmented(bins, grid, jnp.zeros((H, W)),
                                      compare_op=CompareOp.ALWAYS,
                                      interpret=interpret)
            cov = acc[1] > 0
            slot = jnp.where(cov, jnp.round(acc[0] / jnp.where(cov, acc[1], 1)),
                             -1).astype(jnp.int32)
            tri = jnp.where(slot >= 0, rec.tri_id[jnp.maximum(slot, 0)], -1)
            return tri

        return np.asarray(jax.jit(f)(clip, idx))

    # A closed fan mesh: a 24-gon split into triangles around its center.
    n = 24
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False) + 0.1
    ring = np.stack([0.8 * np.cos(ang), 0.8 * np.sin(ang)], 1)
    verts = np.concatenate([[[0.013, -0.021]], ring])
    clip = np.concatenate([verts, np.full((n + 1, 1), 0.5),
                           np.ones((n + 1, 1))], 1).astype(np.float32)
    idx = np.array([[0, 1 + i, 1 + (i + 1) % n] for i in range(n)], np.int32)
    tri = slots(clip, idx)
    ref = render_reference(clip, idx, W, H, cull="none", compare="always")
    inside = ref["tri"] >= 0
    check((tri[inside] >= 0).all(), "closed mesh: gap on a shared edge")
    np.testing.assert_array_equal(tri, ref["tri"])
    log(f"  closed 24-triangle fan: {int(inside.sum())} px, each owned "
        f"once, no gaps, equal to the oracle")

    # Edges through pixel centers: the top-left rule decides ownership.
    px, py = 2.0 / W, 2.0 / H
    quad = np.array([[-1 + a * px + px / 2, -1 + b * py + py / 2, 0.5, 1.0]
                     for a, b in ((8, 4), (40, 4), (40, 20), (8, 20))],
                    np.float32)
    qidx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    tri = slots(quad, qidx)
    ref = render_reference(quad, qidx, W, H, cull="none", compare="always")
    np.testing.assert_array_equal(tri, ref["tri"])
    log("  top-left rule on pixel-center edges: equal to the oracle")


def phase_timing(w=1920, h=1080, n_random=0, reps=10, interpret=False,
                 tiles=((8, 8), (8, 32), (16, 16), (16, 32), (32, 32)),
                 frame_tiles=None, scene_frames=40):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from zenith.ops import TileGrid, setup_with_attrs
    from zenith.ops.lighting import (
        accumulate_point_lights,
        accumulate_point_lights_dense,
    )
    from zenith.ops.raster import raster_segmented, raster_segmented_xla
    from zenith.rhi.state import CullMode

    clip, idx, vary = (jnp.asarray(a) for a in scene_draw(w, h, n_random))
    log(f"timing at {w}x{h} (median of {reps}): the scene's G-buffer draw "
        f"({idx.shape[0]} triangles, 8 varyings)")
    with jax.default_matmul_precision("highest"):
        for th, tw in tiles:
            grid = TileGrid(width=w, height=h, tile_h=th, tile_w=tw)
            z0 = jnp.zeros((h, w), jnp.float32)
            binf = jax.jit(lambda c, i, v: bin_draw(c, i, v, grid,
                                                     cull=CullMode.BACK))
            bins = binf(clip, idx, vary)
            kern = jax.jit(lambda b: raster_segmented(b, grid, z0,
                                                      interpret=interpret))
            t_bin = time_call(binf, clip, idx, vary, reps=reps)
            t_k = time_call(kern, bins, reps=reps)
            cnt = np.asarray(bins.tile_count)
            log(f"  tile {th}x{tw}: binning {t_bin * 1e3:.3f} ms, raster "
                f"kernel {t_k * 1e3:.3f} ms, entries {int(cnt.sum())}, "
                f"busiest tile {int(cnt.max())}, overflow {int(bins.overflow)}")
        grid = TileGrid(width=w, height=h)
        bins = jax.jit(lambda c, i, v: bin_draw(c, i, v, grid,
                                                 cull=CullMode.BACK))(clip, idx, vary)
        z0 = jnp.zeros((h, w), jnp.float32)
        t_k = time_call(jax.jit(lambda b: raster_segmented(
            b, grid, z0, interpret=interpret)), bins, reps=reps)
        t_x = time_call(jax.jit(lambda b: raster_segmented_xla(b, grid, z0)),
                        bins, reps=max(3, reps // 3), warmup=1)
        log(f"  raster at tile {grid.tile_h}x{grid.tile_w}: Triton kernel "
            f"{t_k * 1e3:.3f} ms, plain XLA {t_x * 1e3:.3f} ms")
        from zenith.ops import raster as raster_mod

        default_warps = raster_mod.NUM_WARPS
        try:
            for nw in (1, 2, 4, 8):
                raster_mod.NUM_WARPS = nw  # read when the kernel is traced
                t = time_call(jax.jit(lambda b: raster_segmented(
                    b, grid, z0, interpret=interpret)), bins, reps=reps)
                log(f"  raster kernel with {nw} warp(s): {t * 1e3:.3f} ms")
        finally:
            raster_mod.NUM_WARPS = default_warps

        (am, nr, pe, depth), eye = ground_gbuffer(w, h)
        lp, lc, lr = scene_lights()
        largs = [jnp.asarray(a) for a in
                 (am, nr, pe, depth, eye.astype(np.float32), lp, lc, lr)]
        t_lk = time_call(jax.jit(lambda *a: accumulate_point_lights(
            *a, interpret=interpret)), *largs, reps=reps)
        t_ld = time_call(jax.jit(accumulate_point_lights_dense), *largs,
                         reps=reps)
        log(f"  lights (100): Triton kernel {t_lk * 1e3:.3f} ms, plain XLA "
            f"(dense) {t_ld * 1e3:.3f} ms")

    # The whole scene frame (rebuild path) at each tile shape: the tile
    # the engine defaults to is the fastest here.
    from zenith.rendergraph import CompileOptions

    # The two closest shapes run twice, in alternating order.
    if frame_tiles is None:
        frame_tiles = tiles + ((16, 16), (8, 32))
    for th, tw in frame_tiles:
        _, dts, ovf = run_scene(w, h, scene_frames, ["--no-retained"],
                                compile_options=CompileOptions(tile_h=th,
                                                               tile_w=tw))
        log(f"  scene frame at tile {th}x{tw}: median "
            f"{np.median(dts) * 1e3:.3f} ms over {scene_frames} frames, "
            f"overflow {ovf}")

    # Cost of float32 ("highest") over the default (TF32) matmul precision
    # for the scene draw's vertex stage + setup.
    hom = jnp.concatenate([clip[:, :3], jnp.ones((clip.shape[0], 1))], 1)
    mvp = jnp.asarray(scene_camera(w, h).render_view_projection_unjittered)

    def vertex_stage(hom, mvp, idx, vary):
        c = hom @ mvp.T
        return setup_with_attrs(c, idx, vary, w, h)[0].rast16

    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            t = time_call(jax.jit(vertex_stage), hom, mvp, idx, vary, reps=reps)
        log(f"  vertex stage + setup, matmul precision {prec!r}: "
            f"{t * 1e3:.3f} ms")


def run_scene(w, h, frames, extra_args=(), warmup=3, compile_options=None,
              app_cls=None):
    """Drive a sandbox app through EngineLoop; returns (loop, per-frame
    seconds, summed bin overflow)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from zenith import asset
    from zenith.core import log as zlog
    from zenith.core.cli import EngineArgs
    from zenith.engine import Engine
    from zenith.main_loop import EngineLoop
    from zenith.window import Window

    if app_cls is None:
        from zenith.sandbox.scene import SceneApp as app_cls
    args = EngineArgs(app_args=list(extra_args))
    zlog.initialize(args.log_level.to_logging_level())
    asset.initialize()
    window = Window(width=w, height=h, title="chip_smoke")
    app = app_cls(args)
    loop = EngineLoop(app, window=window)
    if compile_options is not None:
        loop.engine = Engine(window, compile_options=compile_options)
        app.prepare(loop.engine.render_device, window)
    loop.run(max_frames=warmup, final=False)
    jax.block_until_ready(loop.engine.last_retired.bin_overflow)
    overflows, stamps = [], []

    def on_frame(i, win):
        stamps.append(time.perf_counter())
        if loop.engine.last_retired is not None:
            overflows.append(loop.engine.last_retired.bin_overflow)

    loop.run(max_frames=warmup + frames, frame_callback=on_frame, final=False)
    overflows.append(loop.engine.last_retired.bin_overflow)
    jax.block_until_ready(overflows[-1])
    stamps.append(time.perf_counter())
    overflow = int(jnp.sum(jnp.stack([jnp.asarray(o) for o in overflows])))
    loop.run(max_frames=warmup + frames)  # final: flush + shutdown
    return loop, np.diff(np.asarray(stamps)), overflow


def phase_main_path(w=1920, h=1080, frames=120, small=(480, 270),
                    tri_frames=120, compare_cpu=True):
    import jax
    import numpy as np

    for label, extra in (("rebuild", ["--no-retained"]),
                         ("auto-retained", [])):
        loop, dts, overflow = run_scene(w, h, frames, extra)
        img = loop.window.last_frame
        check(img is not None and np.isfinite(np.asarray(img, np.float64)).all(),
              f"scene {label}: no finite frame presented")
        check(overflow == 0, f"scene {label}: bin overflow {overflow}")
        log(f"scene {w}x{h} {label}: {frames} frames, bin_overflow 0, "
            f"frame time median {np.median(dts) * 1e3:.3f} ms, p90 "
            f"{np.percentile(dts, 90) * 1e3:.3f} ms "
            f"(informational, not a claim)")

    if compare_cpu:
        sw, sh = small
        os.environ["ZENITH_ORBIT_SPEED"] = "0"
        try:
            g_loop, _, _ = run_scene(sw, sh, 1, ["--no-retained"], warmup=1)
            gpu_img = np.asarray(g_loop.window.last_frame)
            with jax.default_device(jax.devices("cpu")[0]):
                c_loop, _, _ = run_scene(sw, sh, 1, ["--no-retained"], warmup=1)
            cpu_img = np.asarray(c_loop.window.last_frame)
        finally:
            del os.environ["ZENITH_ORBIT_SPEED"]
        diff = np.abs(gpu_img.astype(np.int32) - cpu_img.astype(np.int32))
        frac = float((diff > XDEV_MAX_LEVELS).mean())
        log(f"scene {sw}x{sh} GPU vs CPU (interpreter): max diff "
            f"{int(diff.max())} levels, {frac:.2e} of values over "
            f"{XDEV_MAX_LEVELS} (limit {XDEV_MAX_FRACTION:g})")
        check(frac <= XDEV_MAX_FRACTION, "GPU and CPU renders disagree")

    from zenith.sandbox.triangle import TriangleApp

    loop, dts, overflow = run_scene(w, h, tri_frames, app_cls=TriangleApp)
    check(overflow == 0 and loop.window.last_frame is not None,
          "triangle demo failed")
    log(f"triangle demo {w}x{h}: {tri_frames} frames, frame time median "
        f"{np.median(dts) * 1e3:.3f} ms")


def phase_dispatch(n=100):
    """Does one device→host fetch slow later dispatches?"""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: x * 1.0001 + 1.0)
    x = jnp.zeros((256,), jnp.float32)

    def per_dispatch():
        y = f(x)
        jax.block_until_ready(y)
        t0 = time.perf_counter()
        for _ in range(n):
            y = f(y)
        t1 = time.perf_counter()
        jax.block_until_ready(y)
        return (t1 - t0) / n

    before = min(per_dispatch() for _ in range(3))
    float(f(x)[0])  # one device→host scalar fetch
    after = min(per_dispatch() for _ in range(3))
    log(f"dispatch: {before * 1e6:.1f} us/call before a device->host fetch, "
        f"{after * 1e6:.1f} us/call after "
        f"({'slower' if after > 3 * before else 'no lasting slowdown'})")


def phase_tests():
    import pytest

    os.environ["ZENITH_VALIDATE"] = os.environ.get("ZENITH_VALIDATE", "1")
    rc = pytest.main([os.path.join(HERE, "tests"), "-m", "gpu", "--gpu",
                      "-p", "no:xdist", "-p", "no:cacheprovider", "-q",
                      "-p", "no:randomly", "-rs"])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")


def phase_four(w=1920, h=1080, frames=3, platform="gpu"):
    """The 4-GPU path: the scene compiled over a 1-D mesh of 4 cards,
    sort-first, sort-last and auto, each against the single-card render,
    plus the binary-swap composite time. (``platform="cpu"`` rehearses it
    on 4 virtual CPU devices.)"""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from zenith.parallel.sharding import composite_depth_planes
    from zenith.rendergraph import CompileOptions

    devs = jax.devices(platform)
    check(len(devs) >= 4, f"--four needs 4 {platform} devices, found {len(devs)}")
    mesh = Mesh(np.array(devs[:4]), ("rows",))
    os.environ["ZENITH_ORBIT_SPEED"] = "0"
    try:
        loop, dts, ovf = run_scene(w, h, frames, ["--no-retained"])
        single = np.asarray(loop.window.last_frame)
        log(f"single card {w}x{h}: frame median {np.median(dts) * 1e3:.3f} ms")
        for mode in ("sort_first", "sort_last", "auto"):
            opts = CompileOptions(mesh=mesh, parallel=mode)
            loop, dts, ovf = run_scene(w, h, frames, ["--no-retained"],
                                       compile_options=opts)
            img = np.asarray(loop.window.last_frame)
            diff = np.abs(img.astype(np.int32) - single.astype(np.int32))
            frac = float((diff > MULTI_MAX_LEVELS).mean())
            log(f"4 cards {mode}: frame median {np.median(dts) * 1e3:.3f} ms, "
                f"overflow {ovf}, vs single card max diff {int(diff.max())} "
                f"levels, {frac:.2e} over {MULTI_MAX_LEVELS}")
            check(ovf == 0, f"{mode}: bin overflow {ovf}")
            check(frac <= MULTI_MAX_FRACTION, f"{mode}: differs from one card")
    finally:
        del os.environ["ZENITH_ORBIT_SPEED"]

    # Binary-swap composite of one 1080p RGBA + depth surface over 4 cards.
    rng = np.random.default_rng(0)
    planes = jnp.asarray(rng.uniform(size=(4, 4, h, w)), jnp.float32)
    depth = jnp.asarray(rng.uniform(size=(4, h, w)), jnp.float32)
    order = jnp.zeros((4, h, w), jnp.int32)
    sh = NamedSharding(mesh, P("rows"))
    planes, depth, order = (jax.device_put(a, sh) for a in (planes, depth, order))

    def comp(planes, depth, order):
        outs = composite_depth_planes([planes[0, c] for c in range(4)],
                                      depth[0], order[0], "rows",
                                      band_output=True)
        return jax.tree_util.tree_map(lambda a: a[None], outs)

    f = jax.jit(jax.shard_map(comp, mesh=mesh, in_specs=(P("rows"),) * 3,
                              out_specs=P("rows")))
    t = time_call(f, planes, depth, order)
    log(f"binary-swap composite, 4 cards, {w}x{h} RGBA + depth: "
        f"{t * 1e3:.3f} ms")


# -- entry ---------------------------------------------------------------------


def device_report(devs) -> dict:
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU path and its single-card reference")
    args = ap.parse_args(argv)

    if not os.path.isfile(os.path.join(HERE, "zenith", "__init__.py")):
        print("chip_smoke: run from a checkout of the repository "
              "(zenith/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.chdir(HERE)

    import jax

    from zenith.engine import ensure_persistent_compile_cache

    cache_dir = ensure_persistent_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's default device is "
              f"{devs[0].platform!r}); there is no CPU fallback",
              file=sys.stderr)
        return 3
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    log(smi)
    log(f"jax {jax.__version__}; devices {device_report(devs)}; "
        f"compile cache {cache_dir}")

    if args.four:
        phases = [("four", phase_four)]
    else:
        phases = [(p, globals()[f"phase_{p}"]) for p in PHASES]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            fn()
        except Exception as e:  # report every phase, fail at the end
            import traceback

            traceback.print_exc()
            failed.append(name)
            log(f"== phase {name} FAILED after {time.perf_counter() - t0:.1f} s: "
                f"{type(e).__name__}: {e}")
            continue
        log(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)")
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device_report(devs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
