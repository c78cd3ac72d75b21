"""Lens flare — procedural ghosts, halo and anamorphic streak added to the
HDR frame before tonemapping.

GPU engines usually draw flare SPRITES (textured quads placed along the
sun-to-center axis) or run a screen-space ghost shader over a bright-pass
texture. Both reduce to the same math per pixel: distance falloffs around
a handful of points mirrored across the screen center. That IS the
cheapest possible form — a fixed, host-unrolled loop of elementwise
gaussian lobes XLA fuses into the frame program; no sprite geometry,
no extra pass, no gathers.

The sun's screen position is host math (camera @ sun direction) riding a
per-frame dynamic, so a moving camera never recompiles. Occlusion uses an
HDR brightness probe: a dynamic-slice window around the sun pixel,
smoothstepped — in an HDR frame the visible sky/sun is far brighter than
lit geometry, so the probe fades the flare out when the sun hides behind
the scene (the GPU equivalent is an occlusion query on the sun sprite).

No reference counterpart (zenith-renderer ships only TriangleRenderer);
this is breadth on the post stack beside bloom/DoF/motion blur.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from zenith.rendergraph import RenderGraphBuilder
from zenith.rendergraph.resource import RenderGraphResource

# Per-ghost (offset scale, size, rgb tint): classic alternating warm/cool
# ghosts marching through the screen center away from the sun.
_GHOSTS = (
    (-0.42, 0.030, (1.0, 0.55, 0.35)),
    (-0.80, 0.055, (0.45, 0.75, 1.0)),
    (-1.25, 0.040, (1.0, 0.85, 0.45)),
    (-1.70, 0.090, (0.55, 0.45, 1.0)),
    (0.45, 0.028, (0.55, 1.0, 0.65)),
    (0.85, 0.060, (1.0, 0.5, 0.65)),
)


@dataclass
class LensFlare:
    """Config + per-frame host state for the flare node.

    ``intensity`` scales everything; ``halo_radius`` is the ring's radius
    as a fraction of screen height around the image center; ``streak``
    scales the horizontal anamorphic line through the sun; ``occlusion``
    enables the HDR brightness probe (``probe_lo``/``probe_hi`` are the
    smoothstep band in scene-luminance units).
    """

    intensity: float = 0.12
    halo_radius: float = 0.42
    streak: float = 0.6
    occlusion: bool = True
    probe_lo: float = 0.35
    probe_hi: float = 1.2
    probe_px: int = 8

    def __zenith_capture_key__(self):
        return ("LensFlare", self.intensity, self.halo_radius, self.streak,
                self.occlusion, self.probe_lo, self.probe_hi, self.probe_px)

    # -- host side: sun screen position ------------------------------------

    def sun_dynamics(self, camera, sun_dir) -> dict:
        """Per-frame dynamics: sun screen position (u, v in [0,1], v=0 top)
        and a host visibility factor (0 when the sun is behind the camera,
        fading as it leaves the frame). ``sun_dir`` points TOWARD the sun
        (DirectionalLight convention)."""
        d = np.asarray(sun_dir, np.float64)
        d = d / max(np.linalg.norm(d), 1e-12)
        # A point far along the sun direction, projected like any vertex.
        p = np.asarray(camera.location, np.float64) + d * 1e4
        clip = np.asarray(camera.render_view_projection, np.float64) @ \
            np.array([*p, 1.0])
        vis = 0.0
        uv = np.array([0.5, 0.5], np.float64)
        if clip[3] > 1e-6:
            ndc = clip[:3] / clip[3]
            uv = np.array([(ndc[0] + 1.0) * 0.5, (ndc[1] + 1.0) * 0.5])
            # Fade over the outer 30% beyond each edge so the flare slides
            # off smoothly instead of popping at the frustum boundary.
            margin = 0.3
            fx = np.clip((margin + min(uv[0], 1.0 - uv[0])) / margin, 0.0, 1.0)
            fy = np.clip((margin + min(uv[1], 1.0 - uv[1])) / margin, 0.0, 1.0)
            vis = float(fx * fy)
        return {
            "flare.sun_uv": uv.astype(np.float32),
            "flare.vis": np.float32(vis),
        }

    # -- graph node ---------------------------------------------------------

    def render_to(
        self,
        builder: RenderGraphBuilder,
        hdr: RenderGraphResource,
        sun_color=(1.0, 1.0, 1.0),
    ) -> None:
        """Rewrite the HDR texture in place (read → add flare → write).
        Call AFTER the scene renderer and BEFORE PostProcess; the caller
        merges ``sun_dynamics(camera, sun.direction)`` into the frame's
        dynamics (rebuild path: just call it before render; retained mode:
        include it in update_dynamics)."""
        node = builder.add_lambda_node("flare")
        src = node.read(hdr)
        dst = node.write(hdr)
        cfg = self
        col = np.asarray(sun_color, np.float32)

        def record(ctx):
            img = ctx.get(src)
            sun_uv = ctx.dynamic("flare.sun_uv")
            vis = ctx.dynamic("flare.vis")
            row0 = 0
            full_h = img.shape[0]
            psum_axis = None
            if ctx.sharded and ctx.num_shards > 1:
                full_h = img.shape[0] * ctx.num_shards
                row0 = jax.lax.axis_index(ctx.shard_axis) * img.shape[0]
                psum_axis = ctx.shard_axis
            if cfg.occlusion:
                vis = vis * _probe_visibility(
                    img[..., :3], sun_uv, cfg, row0, full_h, psum_axis
                )
            out_rgb = _apply_flare(
                img[..., :3], sun_uv, vis, col, cfg, row0, full_h
            )
            ctx.set(dst, jnp.concatenate([out_rgb, img[..., 3:]], axis=-1))

        node.execute(record)


def _probe_visibility(rgb, sun_uv, cfg: LensFlare, row0=0,
                      full_h: "int | None" = None, psum_axis=None):
    """Mean luminance of a probe_px² window at the sun pixel, smoothstepped
    to [0,1]. Traced dynamic_slice — the start index is a dynamic value, so
    one cached program serves every sun position.

    SPMD: each band sums the window rows IT owns (slicing a k-padded local
    luminance plane, so bands the window misses contribute exactly the zero
    padding) and one scalar ``psum`` combines them — no full-surface
    all-gather for an 8×8 probe."""
    h, w = rgb.shape[0], rgb.shape[1]
    if full_h is None:
        full_h = h
    k = cfg.probe_px
    cx = jnp.clip((sun_uv[0] * w).astype(jnp.int32) - k // 2, 0, w - k)
    gy = jnp.clip(
        (sun_uv[1] * full_h).astype(jnp.int32) - k // 2, 0, full_h - k
    )
    luma_plane = jnp.sum(
        rgb * jnp.asarray([0.2126, 0.7152, 0.0722]), axis=-1
    )
    padded = jnp.pad(luma_plane, ((k, k), (0, 0)))
    start = gy - jnp.asarray(row0, jnp.int32) + k
    win = jax.lax.dynamic_slice(padded, (start, cx), (k, k))
    total = jnp.sum(win)
    if psum_axis is not None:
        total = jax.lax.psum(total, psum_axis)
    luma = total / float(k * k)
    t = jnp.clip(
        (luma - cfg.probe_lo) / max(cfg.probe_hi - cfg.probe_lo, 1e-6),
        0.0, 1.0,
    )
    return t * t * (3.0 - 2.0 * t)


def _apply_flare(rgb, sun_uv, vis, sun_color, cfg: LensFlare,
                 row0, full_h: int):
    """Add ghosts + halo + streak to the (H, W, 3) band. All coordinates in
    v-normalized units (x scaled by aspect) so lobes stay circular."""
    hb, w = rgb.shape[0], rgb.shape[1]
    inv_h = 1.0 / float(full_h)
    ys = (row0 + jnp.arange(hb, dtype=jnp.float32) + 0.5) * inv_h
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / float(w)
    aspect = float(w) / float(full_h)
    px = xs[None, :] * aspect
    py = ys[:, None]
    sx = sun_uv[0] * aspect
    sy = sun_uv[1]
    c0x, c0y = 0.5 * aspect, 0.5  # screen center

    # Ghost axis: sun → center, ghosts at fixed multiples along it.
    ax, ay = c0x - sx, c0y - sy
    flare = jnp.zeros_like(rgb)
    for off, size, tint in _GHOSTS:
        gx = c0x + ax * off
        gy = c0y + ay * off
        d2 = (px - gx) ** 2 + (py - gy) ** 2
        lobe = jnp.exp(-d2 / (2.0 * size * size))
        flare = flare + lobe[..., None] * jnp.asarray(tint, jnp.float32)

    # Halo: a thin ring around the screen center whose radius follows
    # halo_radius, brightest when the sun is off-center.
    dc = jnp.sqrt((px - c0x) ** 2 + (py - c0y) ** 2)
    ring = jnp.exp(-((dc - cfg.halo_radius) ** 2) / (2.0 * 0.02 ** 2))
    halo_gain = jnp.clip(jnp.sqrt(ax * ax + ay * ay) * 2.0, 0.0, 1.0)
    flare = flare + (0.6 * halo_gain) * ring[..., None] * jnp.asarray(
        [0.55, 0.7, 1.0], jnp.float32
    )

    # Anamorphic streak: a horizontal line through the sun.
    if cfg.streak > 0.0:
        line = jnp.exp(-((py - sy) ** 2) / (2.0 * 0.004 ** 2)) * \
            jnp.exp(-((px - sx) ** 2) / (2.0 * 0.35 ** 2))
        flare = flare + cfg.streak * line[..., None] * jnp.asarray(
            [0.45, 0.65, 1.0], jnp.float32
        )

    gain = cfg.intensity * vis
    return rgb + flare * gain * jnp.asarray(sun_color, jnp.float32)
