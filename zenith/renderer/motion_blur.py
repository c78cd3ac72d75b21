"""Camera motion blur over the deferred pipeline.

The reference has no motion blur (its only renderer is the triangle
demo); this is the production post effect, built on the
same machinery TAA uses (renderer/taa.py):

- NO velocity pass: the deferred G-buffer already holds world positions,
  so per-pixel velocity is one dense 4x4 transform — this frame's pixel
  coordinate minus the previous frame's screen position of the same
  surface point under the previous UNJITTERED view-projection. Exactly
  TAA's reprojection math, reused for a different purpose.
- The blur gathers N taps along the velocity streak, centered on the
  pixel (±v/2 — centered blur avoids the half-frame lag of a trailing
  streak). Taps are NEAREST fetches (1 gather each): with N≥8 taps the
  sub-pixel quantization error is dithered along the streak, and slow
  motion (|v| < 1 px) degenerates to the identity anyway. This keeps the
  cost at N gathers/pixel vs 4N for bilinear taps .
- Velocity magnitude is clamped to ``max_radius`` pixels and scaled by
  ``strength`` (the shutter fraction); both ride a packed (4,) dynamic,
  so tuning the shutter never recompiles.

With ``DeferredRenderer(velocity=True)`` the G-buffer carries the
PREVIOUS-frame world position per pixel (per-draw velocity), so OBJECT
motion streaks correctly too, and dominant-velocity dilation
(``dilate_velocity``) lets a moving silhouette smear over the static
background behind it — the standard scatter-as-gather fix. Remaining
trade: sky pixels keep zero velocity (a ray reprojection would be
needed; the streak loss on pure camera rotation against sky is minor at
TAA-scale motion). Stateless across frames except the previous-VP
observation — no history surface, no feedback path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from zenith.rendergraph import RenderGraphBuilder
from zenith.rendergraph.resource import RenderGraphResource


def dilate_velocity(vx: jnp.ndarray, vy: jnp.ndarray,
                    radius: int = 1) -> "tuple[jnp.ndarray, jnp.ndarray]":
    """Dominant-velocity dilation: each pixel takes the velocity of the
    FASTEST pixel in its (2r+1)² neighborhood. This is what lets a moving
    object smear OVER the static background behind it — background pixels
    adjacent to the silhouette inherit the object's velocity, so their
    streak taps reach into the object (the standard scatter-as-gather
    trick; a pure gather resolve without it renders object motion with a
    hard edge). Edge-clamped shifts (pad + slice), zero gathers."""
    h, w = vx.shape
    speed2 = vx * vx + vy * vy
    pv = jnp.pad(jnp.stack([vx, vy, speed2], -1),
                 ((radius, radius), (radius, radius), (0, 0)), mode="edge")
    best_vx, best_vy, best_s = vx, vy, speed2
    for dy in range(2 * radius + 1):
        for dx in range(2 * radius + 1):
            if dy == radius and dx == radius:
                continue
            n = pv[dy:dy + h, dx:dx + w]
            take = n[..., 2] > best_s
            best_vx = jnp.where(take, n[..., 0], best_vx)
            best_vy = jnp.where(take, n[..., 1], best_vy)
            best_s = jnp.maximum(best_s, n[..., 2])
    return best_vx, best_vy


def motion_blur_resolve(
    hdr: jnp.ndarray,  # (H, W, 4) scene color (post-TAA, pre-tonemap)
    world_pos: jnp.ndarray,  # (H, W, 3) G-buffer world positions — PREVIOUS
    #   frame's positions when the renderer runs with velocity=True (the
    #   g.prev plane), else current positions (camera-only blur)
    depth: jnp.ndarray,  # (H, W) reverse-Z depth (0 = background)
    prev_vp: jnp.ndarray,  # (4, 4) PREVIOUS frame's unjittered view-proj
    params: jnp.ndarray,  # (4,): strength, max_radius_px, pad, pad
    samples: int = 8,
    jitter: bool = True,
    dilate: int = 0,  # dominant-velocity dilation radius (px)
) -> jnp.ndarray:
    """One motion-blur resolve: reproject → clamp velocity → N-tap
    streak average. Returns the blurred (H, W, 4) color.

    ``jitter`` adds a per-pixel hash phase to the tap positions (SSAO's
    coordinate hash, ops/ssao.py — elementwise, zero extra gathers):
    at streak lengths beyond ``samples`` pixels the discrete taps band
    into N ghost images; the phase dither trades that for noise, the
    standard resolve trick. Off = exactly reproducible tap math."""
    h, w = depth.shape
    rgb = hdr[..., :3]
    strength = params[0]
    max_radius = jnp.maximum(params[1], 0.0)

    # Previous-frame screen position (TAA's reprojection, taa.py:92-107).
    p = jnp.concatenate([world_pos, jnp.ones_like(world_pos[..., :1])], -1)
    clip = p @ prev_vp.T
    cw = jnp.maximum(clip[..., 3], 1e-6)
    sx = (clip[..., 0] / cw * 0.5 + 0.5) * w - 0.5
    sy = (clip[..., 1] / cw * 0.5 + 0.5) * h - 0.5
    xs = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
    ys = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
    covered = (depth > 0.0) & (clip[..., 3] > 0.0)

    # Velocity in pixels: where the point was → where it is.
    vx = jnp.where(covered, xs - sx, 0.0) * strength
    vy = jnp.where(covered, ys - sy, 0.0) * strength
    speed = jnp.sqrt(vx * vx + vy * vy)
    scale = jnp.where(
        speed > max_radius, max_radius / jnp.maximum(speed, 1e-6), 1.0
    )
    vx = vx * scale
    vy = vy * scale
    if dilate > 0:
        vx, vy = dilate_velocity(vx, vy, dilate)

    # Centered streak: offsets in (-1/2, +1/2] of the velocity. Taps use
    # round-half-up (floor(x+0.5)): jnp.round's half-to-even would double
    # up taps whenever |v|/samples lands offsets exactly on .5 (e.g. the
    # common |v| == samples case collapses 8 taps onto 5 pixels).
    if jitter:
        from zenith.ops.ssao import _pixel_hash_angle

        phase = _pixel_hash_angle(h, w) * (0.5 / np.pi)  # [0, 1)
    else:
        phase = 0.5
    flat = rgb.reshape(-1, 3)
    acc = jnp.zeros_like(rgb)
    for i in range(samples):
        t = (i + phase) / samples - 0.5
        tx = jnp.clip(
            jnp.floor(xs + vx * t + 0.5).astype(jnp.int32), 0, w - 1
        )
        ty = jnp.clip(
            jnp.floor(ys + vy * t + 0.5).astype(jnp.int32), 0, h - 1
        )
        acc = acc + jnp.take(
            flat, (ty * w + tx).reshape(-1), axis=0
        ).reshape(h, w, 3)
    out_rgb = acc * (1.0 / samples)
    return jnp.concatenate([out_rgb, hdr[..., 3:4]], axis=-1)


class MotionBlur:
    """Declares the motion-blur node between the scene/TAA output and
    post (see sandbox/scene.py ``--motion-blur``).

    Per frame the app calls:

    1. ``render_to(builder, hdr, out, camera, gbuffer)`` in ``render`` —
       after TAA (blur the anti-aliased frame), before DoF/post.
    2. Retained mode: merge ``frame_dynamics(camera)`` into
       ``update_dynamics`` — the previous-VP roll and shutter params are
       the only per-frame values; there is no cross-frame surface.
    """

    def __init__(self, strength: float = 1.0, max_radius: float = 32.0,
                 samples: int = 8, jitter: bool = True, dilate: int = 1):
        self.strength = float(strength)
        self.max_radius = float(max_radius)
        self.samples = int(samples)
        self.jitter = bool(jitter)
        # Dominant-velocity dilation radius — only applied when the
        # G-buffer carries the per-draw velocity plane (object motion is
        # what needs silhouette smear; pure camera blur has smooth fields).
        self.dilate = int(dilate)
        self._prev_vp = None  # np (4, 4) previous frame's unjittered VP
        self._last_vp = None  # most recent unjittered VP observed

    def __zenith_capture_key__(self):
        return ("MotionBlur", self.samples, self.jitter, self.dilate)

    def reset(self) -> None:
        """Drop the VP history (resize, scene cut)."""
        self._prev_vp = None
        self._last_vp = None

    def _params(self) -> np.ndarray:
        return np.asarray(
            [self.strength, self.max_radius, 0.0, 0.0], np.float32
        )

    def _observe_camera(self, camera) -> np.ndarray:
        """Roll prev ← last ← current, shifting only when the camera's
        unjittered VP VALUE changed (per-frame idempotent — the same
        protocol as TemporalAA._observe_camera, taa.py:199-211; kept
        separate state so TAA+blur together each see one-frame lag)."""
        cur = np.asarray(
            camera.render_view_projection_unjittered, np.float32
        )
        if self._last_vp is None:
            self._last_vp = cur.copy()
            self._prev_vp = self._last_vp
        elif not np.array_equal(cur, self._last_vp):
            self._prev_vp = self._last_vp
            self._last_vp = cur.copy()
        return self._prev_vp

    def frame_dynamics(self, camera) -> dict:
        """Retained-mode per-frame values (merge into update_dynamics)."""
        return {
            "mblur.prev_vp": self._observe_camera(camera),
            "mblur.params": self._params(),
        }

    def render_to(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
        camera,
        gbuffer: dict,  # DeferredRenderer.gbuffer_handles
    ) -> RenderGraphResource:
        builder.set_dynamic("mblur.prev_vp", self._observe_camera(camera))
        builder.set_dynamic("mblur.params", self._params())
        node = builder.add_lambda_node("motion_blur")
        src = node.read(hdr_input)
        # Per-draw velocity plane when the renderer provides it
        # (DeferredRenderer(velocity=True)): object motion streaks too,
        # and dominant-velocity dilation smears silhouettes over the
        # background. Without it: camera-only blur (r3 behavior).
        has_vel = "prev_pos" in gbuffer
        if (getattr(gbuffer, "animated_without_velocity", False)
                and not has_vel):
            from zenith.core import log as _log
            from zenith.core import validate as _validate

            if _validate.enabled() and not getattr(
                    self, "_warned_no_velocity", False):
                self._warned_no_velocity = True
                _log.get(__name__).warning(
                    "[validate] motion blur on an ANIMATED scene without "
                    "the per-draw velocity plane: only CAMERA motion "
                    "streaks — moving objects stay sharp (or smear "
                    "wrongly). Construct DeferredRenderer(velocity=True) "
                    "(auto for skins/morphs/GPU-instanced motion)."
                )
        p_in = node.read(gbuffer["prev_pos"] if has_vel else gbuffer["pos"])
        d_in = node.read(gbuffer["depth"])
        dst = node.write(output)
        samples = self.samples
        jitter = self.jitter
        dilate = self.dilate if has_vel else 0

        def record(ctx):
            hdr = ctx.get(src)
            prev_vp = ctx.dynamic("mblur.prev_vp")
            params = ctx.dynamic("mblur.params")
            if ctx.sharded and ctx.num_shards > 1:
                # Streak taps land anywhere on screen: run on the gathered
                # full surfaces, slice the band back (the TAA pattern).
                full = motion_blur_resolve(
                    ctx.get_full(src),
                    ctx.get_full(p_in)[..., :3],
                    ctx.get_full(d_in),
                    prev_vp, params, samples, jitter, dilate,
                )
                y0 = jax.lax.axis_index(ctx.shard_axis) * hdr.shape[0]
                out = jax.lax.dynamic_slice_in_dim(full, y0, hdr.shape[0], 0)
            else:
                out = motion_blur_resolve(
                    hdr, ctx.get(p_in)[..., :3], ctx.get(d_in),
                    prev_vp, params, samples, jitter, dilate,
                )
            ctx.set(dst, out)

        node.execute(record)
        return output
