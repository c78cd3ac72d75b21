"""Temporal anti-aliasing over the deferred pipeline.

The reference has no AA beyond MSAA-capable state descs (its only renderer
is the triangle demo); TAA is the production deferred-path AA, designed
as follows:

- The camera projection is jittered by a Halton(2,3) sub-pixel sequence
  (``Camera.set_jitter`` — a homogeneous translation after the projection,
  so the jitter is a DYNAMIC: zero recompiles as it cycles).
- Reprojection needs no motion-vector pass: the deferred G-buffer already
  holds world positions, so the previous frame's screen position is one
  dense 4x4 transform with the previous UNJITTERED view-projection —
  exactly the projection math the SSAO taps use (ops/ssao.py). Under
  ``DeferredRenderer(velocity=True)`` the G-buffer additionally carries
  the PREVIOUS-frame world position per pixel (per-draw velocity: prev
  model matrices / joint palettes / morph weights / instance offsets),
  and the resolve reprojects through that plane instead — history lands
  exactly where a moving surface point was, no ghosting fallback.
- History is sampled bilinearly (4 gathers,
  the minimum that doesn't shimmer) and rectified by a 3x3
  neighborhood clamp built from ``jnp.roll`` shifts (zero gathers).
- The blend is inverse-luminance weighted (Karis) to stop fireflies from
  flickering through.

Cross-frame state (the history surface) rides the engine's feedback path:
the TAA output is exported, ``RenderContext.request_output`` hands the
device array back via ``app.on_frame_outputs``, and the next frame feeds
it in as a jax.Array dynamic — the value never touches the host, and the
dynamics signature is frame-invariant so ONE cached frame program serves
every frame (including the first: a ``taa.valid`` scalar gates the blend).

Retained-mode compatible: ``frame_dynamics()`` returns the per-frame
values (history, previous VP, valid flag) for ``update_dynamics``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from zenith.core import log as _log
from zenith.rendergraph import RenderGraphBuilder
from zenith.rendergraph.resource import RenderGraphResource

logger = _log.get(__name__)

_LUMA = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


def halton(index: int, base: int) -> float:
    """Low-discrepancy Halton sample in [0, 1) (1-indexed)."""
    f, r = 1.0, 0.0
    while index > 0:
        f /= base
        r += f * (index % base)
        index //= base
    return r


def jitter_sequence(length: int = 8) -> "list[tuple[float, float]]":
    """Halton(2,3) sub-pixel offsets in [-0.5, 0.5) pixels."""
    return [
        (halton(i + 1, 2) - 0.5, halton(i + 1, 3) - 0.5)
        for i in range(length)
    ]


def taa_resolve(
    cur: jnp.ndarray,  # (H, W, 4) this frame's HDR color (jittered render)
    history: jnp.ndarray,  # (H, W, 4) accumulated history
    world_pos: jnp.ndarray,  # (H, W, 3) G-buffer world positions
    depth: jnp.ndarray,  # (H, W) reverse-Z depth (0 = background)
    prev_vp: jnp.ndarray,  # (4, 4) PREVIOUS frame's unjittered view-proj
    valid: jnp.ndarray,  # scalar: 0 on the first frame (history undefined)
    alpha: float = 0.125,
) -> jnp.ndarray:
    """One TAA resolve: reproject → clamp → blend. Returns the resolved
    (H, W, 4) color, which is both this frame's output and the next
    frame's history."""
    h, w = depth.shape
    rgb = cur[..., :3]

    # 3x3 neighborhood bounds of the current frame — EDGE-CLAMPED shifts
    # (pad + slice): jnp.roll would wrap toroidally and clamp border
    # pixels against opposite-edge colors (a one-pixel ghost band).
    padded = jnp.pad(rgb, ((1, 1), (1, 1), (0, 0)), mode="edge")
    nmin = rgb
    nmax = rgb
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            r = padded[dy:dy + h, dx:dx + w]
            nmin = jnp.minimum(nmin, r)
            nmax = jnp.maximum(nmax, r)

    # Previous-frame screen position of this pixel's surface point — the
    # same NDC→pixel convention the rasterizer and SSAO taps use.
    p = jnp.concatenate([world_pos, jnp.ones_like(world_pos[..., :1])], -1)
    clip = p @ prev_vp.T
    cw = jnp.maximum(clip[..., 3], 1e-6)
    sx = (clip[..., 0] / cw * 0.5 + 0.5) * w - 0.5
    sy = (clip[..., 1] / cw * 0.5 + 0.5) * h - 0.5
    xs = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
    ys = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
    covered = depth > 0.0
    # Background (sky) pixels: zero motion — the clamp absorbs the small
    # rotation-induced drift far cheaper than a ray reprojection would.
    sx = jnp.where(covered, sx, xs)
    sy = jnp.where(covered, sy, ys)
    onscreen = (
        (sx >= 0.0) & (sx <= w - 1.0) & (sy >= 0.0) & (sy <= h - 1.0)
        & ((clip[..., 3] > 0.0) | ~covered)
    )

    # Bilinear history fetch: 4 gathers.
    x0 = jnp.clip(jnp.floor(sx).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(sy).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(sx - x0.astype(jnp.float32), 0.0, 1.0)[..., None]
    fy = jnp.clip(sy - y0.astype(jnp.float32), 0.0, 1.0)[..., None]
    flat = history[..., :3].reshape(-1, 3)

    def gather(yy, xx):
        return jnp.take(flat, (yy * w + xx).reshape(-1), axis=0).reshape(
            h, w, 3
        )

    h00 = gather(y0, x0)
    h01 = gather(y0, x0 + 1)
    h10 = gather(y0 + 1, x0)
    h11 = gather(y0 + 1, x0 + 1)
    hist = (h00 * (1 - fx) + h01 * fx) * (1 - fy) \
        + (h10 * (1 - fx) + h11 * fx) * fy
    hist = jnp.clip(hist, nmin, nmax)

    # Inverse-luminance (Karis) weighting keeps HDR fireflies from
    # strobing through the accumulation.
    luma = jnp.asarray(_LUMA)
    lc = jnp.sum(rgb * luma, axis=-1, keepdims=True)
    lh = jnp.sum(hist * luma, axis=-1, keepdims=True)
    wc = alpha / (1.0 + lc)
    wh = (1.0 - alpha) / (1.0 + lh)
    blended = (rgb * wc + hist * wh) / (wc + wh)

    use_hist = (valid > 0.0) & onscreen
    out_rgb = jnp.where(use_hist[..., None], blended, rgb)
    return jnp.concatenate([out_rgb, cur[..., 3:4]], axis=-1)


class TemporalAA:
    """Declares the TAA node and owns its cross-frame state.

    Per frame the app calls (see sandbox/scene.py ``--taa``):

    1. ``jitter_camera(camera, w, h)`` in ``tick`` — advances the Halton
       sequence and sets the camera's sub-pixel jitter.
    2. ``render_to(builder, hdr, out, camera, w, h, gbuffer)`` in
       ``render`` — after the deferred renderer, before post; reads the
       renderer's ``gbuffer_handles``. Exports ``out``.
    3. ``context.request_output("taa.history", out_handle)`` +
       ``on_frame_outputs`` → ``feedback(array)`` — the engine hands the
       resolved frame back as next frame's history (device-resident).
    """

    def __init__(self, alpha: float = 0.125, sequence_length: int = 8):
        self.alpha = float(alpha)
        self._seq = jitter_sequence(sequence_length)
        self._frame = 0
        self._history = None  # jax.Array (H, W, 4) | None
        self._prev_vp = None  # np (4, 4) previous frame's unjittered VP
        self._last_vp = None  # most recent unjittered VP observed
        self._hw = None

    # -- per-frame camera jitter -------------------------------------------

    def jitter_camera(self, camera, width: int, height: int) -> None:
        ox, oy = self._seq[self._frame % len(self._seq)]
        camera.set_jitter(2.0 * ox / max(width, 1), 2.0 * oy / max(height, 1))
        self._frame += 1

    def reset(self) -> None:
        """Drop history (resize, scene cut)."""
        self._history = None
        self._prev_vp = None
        self._last_vp = None

    # -- cross-frame state ---------------------------------------------------

    def feedback(self, history: jax.Array) -> None:
        """Engine feedback: this frame's resolved output → next history."""
        self._history = history

    def frame_dynamics(self, camera) -> dict:
        """Retained-mode per-frame values (merge into update_dynamics).
        IDEMPOTENT within a frame: the prev-VP roll is keyed by the camera
        matrix actually changing, so update_dynamics followed by a rebuild
        (the return-None path) cannot double-roll the history transform."""
        d = {
            "taa.prev_vp": self._observe_camera(camera),
            "taa.valid": np.float32(0.0 if self._history is None else 1.0),
        }
        if self._history is not None:
            d["taa.history"] = self._history
        return d

    def _observe_camera(self, camera) -> np.ndarray:
        """Roll prev ← last ← current, shifting only when the camera's
        unjittered VP VALUE changed (per-frame idempotency)."""
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

    # -- graph declaration ----------------------------------------------------

    def render_to(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
        camera,
        width: int,
        height: int,
        gbuffer: dict,
    ) -> RenderGraphResource:
        if self._hw != (height, width):
            self.reset()
            self._hw = (height, width)
        valid = self._history is not None
        history = (
            self._history if valid
            else jnp.zeros((height, width, 4), jnp.float32)
        )
        builder.set_dynamic("taa.history", history)
        builder.set_dynamic("taa.prev_vp", self._observe_camera(camera))
        builder.set_dynamic("taa.valid", np.float32(1.0 if valid else 0.0))

        node = builder.add_lambda_node("taa")
        src = node.read(hdr_input)
        # Per-draw velocity (DeferredRenderer(velocity=True)): reproject
        # via the PREVIOUS-frame world-position plane — history lands on
        # where the surface point WAS, correct for moving/skinned/morphing
        # objects. Without it, fall back to the static-world assumption
        # (current positions + previous camera).
        if (getattr(gbuffer, "animated_without_velocity", False)
                and "prev_pos" not in gbuffer):
            from zenith.core import validate as _validate

            if _validate.enabled() and not getattr(
                    self, "_warned_no_velocity", False):
                self._warned_no_velocity = True
                logger.warning(
                    "[validate] TAA on an ANIMATED scene without the "
                    "per-draw velocity plane: history reprojects with the "
                    "static-world assumption — moving/skinned/morphing "
                    "objects will ghost. Construct "
                    "DeferredRenderer(velocity=True) (auto for "
                    "skins/morphs/GPU-instanced motion)."
                )
        p_in = node.read(gbuffer.get("prev_pos", gbuffer["pos"]))
        d_in = node.read(gbuffer["depth"])
        dst = node.write(output)
        alpha = self.alpha

        def record(ctx):
            cur = ctx.get(src)
            if ctx.sharded and ctx.num_shards > 1:
                # Reprojection gathers land anywhere on screen: run on the
                # gathered full surfaces, slice the band back (the history
                # dynamic is replicated already).
                full = taa_resolve(
                    ctx.get_full(src),
                    ctx.dynamic("taa.history"),
                    ctx.get_full(p_in)[..., :3],
                    ctx.get_full(d_in),
                    ctx.dynamic("taa.prev_vp"),
                    ctx.dynamic("taa.valid"),
                    alpha,
                )
                y0 = jax.lax.axis_index(ctx.shard_axis) * cur.shape[0]
                out = jax.lax.dynamic_slice_in_dim(full, y0, cur.shape[0], 0)
            else:
                out = taa_resolve(
                    cur,
                    ctx.dynamic("taa.history"),
                    ctx.get(p_in)[..., :3],
                    ctx.get(d_in),
                    ctx.dynamic("taa.prev_vp"),
                    ctx.dynamic("taa.valid"),
                    alpha,
                )
            ctx.set(dst, out)

        node.execute(record)
        builder.export(output)
        return output
