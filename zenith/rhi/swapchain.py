"""Swapchain: N-deep framebuffer ring + async host readback.

Mirrors zenith-rhi/src/swapchain.rs, re-based on JAX's async dispatch:

- Vulkan: acquire_next_image waits the slot's in-flight fence
  (swapchain.rs:210-231); present submits with semaphores (244-264).
- Here: `acquire_next_image` blocks on the readback of the frame presented
  NUM_BACK_BUFFERS ago (same backpressure, no fence objects); `present`
  encodes the linear framebuffer to the swapchain format on-device and
  starts an async device→host copy. The completed host frame is delivered
  to an `on_present` sink (PNG dump, viewer, parity harness) — the analog
  of the OS compositor.

Config mirrors SwapchainConfig (swapchain.rs:62-78): preferred format
BGRA8_SRGB; present mode MAILBOX (free-running) or FIFO (paced to
refresh_rate).
"""

from __future__ import annotations

import enum
import functools
import time
from dataclasses import dataclass
from typing import Callable, Optional

import jax
import numpy as np

from zenith.core import log
from zenith.rhi.device import NUM_BACK_BUFFERS, RenderDevice
from zenith.rhi.formats import Format, encode_present
from zenith.rhi.resource import Texture, TextureDesc, TextureUsage

logger = log.get(__name__)


class PresentMode(enum.Enum):
    MAILBOX = "mailbox"  # free-running, lowest latency (preferred, swapchain.rs:74)
    FIFO = "fifo"  # paced to refresh_rate


@functools.lru_cache(maxsize=32)
def _encode_jit(fmt: Format):
    # Present encode must be compiled: eager jnp dispatches op by op.
    return jax.jit(lambda img: encode_present(img, fmt))


@dataclass
class SwapchainConfig:
    """(reference swapchain.rs:62-78)"""

    width: int = 1920
    height: int = 1080
    format: Format = Format.BGRA8_SRGB
    present_mode: PresentMode = PresentMode.MAILBOX
    num_images: int = NUM_BACK_BUFFERS
    refresh_rate: float = 60.0
    # Host-readback cadence: deliver every Nth presented frame to the
    # on_present sink (1 = every frame). Device-side rendering/encoding is
    # unaffected; this only throttles the device→host copy. The analog of a
    # display link's fixed bandwidth. 0 = NEVER read back: pure fencing
    # (benchmark mode; `flush()` still delivers nothing, so
    # `Window.last_frame` stays None).
    readback_interval: int = 1

    def __post_init__(self) -> None:
        if self.readback_interval < 0:
            raise ValueError(
                "readback_interval must be >= 0 (0 = benchmark mode: "
                f"never read back); got {self.readback_interval}"
            )


@dataclass
class _PendingFrame:
    frame_counter: int
    encoded: jax.Array  # at-rest dtype, device-resident, host copy in flight
    t_present: float


class Swapchain:
    """Framebuffer ring with async present (reference swapchain.rs:81-475)."""

    def __init__(
        self,
        device: RenderDevice,
        config: SwapchainConfig,
        on_present: "Optional[Callable[[np.ndarray, int], None]]" = None,
    ):
        self.device = device
        self.config = config
        self.on_present = on_present
        self._image_index = 0
        self._pending: list[_PendingFrame] = []
        self._inflight: list[jax.Array] = []  # device-side frames-in-flight
        import os

        self.pace_stride = int(os.environ.get("ZENITH_PACE_STRIDE", "128"))
        self._frame_counter = 0
        self._last_present_time: Optional[float] = None
        self.suboptimal = False
        self._textures = [
            Texture(
                TextureDesc(
                    f"swapchain.{i}",
                    config.width,
                    config.height,
                    # Device-side swapchain images are linear float; the
                    # sRGB encode happens at present (encode_present).
                    Format.RGBA32F,
                    TextureUsage.COLOR_ATTACHMENT | TextureUsage.TRANSFER_SRC,
                )
            )
            for i in range(config.num_images)
        ]

    @property
    def extent(self) -> "tuple[int, int]":
        return (self.config.width, self.config.height)

    def acquire_next_image(self) -> "tuple[int, Texture]":
        """Return (image_index, texture). Blocks only when NUM_BACK_BUFFERS
        frames are already in flight — the reference's in-flight-fence wait
        (swapchain.rs:210-231)."""
        while len(self._pending) >= self.config.num_images:
            self._deliver(self._pending.pop(0))
        idx = self._image_index
        return idx, self._textures[idx]

    def present(
        self, rendered: jax.Array, pre_encoded: "Optional[bool]" = None
    ) -> None:
        """Encode + start async readback; advances the ring
        (reference swapchain.rs:243-264).

        ``pre_encoded=True`` marks ``rendered`` as ALREADY encoded to the
        swapchain format (the frame program folded the present encode in via
        a PresentEncode node) — the extra per-frame encode dispatch is
        skipped. Default (None) infers from dtype: uint8 ⇒ pre-encoded.
        Pass ``pre_encoded=False`` to force the encode for a uint8 image
        that is NOT swapchain-formatted.

        Trap (warned under validation): a pre-encoded present leaves the
        swapchain slot holding the PREVIOUS frame's linear contents — a
        LOAD-op graph reading the swapchain image afterwards silently sees a
        stale frame. Keep the linear surface as a graph-managed resource in
        that case."""
        if pre_encoded is None:
            pre_encoded = bool(rendered.dtype == np.uint8)
        if pre_encoded:
            from zenith.core import validate

            if validate.enabled() and not getattr(self, "_warned_stale", False):
                self._warned_stale = True
                logger.warning(
                    "[validate] pre-encoded present: swapchain slot %d keeps "
                    "its previous LINEAR contents — a LOAD-op graph reading "
                    "the swapchain image next frame sees a stale frame. Use "
                    "a graph-managed linear resource for feedback loops.",
                    self._image_index,
                )
        if not pre_encoded:
            # Keep the (still device-resident) rendered image bound to the
            # slot so LOAD-op graphs can read last frame's contents.
            self._textures[self._image_index] = (
                self._textures[self._image_index].with_array(rendered)
            )
        interval = self.config.readback_interval
        if interval > 0 and self._frame_counter % interval == 0:
            encoded = (
                rendered
                if pre_encoded
                else _encode_jit(self.config.format)(rendered)
            )
            try:
                encoded.copy_to_host_async()
            except Exception:  # some backends lack async copy; readback blocks
                pass
            self._pending.append(
                _PendingFrame(self._frame_counter, encoded, time.perf_counter())
            )
        # Device-side frames-in-flight fence (device.rs:185-193 analog).
        # A blocking wait costs a full host↔device round trip and an array
        # only reports ready one round trip after submission — so the queue
        # must hold at least latency/frame_time entries to run at device
        # throughput. Drain
        # non-blockingly; beyond the cap, pace with short sleeps instead of
        # hard blocks.
        # Amortized pacing: sample every Nth frame into a tiny queue and
        # hard-fence only when more than two samples are outstanding. Worst
        # case the device queue holds 2×stride frames; the fence costs one
        # host↔device round trip per stride frames, amortized over the
        # stride.
        if self._frame_counter % self.pace_stride == 0:
            self._inflight.append(rendered)
            if len(self._inflight) > 2:
                jax.block_until_ready(self._inflight.pop(0))
        self._frame_counter += 1
        self._image_index = (self._image_index + 1) % self.config.num_images
        if self.config.present_mode == PresentMode.FIFO:
            self._pace()

    def flush(self) -> None:
        """Drain all in-flight frames (used at shutdown / for readback tests)."""
        while self._pending:
            self._deliver(self._pending.pop(0))

    def resize(self, width: int, height: int) -> None:
        """(reference swapchain.rs:275-324) drain + rebuild images; the
        frame counter keeps running across resizes."""
        self.flush()
        self.config.width = width
        self.config.height = height
        self._image_index = 0
        self.suboptimal = False
        self._textures = [
            Texture(
                TextureDesc(
                    f"swapchain.{i}",
                    width,
                    height,
                    Format.RGBA32F,
                    TextureUsage.COLOR_ATTACHMENT | TextureUsage.TRANSFER_SRC,
                )
            )
            for i in range(self.config.num_images)
        ]

    # -- internals -----------------------------------------------------------

    def _deliver(self, frame: _PendingFrame) -> None:
        if self.on_present is None:
            # No sink: FENCE only (no device→host copy, see main_loop's
            # readback policy); fences preserve the ring backpressure
            # semantics.
            jax.block_until_ready(frame.encoded)
            return
        host = np.asarray(frame.encoded)  # blocks until device + copy done
        self.on_present(host, frame.frame_counter)

    def _pace(self) -> None:
        period = 1.0 / self.config.refresh_rate
        now = time.perf_counter()
        if self._last_present_time is not None:
            sleep_for = self._last_present_time + period - now
            if sleep_for > 0:
                time.sleep(sleep_for)
                now = time.perf_counter()
        self._last_present_time = now
