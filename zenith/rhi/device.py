"""Device discovery and the render-device facade.

Mirrors zenith-rhi/src/core.rs + device.rs, minus everything XLA makes
unnecessary. What remains meaningful:

- `RhiCore` (core.rs:58-114): platform/runtime init → here, JAX backend query.
- `select_physical_device` (core.rs:304-395): scoring across devices →
  prefer a GPU over the CPU, then memory.
- `RenderDevice` (device.rs:76-359): frame-slot counter (begin/end_frame),
  per-frame stats, submission — where `queue_submit2` submitted command
  buffers, here "submission" is invoking the jitted frame program; JAX async
  dispatch gives the frames-in-flight pipelining the fences provided.
- Debug names (device.rs:16-68): arrays are labeled through desc names,
  surfaced in stats/logs.

What dissolves: memory-type selection, fences/semaphores, defer-release
(XLA allocator + GC), barriers (dataflow ordering).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import jax
import numpy as np

from zenith.core import log
from zenith.rhi.resource import Buffer, BufferUsage, ResourceCache

logger = log.get(__name__)

# Triple buffering, matching the reference (zenith-rhi/src/lib.rs:26).
NUM_BACK_BUFFERS = 3


@dataclass
class PhysicalDevice:
    """A scored compute device (reference core.rs:26-55)."""

    device: jax.Device
    score: int

    @property
    def name(self) -> str:
        return f"{self.device.platform}:{self.device.device_kind}#{self.device.id}"


def _score_device(d: jax.Device) -> int:
    """Score by platform type (reference core.rs:18-24 scores discrete >
    integrated > virtual > cpu; here a GPU outranks the CPU) plus memory."""
    score = 2_000_000 if d.platform.lower() == "gpu" else 1_000_000
    try:
        stats = d.memory_stats()
        if stats and "bytes_limit" in stats:
            score += min(stats["bytes_limit"] // (1 << 30), 999_999)
    except Exception:
        pass
    return score


def select_physical_device(devices: "Optional[list[jax.Device]]" = None) -> PhysicalDevice:
    """Pick the best device (reference core.rs:349-395)."""
    devices = devices if devices is not None else jax.devices()
    if not devices:
        raise RuntimeError("no compute devices available")
    scored = [PhysicalDevice(d, _score_device(d)) for d in devices]
    best = max(scored, key=lambda p: p.score)
    logger.info("selected device %s (kind %s, score %d) of %d", best.name,
                best.device.device_kind, best.score, len(scored))
    return best


class RhiCore:
    """Runtime entry point (reference core.rs:58-114). No instance/validation
    ceremony: JAX is already initialized; this just snapshots platform info."""

    def __init__(self) -> None:
        self.backend = jax.default_backend()
        self.devices = jax.devices()
        logger.info("RhiCore: backend=%s devices=%d", self.backend, len(self.devices))

    def create_render_device(self, physical: Optional[PhysicalDevice] = None) -> "RenderDevice":
        return RenderDevice(physical or select_physical_device(self.devices))


@dataclass
class FrameStats:
    """Per-second stats feed (reference main_loop.rs:146-162 + device.rs
    LastFreedStats). Tracks what the 1 Hz log line prints."""

    frame_index: int = 0
    submits: int = 0
    uploads: int = 0
    upload_bytes: int = 0


class RenderDevice:
    """The logical device (reference device.rs:76-359)."""

    def __init__(self, physical: PhysicalDevice):
        self.physical = physical
        self.device = physical.device
        self._frame_counter = 0
        self._current_frame = 0  # slot in [0, NUM_BACK_BUFFERS)
        self.stats = FrameStats()
        # Host-persistent resource recycler (swapchain/readback only; graph
        # intermediates are jit-internal).
        self.resource_cache = ResourceCache()
        self._in_flight: list[Any] = []

    # -- frame lifecycle (device.rs:185-215) --------------------------------

    @property
    def current_frame(self) -> int:
        return self._current_frame

    @property
    def frame_counter(self) -> int:
        return self._frame_counter

    def begin_frame(self) -> int:
        """Start a frame slot. The fence-wait of the reference (device.rs:
        185-193) is implicit: backpressure comes from the swapchain blocking
        on the N-frames-ago readback."""
        self.stats.frame_index = self._frame_counter
        return self._current_frame

    def end_frame(self) -> None:
        self._frame_counter += 1
        self._current_frame = self._frame_counter % NUM_BACK_BUFFERS

    # -- submission ----------------------------------------------------------

    def submit(self, fn, *args, **kwargs):
        """Invoke a (jitted) frame program. Returns its (async) outputs —
        the analog of queue_submit2 (device.rs:297-338): the call enqueues
        device work and returns immediately under JAX async dispatch."""
        self.stats.submits += 1
        return fn(*args, **kwargs)

    def wait_until_idle(self, *arrays: Any) -> None:
        """Block until given arrays (or all known in-flight work) complete
        (reference device.rs wait_until_idle)."""
        targets = arrays if arrays else tuple(self._in_flight)
        for a in targets:
            jax.block_until_ready(a)
        if not arrays:
            self._in_flight.clear()

    def track(self, array: Any) -> Any:
        self._in_flight.append(array)
        if len(self._in_flight) > 64:
            del self._in_flight[:32]
        return array

    # -- debug names (reference device.rs:16-68) ------------------------------

    def set_debug_name(self, obj: Any, name: str) -> Any:
        """Attach a debug name to any RHI object — the
        ``set_debug_utils_object_name`` analog (device.rs:16-68). Resources
        default to their desc name; an explicit debug name overrides it in
        diagnostics (validation warnings, graph hazard messages). Returns
        ``obj`` for chaining, like the reference's builder style."""
        try:
            obj.debug_name = name
        except AttributeError:
            object.__setattr__(obj, "debug_name", name)
        return obj

    # -- uploads (the UploadPool analog, reference upload.rs) ----------------

    def upload_buffer(self, name: str, data: np.ndarray,
                      usage: BufferUsage = BufferUsage.STORAGE) -> Buffer:
        """Host→HBM upload. device_put replaces the staging-buffer + barrier
        + blocking-submit dance of upload.rs:92-192."""
        buf = Buffer.from_numpy(name, data, usage)
        self.stats.uploads += 1
        self.stats.upload_bytes += data.nbytes
        return buf

    def put(self, array: np.ndarray) -> jax.Array:
        return jax.device_put(np.asarray(array), self.device)
