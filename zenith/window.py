"""Headless window — the winit analog.

The reference creates a centered 1920×1080 winit window (main_loop.rs:21-62).
This framework is headless: a `Window` is a surface size + an event queue
that a front-end (replay script, interactive viewer, test, benchmark driver)
feeds, plus a present sink that receives finished frames (encoded host
images) — PNG dumping built in.
"""

from __future__ import annotations

from collections import deque
from pathlib import Path
from typing import Callable, Deque, Optional, Union

import numpy as np

from zenith.core import log
from zenith.core.events import DeviceEvent, WindowEvent

logger = log.get(__name__)

DEFAULT_WIDTH = 1920  # main_loop.rs:22 parity
DEFAULT_HEIGHT = 1080


class Window:
    def __init__(
        self,
        width: int = DEFAULT_WIDTH,
        height: int = DEFAULT_HEIGHT,
        title: str = "zenith",
        on_present: "Optional[Callable[[np.ndarray, int], None]]" = None,
    ):
        self.width = width
        self.height = height
        self.title = title
        self.on_present = on_present
        self.closed = False
        self._window_events: Deque[WindowEvent] = deque()
        self._device_events: Deque[DeviceEvent] = deque()
        self._dump_dir: Optional[Path] = None
        self._dump_every: int = 0
        self.last_frame: Optional[np.ndarray] = None
        self.presented_frames = 0

    @property
    def extent(self) -> "tuple[int, int]":
        return (self.width, self.height)

    # -- event feeding (front-end side) ---------------------------------------

    def push_window_event(self, event: WindowEvent) -> None:
        self._window_events.append(event)

    def push_device_event(self, event: DeviceEvent) -> None:
        self._device_events.append(event)

    def drain_window_events(self) -> "list[WindowEvent]":
        out = list(self._window_events)
        self._window_events.clear()
        return out

    def drain_device_events(self) -> "list[DeviceEvent]":
        out = list(self._device_events)
        self._device_events.clear()
        return out

    def request_close(self) -> None:
        self.closed = True

    # -- present sink ----------------------------------------------------------

    def enable_png_dump(self, directory: "Union[str, Path]", every: int = 1) -> None:
        """Write presented frames as PNGs: frame_%05d.png under `directory`."""
        self._dump_dir = Path(directory)
        self._dump_dir.mkdir(parents=True, exist_ok=True)
        self._dump_every = max(1, every)

    def present(self, image: np.ndarray, frame_index: int) -> None:
        """Receives the encoded host frame from the swapchain."""
        self.last_frame = image
        self.presented_frames += 1
        if self.on_present is not None:
            self.on_present(image, frame_index)
        if self._dump_dir is not None and frame_index % self._dump_every == 0:
            self.write_png(self._dump_dir / f"frame_{frame_index:05d}.png", image)

    @staticmethod
    def write_png(path: "Union[str, Path]", image: np.ndarray) -> None:
        from zenith.native import encode_png

        arr = np.asarray(image)
        if arr.shape[-1] == 4:
            # Host images arrive in the swapchain format's channel order;
            # BGRA → RGB for viewing.
            arr = arr[..., [2, 1, 0]]
        Path(path).write_bytes(encode_png(arr))
        logger.debug("wrote %s", path)
