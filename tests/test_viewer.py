"""Interactive HTTP viewer (zenith/viewer.py) — the winit front-end
analog (reference main_loop.rs:21-62). Verifies the full wire contract
without a browser: input POSTed as JSON lands in the Window event queue as
the typed events of core.events, and presented frames come back over
/frame and the MJPEG /stream."""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest

from zenith.core.events import (
    CloseRequested,
    ElementState,
    KeyboardInput,
    KeyCode,
    MouseButton,
    MouseInput,
    MouseMotion,
    Resized,
)
from zenith.viewer import ViewerServer, decode_event, keycode_from_js
from zenith.window import Window


@pytest.fixture()
def served():
    window = Window(width=64, height=32, title="t")
    viewer = ViewerServer(window, port=0).start()
    yield window, viewer
    viewer.stop()


def _url(viewer, path):
    return viewer.url.rstrip("/") + path


def _post(viewer, path, payload):
    req = urllib.request.Request(
        _url(viewer, path), data=json.dumps(payload).encode(), method="POST"
    )
    with urllib.request.urlopen(req, timeout=5) as resp:
        return resp.status, json.loads(resp.read())


class TestWireDecode:
    def test_js_keymap_covers_contract(self):
        assert keycode_from_js("KeyW") is KeyCode.KEY_W
        assert keycode_from_js("ShiftLeft") is KeyCode.SHIFT_LEFT
        assert keycode_from_js("ArrowUp") is KeyCode.ARROW_UP
        assert keycode_from_js("F13") is None  # outside the contract

    def test_decode_key(self):
        ev = decode_event({"type": "key", "code": "KeyW", "state": "down"})
        assert ev == KeyboardInput(KeyCode.KEY_W, ElementState.PRESSED)
        ev = decode_event(
            {"type": "key", "code": "KeyW", "state": "down", "repeat": True}
        )
        assert ev.repeat
        ev = decode_event({"type": "key", "code": "KeyW", "state": "up"})
        assert ev.state is ElementState.RELEASED

    def test_decode_button_motion_resize_close(self):
        assert decode_event(
            {"type": "button", "button": 0, "state": "down"}
        ) == MouseInput(MouseButton.LEFT, ElementState.PRESSED)
        m = decode_event({"type": "motion", "dx": 1.5, "dy": -0.25})
        assert m == MouseMotion(dx=1.5, dy=-0.25)
        assert decode_event(
            {"type": "resize", "width": 800, "height": 600}
        ) == Resized(800, 600)
        assert isinstance(decode_event({"type": "close"}), CloseRequested)

    def test_decode_unknown_is_none(self):
        assert decode_event({"type": "key", "code": "F13", "state": "down"}) is None
        assert decode_event({"type": "gamepad"}) is None
        assert decode_event({}) is None


class TestEventsEndpoint:
    def test_events_land_typed_in_window_queue(self, served):
        window, viewer = served
        status, body = _post(viewer, "/events", [
            {"type": "key", "code": "KeyW", "state": "down"},
            {"type": "button", "button": 0, "state": "down"},
            {"type": "motion", "dx": 2.0, "dy": 1.0},
            {"type": "key", "code": "F13", "state": "down"},  # dropped
        ])
        assert status == 200 and body["accepted"] == 3
        wevents = window.drain_window_events()
        assert wevents == [
            KeyboardInput(KeyCode.KEY_W, ElementState.PRESSED),
            MouseInput(MouseButton.LEFT, ElementState.PRESSED),
        ]
        assert window.drain_device_events() == [MouseMotion(dx=2.0, dy=1.0)]

    def test_close_event_reaches_queue(self, served):
        window, viewer = served
        _post(viewer, "/events", [{"type": "close"}])
        assert isinstance(window.drain_window_events()[0], CloseRequested)

    def test_bad_json_is_400(self, served):
        _window, viewer = served
        req = urllib.request.Request(
            _url(viewer, "/events"), data=b"{nope", method="POST"
        )
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=5)
        assert exc.value.code == 400


class TestFrameDelivery:
    def _present(self, window, seed=0):
        rng = np.random.default_rng(seed)
        frame = rng.integers(
            0, 255, (window.height, window.width, 4), dtype=np.uint8
        )
        window.present(frame, window.presented_frames)
        return frame

    def test_frame_endpoint_encodes_latest_present(self, served):
        window, viewer = served
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(_url(viewer, "/frame"), timeout=5)
        assert exc.value.code == 503  # nothing presented yet
        self._present(window)
        with urllib.request.urlopen(_url(viewer, "/frame"), timeout=5) as resp:
            assert resp.status == 200
            mime = resp.headers["Content-Type"]
            data = resp.read()
        assert mime in ("image/jpeg", "image/png") and len(data) > 100
        magic = {b"\xff\xd8": "image/jpeg", b"\x89P": "image/png"}
        assert magic[data[:2]] == mime

    def test_stats_endpoint(self, served):
        window, viewer = served
        self._present(window)
        with urllib.request.urlopen(_url(viewer, "/stats"), timeout=5) as resp:
            stats = json.loads(resp.read())
        assert stats == {
            "presented_frames": 1, "width": 64, "height": 32, "closed": False,
            "quality": 85,
        }

    def test_stream_yields_multipart_frames(self, served):
        import threading
        import time

        window, viewer = served
        self._present(window)

        def keep_presenting():
            for i in range(20):
                self._present(window, seed=i + 1)
                time.sleep(0.01)

        t = threading.Thread(target=keep_presenting, daemon=True)
        t.start()
        with urllib.request.urlopen(_url(viewer, "/stream"), timeout=5) as resp:
            assert "multipart/x-mixed-replace" in resp.headers["Content-Type"]
            blob = resp.read(40000)
        t.join()
        assert blob.count(b"--zenithframe") >= 1
        assert b"Content-Type: image/" in blob

    def test_present_hook_chains(self):
        seen = []
        window = Window(width=8, height=8, on_present=lambda img, i: seen.append(i))
        viewer = ViewerServer(window, port=0).start()
        try:
            window.present(np.zeros((8, 8, 4), np.uint8), 7)
            assert seen == [7]
            assert viewer.wait_frame(0, timeout=1.0) == 1
        finally:
            viewer.stop()


class TestAdaptiveStream:
    """Dynamic-resolution controller (viewer.AdaptiveStream): rung ladder,
    probe-driven initial pick, runtime step-down/step-up with hysteresis,
    bottom-rung quality degradation. Time is injected by monkeypatching
    time.perf_counter so the hysteresis windows are deterministic."""

    def _make(self, monkeypatch, target=30.0, view=(1280, 720)):
        from zenith import viewer as viewer_mod

        clock = [1000.0]
        monkeypatch.setattr(viewer_mod.time, "perf_counter", lambda: clock[0])
        window = Window(width=view[0], height=view[1], title="t")
        adaptive = viewer_mod.AdaptiveStream(window, target_fps=target)
        return adaptive, window, clock

    def _run_frames(self, adaptive, clock, fps, seconds):
        dt = 1.0 / fps
        end = clock[0] + seconds
        while clock[0] < end:
            clock[0] += dt
            adaptive.note_present()

    def test_rung_ladder_preserves_aspect_and_dedups(self, monkeypatch):
        adaptive, _, _ = self._make(monkeypatch)
        assert adaptive.rungs[0] == (1280, 720)
        aspect = 1280 / 720
        for w, h in adaptive.rungs:
            assert w % 8 == 0 and h % 8 == 0
            assert abs(w / h - aspect) < 0.06
        assert len(adaptive.rungs) == len(set(adaptive.rungs))
        assert sorted(adaptive.rungs, reverse=True) == adaptive.rungs

    def test_pick_initial_from_probe(self, monkeypatch):
        adaptive, window, _ = self._make(monkeypatch, target=30.0)
        # 720p too slow (50 ms > 30 ms budget), the next rung fits.
        probe = {
            adaptive.rungs[0]: {"ms": 50.0},
            adaptive.rungs[1]: {"ms": 20.0},
        }
        w, h = adaptive.pick_initial(probe)
        assert (w, h) == adaptive.rungs[1]
        ev = window.drain_window_events()
        assert ev and ev[-1] == Resized(w, h)

    def test_pick_initial_all_slow_lands_bottom(self, monkeypatch):
        adaptive, _, _ = self._make(monkeypatch)
        probe = {wh: {"ms": 500.0} for wh in adaptive.rungs}
        assert adaptive.pick_initial(probe) == adaptive.rungs[-1]

    def test_sustained_shortfall_steps_down(self, monkeypatch):
        adaptive, window, clock = self._make(monkeypatch, target=30.0)
        adaptive._apply()
        window.drain_window_events()
        self._run_frames(adaptive, clock, fps=15.0, seconds=6.0)
        assert adaptive.rung >= 1
        ev = window.drain_window_events()
        assert any(isinstance(e, Resized) for e in ev)

    def test_headroom_steps_up_after_hold(self, monkeypatch):
        adaptive, window, clock = self._make(monkeypatch, target=30.0)
        adaptive.rung = 2
        adaptive._apply()
        window.drain_window_events()
        # 60 FPS at rung 2: pixel-scaled prediction clears the target.
        self._run_frames(adaptive, clock, fps=60.0, seconds=8.0)
        assert adaptive.rung < 2
        assert any(
            isinstance(e, Resized) for e in window.drain_window_events()
        )

    def test_failed_rung_is_not_reentered_soon(self, monkeypatch):
        adaptive, window, clock = self._make(monkeypatch, target=30.0)
        # State after falling off rung 0: it failed just now.
        adaptive._failed_at[0] = clock[0]
        adaptive.rung = 1
        adaptive._apply()
        window.drain_window_events()
        # Plenty of headroom, but rung 0 just failed — hold for 20 s.
        self._run_frames(adaptive, clock, fps=60.0, seconds=8.0)
        assert adaptive.rung == 1
        self._run_frames(adaptive, clock, fps=60.0, seconds=15.0)
        assert adaptive.rung == 0

    def test_bottom_rung_degrades_quality_then_recovers(self, monkeypatch):
        from zenith import viewer as viewer_mod

        clock = [1000.0]
        monkeypatch.setattr(viewer_mod.time, "perf_counter", lambda: clock[0])
        window = Window(width=256, height=144, title="t")
        server = ViewerServer(window, port=0)  # not started; quality holder
        adaptive = viewer_mod.AdaptiveStream(
            window, target_fps=30.0, viewer=server
        )
        adaptive.rung = len(adaptive.rungs) - 1
        adaptive._apply()
        base_q = server.quality
        self._run_frames(adaptive, clock, fps=12.0, seconds=8.0)
        assert server.quality < base_q
        self._run_frames(adaptive, clock, fps=40.0, seconds=10.0)
        assert server.quality == base_q

    def test_stats_reports_adaptive_state(self, served):
        window, viewer = served
        from zenith.viewer import AdaptiveStream

        viewer.adaptive = AdaptiveStream(window, target_fps=30.0,
                                         viewer=viewer)
        with urllib.request.urlopen(_url(viewer, "/stats"), timeout=5) as r:
            stats = json.loads(r.read())
        assert stats["view_width"] == 64 and stats["view_height"] == 32
        assert "rung" in stats and "fps" in stats
