"""Interactive HTTP viewer — the winit front-end analog.

The reference is an interactive windowed renderer: winit creates the OS
window, delivers keyboard/mouse events, and the app redraws continuously
(/root/reference/zenith/src/main_loop.rs:21-62,107-138). This framework is
headless (frames are device arrays; "present" is a host readback), so the
front-end half lives here instead: a tiny stdlib HTTP server that

- streams presented frames to any browser as MJPEG
  (``multipart/x-mixed-replace``; JPEG via PIL when available, PNG
  fallback), and
- receives keyboard/mouse input from the browser page and feeds it into
  the ``Window`` event queue as the typed events of ``core.events`` —
  the same contract scripted replays and tests use.

So the full interactive loop is: browser keydown → POST /events →
``Window.push_window_event(KeyboardInput(...))`` → ``EngineLoop._pump_events``
→ ``InputActionMapper``/``CameraController`` → camera moves → frame renders
on the device → swapchain readback → ``Window.present`` → MJPEG part → browser.

Run:  python -m zenith.sandbox.fly --serve 8089
then open http://127.0.0.1:8089/ and fly with WASD/QE + drag-to-look
(click the view to grab the pointer, Esc to release, Shift to sprint).

Threading: the engine loop owns the main thread; the HTTP server runs
daemon threads. ``deque.append`` / the present hook are GIL-atomic, so the
queue handoff needs no locks; the stream handler waits on a Condition the
present hook notifies.
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from zenith.core import log
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
from zenith.window import Window

logger = log.get(__name__)

# JS KeyboardEvent.code → KeyCode (winit::keyboard::KeyCode parity — the
# browser uses the same physical-key naming, "KeyW"/"ShiftLeft"/"ArrowUp").
_JS_KEYMAP = {
    "KeyW": KeyCode.KEY_W,
    "KeyA": KeyCode.KEY_A,
    "KeyS": KeyCode.KEY_S,
    "KeyD": KeyCode.KEY_D,
    "KeyQ": KeyCode.KEY_Q,
    "KeyE": KeyCode.KEY_E,
    "KeyR": KeyCode.KEY_R,
    "KeyF": KeyCode.KEY_F,
    "Space": KeyCode.SPACE,
    "ShiftLeft": KeyCode.SHIFT_LEFT,
    "ControlLeft": KeyCode.CONTROL_LEFT,
    "AltLeft": KeyCode.ALT_LEFT,
    "MetaLeft": KeyCode.SUPER_LEFT,
    "Escape": KeyCode.ESCAPE,
    "Tab": KeyCode.TAB,
    "Enter": KeyCode.ENTER,
    "ArrowUp": KeyCode.ARROW_UP,
    "ArrowDown": KeyCode.ARROW_DOWN,
    "ArrowLeft": KeyCode.ARROW_LEFT,
    "ArrowRight": KeyCode.ARROW_RIGHT,
}

_JS_BUTTONS = {0: MouseButton.LEFT, 1: MouseButton.MIDDLE, 2: MouseButton.RIGHT}


def keycode_from_js(code: str) -> Optional[KeyCode]:
    """Map a JS ``KeyboardEvent.code`` to the framework KeyCode (None =
    key not in the contract; the page just drops it)."""
    return _JS_KEYMAP.get(code)


def decode_event(msg: dict):
    """One JSON wire event → a typed core.events event, or None.

    Wire format (the page's half of the contract):
      {"type": "key",    "code": "KeyW", "state": "down"|"up", "repeat": bool}
      {"type": "button", "button": 0|1|2, "state": "down"|"up"}
      {"type": "motion", "dx": float, "dy": float}
      {"type": "resize", "width": int, "height": int}
      {"type": "close"}
    """
    kind = msg.get("type")
    if kind == "key":
        key = keycode_from_js(str(msg.get("code", "")))
        if key is None:
            return None
        state = (
            ElementState.PRESSED
            if msg.get("state") == "down"
            else ElementState.RELEASED
        )
        return KeyboardInput(key, state, repeat=bool(msg.get("repeat", False)))
    if kind == "button":
        button = _JS_BUTTONS.get(int(msg.get("button", 0)))
        if button is None:
            return None
        state = (
            ElementState.PRESSED
            if msg.get("state") == "down"
            else ElementState.RELEASED
        )
        return MouseInput(button, state)
    if kind == "motion":
        return MouseMotion(dx=float(msg.get("dx", 0.0)), dy=float(msg.get("dy", 0.0)))
    if kind == "resize":
        return Resized(int(msg["width"]), int(msg["height"]))
    if kind == "close":
        return CloseRequested()
    return None


def encode_jpeg(frame: np.ndarray, quality: int = 85) -> "tuple[bytes, str]":
    """Encoded image bytes + MIME for one presented host frame.

    Frames arrive in the swapchain channel order (BGRA, like
    ``Window.write_png``); JPEG via PIL when installed, lossless PNG via
    the native encoder otherwise.
    """
    arr = np.asarray(frame)
    if arr.ndim == 3 and arr.shape[-1] == 4:
        arr = arr[..., [2, 1, 0]]  # BGRA → RGB
    if arr.dtype != np.uint8:
        if arr.dtype.kind == "f":
            arr = np.clip(arr, 0.0, 1.0) * 255.0 + 0.5
        arr = arr.astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        from zenith.native import encode_png

        return encode_png(np.ascontiguousarray(arr)), "image/png"
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(arr)).save(buf, "JPEG", quality=quality)
    return buf.getvalue(), "image/jpeg"


def probe_transport(
    sizes: "list[tuple[int, int]]", frames: int = 24, quality: int = 80
) -> "dict[tuple[int, int], dict]":
    """Measure what the device→host readback + host JPEG encoder actually
    deliver per frame size, on synthetic device frames (~0.3 s per size).

    Returns ``{(w, h): {"readback_ms": .., "jpeg_ms": .., "ms": ..}}``
    where ``ms`` is the predicted per-frame service time: pipelined
    readback (the swapchain ring discipline) + JPEG encode, both of which
    serialize on the single host core in an interactive session. This is
    the measurement ``AdaptiveStream`` picks its starting rung from."""
    import time

    import jax
    import jax.numpy as jnp

    out: "dict[tuple[int, int], dict]" = {}
    for w, h in sizes:
        @jax.jit
        def make(i, h=h, w=w):
            r = (
                jnp.arange(h, dtype=jnp.uint32)[:, None]
                + jnp.arange(w, dtype=jnp.uint32)[None, :] * 3
                + i
            )
            v = (r % 251).astype(jnp.uint8)
            return jnp.stack([v, v ^ 85, v ^ 170, jnp.full_like(v, 255)], -1)

        pool = [make(i) for i in range(4)]
        jax.block_until_ready(pool)
        # Pipelined readback with the swapchain's ring depth.
        pending = []
        t0 = time.perf_counter()
        for i in range(frames):
            f = pool[i % len(pool)]
            try:
                f.copy_to_host_async()
            except Exception:
                pass
            pending.append(f)
            if len(pending) >= 3:
                np.asarray(pending.pop(0))
        while pending:
            np.asarray(pending.pop(0))
        readback_ms = (time.perf_counter() - t0) / frames * 1e3
        # Host JPEG encode at this size (min of 3).
        host = np.asarray(pool[0])
        enc_ms = 0.0
        try:
            enc = []
            for _ in range(3):
                t0 = time.perf_counter()
                encode_jpeg(host, quality)
                enc.append(time.perf_counter() - t0)
            enc_ms = min(enc) * 1e3
        except Exception:
            pass
        out[(w, h)] = {
            "readback_ms": round(readback_ms, 2),
            "jpeg_ms": round(enc_ms, 2),
            "ms": round(readback_ms + enc_ms, 2),
        }
        logger.info(
            "transport probe %dx%d: readback %.1f ms + jpeg %.1f ms",
            w, h, readback_ms, enc_ms,
        )
    return out


class AdaptiveStream:
    """Dynamic-resolution controller for the interactive viewer.

    The interactive bottleneck can be the device→host readback plus the
    host JPEG encode rather than rendering (moving 720p RGBA at 30 FPS
    needs ~111 MB/s of readback). Instead of streaming a postage stamp,
    the controller treats render resolution as the lever — dynamic
    resolution scaling, the same trick games use against a fixed GPU
    budget, pointed here at the transport:

    1. At serve start it probes the transport per rung
       (:func:`probe_transport`) and starts at the largest rung predicted
       to hold ``target_fps``.
    2. At runtime it watches the presented-frame rate: sustained shortfall
       (< 0.85x target) steps DOWN a rung; sustained headroom whose
       pixel-scaled prediction clears the target steps back UP. Hysteresis
       (hold-down timers + a re-entry cooldown on rungs that just failed)
       keeps it from flapping.
    3. At the bottom rung, shortfall degrades JPEG quality instead (the
       last, cheapest lever); recovery restores it.

    A rung change is one ``Resized`` event through the window queue — the
    engine recompiles at the new extent (revisits hit the per-size program
    cache), the camera aspect is unchanged because every rung preserves
    the view aspect, and the browser page upscales the stream to the view
    size, so the user keeps a full-size viewport throughout.
    """

    RUNG_SCALES = (1.0, 0.75, 2.0 / 3.0, 0.5, 0.375, 0.25)

    def __init__(
        self,
        window: Window,
        target_fps: float = 30.0,
        viewer: "Optional[ViewerServer]" = None,
        scales: "tuple[float, ...]" = RUNG_SCALES,
    ):
        self.window = window
        self.target_fps = target_fps
        self.viewer = viewer
        self.view_w, self.view_h = window.width, window.height
        self.rungs: "list[tuple[int, int]]" = []
        for s in scales:
            w = max(64, int(self.view_w * s) // 8 * 8)
            h = max(64, int(self.view_h * s) // 8 * 8)
            if (w, h) not in self.rungs:
                self.rungs.append((w, h))
        self.rung = 0
        self._base_quality = viewer.quality if viewer is not None else 80
        self._times: "deque[float]" = deque(maxlen=64)
        self._last_change = 0.0
        self._last_eval = 0.0
        self._failed_at: "dict[int, float]" = {}  # rung → when it last failed
        self.measured_fps = 0.0

    # -- rung selection --------------------------------------------------------

    def pick_initial(self, probe: "Optional[dict]" = None) -> "tuple[int, int]":
        """Choose the starting rung from a transport probe and apply it.
        ``probe`` defaults to measuring the first rungs now (serve start)."""
        if probe is None:
            probe = probe_transport(self.rungs, quality=self._base_quality)
        budget_ms = 1e3 / self.target_fps * 0.9  # 10% safety margin
        self.rung = len(self.rungs) - 1
        for i, wh in enumerate(self.rungs):
            ms = probe.get(wh, {}).get("ms")
            if ms is not None and ms <= budget_ms:
                self.rung = i
                break
        self._apply()
        return self.rungs[self.rung]

    def _apply(self) -> None:
        w, h = self.rungs[self.rung]
        if (w, h) != (self.window.width, self.window.height):
            self.window.push_window_event(Resized(w, h))
        self._last_change = time.perf_counter()
        self._times.clear()
        logger.info(
            "adaptive stream: rung %d/%d -> %dx%d (target %.0f FPS)",
            self.rung, len(self.rungs) - 1, w, h, self.target_fps,
        )

    # -- runtime control (called from the present hook, engine thread) ---------

    def note_present(self) -> None:
        now = time.perf_counter()
        self._times.append(now)
        if now - self._last_eval < 1.0:
            return
        self._last_eval = now
        self._evaluate(now)

    def _fps(self, now: float, window_s: float = 2.0) -> "Optional[float]":
        recent = [t for t in self._times if now - t <= window_s]
        if len(recent) < 8:
            return None
        span = recent[-1] - recent[0]
        if span <= 0.0:
            return None
        return (len(recent) - 1) / span

    def _evaluate(self, now: float) -> None:
        fps = self._fps(now)
        if fps is None:
            return
        self.measured_fps = fps
        if now - self._last_change < 2.5:  # settle after any change
            return
        target = self.target_fps
        if fps < 0.85 * target:
            if self.rung + 1 < len(self.rungs):
                self._failed_at[self.rung] = now
                self.rung += 1
                self._apply()
            elif self.viewer is not None and self.viewer.quality > 50:
                # Bottom rung: degrade encode quality, the last lever.
                self.viewer.quality = max(50, self.viewer.quality - 15)
                self._last_change = now
                logger.info(
                    "adaptive stream: bottom rung, quality -> %d",
                    self.viewer.quality,
                )
            return
        if (
            self.viewer is not None
            and self.viewer.quality < self._base_quality
            and fps >= 1.05 * target
        ):
            self.viewer.quality = min(
                self._base_quality, self.viewer.quality + 15
            )
            self._last_change = now
            return
        if self.rung > 0 and now - self._last_change > 6.0:
            up = self.rung - 1
            if now - self._failed_at.get(up, 0.0) < 20.0:
                return  # that rung just failed; don't flap back
            w0, h0 = self.rungs[self.rung]
            w1, h1 = self.rungs[up]
            # Optimistic margin (1.1x, not 1/0.85): measured fps saturates
            # at the pace cap, hiding headroom — a wrong step up costs one
            # step back down plus the 20 s re-entry cooldown.
            predicted = fps * (w0 * h0) / (w1 * h1)
            if predicted >= target * 1.1:
                self.rung = up
                self._apply()


def serve_loop(
    loop,
    port: int,
    fps_cap: float = 60.0,
    adaptive: bool = True,
    target_fps: float = 30.0,
    max_frames: "Optional[int]" = None,
) -> "ViewerServer":
    """Run an EngineLoop interactively behind a ViewerServer — the shared
    ``--serve`` path every sandbox app uses. ``adaptive=True`` (default)
    probes the transport and holds ``target_fps`` by dynamic resolution
    (:class:`AdaptiveStream`); the browser keeps a full-size viewport."""
    viewer = ViewerServer(loop.window, port=port).start()
    if adaptive:
        viewer.adaptive = AdaptiveStream(
            loop.window, target_fps=target_fps, viewer=viewer
        )
        w, h = viewer.adaptive.pick_initial()
        print(f"adaptive stream: starting at {w}x{h} "
              f"(view {viewer.adaptive.view_w}x{viewer.adaptive.view_h}, "
              f"target {target_fps:.0f} FPS)")
    print(f"serving interactively at {viewer.url} (Esc in-app or close the "
          f"tab to stop; Ctrl-C here)")
    try:
        loop.run(max_frames=max_frames, frame_callback=make_pace(fps_cap))
    finally:
        viewer.stop()
    return viewer


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>zenith viewer</title><style>
  html,body { margin:0; background:#111; color:#9a9; font:12px monospace;
              height:100%; overflow:hidden; }
  #view { display:block; margin:0 auto; max-width:100vw; max-height:94vh;
          image-rendering:auto; cursor:crosshair; }
  #bar { height:6vh; display:flex; align-items:center; justify-content:center;
         gap:2em; user-select:none; }
</style></head><body>
<img id="view" src="/stream" draggable="false">
<div id="bar"><span>zenith — WASD/QE move, click to grab mouse-look,
Esc releases, Shift sprints</span><span id="stat"></span></div>
<script>
const view = document.getElementById('view');
const stat = document.getElementById('stat');
let queue = [];
function push(ev) { queue.push(ev); }
setInterval(() => {
  if (!queue.length) return;
  const batch = queue; queue = [];
  fetch('/events', {method: 'POST', body: JSON.stringify(batch),
                    keepalive: true}).catch(() => {});
}, 16);
window.addEventListener('keydown', e => {
  if (e.repeat) { push({type:'key', code:e.code, state:'down', repeat:true}); }
  else push({type:'key', code:e.code, state:'down'});
  if (e.code !== 'Escape') e.preventDefault();
});
window.addEventListener('keyup', e => {
  push({type:'key', code:e.code, state:'up'}); e.preventDefault();
});
view.addEventListener('click', () => view.requestPointerLock());
window.addEventListener('mousedown', e =>
  push({type:'button', button:e.button, state:'down'}));
window.addEventListener('mouseup', e =>
  push({type:'button', button:e.button, state:'up'}));
window.addEventListener('mousemove', e => {
  if (document.pointerLockElement === view)
    push({type:'motion', dx:e.movementX, dy:e.movementY});
});
document.addEventListener('pointerlockchange', () => {
  // Pointer grab doubles as the look button (CameraController grabs on
  // LMB, camera.rs:232-269 parity) — hold it for the lock's duration.
  const locked = document.pointerLockElement === view;
  push({type:'button', button:0, state: locked ? 'down' : 'up'});
});
window.addEventListener('beforeunload', () => {
  navigator.sendBeacon('/events', JSON.stringify([{type:'close'}]));
});
setInterval(async () => {
  try {
    const s = await (await fetch('/stats')).json();
    // Dynamic resolution: the stream may be smaller than the view — hold
    // the viewport at the view size and let the browser upscale.
    if (s.view_width) view.style.width = Math.min(s.view_width,
        window.innerWidth) + 'px';
    stat.textContent = s.view_width
      ? `${s.width}x${s.height} @ q${s.quality} | ${s.fps ?? '?'} FPS ` +
        `(view ${s.view_width}x${s.view_height}, rung ${s.rung})`
      : JSON.stringify(s);
  } catch (e) {}
}, 1000);
</script></body></html>
"""

_BOUNDARY = "zenithframe"


def make_pace(fps_cap: float = 60.0):
    """Frame callback that paces the engine loop to ``fps_cap`` — an
    interactive session must not spin the chip (and the MJPEG encoder)
    for frames nobody sees. Device readback back-pressure may pace lower
    still."""
    import time

    min_dt = 1.0 / max(fps_cap, 1e-3)
    last = [0.0]

    def pace(_frame: int, _window) -> None:
        now = time.perf_counter()
        if now - last[0] < min_dt:
            time.sleep(min_dt - (now - last[0]))
        last[0] = time.perf_counter()

    return pace


class ViewerServer:
    """Serve a ``Window`` over HTTP: MJPEG stream out, input events in."""

    def __init__(
        self,
        window: Window,
        host: str = "127.0.0.1",
        port: int = 8089,
        quality: int = 85,
        max_stream_fps: float = 60.0,
    ):
        self.window = window
        self.host = host
        self.port = port
        self.quality = quality
        self.max_stream_fps = max_stream_fps
        self.adaptive: "Optional[AdaptiveStream]" = None
        self._cond = threading.Condition()
        self._frame_seq = 0
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._prev_on_present = window.on_present
        window.on_present = self._on_present

    # -- present hook (render thread) ----------------------------------------

    def _on_present(self, image: np.ndarray, frame_index: int) -> None:
        if self._prev_on_present is not None:
            self._prev_on_present(image, frame_index)
        if self.adaptive is not None:
            self.adaptive.note_present()
        with self._cond:
            self._frame_seq += 1
            self._cond.notify_all()

    def wait_frame(self, seen: int, timeout: float = 1.0) -> int:
        """Block until a frame newer than ``seen`` was presented; returns
        the current sequence number (== ``seen`` on timeout)."""
        with self._cond:
            self._cond.wait_for(lambda: self._frame_seq > seen, timeout)
            return self._frame_seq

    # -- lifecycle -------------------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def start(self) -> "ViewerServer":
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through our logger
                logger.debug("http: " + fmt, *args)

            def _send(self, code: int, body: bytes, mime: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", mime)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
                elif self.path == "/frame":
                    frame = viewer.window.last_frame
                    if frame is None:
                        self._send(503, b"no frame presented yet", "text/plain")
                        return
                    body, mime = encode_jpeg(frame, viewer.quality)
                    self._send(200, body, mime)
                elif self.path == "/stats":
                    w = viewer.window
                    stats = {
                        "presented_frames": w.presented_frames,
                        "width": w.width,
                        "height": w.height,
                        "closed": w.closed,
                        "quality": viewer.quality,
                    }
                    if viewer.adaptive is not None:
                        a = viewer.adaptive
                        stats.update(
                            view_width=a.view_w,
                            view_height=a.view_h,
                            rung=a.rung,
                            fps=round(a.measured_fps, 1),
                        )
                    body = json.dumps(stats).encode()
                    self._send(200, body, "application/json")
                elif self.path == "/stream":
                    self._stream()
                else:
                    self._send(404, b"not found", "text/plain")

            def _stream(self):
                import time as _time

                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    f"multipart/x-mixed-replace; boundary={_BOUNDARY}",
                )
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                seen = 0
                min_dt = 1.0 / max(viewer.max_stream_fps, 1e-3)
                last = 0.0
                try:
                    while not viewer.window.closed:
                        seen = viewer.wait_frame(seen)
                        frame = viewer.window.last_frame
                        if frame is None:
                            continue
                        now = _time.perf_counter()
                        if now - last < min_dt:
                            _time.sleep(min_dt - (now - last))
                        last = _time.perf_counter()
                        body, mime = encode_jpeg(frame, viewer.quality)
                        self.wfile.write(
                            (
                                f"--{_BOUNDARY}\r\nContent-Type: {mime}\r\n"
                                f"Content-Length: {len(body)}\r\n\r\n"
                            ).encode()
                        )
                        self.wfile.write(body)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # viewer tab closed

            def do_POST(self):
                if self.path != "/events":
                    self._send(404, b"not found", "text/plain")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    batch = json.loads(self.rfile.read(n) or b"[]")
                except json.JSONDecodeError:
                    self._send(400, b"bad json", "text/plain")
                    return
                if isinstance(batch, dict):
                    batch = [batch]
                accepted = 0
                for msg in batch:
                    event = decode_event(msg)
                    if event is None:
                        continue
                    accepted += 1
                    if isinstance(event, MouseMotion):
                        viewer.window.push_device_event(event)
                    else:
                        viewer.window.push_window_event(event)
                self._send(
                    200, json.dumps({"accepted": accepted}).encode(),
                    "application/json",
                )

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="zenith-viewer", daemon=True
        )
        self._thread.start()
        logger.info("viewer serving at %s", self.url)
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            # Wake any /stream handlers blocked on the frame condition so
            # their daemon threads exit promptly.
            with self._cond:
                self._cond.notify_all()
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
