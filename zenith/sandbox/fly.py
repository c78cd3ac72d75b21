"""FlyApp — interactive fly-camera over the scene.

Exercises the full input stack end-to-end (the reference's camera workflow:
InputActionMapper axes + CameraController mouse smoothing, camera.rs:232-269
+ input.rs:275-302) through the real engine loop. Headless: events come from
the window's event queue — fed interactively by a front-end, or synthesized
by ``--flight`` which replays a scripted WASD+mouse path.

Run:  python -m zenith.sandbox.fly --frames 240 --out /tmp/fly.png
Interactive (the winit-window analog, zenith.viewer):
      python -m zenith.sandbox.fly --serve 8089
then open http://127.0.0.1:8089/ in a browser and fly for real.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional

import numpy as np

from zenith.app import Args, RenderableApp, RenderContext
from zenith.core.camera import Camera, CameraController
from zenith.core.events import (
    ElementState,
    KeyboardInput,
    KeyCode,
    MouseButton,
    MouseInput,
    MouseMotion,
)
from zenith.core.input import InputActionMapper
from zenith.core.mathtypes import Degree
from zenith.renderer import ForwardShadowRenderer
from zenith.rhi import TextureDesc
from zenith.sandbox.scene import build_scene


class FlyApp(RenderableApp):
    def __init__(self, args: Args):
        super().__init__(args)
        self.renderer = None
        self.camera: Optional[Camera] = None
        self.controller = CameraController(mouse_sensitivity=0.4)
        self.mapper = InputActionMapper()
        # WASD + QE vertical, like any fly camera.
        self.mapper.register_axis("forward", [KeyCode.KEY_W], [KeyCode.KEY_S], 0.5)
        self.mapper.register_axis("right", [KeyCode.KEY_D], [KeyCode.KEY_A], 0.5)
        self.mapper.register_axis("up", [KeyCode.KEY_E], [KeyCode.KEY_Q], 0.5)
        self.mapper.register_action("quit", [KeyCode.ESCAPE])
        self._quit_requested = False

    def prepare(self, render_device, window) -> None:
        scene = build_scene(render_device, 0, np.random.default_rng(42))
        self.renderer = ForwardShadowRenderer(scene)
        self.camera = Camera(
            fov_y=Degree(40.0), aspect_ratio=window.width / max(window.height, 1)
        )
        self.camera.set_position(np.array([0.0, -160.0, 30.0], np.float32))
        self.controller.move_speed = 60.0
        self._window = window

    def on_window_event(self, event) -> None:
        self.mapper.on_window_event(event)
        self.controller.on_window_event(event)

    def on_device_event(self, event) -> None:
        self.controller.on_device_event(event)

    def tick(self, delta_time: float) -> None:
        self.mapper.tick(delta_time)
        if self.mapper.is_action_just_pressed("quit"):
            self._window.request_close()
        self.controller.update_cameras(
            delta_time,
            self.mapper.get_axis("forward"),
            self.mapper.get_axis("right"),
            self.mapper.get_axis("up"),
            [self.camera],
        )

    def render(self, context: RenderContext) -> None:
        width, height = context.extent
        if width == 0 or height == 0:
            return
        builder = context.builder()
        out = builder.import_resource(context.swapchain_texture())
        depth = builder.create(TextureDesc.depth("fly.depth", width, height))
        self.renderer.render_to(builder, out, depth, self.camera)


def scripted_flight(frame: int, window) -> None:
    """Synthesized pilot: fly forward, strafe, mouse-look — the headless
    stand-in for a human at the controls."""
    if frame == 0:
        window.push_window_event(KeyboardInput(KeyCode.KEY_W, ElementState.PRESSED))
        window.push_window_event(MouseInput(MouseButton.LEFT, ElementState.PRESSED))
    if 40 <= frame < 120:
        window.push_device_event(MouseMotion(dx=1.2, dy=-0.15))
    if frame == 120:
        window.push_window_event(KeyboardInput(KeyCode.KEY_W, ElementState.RELEASED))
        window.push_window_event(KeyboardInput(KeyCode.KEY_D, ElementState.PRESSED))
    if frame == 200:
        window.push_window_event(KeyboardInput(KeyCode.KEY_D, ElementState.RELEASED))


def main() -> None:
    from zenith.main_loop import EngineLoop
    from zenith.window import Window
    from zenith.core.cli import EngineArgs

    parser = argparse.ArgumentParser("zenith-sandbox fly")
    parser.add_argument("--frames", type=int, default=240)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--readback-interval", type=int, default=1)
    parser.add_argument(
        "--serve", type=int, nargs="?", const=8089, default=None,
        metavar="PORT",
        help="serve an interactive browser viewer on PORT (default 8089) "
        "instead of replaying the scripted flight",
    )
    parser.add_argument(
        "--fps-cap", type=float, default=60.0,
        help="frame pacing for --serve (the stream can't use more)",
    )
    parser.add_argument(
        "--target-fps", type=float, default=30.0,
        help="adaptive-stream FPS target for --serve (dynamic resolution "
        "holds this over the transport; see viewer.AdaptiveStream)",
    )
    parser.add_argument(
        "--no-adaptive", action="store_true",
        help="serve at the fixed window resolution (no dynamic resolution)",
    )
    known, rest = parser.parse_known_args()
    os.environ.setdefault("ZENITH_READBACK_INTERVAL", str(known.readback_interval))

    window = Window(width=known.width, height=known.height, title="fly")
    args = EngineArgs.parse_args(rest)
    from zenith import asset
    from zenith.core import log, profile

    profile.initialize()
    log.initialize(args.log_level.to_logging_level())
    asset.initialize()

    app = FlyApp(args)
    loop = EngineLoop(app, window=window)
    if known.serve is not None:
        from zenith.viewer import serve_loop

        print("flying — WASD/QE + click-to-look, Esc quits")
        serve_loop(loop, port=known.serve, fps_cap=known.fps_cap,
                   adaptive=not known.no_adaptive,
                   target_fps=known.target_fps)
    else:
        loop.run(max_frames=known.frames, frame_callback=scripted_flight)

    if known.out and window.last_frame is not None:
        window.write_png(known.out, window.last_frame)
        print(f"wrote {known.out}")
    print(
        f"rendered {loop.frames_rendered} frames; camera at "
        f"{np.round(app.camera.location, 1)}"
    )


if __name__ == "__main__":
    main()
