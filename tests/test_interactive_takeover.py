"""Interactive take-over in the scripted sandbox apps: the first real
input event (browser viewer / any front-end) switches SceneApp and
TerrainApp from their scripted orbit/flyover to fly controls, continuing
from the camera's current pose (no snap). Complements sandbox.fly, which
is input-driven from the start."""

from __future__ import annotations

import numpy as np
import pytest

from zenith.core.camera import Camera
from zenith.core.cli import EngineArgs
from zenith.core.events import (
    ElementState,
    KeyboardInput,
    KeyCode,
    MouseButton,
    MouseInput,
    MouseMotion,
)
from zenith.core.mathtypes import Degree


class _FakeWindow:
    def __init__(self):
        self.closed = False

    def request_close(self):
        self.closed = True


def _prep(app):
    """Give a constructed-but-unprepared app the bits its interactive
    branch needs (prepare() would set these from the real device/window)."""
    app.camera = Camera(fov_y=Degree(40.0), aspect_ratio=16 / 9)
    app.camera.set_position(np.array([0.0, -160.0, 30.0], np.float32))
    app._window = _FakeWindow()
    return app


def _apps():
    from zenith.sandbox.scene import SceneApp
    from zenith.sandbox.terrain import TerrainApp

    return [
        ("scene", _prep(SceneApp(EngineArgs.parse_args([])))),
        ("terrain", _prep(TerrainApp(EngineArgs.parse_args([])))),
    ]


@pytest.mark.parametrize("name,app", _apps())
class TestTakeover:
    def test_starts_scripted(self, name, app):
        assert not app._interactive
        orbit0 = app.orbit
        app.tick(1 / 60)
        assert app.orbit != orbit0  # scripted path advances the orbit

    def test_input_takes_over_and_flies(self, name, app):
        app.on_window_event(KeyboardInput(KeyCode.KEY_W, ElementState.PRESSED))
        assert app._interactive
        pos0 = np.array(app.camera.location, np.float32)
        orbit0 = app.orbit
        for _ in range(30):
            app.tick(1 / 60)
        assert app.orbit == orbit0  # script no longer drives
        moved = np.linalg.norm(np.array(app.camera.location) - pos0)
        assert moved > 1.0  # W flew the camera forward

    def test_mouse_look_requires_grab(self, name, app):
        app.on_window_event(MouseInput(MouseButton.LEFT, ElementState.PRESSED))
        assert app._interactive
        yaw0 = float(app.camera._yaw)
        app.on_device_event(MouseMotion(dx=300.0, dy=0.0))
        for _ in range(10):
            app.tick(1 / 60)
        assert float(app.camera._yaw) != yaw0

    def test_escape_closes_window(self, name, app):
        app.on_window_event(KeyboardInput(KeyCode.ESCAPE, ElementState.PRESSED))
        app.on_window_event(KeyboardInput(KeyCode.ESCAPE, ElementState.RELEASED))
        app.tick(1 / 60)
        assert app._window.closed
