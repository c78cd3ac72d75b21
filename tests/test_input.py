"""Input state-machine tests (vs reference zenith-core/src/input.rs)."""

import pytest

from zenith.core.events import (
    ElementState,
    Focused,
    KeyboardInput,
    KeyCode,
    ModifiersChanged,
    MouseButton,
    MouseInput,
)
from zenith.core.input import InputActionMapper, InputManager, KeyState


def press(key):
    return KeyboardInput(key, ElementState.PRESSED)


def release(key):
    return KeyboardInput(key, ElementState.RELEASED)


class TestInputManager:
    def test_key_lifecycle(self):
        im = InputManager()
        im.on_window_event(press(KeyCode.KEY_W))
        im.tick()
        assert im.key_state(KeyCode.KEY_W) == KeyState.JUST_PRESSED
        assert im.is_key_pressed(KeyCode.KEY_W)
        assert not im.is_key_held(KeyCode.KEY_W)  # held = pressed but not just

        im.tick()
        assert im.key_state(KeyCode.KEY_W) == KeyState.HELD
        assert im.is_key_held(KeyCode.KEY_W)

        im.on_window_event(release(KeyCode.KEY_W))
        im.tick()
        assert im.key_state(KeyCode.KEY_W) == KeyState.JUST_RELEASED
        im.tick()
        assert im.key_state(KeyCode.KEY_W) == KeyState.RELEASED

    def test_repeat_events_do_not_re_press(self):
        im = InputManager()
        im.on_window_event(press(KeyCode.KEY_A))
        im.tick()
        im.tick()
        # OS key-repeat must not flip back to JustPressed (input.rs:72-79).
        im.on_window_event(KeyboardInput(KeyCode.KEY_A, ElementState.PRESSED, repeat=True))
        im.tick()
        assert im.key_state(KeyCode.KEY_A) == KeyState.HELD

    def test_mouse_buttons(self):
        im = InputManager()
        im.on_window_event(MouseInput(MouseButton.LEFT, ElementState.PRESSED))
        im.tick()
        assert im.is_mouse_just_pressed(MouseButton.LEFT)
        im.tick()
        assert im.is_mouse_pressed(MouseButton.LEFT)
        assert not im.is_mouse_just_pressed(MouseButton.LEFT)
        im.on_window_event(MouseInput(MouseButton.LEFT, ElementState.RELEASED))
        im.tick()
        assert im.is_mouse_just_released(MouseButton.LEFT)

    def test_modifiers(self):
        im = InputManager()
        im.on_window_event(ModifiersChanged(shift=True, ctrl=True))
        assert im.modifiers.shift and im.modifiers.ctrl
        assert not im.modifiers.alt

    def test_focus_loss_clears(self):
        im = InputManager()
        im.on_window_event(press(KeyCode.KEY_W))
        im.tick()
        im.on_window_event(Focused(False))
        im.tick()
        assert not im.is_key_pressed(KeyCode.KEY_W)


class TestActionMapper:
    def test_action_any_key(self):
        am = InputActionMapper()
        am.register_action("jump", [KeyCode.SPACE, KeyCode.KEY_W])
        am.on_window_event(press(KeyCode.SPACE))
        am.tick(1 / 60)
        assert am.is_action_pressed("jump")
        assert am.is_action_just_pressed("jump")
        am.tick(1 / 60)
        assert am.is_action_pressed("jump")
        assert not am.is_action_just_pressed("jump")

    def test_unknown_action(self):
        am = InputActionMapper()
        assert not am.is_action_pressed("nope")
        assert am.get_axis("nope") == 0.0

    def test_axis_smoothing_rises_and_decays(self):
        am = InputActionMapper()
        am.register_axis("move", [KeyCode.KEY_W], [KeyCode.KEY_S], 0.5)
        am.on_window_event(press(KeyCode.KEY_W))
        values = []
        for _ in range(60):
            am.tick(1 / 60)
            values.append(am.get_axis("move"))
        assert values[0] > 0.0
        assert values[-1] == pytest.approx(1.0, abs=1e-3)
        assert all(b >= a - 1e-9 for a, b in zip(values, values[1:]))  # monotone rise

        am.on_window_event(release(KeyCode.KEY_W))
        for _ in range(120):
            am.tick(1 / 60)
        assert am.get_axis("move") == pytest.approx(0.0, abs=1e-3)

    def test_axis_negative_direction(self):
        am = InputActionMapper()
        am.register_axis("move", [KeyCode.KEY_W], [KeyCode.KEY_S], 0.0)
        am.on_window_event(press(KeyCode.KEY_S))
        am.tick(1 / 60)
        # smoothing 0 ⇒ abrupt: one tick saturates to -1.
        assert am.get_axis("move") == pytest.approx(-1.0)


class TestSameFrameTap:
    """Press+release batched into ONE event pump (a quick tap through a
    network front-end that flushes every ~16 ms, e.g. zenith.viewer).
    The prev-frame set diff alone would lose the tap entirely; the latch
    makes it JUST_PRESSED for one frame, JUST_RELEASED the next."""

    def test_key_tap_within_one_frame_registers(self):
        im = InputManager()
        im.on_window_event(press(KeyCode.ESCAPE))
        im.on_window_event(release(KeyCode.ESCAPE))
        im.tick()
        assert im.is_key_just_pressed(KeyCode.ESCAPE)
        assert not im.is_key_pressed(KeyCode.ESCAPE)  # physically up by now
        im.tick()
        assert im.is_key_just_released(KeyCode.ESCAPE)
        im.tick()
        assert im.key_state(KeyCode.ESCAPE) == KeyState.RELEASED

    def test_tap_then_repress_same_frame_stays_held(self):
        im = InputManager()
        im.on_window_event(press(KeyCode.KEY_W))
        im.on_window_event(release(KeyCode.KEY_W))
        im.on_window_event(press(KeyCode.KEY_W))
        im.tick()
        assert im.is_key_just_pressed(KeyCode.KEY_W)
        assert im.is_key_pressed(KeyCode.KEY_W)
        im.tick()
        assert im.key_state(KeyCode.KEY_W) == KeyState.HELD

    def test_release_of_held_key_is_not_a_tap(self):
        im = InputManager()
        im.on_window_event(press(KeyCode.KEY_W))
        im.tick()
        im.tick()
        im.on_window_event(release(KeyCode.KEY_W))
        im.tick()
        assert im.is_key_just_released(KeyCode.KEY_W)
        assert not im.is_key_just_pressed(KeyCode.KEY_W)

    def test_mouse_tap_within_one_frame_registers(self):
        im = InputManager()
        im.on_window_event(MouseInput(MouseButton.LEFT, ElementState.PRESSED))
        im.on_window_event(MouseInput(MouseButton.LEFT, ElementState.RELEASED))
        im.tick()
        assert im.is_mouse_just_pressed(MouseButton.LEFT)
        im.tick()
        assert im.is_mouse_just_released(MouseButton.LEFT)

    def test_action_fires_on_same_frame_tap(self):
        mapper = InputActionMapper()
        mapper.register_action("quit", [KeyCode.ESCAPE])
        mapper.on_window_event(press(KeyCode.ESCAPE))
        mapper.on_window_event(release(KeyCode.ESCAPE))
        mapper.tick(1 / 60)
        assert mapper.is_action_just_pressed("quit")
