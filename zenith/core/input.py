"""Input state machine + action/axis mapping.

Mirrors the reference's input module (zenith-core/src/input.rs):

- ``InputManager`` (input.rs:23-218): per-frame key/mouse state machine —
  JustPressed / Held / JustReleased / Released computed by a prev-frame set
  diff in ``tick()``.
- ``InputActionMapper`` (input.rs:224-335): name→keys action map plus
  smoothed ``[-1, 1]`` axis mappings with per-tick exponential lerp.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from zenith.core.events import (
    ElementState,
    Focused,
    KeyboardInput,
    KeyCode,
    ModifiersChanged,
    MouseButton,
    MouseInput,
    WindowEvent,
)


class KeyState(enum.Enum):
    """Key state for the current frame (reference input.rs:10-19)."""

    JUST_PRESSED = "just_pressed"
    HELD = "held"
    JUST_RELEASED = "just_released"
    RELEASED = "released"


@dataclass
class ModifiersState:
    shift: bool = False
    ctrl: bool = False
    alt: bool = False
    super_key: bool = False


class InputManager:
    """Collects input events; queryable per-frame key state
    (reference input.rs:23-218)."""

    def __init__(self) -> None:
        self._keys_pressed: set[KeyCode] = set()
        self._keys_just_pressed: set[KeyCode] = set()
        self._keys_just_released: set[KeyCode] = set()
        self._keys_with_repeat: set[KeyCode] = set()
        self._prev_keys_pressed: set[KeyCode] = set()
        # Keys pressed AND released between two ticks (a quick tap batched
        # into one event pump — routine for a network front-end that
        # flushes events every ~16 ms, impossible under winit's per-event
        # cadence). A pure prev-frame set diff would lose them; latch so
        # the tap reads JUST_PRESSED this frame, JUST_RELEASED the next.
        self._keys_tapped: set[KeyCode] = set()

        self._mouse_pressed: set[MouseButton] = set()
        self._mouse_just_pressed: set[MouseButton] = set()
        self._mouse_just_released: set[MouseButton] = set()
        self._prev_mouse_pressed: set[MouseButton] = set()
        self._mouse_tapped: set[MouseButton] = set()

        self._modifiers = ModifiersState()

    def on_window_event(self, event: WindowEvent) -> None:
        if isinstance(event, KeyboardInput):
            if event.state == ElementState.PRESSED:
                if not event.repeat:
                    # Only register as pressed if it's not a repeat event
                    # (reference input.rs:72-79).
                    self._keys_pressed.add(event.key)
                    self._keys_with_repeat.discard(event.key)
                else:
                    self._keys_with_repeat.add(event.key)
            else:
                if (event.key in self._keys_pressed
                        and event.key not in self._prev_keys_pressed):
                    self._keys_tapped.add(event.key)
                self._keys_pressed.discard(event.key)
                self._keys_with_repeat.discard(event.key)
        elif isinstance(event, MouseInput):
            if event.state == ElementState.PRESSED:
                self._mouse_pressed.add(event.button)
            else:
                if (event.button in self._mouse_pressed
                        and event.button not in self._prev_mouse_pressed):
                    self._mouse_tapped.add(event.button)
                self._mouse_pressed.discard(event.button)
        elif isinstance(event, ModifiersChanged):
            self._modifiers = ModifiersState(
                shift=event.shift,
                ctrl=event.ctrl,
                alt=event.alt,
                super_key=event.super_key,
            )
        elif isinstance(event, Focused) and not event.focused:
            # Clear all input when the window loses focus (input.rs:106-109).
            self.clear()

    def tick(self) -> None:
        """Advance the state machine one frame (reference input.rs:115-147).

        Latched taps (press+release inside one pump) are folded into the
        prev-frame diff: JUST_PRESSED now, JUST_RELEASED on the next tick
        (they ride ``_prev_*_pressed`` into it)."""
        self._keys_just_pressed = (
            self._keys_pressed | self._keys_tapped
        ) - self._prev_keys_pressed
        self._keys_just_released = self._prev_keys_pressed - self._keys_pressed
        self._mouse_just_pressed = (
            self._mouse_pressed | self._mouse_tapped
        ) - self._prev_mouse_pressed
        self._mouse_just_released = self._prev_mouse_pressed - self._mouse_pressed
        self._prev_keys_pressed = self._keys_pressed | self._keys_tapped
        self._prev_mouse_pressed = self._mouse_pressed | self._mouse_tapped
        self._keys_tapped = set()
        self._mouse_tapped = set()

    def key_state(self, key: KeyCode) -> KeyState:
        if key in self._keys_just_pressed:
            return KeyState.JUST_PRESSED
        if key in self._keys_pressed:
            return KeyState.HELD
        if key in self._keys_just_released:
            return KeyState.JUST_RELEASED
        return KeyState.RELEASED

    def is_key_pressed(self, key: KeyCode) -> bool:
        return key in self._keys_pressed

    def is_key_just_pressed(self, key: KeyCode) -> bool:
        return key in self._keys_just_pressed

    def is_key_just_released(self, key: KeyCode) -> bool:
        return key in self._keys_just_released

    def is_key_held(self, key: KeyCode) -> bool:
        return key in self._keys_pressed and key not in self._keys_just_pressed

    def pressed_keys(self) -> frozenset[KeyCode]:
        return frozenset(self._keys_pressed)

    def is_mouse_pressed(self, button: MouseButton) -> bool:
        return button in self._mouse_pressed

    def is_mouse_just_pressed(self, button: MouseButton) -> bool:
        return button in self._mouse_just_pressed

    def is_mouse_just_released(self, button: MouseButton) -> bool:
        return button in self._mouse_just_released

    @property
    def modifiers(self) -> ModifiersState:
        return self._modifiers

    def clear(self) -> None:
        self._keys_pressed.clear()
        self._keys_just_pressed.clear()
        self._keys_just_released.clear()
        self._keys_with_repeat.clear()
        self._keys_tapped.clear()
        self._mouse_pressed.clear()
        self._mouse_just_pressed.clear()
        self._mouse_just_released.clear()
        self._mouse_tapped.clear()


@dataclass
class AxisMapping:
    """Directional, non-abrupt axis mapping (reference input.rs:231-238)."""

    positive: list[KeyCode] = field(default_factory=list)
    negative: list[KeyCode] = field(default_factory=list)
    axis: float = 0.0
    # The higher the value, the higher the lagging; zero = abrupt change.
    smoothing_factor: float = 0.0


class InputActionMapper:
    """Maps raw input into named actions and smoothed axes
    (reference input.rs:224-335)."""

    def __init__(self) -> None:
        self._input = InputManager()
        self._action_mappings: dict[str, list[KeyCode]] = {}
        self._axis_mappings: dict[str, AxisMapping] = {}

    def register_action(self, action: str, keys: "list[KeyCode]") -> None:
        self._action_mappings[action] = list(keys)

    def register_axis(
        self,
        axis: str,
        positive: "list[KeyCode]",
        negative: "list[KeyCode]",
        smoothing_factor: float,
    ) -> None:
        self._axis_mappings[axis] = AxisMapping(
            positive=list(positive),
            negative=list(negative),
            axis=0.0,
            smoothing_factor=smoothing_factor,
        )

    def on_window_event(self, event: WindowEvent) -> None:
        self._input.on_window_event(event)

    def tick(self, delta_time: float) -> None:
        """Advance input + smooth axes (reference input.rs:275-302)."""
        self._input.tick()
        for mapping in self._axis_mappings.values():
            # blend = 1 - s^(20*dt): frame-rate-independent exponential decay.
            blend_factor = 1.0 - mapping.smoothing_factor ** (20.0 * delta_time)
            axis_acceleration = blend_factor

            any_input = False
            for key in mapping.positive:
                if self._input.is_key_pressed(key):
                    mapping.axis += axis_acceleration
                    any_input = True
            for key in mapping.negative:
                if self._input.is_key_pressed(key):
                    mapping.axis -= axis_acceleration
                    any_input = True
            mapping.axis = min(max(mapping.axis, -1.0), 1.0)

            if not any_input:
                mapping.axis = mapping.axis + (0.0 - mapping.axis) * blend_factor

    def is_action_pressed(self, action: str) -> bool:
        keys = self._action_mappings.get(action, [])
        return any(self._input.is_key_pressed(k) for k in keys)

    def is_action_just_pressed(self, action: str) -> bool:
        keys = self._action_mappings.get(action, [])
        return any(self._input.is_key_just_pressed(k) for k in keys)

    def get_axis(self, axis: str) -> float:
        mapping = self._axis_mappings.get(axis)
        return mapping.axis if mapping is not None else 0.0

    @property
    def raw_input(self) -> InputManager:
        return self._input
