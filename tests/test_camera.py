"""Camera semantics tests (vs reference zenith-core/src/camera.rs)."""

import math

import numpy as np
import pytest

from zenith.core.camera import (
    Camera,
    CameraController,
    WORLD_SPACE_FORWARD,
    WORLD_SPACE_RIGHT,
    WORLD_SPACE_UP,
)
from zenith.core.events import (
    ElementState,
    Focused,
    MouseButton,
    MouseInput,
    MouseMotion,
)
from zenith.core.mathtypes import Radians


class TestCamera:
    def test_default_basis(self):
        cam = Camera()
        np.testing.assert_allclose(cam.forward, WORLD_SPACE_FORWARD)
        np.testing.assert_allclose(cam.right, WORLD_SPACE_RIGHT)
        np.testing.assert_allclose(cam.up, WORLD_SPACE_UP)

    def test_view_maps_forward_to_minus_z(self):
        cam = Camera()
        fwd_view = cam.view @ np.append(cam.forward, 0.0)
        np.testing.assert_allclose(fwd_view[:3], [0, 0, -1], atol=1e-6)

    def test_reverse_z_projection(self):
        cam = Camera(fov_y=Radians(math.pi / 2), aspect_ratio=1.0, z_near=0.1)
        # Point straight ahead (+Y world) at the near distance → depth 1.
        vp = cam.view_projection
        p = vp @ np.array([0.0, 0.1, 0.0, 1.0], dtype=np.float32)
        assert p[2] / p[3] == pytest.approx(1.0)
        # Far point → depth ≈ 0.
        p = vp @ np.array([0.0, 1e6, 0.0, 1.0], dtype=np.float32)
        assert p[2] / p[3] == pytest.approx(0.0, abs=1e-5)

    def test_translate_in_local_basis(self):
        cam = Camera()
        cam.translate(np.array([1.0, 2.0, 3.0]))  # (right, forward, up)
        np.testing.assert_allclose(cam.location, [1.0, 2.0, 3.0], atol=1e-6)

    def test_yaw_rotates_about_world_up(self):
        cam = Camera()
        cam.set_yaw_pitch(Radians(math.pi / 2), Radians(0.0))
        np.testing.assert_allclose(cam.forward, [-1, 0, 0], atol=1e-6)
        np.testing.assert_allclose(cam.right, [0, 1, 0], atol=1e-6)

    def test_pitch_clamp(self):
        cam = Camera()
        cam.rotate(Radians(0.0), Radians(10.0), max_pitch=Radians(1.0))
        cam.update_local_basis()
        # Pitch clamped to 1 rad: forward z = sin(1).
        np.testing.assert_allclose(cam.forward[2], math.sin(1.0), atol=1e-6)


class TestCameraController:
    def test_grab_gates_mouse_motion(self):
        ctrl = CameraController()
        cam = Camera()
        # Not grabbed: motion ignored.
        ctrl.on_device_event(MouseMotion(dx=100.0, dy=0.0))
        ctrl.update_cameras(1 / 60, 0, 0, 0, [cam])
        np.testing.assert_allclose(cam.forward, WORLD_SPACE_FORWARD, atol=1e-6)
        # Grab with LMB: motion applies.
        ctrl.on_window_event(MouseInput(MouseButton.LEFT, ElementState.PRESSED))
        ctrl.on_device_event(MouseMotion(dx=100.0, dy=0.0))
        ctrl.update_cameras(1 / 60, 0, 0, 0, [cam])
        assert abs(cam.forward[0]) > 0.0  # yawed away from +Y

    def test_focus_loss_releases(self):
        ctrl = CameraController()
        ctrl.on_window_event(MouseInput(MouseButton.LEFT, ElementState.PRESSED))
        assert ctrl.is_grabbed
        ctrl.on_window_event(Focused(False))
        assert not ctrl.is_grabbed

    def test_rotation_smoothing_converges(self):
        ctrl = CameraController()
        ctrl.rotation_smoothing_factor = 0.5
        cam = Camera()
        ctrl.on_window_event(MouseInput(MouseButton.LEFT, ElementState.PRESSED))
        ctrl.on_device_event(MouseMotion(dx=-10.0, dy=0.0))
        total_target = 10.0 * ctrl.mouse_sensitivity * (1 / 60)
        for _ in range(200):
            ctrl.update_cameras(1 / 60, 0, 0, 0, [cam])
        # After many smoothing steps the full accumulated yaw is applied.
        assert math.atan2(-cam.forward[0], cam.forward[1]) == pytest.approx(
            total_target, rel=1e-3
        )

    def test_translation_speed(self):
        ctrl = CameraController()
        ctrl.move_speed = 10.0
        cam = Camera()
        ctrl.update_cameras(0.1, 1.0, 0.0, 0.0, [cam])  # forward axis
        np.testing.assert_allclose(cam.location, [0.0, 1.0, 0.0], atol=1e-6)


class TestMultiCamera:
    def test_updates_all_cameras(self):
        ctrl = CameraController()
        cams = [Camera(), Camera()]
        ctrl.update_cameras(0.1, 0.0, 1.0, 0.0, cams)
        for cam in cams:
            assert cam.location[0] > 0.0
