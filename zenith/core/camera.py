"""Camera + controller.

Mirrors the reference camera (zenith-core/src/camera.rs):

- Right-handed, **Z-up** world space (camera.rs:1-20):
  up = +Z, forward = +Y, right = +X.
- Infinite-far **reverse-Z** perspective projection (camera.rs:50,60).
- Quaternion yaw/pitch rotation with roll eliminated via intrinsic Z→X→Y
  euler composition (camera.rs:115-121).
- ``CameraController`` (camera.rs:136-291): cursor-grab on LMB, mouse-delta
  accumulation, exponential rotation smoothing, axis-speed translation
  applied to N cameras at once.

All math is host-side float32 NumPy; view/projection matrices feed the
jitted frame function as small device arrays.
"""

from __future__ import annotations

import math

import numpy as np

from zenith.core import mathtypes as m
from zenith.core.events import (
    DeviceEvent,
    ElementState,
    Focused,
    MouseButton,
    MouseInput,
    MouseMotion,
    WindowEvent,
)
from zenith.core.mathtypes import Degree, Radians

NEAR_PLANE: float = 0.1
WORLD_SPACE_UP = m.vec3(0.0, 0.0, 1.0)
WORLD_SPACE_FORWARD = m.vec3(0.0, 1.0, 0.0)
WORLD_SPACE_RIGHT = m.vec3(1.0, 0.0, 0.0)


class Camera:
    """Common camera data (reference camera.rs:24-133)."""

    def __init__(
        self,
        fov_y: "Radians | Degree" = Radians(math.pi / 6.0),
        aspect_ratio: float = 1.77777,
        z_near: float = NEAR_PLANE,
    ) -> None:
        self._position = m.vec3(0.0, 0.0, 0.0)
        self._rotation = m.QUAT_IDENTITY.copy()
        self._pitch = Radians(0.0)
        self._yaw = Radians(0.0)

        self._forward = WORLD_SPACE_FORWARD.copy()
        self._right = WORLD_SPACE_RIGHT.copy()
        self._up = WORLD_SPACE_UP.copy()

        self._z_near = max(z_near, 1e-4)
        self._proj = m.perspective_infinite_reverse_rh(
            fov_y, aspect_ratio, self._z_near
        )
        # View / view-projection are computed LAZILY (None = stale): the
        # render loop typically calls set_position + set_yaw_pitch back to
        # back every frame, and eagerly rebuilding look_to_rh + the two 4x4
        # products per setter doubled the per-frame camera cost.
        self._view = None
        self._rvp = None
        self._rvp_base = None  # unjittered flip @ proj @ view
        self._rivp = None
        self._inv_fp = None  # (flip @ proj)⁻¹, constant per projection
        # Sub-pixel projection jitter in NDC units (TAA); applied as a
        # homogeneous translation AFTER the projection, so geometry shifts
        # by exactly (jx/2·W, jy/2·H) pixels after the perspective divide.
        self._jitter = (0.0, 0.0)

    # -- accessors ---------------------------------------------------------

    @property
    def location(self) -> np.ndarray:
        return self._position

    @property
    def view(self) -> np.ndarray:
        if self._view is None:
            self._view = m.look_to_rh(
                self._position, self._forward, WORLD_SPACE_UP
            )
        return self._view

    @property
    def projection(self) -> np.ndarray:
        return self._proj

    @property
    def z_near(self) -> float:
        return self._z_near

    @property
    def view_projection(self) -> np.ndarray:
        """proj @ view (reference camera.rs:85-87), glam conventions."""
        return (self._proj @ self.view).astype(np.float32)

    @property
    def render_view_projection(self) -> np.ndarray:
        """view_projection with the Vulkan clip-space Y flip baked in — what
        renderers feed the rasterizer (see mathtypes.VULKAN_Y_FLIP).
        Cached until the next camera mutation (renderers read it several
        times per frame). Includes the TAA sub-pixel jitter when set
        (set_jitter); temporal passes reproject with the unjittered matrix
        (render_view_projection_unjittered)."""
        if self._rvp is None:
            base = self.render_view_projection_unjittered
            jx, jy = self._jitter
            if jx == 0.0 and jy == 0.0:
                self._rvp = base
            else:
                # J @ base where J is a homogeneous (jx, jy) translation:
                # adds jitter·w to clip x/y — two row axpys, no 4x4 matmul.
                rvp = base.copy()
                rvp[0] += jx * base[3]
                rvp[1] += jy * base[3]
                self._rvp = rvp
        return self._rvp

    @property
    def render_view_projection_unjittered(self) -> np.ndarray:
        """flip @ proj @ view WITHOUT the TAA jitter — what temporal
        reprojection (history UV lookup) must use."""
        if self._rvp_base is None:
            self._rvp_base = (
                m.VULKAN_Y_FLIP @ self._proj @ self.view
            ).astype(np.float32)
        return self._rvp_base

    @property
    def render_inv_view_projection(self) -> np.ndarray:
        """(flip @ proj @ view)⁻¹ — the NDC→world matrix skybox/IBL rays
        need. Computed analytically: the projection half is inverted ONCE
        (it is constant per camera) and the view half is a rigid transform
        whose inverse is a transpose — no per-frame LAPACK call (a 4×4
        np.linalg.inv measured ~0.03 ms/frame on the rebuild path)."""
        if self._rivp is None:
            if self._inv_fp is None:
                self._inv_fp = np.linalg.inv(
                    (m.VULKAN_Y_FLIP @ self._proj).astype(np.float64)
                )
            v = self.view.astype(np.float64)
            r_t = v[:3, :3].T
            inv_v = np.eye(4)
            inv_v[:3, :3] = r_t
            inv_v[:3, 3] = -r_t @ v[:3, 3]
            rivp = inv_v @ self._inv_fp
            jx, jy = self._jitter
            if jx != 0.0 or jy != 0.0:
                # inv(J @ F @ P @ V) = inv(V)·inv(F·P)·inv(J); right-multiply
                # by the (-jx, -jy) translation = one column axpy.
                rivp = rivp.copy()
                rivp[:, 3] -= jx * rivp[:, 0] + jy * rivp[:, 1]
            self._rivp = rivp.astype(np.float32)
        return self._rivp

    @property
    def forward(self) -> np.ndarray:
        return self._forward

    @property
    def right(self) -> np.ndarray:
        return self._right

    @property
    def up(self) -> np.ndarray:
        return self._up

    # -- mutation ----------------------------------------------------------

    def set_position(self, position: np.ndarray) -> None:
        self._position = np.asarray(position, dtype=np.float32).copy()
        self._view = None
        self._rvp = None
        self._rvp_base = None
        self._rivp = None

    def set_jitter(self, jx: float, jy: float) -> None:
        """Sub-pixel projection jitter in NDC units (TAA): one pixel =
        2/width (x) or 2/height (y). Only the jittered products go stale —
        the unjittered base survives a jitter-only change."""
        j = (float(jx), float(jy))
        if j != self._jitter:
            self._jitter = j
            self._rvp = None
            self._rivp = None

    def set_yaw_pitch(self, yaw: Radians, pitch: Radians) -> None:
        self._yaw = yaw
        self._pitch = pitch
        self._rotation = m.quat_from_euler_zxy(self._yaw.value, self._pitch.value, 0.0)
        self._update_local_basis()

    def translate(self, delta_position: np.ndarray) -> None:
        """Move in the camera's local basis (camera.rs:107-113):
        delta = (right, forward, up) components."""
        d = np.asarray(delta_position, dtype=np.float32)
        self._position = (
            self._position
            + self._right * d[0]
            + self._forward * d[1]
            + self._up * d[2]
        ).astype(np.float32)
        self._view = None
        self._rvp = None
        self._rvp_base = None
        self._rivp = None

    def rotate(
        self, delta_yaw: Radians, delta_pitch: Radians, max_pitch: Radians
    ) -> None:
        """Yaw/pitch with pitch clamp; roll eliminated via ZXY euler
        (camera.rs:115-121)."""
        self._yaw = self._yaw + delta_yaw
        self._pitch = (self._pitch + delta_pitch).clamp(-max_pitch, max_pitch)
        self._rotation = m.quat_from_euler_zxy(self._yaw.value, self._pitch.value, 0.0)
        self._view = None
        self._rvp = None
        self._rvp_base = None
        self._rivp = None

    def update_local_basis(self) -> None:
        self._update_local_basis()

    def update_view(self) -> None:
        self._update_view()

    def _update_local_basis(self) -> None:
        # Rotating the three world axes = the columns of the rotation
        # matrix: one quat→mat conversion replaces three quat_rotate calls
        # (each two cross products + allocations) on the per-frame path.
        r = m.mat4_from_quat(self._rotation)
        self._right = np.ascontiguousarray(r[:3, 0])
        self._forward = np.ascontiguousarray(r[:3, 1])
        self._up = np.ascontiguousarray(r[:3, 2])
        self._view = None
        self._rvp = None
        self._rvp_base = None
        self._rivp = None

    def _update_view(self) -> None:
        self._view = None
        self._rvp = None
        self._rvp_base = None
        self._rivp = None


class CameraController:
    """Smoothed fly-camera controller (reference camera.rs:136-291).

    The windowing front-end forwards window/device events; ``update_cameras``
    applies accumulated mouse deltas (with exponential smoothing) and axis
    speeds to any number of cameras.
    """

    def __init__(self, mouse_sensitivity: float = 0.4) -> None:
        self._accum_local_pitch = Radians(0.0)
        self._max_pitch_angle: Radians = Degree(89.99).to_radians()
        self._accum_local_yaw = Radians(0.0)

        self.move_speed = 70.0
        self.mouse_sensitivity = mouse_sensitivity
        # The higher the value, the higher the lagging; zero = abrupt changes.
        self.rotation_smoothing_factor = 0.5

        self._accum_dx = 0.0
        self._accum_dy = 0.0
        self._is_grabbed = False

    def on_window_event(self, event: WindowEvent) -> None:
        """LMB grabs the cursor; release or focus loss releases it
        (camera.rs:194-214)."""
        if isinstance(event, MouseInput) and event.button == MouseButton.LEFT:
            self._is_grabbed = event.state == ElementState.PRESSED
        elif isinstance(event, Focused) and not event.focused:
            self._is_grabbed = False

    def on_device_event(self, event: DeviceEvent) -> None:
        """Accumulate raw mouse deltas while grabbed (camera.rs:218-228)."""
        if isinstance(event, MouseMotion) and self._is_grabbed:
            self._accum_dx += event.dx
            self._accum_dy += event.dy

    @property
    def is_grabbed(self) -> bool:
        return self._is_grabbed

    def update_cameras(
        self,
        delta_time: float,
        forward_axis_speed: float,
        right_axis_speed: float,
        up_axis_speed: float,
        cameras: "list[Camera]",
    ) -> None:
        """Apply smoothed rotation + translation (camera.rs:232-269)."""
        d_local_yaw = Radians(-self._accum_dx * self.mouse_sensitivity * delta_time)
        d_local_pitch = Radians(-self._accum_dy * self.mouse_sensitivity * delta_time)

        blend_factor = 1.0 - self.rotation_smoothing_factor ** (delta_time * 60.0)

        self._accum_local_yaw = self._accum_local_yaw + d_local_yaw
        self._accum_local_pitch = self._accum_local_pitch + d_local_pitch

        delta_yaw = self._accum_local_yaw * blend_factor
        delta_pitch = self._accum_local_pitch * blend_factor

        self._accum_local_yaw = self._accum_local_yaw - delta_yaw
        self._accum_local_pitch = self._accum_local_pitch - delta_pitch

        axis_dir = m.vec3(right_axis_speed, forward_axis_speed, up_axis_speed)
        delta_pos = axis_dir * self.move_speed * delta_time

        for camera in cameras:
            camera.rotate(delta_yaw, delta_pitch, self._max_pitch_angle)
            camera.translate(delta_pos)
            camera.update_local_basis()
            camera.update_view()

        self._accum_dx = 0.0
        self._accum_dy = 0.0
