"""Skeletal animation: keyframe sampling → joint matrix palettes.

The reference has no animation system at all (its only renderer draws one
static triangle); this is the host side of the skinning pipeline:

- ``AnimationPlayer.joint_matrices(t)`` samples every channel of a clip
  (binary-search keyframes, lerp translations/scales, shortest-path nlerp
  rotations), composes local TRS matrices, walks the parent hierarchy
  (topologically ordered — one pass), and right-multiplies the inverse
  bind matrices.
- The result is a tiny (J, 4, 4) float32 palette that rides the frame
  program as a DYNAMIC — animation never recompiles, works on both the
  rebuild and retained paths, and the actual per-vertex blending runs on
  device in the skinned vertex stage (renderer/deferred.py), where the
  (N, 4) joint gathers and weighted matrix blends are dense matmul-friendly
  math over the whole vertex buffer.

All math here is NumPy over a few dozen joints — microseconds per frame.
"""

from __future__ import annotations

import numpy as np

from zenith.asset.render_types import AnimationClip, Skin


def _nlerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Normalized lerp with shortest-path sign fix (xyzw)."""
    if float(np.dot(q0, q1)) < 0.0:
        q1 = -q1
    q = q0 + (q1 - q0) * t
    return q / max(float(np.linalg.norm(q)), 1e-12)


def _sample_channel(times: np.ndarray, values: np.ndarray, t: float,
                    is_quat: bool, step: bool = False) -> np.ndarray:
    if t <= float(times[0]):
        return values[0]
    if t >= float(times[-1]):
        return values[-1]
    i = int(np.searchsorted(times, t, side="right")) - 1
    if step:  # glTF STEP: hold the previous key (pose snaps)
        return values[i]
    t0, t1 = float(times[i]), float(times[i + 1])
    f = (t - t0) / max(t1 - t0, 1e-12)
    if is_quat:
        return _nlerp(values[i], values[i + 1], f)
    return values[i] + (values[i + 1] - values[i]) * f


def _trs_matrix(t: np.ndarray, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    """T·R·S local transform from translation / xyzw quaternion / scale
    (glTF node TRS composition order)."""
    x, y, z, w = (float(c) for c in r)
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    m = np.eye(4)
    m[:3, :3] = rot * np.asarray(s, np.float64)[None, :]
    m[:3, 3] = t
    return m


def sample_morph_weights(clip: AnimationClip, t: float,
                         num_targets: int, loop: bool = True) -> np.ndarray:
    """(T,) morph-target weights at time t from the clip's ``weights``
    channel (glTF animation path "weights"; linear interpolation). Zeros
    when the clip has no weights channel."""
    if loop and clip.duration > 0:
        t = float(t) % clip.duration
    for ch in clip.channels:
        if ch.path == "weights":
            w = _sample_channel(
                ch.times, ch.values, t, False,
                getattr(ch, "interpolation", "LINEAR") == "STEP",
            )
            return np.asarray(w, np.float32).reshape(-1)[:num_targets]
    return np.zeros((num_targets,), np.float32)


class AnimationPlayer:
    """Samples one clip over one skin. Stateless in time — pass ``t``."""

    def __init__(self, skin: Skin, clip: AnimationClip, loop: bool = True):
        self.skin = skin
        self.clip = clip
        self.loop = loop
        # Channel → joint routing resolved once.
        self._by_joint: "dict[int, dict[str, tuple]]" = {}
        for ch in clip.channels:
            self._by_joint.setdefault(ch.joint, {})[ch.path] = (
                ch.times, ch.values,
                getattr(ch, "interpolation", "LINEAR") == "STEP",
            )

    def local_trs(self, t: float):
        """(J,3) translations, (J,4) quats, (J,3) scales at time t."""
        skin = self.skin
        if self.loop and self.clip.duration > 0:
            t = float(t) % self.clip.duration
        tr = skin.rest_t.copy()
        ro = skin.rest_r.copy()
        sc = skin.rest_s.copy()
        for j, paths in self._by_joint.items():
            if "translation" in paths:
                tm, vv, st = paths["translation"]
                tr[j] = _sample_channel(tm, vv, t, False, st)
            if "rotation" in paths:
                tm, vv, st = paths["rotation"]
                ro[j] = _sample_channel(tm, vv, t, True, st)
            if "scale" in paths:
                tm, vv, st = paths["scale"]
                sc[j] = _sample_channel(tm, vv, t, False, st)
        return tr, ro, sc

    def joint_matrices(self, t: float) -> np.ndarray:
        """(J, 4, 4) float32 skinning palette: world(joint) @ inverse_bind.
        Feed it to ``SceneObject.joint_matrices`` (it rides the frame
        program as a dynamic)."""
        skin = self.skin
        tr, ro, sc = self.local_trs(t)
        j = skin.num_joints
        world = np.empty((j, 4, 4))
        pre = skin.pre.astype(np.float64)
        for i in range(j):
            # pre = constant non-joint transforms between this joint and
            # its joint-parent (Armature nodes etc. — see Skin docstring).
            local = pre[i] @ _trs_matrix(tr[i], ro[i], sc[i])
            p = int(skin.parents[i])
            world[i] = local if p < 0 else world[p] @ local
        return np.einsum(
            "jab,jbc->jac", world, skin.inverse_bind.astype(np.float64)
        ).astype(np.float32)
