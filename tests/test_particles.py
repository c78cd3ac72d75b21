"""GPU particle sim: step math, determinism, and the compute-node +
feedback + instanced-draw loop end-to-end."""

import jax.numpy as jnp
import numpy as np

from zenith.renderer.particles import _STATE_COLS, particle_step


def _alive_state(p):
    st = np.zeros((p, _STATE_COLS), np.float32)
    st[:, 0] = np.linspace(-5, 5, p)  # x
    st[:, 2] = 20.0  # z well above ground
    st[:, 3:6] = [1.0, 0.0, 2.0]  # velocity
    st[:, 6] = 0.1  # age
    st[:, 7] = 10.0  # life (won't expire this step)
    return st


class TestStep:
    def test_gravity_integration_matches_closed_form(self):
        p = 16
        st = _alive_state(p)
        dt = 0.02
        out = np.asarray(particle_step(
            jnp.asarray(st), jnp.float32(dt), jnp.float32(3.0),
            jnp.asarray([0.0, 0.0, 2.0]), gravity=-35.0, drag=0.12,
        ))
        vel = st[:, 3:6] * (1.0 - 0.12 * dt) + np.array([0, 0, -35.0]) * dt
        pos = st[:, 0:3] + vel * dt
        np.testing.assert_allclose(out[:, 3:6], vel, atol=1e-5)
        np.testing.assert_allclose(out[:, 0:3], pos, atol=1e-5)
        np.testing.assert_allclose(out[:, 6], st[:, 6] + dt, atol=1e-6)

    def test_ground_bounce_reflects(self):
        st = _alive_state(4)
        st[:, 2] = 0.05  # about to cross the ground
        st[:, 5] = -10.0  # falling
        out = np.asarray(particle_step(
            jnp.asarray(st), jnp.float32(0.05), jnp.float32(1.0),
            jnp.asarray([0.0, 0.0, 2.0]), bounce=0.45,
        ))
        assert np.all(out[:, 2] >= 0.0)  # reflected above ground
        assert np.all(out[:, 5] > 0.0)  # z velocity flipped upward

    def test_respawn_at_emitter_and_determinism(self):
        p = 32
        st = _alive_state(p)
        st[:, 6] = 100.0  # everyone past their life → respawn
        emitter = jnp.asarray([7.0, -3.0, 2.0])
        a = np.asarray(particle_step(
            jnp.asarray(st), jnp.float32(0.016), jnp.float32(5.0), emitter
        ))
        b = np.asarray(particle_step(
            jnp.asarray(st), jnp.float32(0.016), jnp.float32(5.0), emitter
        ))
        np.testing.assert_array_equal(a, b)  # hash randomness: reproducible
        np.testing.assert_allclose(
            a[:, 0:3], np.tile([7.0, -3.0, 2.0], (32, 1)), atol=1e-5
        )
        np.testing.assert_allclose(a[:, 6], 0.0)  # age reset
        assert np.all(a[:, 8 - 1] > 0.0)  # fresh life
        assert np.all(a[:, 5] > 0.0)  # launched upward
        # Velocities differ across particles (hash variety).
        assert np.std(a[:, 3]) > 0.1

    def test_different_tick_different_respawn(self):
        st = _alive_state(8)
        st[:, 6] = 100.0
        emitter = jnp.asarray([0.0, 0.0, 0.0])
        a = np.asarray(particle_step(
            jnp.asarray(st), jnp.float32(0.016), jnp.float32(1.0), emitter
        ))
        b = np.asarray(particle_step(
            jnp.asarray(st), jnp.float32(0.016), jnp.float32(2.0), emitter
        ))
        assert np.abs(a[:, 3:6] - b[:, 3:6]).max() > 0.05


class TestEngineLoop:
    def test_compute_node_feedback_and_instanced_draw(self):
        """Full loop: sim compute node + exported state fed back each frame
        + instanced draw at device-resident positions — positions move,
        ONE frame program, no host round trip."""
        from zenith.launch import launch
        from zenith.rendergraph.graph import (
            clear_frame_program_cache,
            frame_program_cache_size,
        )
        from zenith.sandbox.scene import SceneApp
        from zenith.window import Window

        clear_frame_program_cache()
        window = Window(width=128, height=64, title="t")
        seen = []

        class App(SceneApp):
            def on_frame_outputs(self, outputs):
                super().on_frame_outputs(outputs)
                if "psys.pos" in outputs:
                    seen.append(np.asarray(outputs["psys.pos"]))

        launch(
            App,
            argv=["--", "--mode", "deferred", "--lights", "2",
                  "--particles", "16", "--no-post"],
            window=window,
            max_frames=4,
        )
        assert frame_program_cache_size() == 1
        assert len(seen) == 4
        # The sim actually advances: consecutive position sets differ.
        assert np.abs(seen[1] - seen[0]).max() > 1e-4
        assert np.abs(seen[3] - seen[2]).max() > 1e-4
        assert np.isfinite(seen[-1]).all()
