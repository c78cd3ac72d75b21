"""GPU-simulated particles: a compute node in the frame program.

The reference declares a compute-node variant and never implements it
(zenith-rendergraph/src/node.rs:24-40); here compute nodes are first-class
traced stages, and this module is the canonical use: the particle state
lives ON DEVICE, a compute node inside the SAME jitted frame program
integrates it (gravity, drag, ground bounce, hash-based respawn — all
elementwise, statically shaped), and the instanced draw renders the
PREVIOUS frame's positions (the standard one-frame sim→draw latency, which
keeps sim and draw in one program with zero host round trips).

State flow is the engine's cross-frame feedback path (the same one TAA and
auto-exposure use): the stepped state + the (P,3) position slice are
exported, ``RenderContext.request_output`` hands them back, and next frame
they ride in as jax.Array dynamics — respawn randomness comes from a
per-particle coordinate hash seeded by the frame tick, so the whole system
is deterministic and never recompiles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from zenith.rendergraph import RenderGraphBuilder
from zenith.rhi.resource import BufferDesc

# State row: pos.xyz, vel.xyz, age, life.
_STATE_COLS = 8


def _hash01(ids: jnp.ndarray, salt: jnp.ndarray) -> jnp.ndarray:
    """Per-particle uniform [0,1) from an integer hash (deterministic,
    recompile-free randomness — same scheme as the SSAO kernel rotation)."""
    n = ids.astype(jnp.uint32) * jnp.uint32(374761393) + (
        salt * jnp.float32(977.0)
    ).astype(jnp.uint32) * jnp.uint32(668265263)
    n = (n ^ (n >> jnp.uint32(13))) * jnp.uint32(1274126177)
    n = n ^ (n >> jnp.uint32(16))
    return (n & jnp.uint32(0xFFFFFF)).astype(jnp.float32) / float(1 << 24)


def particle_step(
    state: jnp.ndarray,  # (P, 8)
    dt: jnp.ndarray,  # scalar
    tick: jnp.ndarray,  # scalar (frame counter — respawn hash salt)
    emitter: jnp.ndarray,  # (3,)
    gravity: float = -35.0,
    drag: float = 0.12,
    ground_z: float = 0.0,
    bounce: float = 0.45,
    spread: float = 14.0,
    up_speed: float = 42.0,
    life: float = 2.5,
) -> jnp.ndarray:
    """One sim step — pure elementwise math over the (P, 8) state."""
    p = state.shape[0]
    ids = jnp.arange(p, dtype=jnp.int32)
    pos = state[:, 0:3]
    vel = state[:, 3:6]
    age = state[:, 6]
    plife = jnp.maximum(state[:, 7], 1e-3)

    vel = vel * (1.0 - drag * dt) + jnp.asarray(
        [0.0, 0.0, gravity], jnp.float32
    ) * dt
    pos = pos + vel * dt
    # Ground bounce with energy loss.
    below = pos[:, 2] < ground_z
    pos = pos.at[:, 2].set(
        jnp.where(below, 2.0 * ground_z - pos[:, 2], pos[:, 2])
    )
    vel = vel * jnp.where(
        below[:, None],
        jnp.asarray([0.8, 0.8, -bounce], jnp.float32),
        jnp.ones((3,), jnp.float32),
    )
    age = age + dt

    # Respawn: hash-random launch cone from the emitter.
    dead = age >= plife
    r0 = _hash01(ids, tick)
    r1 = _hash01(ids + p, tick)
    r2 = _hash01(ids + 2 * p, tick)
    ang = r0 * (2.0 * np.pi)
    rad = jnp.sqrt(r1) * spread
    new_vel = jnp.stack([
        jnp.cos(ang) * rad,
        jnp.sin(ang) * rad,
        up_speed * (0.65 + 0.7 * r2),
    ], axis=1)
    new_life = life * (0.6 + 0.8 * r0)
    pos = jnp.where(dead[:, None], emitter[None, :], pos)
    vel = jnp.where(dead[:, None], new_vel, vel)
    age = jnp.where(dead, 0.0, age)
    plife = jnp.where(dead, new_life, plife)
    return jnp.concatenate(
        [pos, vel, age[:, None], plife[:, None]], axis=1
    )


class ParticleSystem:
    """Owns the device-resident state and declares the sim compute node.

    Per frame (see sandbox/scene.py ``--particles``):

    1. ``sim_to(builder, dt)`` — declares the compute node; exports the
       stepped state and the (P,3) position plane.
    2. ``context.request_output`` both; ``feedback(state, positions)``
       stores them for the next frame.
    3. The emitter's SceneObject renders instanced at ``positions`` (the
       renderers pass device-resident instance offsets through untouched).
    """

    def __init__(self, count: int, emitter=(0.0, 0.0, 2.0), **sim_kwargs):
        self.count = int(count)
        self.emitter = np.asarray(emitter, np.float32)
        self.sim_kwargs = dict(sim_kwargs)
        self._tick = 0
        # Start everything dead (age ≥ life) so frame 0 respawns staggered.
        init = np.zeros((self.count, _STATE_COLS), np.float32)
        init[:, 2] = -1e4  # far below ground, invisible until respawn
        init[:, 6] = 1e3  # age
        init[:, 7] = np.linspace(0.01, 2.0, self.count)  # staggered deaths
        self._state = jnp.asarray(init)
        self._positions = jnp.asarray(init[:, :3])

    def __zenith_capture_key__(self):
        return ("particles", self.count, tuple(self.emitter.tolist()),
                tuple(sorted(self.sim_kwargs.items())))

    @property
    def positions(self) -> jax.Array:
        """(P, 3) device-resident positions (last completed sim step)."""
        return self._positions

    def feedback(self, state: jax.Array, positions: jax.Array) -> None:
        self._state = state
        self._positions = positions
        # The respawn hash salt advances once per COMPLETED frame here —
        # frame_dynamics stays pure, so update_dynamics followed by a
        # rebuild (the return-None path) cannot double-advance it.
        self._tick += 1

    def frame_dynamics(self, dt: float) -> dict:
        """Per-frame values (retained mode merges these too). Pure — safe
        to call more than once per frame."""
        return {
            "psys.state": self._state,
            "psys.dt": np.float32(max(dt, 1e-4)),
            "psys.tick": np.float32(self._tick),
        }

    def sim_to(self, builder: RenderGraphBuilder, dt: float):
        """Declare the sim compute node. Returns (state_handle, pos_handle)
        — both exported; feed their values back via ``feedback``."""
        for name, value in self.frame_dynamics(dt).items():
            builder.set_dynamic(name, value)
        state_out = builder.create(
            BufferDesc.storage("psys.state.out", (self.count, _STATE_COLS))
        )
        pos_out = builder.create(
            BufferDesc.storage("psys.pos.out", (self.count, 3))
        )
        node = builder.add_compute_node("psys.step")
        st_w = node.write(state_out)
        pos_w = node.write(pos_out)
        emitter = self.emitter
        kwargs = self.sim_kwargs

        def record(ctx):
            new_state = particle_step(
                ctx.dynamic("psys.state"),
                ctx.dynamic("psys.dt"),
                ctx.dynamic("psys.tick"),
                jnp.asarray(emitter),
                **kwargs,
            )
            ctx.set(st_w, new_state)
            ctx.set(pos_w, new_state[:, 0:3])

        node.execute(record)
        builder.export(state_out)
        builder.export(pos_out)
        return state_out, pos_out
