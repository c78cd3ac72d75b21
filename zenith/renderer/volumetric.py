"""Volumetric fog / sun-shaft node over the deferred pipeline.

Sits after SSR, before TAA (the march dither is designed to be resolved
by TAA's history blend): reads the lit HDR + the G-buffer position/depth
planes and — when the deferred renderer published its single sun shadow
map (``gbuffer_handles["sun_shadow"]``) — marches that map for god rays
(ops/volumetric.py has the algorithm and gather-budget notes).

Coupling contract: with shafts enabled this node READS the graph-global
``def.light_vp`` / ``def.shadow_bias`` dynamics the deferred renderer
set for the same builder — the exact VP that rendered the map. Its own
per-frame values (inverse VP, camera, sun vector/color, the packed fog
params) ride ``fog.*`` dynamics, so a scene without a sun still gets
pure height fog (zero gathers).

Stateless across frames; retained mode only needs ``frame_dynamics``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from zenith.rendergraph import RenderGraphBuilder
from zenith.rendergraph.resource import RenderGraphResource


class VolumetricFog:
    """Declares the volumetric node (see sandbox/scene.py ``--fog``).

    Per frame the app calls ``render_to(builder, hdr, out, camera,
    gbuffer, sun=scene.sun)`` after the deferred renderer (and SSR),
    before TAA. Retained mode: merge ``frame_dynamics(camera)``.
    """

    def __init__(self, density: float = 0.0035, height: float = 0.0,
                 height_falloff: float = 45.0, anisotropy: float = 0.6,
                 max_distance: float = 400.0, sun_boost: float = 0.9,
                 ambient: float = 0.08, steps: int = 16,
                 jitter: bool = True, shafts: bool = True):
        self.density = float(density)
        self.height = float(height)
        self.height_falloff = float(height_falloff)
        self.anisotropy = float(anisotropy)
        self.max_distance = float(max_distance)
        self.sun_boost = float(sun_boost)
        self.ambient = float(ambient)
        self.steps = int(steps)
        self.jitter = bool(jitter)
        self.shafts = bool(shafts)
        self._sun = None  # observed at render_to / frame_dynamics

    def __zenith_capture_key__(self):
        return ("VolumetricFog", self.steps, self.jitter, self.shafts)

    def _params(self) -> np.ndarray:
        return np.asarray(
            [self.density, self.height, self.height_falloff,
             self.anisotropy, self.max_distance, self.sun_boost,
             self.ambient, 0.0],
            np.float32,
        )

    def _sun_values(self, sun) -> "tuple[np.ndarray, np.ndarray]":
        if sun is None:
            return (np.asarray([0.0, 0.0, 1.0], np.float32),
                    np.asarray([1.0, 1.0, 1.0], np.float32))
        from zenith.core import mathtypes as m

        return (
            m.normalize(np.asarray(sun.direction, np.float32)),
            np.asarray(sun.color, np.float32) * sun.intensity,
        )

    def frame_dynamics(self, camera, sun=None) -> dict:
        """Retained-mode per-frame values (merge into update_dynamics)."""
        sdir, scol = self._sun_values(sun if sun is not None else self._sun)
        return {
            "fog.inv_vp": np.asarray(
                camera.render_inv_view_projection, np.float32
            ),
            "fog.cam_pos": np.asarray(camera.location, np.float32),
            "fog.sun_dir": sdir,
            "fog.sun_color": scol,
            "fog.params": self._params(),
        }

    def render_to(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
        camera,
        gbuffer: dict,  # DeferredRenderer.gbuffer_handles
        sun=None,  # scene.sun (shaft color/direction; None = white fog)
    ) -> RenderGraphResource:
        self._sun = sun
        for name, value in self.frame_dynamics(camera, sun).items():
            builder.set_dynamic(name, value)
        node = builder.add_lambda_node("fog")
        src = node.read(hdr_input)
        p_in = node.read(gbuffer["pos"])
        d_in = node.read(gbuffer["depth"])
        sm_in = (
            node.read(gbuffer["sun_shadow"])
            if self.shafts and "sun_shadow" in gbuffer
            else None
        )
        dst = node.write(output)
        steps, jitter = self.steps, self.jitter

        def record(ctx):
            from zenith.ops.volumetric import volumetric_sun

            hdr = ctx.get(src)
            wpos = ctx.get(p_in)[..., :3]
            dep = ctx.get(d_in)
            cam = ctx.dynamic("fog.cam_pos")
            inv_vp = ctx.dynamic("fog.inv_vp")
            h, w = dep.shape
            full_h, row0 = h, 0
            if ctx.sharded and ctx.num_shards > 1:
                full_h = h * ctx.num_shards
                row0 = jax.lax.axis_index(ctx.shard_axis) * h
            # Per-pixel unit view rays from the inverse VP (GLOBAL rows —
            # the skybox reconstruction, deferred.py record_lighting).
            ndc_x = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w * 2 - 1
            ndc_y = (
                (row0 + jnp.arange(h, dtype=jnp.float32) + 0.5)
                / full_h * 2 - 1
            )
            px = jnp.broadcast_to(ndc_x[None, :], (h, w))
            py = jnp.broadcast_to(ndc_y[:, None], (h, w))
            ndc = jnp.stack(
                [px, py, jnp.full_like(px, 0.5), jnp.ones_like(px)], -1
            )
            p = ndc @ inv_vp.T
            dirs = p[..., :3] / p[..., 3:4] - cam
            dirs = dirs / jnp.maximum(
                jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-8
            )
            if sm_in is not None:
                # The map is small; marched taps land anywhere on it —
                # gather it full. Screen planes stay on the local band
                # (the op has zero screen-plane gathers).
                sm = ctx.get_full(sm_in)
                lvp = ctx.dynamic("def.light_vp")
                bias = ctx.dynamic("def.shadow_bias")
            else:
                sm, lvp, bias = None, None, 0.0
            out = volumetric_sun(
                hdr, wpos, dep, cam, dirs,
                ctx.dynamic("fog.sun_dir"), ctx.dynamic("fog.sun_color"),
                ctx.dynamic("fog.params"),
                shadow_map=sm, light_vp=lvp, shadow_bias=bias,
                steps=steps, jitter=jitter, row0=row0,
            )
            ctx.set(dst, out)

        node.execute(record)
        return output
