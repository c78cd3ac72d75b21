"""Screen-space reflections node over the deferred pipeline.

Sits between the lighting resolve and TAA (reflections should be
anti-aliased like everything else): reads the lit HDR + the G-buffer
planes (``DeferredRenderer.gbuffer_handles``), writes HDR with
Fresnel-weighted reflections added (ops/ssr.py has the algorithm and the
gather-budget design notes).

Stateless across frames — unlike TAA/auto-exposure there is no history
surface, so retained mode only needs the camera values
(``frame_dynamics``). All tuning parameters ride one packed (4,)
dynamic; changing ``steps``/``refine``/``jitter`` re-traces (they shape
the program).
"""

from __future__ import annotations

import jax
import numpy as np

from zenith.rendergraph import RenderGraphBuilder
from zenith.rendergraph.resource import RenderGraphResource


class ScreenSpaceReflections:
    """Declares the SSR node (see sandbox/scene.py ``--ssr``).

    Per frame the app calls ``render_to(builder, hdr, out, camera,
    gbuffer)`` after the deferred renderer, before TAA. Retained mode:
    merge ``frame_dynamics(camera)`` into ``update_dynamics``.
    """

    def __init__(self, steps: int = 12, refine: int = 4,
                 max_distance: float = 150.0, thickness: float = 2.0,
                 strength: float = 1.0, max_roughness: float = 0.6,
                 jitter: bool = True):
        self.steps = int(steps)
        self.refine = int(refine)
        self.max_distance = float(max_distance)
        self.thickness = float(thickness)
        self.strength = float(strength)
        self.max_roughness = float(max_roughness)
        self.jitter = bool(jitter)

    def __zenith_capture_key__(self):
        return ("SSR", self.steps, self.refine, self.jitter)

    def _params(self) -> np.ndarray:
        return np.asarray(
            [self.strength, self.max_distance, self.thickness,
             self.max_roughness],
            np.float32,
        )

    def frame_dynamics(self, camera) -> dict:
        """Retained-mode per-frame values (merge into update_dynamics)."""
        return {
            "ssr.view_proj": np.asarray(
                camera.render_view_projection, np.float32
            ),
            "ssr.cam_pos": np.asarray(camera.location, np.float32),
            "ssr.params": self._params(),
        }

    def render_to(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
        camera,
        gbuffer: dict,  # DeferredRenderer.gbuffer_handles
    ) -> RenderGraphResource:
        builder.set_dynamic(
            "ssr.view_proj",
            np.asarray(camera.render_view_projection, np.float32),
        )
        builder.set_dynamic(
            "ssr.cam_pos", np.asarray(camera.location, np.float32)
        )
        builder.set_dynamic("ssr.params", self._params())
        node = builder.add_lambda_node("ssr")
        src = node.read(hdr_input)
        a_in = node.read(gbuffer["albedo"])
        n_in = node.read(gbuffer["normal"])
        p_in = node.read(gbuffer["pos"])
        d_in = node.read(gbuffer["depth"])
        dst = node.write(output)
        steps, refine, jitter = self.steps, self.refine, self.jitter

        def record(ctx):
            from zenith.ops.ssr import ssr_reflect

            hdr = ctx.get(src)
            vp = ctx.dynamic("ssr.view_proj")
            cam = ctx.dynamic("ssr.cam_pos")
            params = ctx.dynamic("ssr.params")
            if ctx.sharded and ctx.num_shards > 1:
                # Reflection rays land anywhere on screen: resolve on the
                # gathered full surfaces, slice the band back (the
                # motion-blur/TAA pattern — output bit-equal to
                # single-device).
                full = ssr_reflect(
                    ctx.get_full(src),
                    ctx.get_full(a_in),
                    ctx.get_full(n_in),
                    ctx.get_full(p_in)[..., :3],
                    ctx.get_full(d_in),
                    cam, vp, params, steps, refine, jitter,
                )
                y0 = jax.lax.axis_index(ctx.shard_axis) * hdr.shape[0]
                out = jax.lax.dynamic_slice_in_dim(full, y0, hdr.shape[0], 0)
            else:
                out = ssr_reflect(
                    hdr, ctx.get(a_in), ctx.get(n_in),
                    ctx.get(p_in)[..., :3], ctx.get(d_in),
                    cam, vp, params, steps, refine, jitter,
                )
            ctx.set(dst, out)

        node.execute(record)
        return output
