"""Depth of field — gather-free.

Classic DoF scatters each pixel into a bokeh disc (or gathers a
variable-radius neighborhood) — both are the expensive primitive here.
Instead this is the mip-blur formulation mapped onto the same dense
level-blend trick the IBL specular lookup uses (ops/ibl.sample_cube_lod):

1. build a small blur pyramid of the scene color (downsample = reshape
   means; blur = separable rolls),
2. upsample every level back to full resolution (repeats + crops),
3. per pixel, compute the circle of confusion from the G-buffer's view
   distance and blend the pyramid levels with tent weights
   max(0, 1 − |lod − m|) — trilinear-exact, at most two non-zero levels,
   all dense elementwise math.

The known quality trade of the mip approach (slight background bleed
across sharp silhouettes) is the standard price for a scatter-free DoF;
the focus parameters ride a packed dynamic, so racking focus never
recompiles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from zenith.rendergraph import RenderGraphBuilder
from zenith.rendergraph.resource import RenderGraphResource


def _blur_levels(rgb: jnp.ndarray, levels: int) -> "list[jnp.ndarray]":
    from zenith.renderer.post import _blur_axis, _downsample2, _upsample2

    h, w = rgb.shape[0], rgb.shape[1]
    out = [rgb]
    cur = rgb
    for _ in range(levels - 1):
        cur = _downsample2(cur)
        cur = _blur_axis(_blur_axis(cur, 0), 1)
        out.append(_upsample2(cur, h, w))
    return out


def dof_blend(
    hdr: jnp.ndarray,  # (H, W, 4)
    view_dist: jnp.ndarray,  # (H, W) camera→surface distance (0 = sky)
    params: jnp.ndarray,  # (4,): focus_dist, focal_range, strength, pad
    levels: int = 4,
) -> jnp.ndarray:
    """Per-pixel level blend by circle of confusion."""
    rgb = hdr[..., :3]
    pyramid = _blur_levels(rgb, levels)
    focus = params[0]
    frange = jnp.maximum(params[1], 1e-3)
    strength = params[2]
    # Sky (dist 0) focuses at infinity → use a huge distance.
    d = jnp.where(view_dist > 0.0, view_dist, 1e6)
    coc = jnp.abs(d - focus) / (jnp.abs(d) + frange)
    lod = jnp.clip(coc * strength * (levels - 1), 0.0, levels - 1.0)
    acc = jnp.zeros_like(rgb)
    for m, lvl in enumerate(pyramid):
        wgt = jnp.maximum(1.0 - jnp.abs(lod - m), 0.0)[..., None]
        acc = acc + lvl * wgt
    return jnp.concatenate([acc, hdr[..., 3:4]], axis=-1)


class DepthOfField:
    """Declares the DoF node between the scene/TAA output and post.

    Parameters ride a packed (4,) dynamic — mutate the fields (or call
    ``focus_at``) and the next frame racks focus with zero recompiles.
    """

    def __init__(self, focus_distance: float = 170.0,
                 focal_range: float = 40.0, strength: float = 1.0,
                 levels: int = 4):
        self.focus_distance = float(focus_distance)
        self.focal_range = float(focal_range)
        self.strength = float(strength)
        self.levels = int(levels)

    def __zenith_capture_key__(self):
        return ("DepthOfField", self.levels)

    def focus_at(self, distance: float) -> None:
        self.focus_distance = float(distance)

    def _params(self) -> np.ndarray:
        return np.asarray(
            [self.focus_distance, self.focal_range, self.strength, 0.0],
            np.float32,
        )

    def frame_dynamics(self) -> dict:
        """Retained-mode per-frame values (focus racking)."""
        return {"dof.params": self._params()}

    def render_to(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
        gbuffer: dict,  # DeferredRenderer.gbuffer_handles
    ) -> RenderGraphResource:
        builder.set_dynamic("dof.params", self._params())
        node = builder.add_lambda_node("dof")
        src = node.read(hdr_input)
        p_in = node.read(gbuffer["pos"])
        d_in = node.read(gbuffer["depth"])
        dst = node.write(output)
        levels = self.levels

        def record(ctx):
            hdr = ctx.get(src)
            banded = ctx.sharded and ctx.num_shards > 1
            cam = ctx.dynamic("def.camera_pos")
            params = ctx.dynamic("dof.params")

            def dist_of(pos_plane, depth_plane):
                dd = jnp.linalg.norm(
                    pos_plane[..., :3] - cam, axis=-1
                )
                return jnp.where(depth_plane > 0.0, dd, 0.0)

            if banded:
                # The pyramid's blur crosses band rows: gather, compute,
                # slice back (the thin-band post pattern).
                full = dof_blend(
                    ctx.get_full(src),
                    dist_of(ctx.get_full(p_in), ctx.get_full(d_in)),
                    params, levels,
                )
                y0 = jax.lax.axis_index(ctx.shard_axis) * hdr.shape[0]
                out = jax.lax.dynamic_slice_in_dim(full, y0, hdr.shape[0], 0)
            else:
                out = dof_blend(
                    hdr, dist_of(ctx.get(p_in), ctx.get(d_in)),
                    params, levels,
                )
            ctx.set(dst, out)

        node.execute(record)
        return output
