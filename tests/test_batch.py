"""draw_indexed_batch ⇔ sequential draw_indexed equivalence.

Batching N opaque draws into one binning+raster+shade pass must reproduce
the sequential result exactly: records concatenate in submission order and
the (tile, record) sort preserves cross-draw ordering, so the depth winner
per pixel is identical; per-draw uniforms ride as constant varyings whose
perspective division reproduces them bit-cleanly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from zenith.ops import TileGrid, clear_color, clear_depth
from zenith.ops.draw import draw_indexed, draw_indexed_batch
from zenith.rhi.pipeline import (
    GraphicPipeline,
    GraphicPipelineDesc,
    GraphicShaderInput,
)
from zenith.rhi.formats import Format
from zenith.rhi.shader import Shader, uniform
from zenith.rhi.state import (
    ColorAttachmentDesc,
    CullMode,
    DepthStencilDesc,
    GraphicPipelineAttachments,
    GraphicPipelineState,
    RasterizationState,
    VertexLayout,
)

W, H = 128, 32
GRID = TileGrid(width=W, height=H, tile_h=8, tile_w=128)


def _vs(attrs, res):
    pos = attrs["position"]
    offs = res["Offset"]  # (4,) xyzw offset per draw
    return {"position": pos + offs[None, :], "color": attrs["color"]}


def _fs(varyings, res, builtins):
    tint = res["Tint"]
    # Shape-generic: (4,) when drawn individually, (H, W, 4) batched plane.
    return varyings["color"] * jnp.broadcast_to(
        tint, varyings["color"].shape
    ) if tint.ndim == 1 else varyings["color"] * tint


def _pipeline(blend=False, samples=1):
    from zenith.rhi.state import MultisampleState

    vs = Shader.vertex("batch.vs", _vs, bindings=[uniform("Offset")])
    fs = Shader.fragment("batch.fs", _fs, bindings=[uniform("Tint")])
    layout = VertexLayout.from_fields(("position", 4), ("color", 4))
    cdesc = ColorAttachmentDesc()
    if blend:
        cdesc = cdesc.translucent()
    return GraphicPipeline(
        GraphicPipelineDesc(
            shader_input=GraphicShaderInput(vs, fs, layout),
            state=GraphicPipelineState(
                rasterization=RasterizationState(cull_mode=CullMode.NONE),
                depth_stencil=DepthStencilDesc().reverse_z(),
                multisample=MultisampleState(samples=samples),
            ),
            attachments=GraphicPipelineAttachments(
                color_formats=(Format.RGBA32F,), depth_format=Format.D32F
            ),
            color_attachment_descs=(cdesc,),
        )
    )


def _tri(cx, cy, z, rgba):
    v = np.array(
        [
            [cx, cy - 0.5, z, 1.0, *rgba],
            [cx + 0.45, cy + 0.4, z, 1.0, *rgba],
            [cx - 0.45, cy + 0.4, z, 1.0, *rgba],
        ],
        np.float32,
    )
    return jnp.asarray(v), jnp.asarray([[0, 1, 2]], jnp.int32)


@pytest.fixture
def draws(rng):
    out = []
    for i in range(3):
        vb, ib = _tri(
            -0.5 + 0.45 * i, 0.0, 0.3 + 0.2 * i,
            (1.0 if i == 0 else 0.2, 1.0 if i == 1 else 0.2,
             1.0 if i == 2 else 0.2, 1.0),
        )
        res = {
            "Offset": jnp.asarray([0.05 * i, 0.02 * i, 0.0, 0.0], jnp.float32),
            "Tint": jnp.asarray([1.0, 0.9, 0.8, 1.0], jnp.float32)
            * (0.5 + 0.25 * i),
        }
        out.append((vb, ib, res))
    return out


class TestBatchEquivalence:
    def test_batched_equals_sequential(self, draws):
        pipeline = _pipeline()

        colors = [clear_color(H, W, (0, 0, 0, 1))]
        depth = clear_depth(H, W, 0.0)
        for vb, ib, res in draws:
            colors, depth, _ = draw_indexed(
                colors, depth, pipeline, vb, ib, res, GRID
            )
        seq_img, seq_z = np.asarray(colors[0]), np.asarray(depth)

        colors = [clear_color(H, W, (0, 0, 0, 1))]
        depth = clear_depth(H, W, 0.0)
        colors, depth, stats = draw_indexed_batch(
            colors, depth, pipeline, draws, GRID,
            per_draw_uniforms=("Tint",),
        )
        bat_img, bat_z = np.asarray(colors[0]), np.asarray(depth)

        assert np.asarray(stats.bin_overflow) == 0
        np.testing.assert_array_equal(bat_z, seq_z)
        np.testing.assert_allclose(bat_img, seq_img, atol=2e-6)
        assert (bat_img[..., :3].max(axis=(0, 1)) > 0.1).all()  # all drawn

    def test_overlap_depth_order_preserved(self):
        """Overlapping triangles at distinct depths: the batched depth
        winner matches sequential submission, including the later-equal-z
        loser under GREATER."""
        pipeline = _pipeline()
        a = _tri(0.0, 0.0, 0.5, (1, 0, 0, 1))
        b = _tri(0.1, 0.0, 0.5, (0, 1, 0, 1))  # same z, later → loses ties
        res = {
            "Offset": jnp.zeros((4,), jnp.float32),
            "Tint": jnp.ones((4,), jnp.float32),
        }
        draws = [(a[0], a[1], res), (b[0], b[1], res)]

        colors = [clear_color(H, W, (0, 0, 0, 1))]
        depth = clear_depth(H, W, 0.0)
        for vb, ib, r in draws:
            colors, depth, _ = draw_indexed(colors, depth, pipeline, vb, ib, r, GRID)
        seq_img = np.asarray(colors[0])

        colors = [clear_color(H, W, (0, 0, 0, 1))]
        depth = clear_depth(H, W, 0.0)
        colors, depth, _ = draw_indexed_batch(
            colors, depth, pipeline, draws, GRID, per_draw_uniforms=("Tint",)
        )
        np.testing.assert_allclose(np.asarray(colors[0]), seq_img, atol=2e-6)

    def test_blend_rejected(self, draws):
        pipeline = _pipeline(blend=True)
        colors = [clear_color(H, W, (0, 0, 0, 1))]
        depth = clear_depth(H, W, 0.0)
        with pytest.raises(ValueError, match="blend"):
            draw_indexed_batch(
                colors, depth, pipeline, draws, GRID,
                per_draw_uniforms=("Tint",),
            )

    def test_single_draw_batch_ok(self, draws):
        pipeline = _pipeline()
        colors = [clear_color(H, W, (0, 0, 0, 1))]
        depth = clear_depth(H, W, 0.0)
        colors, depth, _ = draw_indexed_batch(
            colors, depth, pipeline, draws[:1], GRID,
            per_draw_uniforms=("Tint",),
        )
        assert np.asarray(colors[0])[..., 0].max() > 0.2


class TestBatchMsaa:
    """Batched draws under an MSAA pipeline: one shared binning, one
    raster + shade per sample — must equal the sequential single-draw MSAA
    path exactly (same sample positions, same winner per sample)."""

    def _msaa_clear(self, samples):
        colors = [jnp.broadcast_to(
            clear_color(H, W, (0, 0, 0, 1)), (samples, H, W, 4)
        )]
        depth = jnp.broadcast_to(clear_depth(H, W, 0.0), (samples, H, W))
        return colors, depth

    @pytest.mark.parametrize("samples", [2, 4])
    def test_msaa_batched_equals_sequential(self, draws, samples):
        pipeline = _pipeline(samples=samples)

        colors, depth = self._msaa_clear(samples)
        for vb, ib, res in draws:
            colors, depth, _ = draw_indexed(
                colors, depth, pipeline, vb, ib, res, GRID
            )
        seq_img, seq_z = np.asarray(colors[0]), np.asarray(depth)

        colors, depth = self._msaa_clear(samples)
        colors, depth, stats = draw_indexed_batch(
            colors, depth, pipeline, draws, GRID,
            per_draw_uniforms=("Tint",),
        )
        bat_img, bat_z = np.asarray(colors[0]), np.asarray(depth)

        assert bat_img.shape == (samples, H, W, 4)
        np.testing.assert_array_equal(bat_z, seq_z)
        np.testing.assert_allclose(bat_img, seq_img, atol=2e-6)

    def test_msaa_samples_rasterize_at_distinct_positions(self, draws):
        """Per-sample planes must differ at silhouette pixels (each sample
        rasterized at its own Vulkan standard position) — the edge
        anti-aliasing MSAA exists for."""
        pipeline = _pipeline(samples=4)
        colors, depth = self._msaa_clear(4)
        colors, _, _ = draw_indexed_batch(
            colors, depth, pipeline, draws, GRID,
            per_draw_uniforms=("Tint",),
        )
        per_sample = np.asarray(colors[0])
        differs = np.abs(per_sample - per_sample[0:1]).max(axis=(0, 3)) > 1e-6
        assert differs.any()


def test_per_draw_uniforms_ride_records_at_high_draw_count(rng):
    """Above 8 draws, per-draw uniforms switch from draw-id where-chains to
    constant record columns — results must stay identical to the
    sequential draw-by-draw reference."""
    import jax.numpy as jnp
    import numpy as np

    from zenith.ops.binning import TileGrid
    from zenith.ops.draw import draw_indexed, draw_indexed_batch
    from zenith.rhi import (
        ColorAttachmentDesc,
        Format,
        GraphicPipelineAttachments,
        GraphicShaderInput,
        Shader,
        attr,
        uniform,
    )
    from zenith.rhi.pipeline import GraphicPipeline, GraphicPipelineDesc
    from zenith.rhi.state import (
        CullMode,
        DepthStencilDesc,
        GraphicPipelineState,
        RasterizationState,
        VertexLayout,
    )

    W, H = 128, 32
    grid = TileGrid(width=W, height=H, tile_h=8, tile_w=128)
    layout = VertexLayout.from_fields(("position", 3),)

    def vs(attrs, res):
        p = attrs["position"]
        return {"position": jnp.concatenate(
            [p, jnp.ones((p.shape[0], 1), jnp.float32)], 1)}

    def fs(varyings, res, builtins):
        c = res["Color"]
        return jnp.broadcast_to(c, builtins.depth.shape + (4,))

    ds = DepthStencilDesc().reverse_z()
    pipe = GraphicPipeline(GraphicPipelineDesc(
        shader_input=GraphicShaderInput(
            Shader.vertex("hi.vs", vs, inputs=[attr("position", 3)]),
            Shader.fragment("hi.fs", fs, bindings=[uniform("Color")]),
            layout,
        ),
        state=GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE),
            depth_stencil=ds,
        ),
        attachments=GraphicPipelineAttachments(
            color_formats=(Format.RGBA32F,), depth_format=Format.D32F
        ),
        color_attachment_descs=(ColorAttachmentDesc(),),
        depth_attachment_desc=ds,
    ))

    ib = jnp.asarray([0, 1, 2], jnp.int32)
    draws = []
    for i in range(12):  # > 8: records path
        z = 0.2 + 0.05 * i
        dx = -0.8 + 0.14 * i
        vb = jnp.asarray(
            [[dx, -0.5, z], [dx + 0.35, 0.5, z], [dx - 0.35, 0.5, z]],
            jnp.float32,
        )
        color = jnp.asarray(rng.uniform(0.1, 1.0, 4), jnp.float32)
        draws.append((vb, ib, {"Color": color}))

    colors_b = [jnp.zeros((H, W, 4), jnp.float32)]
    depth_b = jnp.zeros((H, W), jnp.float32)
    colors_b, _, _ = draw_indexed_batch(
        colors_b, depth_b, pipe, draws, grid,
        per_draw_uniforms=("Color",),
    )

    colors_s = [jnp.zeros((H, W, 4), jnp.float32)]
    depth_s = jnp.zeros((H, W), jnp.float32)
    for vb, ibx, res in draws:
        colors_s, depth_s, _ = draw_indexed(
            colors_s, depth_s, pipe, vb, ibx, res, grid
        )
    np.testing.assert_allclose(
        np.asarray(colors_b[0]), np.asarray(colors_s[0]), atol=1e-5
    )
