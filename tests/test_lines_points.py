"""Line/point topologies + wireframe polygon mode.

The reference's RasterizationState/InputAssemblyState pass vk::PolygonMode
and vk::PrimitiveTopology straight through to the driver
(pipeline.rs:483-506, 508-586); here lines and points expand to screen-space
quads (Vulkan 27.5/27.6 rectangle semantics) that ride the ordinary triangle
raster path. These tests pin exact coverage for axis-aligned cases, the
strip/restart decode, perspective-correct interpolation along a line, and
wireframe's polygon-facing cull.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from zenith.ops import TileGrid, clear_color, clear_depth
from zenith.ops.draw import assemble_lines, draw_indexed
from zenith.rhi.formats import Format
from zenith.rhi.pipeline import (
    GraphicPipeline,
    GraphicPipelineDesc,
    GraphicShaderInput,
)
from zenith.rhi.shader import Shader
from zenith.rhi.state import (
    ColorAttachmentDesc,
    CullMode,
    DepthStencilDesc,
    GraphicPipelineAttachments,
    GraphicPipelineState,
    InputAssemblyState,
    PolygonMode,
    PrimitiveTopology,
    RasterizationState,
    VertexLayout,
)

W, H = 128, 32
GRID = TileGrid(width=W, height=H, tile_h=8, tile_w=128)


def _ndc_x(sx):
    return 2.0 * sx / W - 1.0


def _ndc_y(sy):
    return 2.0 * sy / H - 1.0


def _vs(attrs, res):
    return {"position": attrs["position"], "color": attrs["color"]}


def _vs_pointsize(attrs, res):
    return {
        "position": attrs["position"],
        "color": attrs["color"],
        "point_size": attrs["color"][:, 3:4] * 0.0 + 3.0,
    }


def _fs(varyings, res, builtins):
    return varyings["color"]


def _pipeline(topology=PrimitiveTopology.LINE_LIST, polygon_mode=PolygonMode.FILL,
              line_width=1.0, cull=CullMode.NONE, point_size_vs=False,
              restart=False):
    vs = Shader.vertex("lp.vs", _vs_pointsize if point_size_vs else _vs)
    fs = Shader.fragment("lp.fs", _fs)
    layout = VertexLayout.from_fields(("position", 4), ("color", 4))
    return GraphicPipeline(
        GraphicPipelineDesc(
            shader_input=GraphicShaderInput(vs, fs, layout),
            state=GraphicPipelineState(
                input_assembly=InputAssemblyState(
                    topology=topology, primitive_restart=restart
                ),
                rasterization=RasterizationState(
                    cull_mode=cull, polygon_mode=polygon_mode,
                    line_width=line_width,
                ),
                depth_stencil=DepthStencilDesc().reverse_z(),
            ),
            attachments=GraphicPipelineAttachments(
                color_formats=(Format.RGBA32F,), depth_format=Format.D32F
            ),
            color_attachment_descs=(
                ColorAttachmentDesc(clear_value=(0, 0, 0, 0)),
            ),
        )
    )


def _render(pipeline, verts, indices):
    colors = [clear_color(H, W, (0.0, 0.0, 0.0, 0.0))]
    depth = clear_depth(H, W, 0.0)
    new_colors, new_depth, _ = draw_indexed(
        colors, depth, pipeline,
        jnp.asarray(verts), jnp.asarray(indices, jnp.int32),
        {}, GRID,
    )
    return np.asarray(new_colors[0]), np.asarray(new_depth)


def _vert(sx, sy, z=0.5, w=1.0, rgba=(1, 1, 1, 1)):
    # Clip-space vertex landing at screen (sx, sy) with the given w.
    return [_ndc_x(sx) * w, _ndc_y(sy) * w, z * w, w, *rgba]


class TestAssembleLines:
    def test_list(self):
        segs = np.asarray(assemble_lines(
            jnp.asarray([0, 1, 2, 3], jnp.int32),
            InputAssemblyState(topology=PrimitiveTopology.LINE_LIST),
        ))
        np.testing.assert_array_equal(segs, [[0, 1], [2, 3]])

    def test_strip(self):
        segs = np.asarray(assemble_lines(
            jnp.asarray([0, 1, 2], jnp.int32),
            InputAssemblyState(topology=PrimitiveTopology.LINE_STRIP),
        ))
        np.testing.assert_array_equal(segs, [[0, 1], [1, 2]])

    def test_strip_restart_splits(self):
        segs = np.asarray(assemble_lines(
            jnp.asarray([0, 1, -1, 2, 3], jnp.int32),
            InputAssemblyState(
                topology=PrimitiveTopology.LINE_STRIP, primitive_restart=True
            ),
        ))
        # Segments touching the restart collapse to the degenerate (0, 0).
        np.testing.assert_array_equal(
            segs, [[0, 1], [0, 0], [0, 0], [2, 3]]
        )


class TestLineRaster:
    def test_horizontal_exact_coverage(self):
        """Width-2 horizontal line at screen y=8 from x=4 to x=12 covers
        exactly rows {7, 8} x cols {4..11} (rectangle [4,12]x[7,9], butt
        caps, pixel centers at +0.5)."""
        pipe = _pipeline(line_width=2.0)
        verts = np.array([_vert(4, 8), _vert(12, 8)], np.float32)
        img, _ = _render(pipe, verts, [0, 1])
        cover = img[..., 0] > 0.5
        expected = np.zeros((H, W), bool)
        expected[7:9, 4:12] = True
        np.testing.assert_array_equal(cover, expected)

    def test_vertical_exact_coverage(self):
        pipe = _pipeline(line_width=2.0)
        verts = np.array([_vert(20, 4), _vert(20, 28)], np.float32)
        img, _ = _render(pipe, verts, [0, 1])
        cover = img[..., 0] > 0.5
        expected = np.zeros((H, W), bool)
        expected[4:28, 19:21] = True
        np.testing.assert_array_equal(cover, expected)

    def test_diagonal_coverage_scales_with_length(self):
        pipe = _pipeline(line_width=1.0)
        verts = np.array([_vert(10, 5), _vert(100, 25)], np.float32)
        img, _ = _render(pipe, verts, [0, 1])
        n = (img[..., 0] > 0.5).sum()
        length = np.hypot(90, 20)
        assert 0.7 * length <= n <= 1.5 * length, n

    def test_depth_interpolates_along_line(self):
        pipe = _pipeline(line_width=2.0)
        verts = np.array(
            [_vert(4, 8, z=0.8), _vert(12, 8, z=0.4)], np.float32
        )
        _, z = _render(pipe, verts, [0, 1])
        # Screen-linear z (w const): z(x) = 0.8 + (x - 4)/8 * (0.4 - 0.8).
        for col in (4, 7, 11):
            t = (col + 0.5 - 4.0) / 8.0
            np.testing.assert_allclose(
                z[8, col], 0.8 + t * (0.4 - 0.8), atol=1e-5
            )

    def test_perspective_correct_attr_along_line(self):
        """Endpoint w 1 vs 4: the red varying at the screen midpoint must be
        the perspective-correct (attr/w)/(1/w) blend, not the screen-linear
        average."""
        pipe = _pipeline(line_width=2.0)
        verts = np.array(
            [
                _vert(4, 8, w=1.0, rgba=(0, 1, 1, 1)),
                _vert(100, 8, w=4.0, rgba=(1, 1, 1, 1)),
            ],
            np.float32,
        )
        img, _ = _render(pipe, verts, [0, 1])
        mid = img[8, 52, 0]  # screen x=52.5 ≈ midpoint of [4, 100]
        t = (52.5 - 4.0) / 96.0
        expect = (t / 4.0) / ((1 - t) / 1.0 + t / 4.0)
        np.testing.assert_allclose(mid, expect, atol=0.02)
        assert abs(mid - t) > 0.05  # distinguishably NOT screen-linear

    def test_line_strip_restart_renders_two_segments(self):
        pipe = _pipeline(
            topology=PrimitiveTopology.LINE_STRIP, line_width=2.0,
            restart=True,
        )
        verts = np.array(
            [_vert(4, 8), _vert(12, 8), _vert(4, 20), _vert(12, 20)],
            np.float32,
        )
        img, _ = _render(pipe, verts, [0, 1, -1, 2, 3])
        cover = img[..., 0] > 0.5
        expected = np.zeros((H, W), bool)
        expected[7:9, 4:12] = True
        expected[19:21, 4:12] = True
        np.testing.assert_array_equal(cover, expected)

    def test_near_clipped_line_stays_finite(self):
        pipe = _pipeline(line_width=2.0)
        # One endpoint behind the camera (w < 0): segment must clip, render
        # some pixels, and never produce NaN.
        verts = np.array(
            [_vert(64, 16, z=0.5, w=1.0),
             [0.5, 0.0, 0.5, -1.0, 1, 1, 1, 1]],
            np.float32,
        )
        img, z = _render(pipe, verts, [0, 1])
        assert np.isfinite(img).all() and np.isfinite(z).all()
        assert (img[..., 0] > 0.5).sum() > 0

    def test_zero_length_line_draws_nothing(self):
        pipe = _pipeline(line_width=4.0)
        verts = np.array([_vert(20, 16), _vert(20, 16)], np.float32)
        img, _ = _render(pipe, verts, [0, 1])
        assert (img[..., 0] > 0.0).sum() == 0


class TestPointRaster:
    def test_default_size_one_pixel(self):
        pipe = _pipeline(topology=PrimitiveTopology.POINT_LIST)
        verts = np.array([_vert(20.5, 16.5)], np.float32)
        img, _ = _render(pipe, verts, [0])
        cover = img[..., 0] > 0.5
        expected = np.zeros((H, W), bool)
        expected[16, 20] = True
        np.testing.assert_array_equal(cover, expected)

    def test_point_size_from_vertex_shader(self):
        """PointSize 3 centered on a pixel center → exact 3x3 block."""
        pipe = _pipeline(
            topology=PrimitiveTopology.POINT_LIST, point_size_vs=True
        )
        verts = np.array([_vert(20.5, 16.5)], np.float32)
        img, _ = _render(pipe, verts, [0])
        cover = img[..., 0] > 0.5
        expected = np.zeros((H, W), bool)
        expected[15:18, 19:22] = True
        np.testing.assert_array_equal(cover, expected)

    def test_point_behind_camera_culled(self):
        pipe = _pipeline(topology=PrimitiveTopology.POINT_LIST)
        verts = np.array([[0.0, 0.0, 0.5, -1.0, 1, 1, 1, 1]], np.float32)
        img, _ = _render(pipe, verts, [0])
        assert (img[..., 0] > 0.0).sum() == 0


class TestWireframe:
    TRI_VERTS = np.array(
        [
            _vert(20, 26, rgba=(1, 0, 0, 1)),
            _vert(100, 26, rgba=(1, 0, 0, 1)),
            _vert(60, 5, rgba=(1, 0, 0, 1)),
        ],
        np.float32,
    )

    def test_wireframe_outlines_not_interior(self):
        filled_img, _ = _render(_pipeline(
            topology=PrimitiveTopology.TRIANGLE_LIST,
        ), self.TRI_VERTS, [0, 1, 2])
        wire_img, _ = _render(_pipeline(
            topology=PrimitiveTopology.TRIANGLE_LIST,
            polygon_mode=PolygonMode.LINE, line_width=1.0,
        ), self.TRI_VERTS, [0, 1, 2])
        filled = filled_img[..., 0] > 0.5
        wire = wire_img[..., 0] > 0.5
        assert 0 < wire.sum() < 0.5 * filled.sum()
        # Interior pixel (centroid) is not covered in wireframe.
        assert filled[20, 60] and not wire[20, 60]

    def test_wire_pixels_near_triangle_edges(self):
        wire_img, _ = _render(_pipeline(
            topology=PrimitiveTopology.TRIANGLE_LIST,
            polygon_mode=PolygonMode.LINE, line_width=1.0,
        ), self.TRI_VERTS, [0, 1, 2])
        ys, xs = np.nonzero(wire_img[..., 0] > 0.5)
        # Distance from each wire pixel center to the nearest of the three
        # edges must be < 1.5 px.
        pts = np.stack([xs + 0.5, ys + 0.5], axis=1)
        corners = np.array([[20, 26], [100, 26], [60, 5]], np.float64)
        dmin = np.full(len(pts), np.inf)
        for i in range(3):
            a, b = corners[i], corners[(i + 1) % 3]
            ab = b - a
            t = np.clip(((pts - a) @ ab) / (ab @ ab), 0, 1)
            proj = a + t[:, None] * ab
            dmin = np.minimum(dmin, np.linalg.norm(pts - proj, axis=1))
        assert dmin.max() < 1.5, dmin.max()

    def test_wireframe_backface_culled(self):
        # Reversed winding + cull BACK: the polygon is culled BEFORE edge
        # decomposition (Vulkan 27.7.1) → nothing rendered.
        img, _ = _render(_pipeline(
            topology=PrimitiveTopology.TRIANGLE_LIST,
            polygon_mode=PolygonMode.LINE, cull=CullMode.BACK,
        ), self.TRI_VERTS, [0, 2, 1])
        img_ok, _ = _render(_pipeline(
            topology=PrimitiveTopology.TRIANGLE_LIST,
            polygon_mode=PolygonMode.LINE, cull=CullMode.BACK,
        ), self.TRI_VERTS, [0, 1, 2])
        one_visible = (img_ok[..., 0] > 0.5).sum()
        other_visible = (img[..., 0] > 0.5).sum()
        # Exactly one of the two windings survives the cull.
        assert (one_visible == 0) != (other_visible == 0)

    def test_point_polygon_mode_renders_corners(self):
        img, _ = _render(_pipeline(
            topology=PrimitiveTopology.TRIANGLE_LIST,
            polygon_mode=PolygonMode.POINT, point_size_vs=True,
        ), self.TRI_VERTS, [0, 1, 2])
        cover = img[..., 0] > 0.5
        # A 3x3 block at each corner, nothing at the centroid.
        for cx, cy in ((20, 26), (100, 26), (60, 5)):
            assert cover[int(cy), int(cx)] or cover[int(cy) - 1, int(cx)] or \
                cover[int(cy), int(cx) - 1], (cx, cy)
        assert not cover[20, 60]
        assert cover.sum() <= 3 * 16  # just corner blocks, not fill
