"""TriangleRenderer (reference zenith-renderer/src/triangle.rs:18-180).

Faithful port of the reference triangle: same vertex data (triangle.rs:28-33),
same shader semantics (content/shaders/triangle.slang — passthrough VS,
fragment ``color * (0.5 + 0.5*sin(time*3 + color*6.28))``), same pipeline
state (no culling, clear to 0.1 gray, triangle.rs:110-117) — with slangc +
SPIR-V reflection replaced by Python shader functions + declared bindings,
and the per-frame time uniform write (triangle.rs:131-138) replaced by a
graph dynamic.
"""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np

from zenith.rendergraph import RenderGraphBuilder
from zenith.rendergraph.resource import RenderGraphResource
from zenith.rhi import (
    Buffer,
    BufferUsage,
    ColorAttachmentDesc,
    CullMode,
    GraphicShaderInput,
    RasterizationState,
    Shader,
    VertexLayout,
    attr,
    uniform,
)
from zenith.rhi.device import RenderDevice
from zenith.rhi.state import GraphicPipelineState

# #[derive(VertexLayout)] Vertex { position: [f32; 3], color: [f32; 3] }
# (triangle.rs:11-16)
VERTEX_LAYOUT = VertexLayout.from_fields(("position", 3), ("color", 3))


def _vs(attrs, res):
    """triangle.slang vsmain (lines 19-25): passthrough position, w=1."""
    pos = attrs["position"]
    n = pos.shape[0]
    return {
        "position": jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1),
        "color": attrs["color"],
    }


def _fs(varyings, res, builtins):
    """triangle.slang psmain (lines 34-38): time-animated color."""
    t = res["Time"]
    c = varyings["color"]
    animated = c * (0.5 + 0.5 * jnp.sin(t * 3.0 + c * 6.28))
    return jnp.concatenate([animated, jnp.ones_like(c[..., :1])], axis=-1)


class TriangleRenderer:
    """(triangle.rs:18-75)"""

    def __init__(self, device: RenderDevice):
        vertices = np.array(
            [
                [0.0, 0.5, 0.0, 1.0, 0.0, 0.0],
                [-0.5, -0.5, 0.0, 0.0, 1.0, 0.0],
                [0.5, -0.5, 0.0, 0.0, 0.0, 1.0],
            ],
            np.float32,
        )
        indices = np.array([0, 1, 2], np.int32)
        # UploadPool + immediate submit (triangle.rs:41-49) → device uploads.
        self.vertex_buffer = device.upload_buffer(
            "triangle.vertex", vertices, BufferUsage.VERTEX
        )
        self.index_buffer = device.upload_buffer(
            "triangle.index", indices, BufferUsage.INDEX
        )
        # Shader::from_file + reflection (triangle.rs:52-66) → shader fns.
        self.vertex_shader = Shader.vertex(
            "shader.triangle.vs", _vs,
            inputs=[attr("position", 3), attr("color", 3)],
        )
        self.fragment_shader = Shader.fragment(
            "shader.triangle.ps", _fs, bindings=[uniform("Time")]
        )
        self.start_time = time.perf_counter()

    def frame_dynamics(self, time_s: "float | None" = None) -> dict:
        """Per-frame dynamics for RETAINED execution (engine.py)."""
        import numpy as _np

        if time_s is None:
            time_s = time.perf_counter() - self.start_time
        return {"triangle.time": _np.float32(time_s)}

    def render_to(
        self,
        builder: RenderGraphBuilder,
        output: RenderGraphResource,
        width: int,
        height: int,
        time_s: "float | None" = None,
    ) -> None:
        """(triangle.rs:78-179) Declare the triangle node."""
        vb = builder.import_resource(self.vertex_buffer)
        ib = builder.import_resource(self.index_buffer)
        import numpy as _np

        if time_s is None:
            time_s = time.perf_counter() - self.start_time
        builder.set_dynamic("triangle.time", _np.float32(time_s))

        node = builder.add_graphic_node("triangle")
        vba = node.read(vb)
        iba = node.read(ib)
        output_rt = node.write(output)

        shader = GraphicShaderInput(
            self.vertex_shader, self.fragment_shader, VERTEX_LAYOUT
        )
        state = GraphicPipelineState(
            rasterization=RasterizationState(cull_mode=CullMode.NONE)
        )
        with node.pipeline(shader, state) as binder:
            binder.push_color(
                output_rt,
                ColorAttachmentDesc(clear_value=(0.1, 0.1, 0.1, 1.0)),
            )

        def record(ctx):
            ctx.bind("Time", ctx.dynamic("triangle.time"))
            ctx.draw_indexed(vba, iba, bin_capacity=8)

        node.execute(record)
