"""Render graph builder — the per-frame declarative API.

Mirrors zenith-rendergraph/src/builder.rs: ``create``/``import_resource``/
``export``/``add_graphic_node``/``add_lambda_node``/``build`` (builder.rs:
29-140); per-node ``read``/``write`` access declarations (builder.rs:147-299);
``GraphicNodeBuilder.pipeline(...)`` returning an ``AttachmentBinder`` that
collects color/depth attachments and finalizes a GraphicPipelineDesc with
formats pulled from the graph resources (builder.rs:301-427).

What changes here: barrier stage hints disappear (no barriers exist), and
**per-frame values flow through declared dynamics** (``set_dynamic`` /
``ctx.dynamic(name)``) instead of closure captures — node closures run once
at trace time, so a captured Python float would be baked into the compiled
frame program. The graph is rebuilt every frame exactly like the reference
(engine.rs:93-102); compilation is cached on graph *structure*.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from zenith.core import log
from zenith.rendergraph.resource import (
    InitialResourceStorage,
    RenderGraphResource,
    RenderGraphResourceAccess,
    ViewKind,
)
from zenith.rhi.pipeline import (
    GraphicPipelineAttachments,
    GraphicPipelineDesc,
    GraphicShaderInput,
)
from zenith.rhi.resource import Buffer, BufferDesc, Texture, TextureDesc
from zenith.rhi.state import (
    ColorAttachmentDesc,
    DepthStencilDesc,
    GraphicPipelineState,
)

logger = log.get(__name__)


@dataclass
class ResourceAccessStorage:
    """(builder.rs:15-19, minus the vk stage hint — no barriers to derive).
    ``mip``/``layer``/``brange`` mirror the access's sub-resource selectors
    (texture.rs:536-559, buffer.rs:276-322) into the structure key."""

    resource_id: int
    view: ViewKind
    mip: Optional[int] = None
    layer: Optional[int] = None
    brange: "Optional[Tuple[int, int]]" = None


@dataclass
class GraphNode:
    """(node.rs:7-21) One graph node: accesses + pipeline + record closure."""

    name: str
    index: int
    kind: str  # "graphic" | "lambda"
    inputs: List[ResourceAccessStorage] = field(default_factory=list)
    outputs: List[ResourceAccessStorage] = field(default_factory=list)
    # Graphic-only. Attachment tuples carry the sub-resource selectors
    # (mip, layer) of the bound access — (0, None) = whole surface.
    pipeline_desc: Optional[GraphicPipelineDesc] = None
    color_attachments: "List[Tuple[int, ColorAttachmentDesc, int, Optional[int]]]" = field(default_factory=list)
    depth_attachment: "Optional[Tuple[int, DepthStencilDesc, int, Optional[int]]]" = None
    stencil_attachment: Optional[int] = None  # resource id of the S8 plane
    # The record callback, run at trace time with an execution context.
    job: Optional[Callable[[Any], Any]] = None
    # Screen-row occupancy hint for CompileOptions(parallel="auto"): a
    # list of (triangle_count, y0, y1) per draw, y in [0, 1] fractional
    # framebuffer rows (renderers project object AABBs). DELIBERATELY
    # outside the structure key — it guides the sort-first/sort-last
    # choice at first compile and must not re-key cached programs as the
    # camera moves (both modes are bit-equal, so a stale choice is a
    # performance nuance, never a correctness one).
    band_hint: "Optional[list]" = None

    @property
    def is_complete(self) -> bool:
        if self.job is None:
            return False
        if self.kind == "graphic" and self.pipeline_desc is None:
            return False
        return True


class NodeBuilder:
    """Shared read/write declaration API (builder.rs:147-299)."""

    def __init__(self, builder: "RenderGraphBuilder", node: GraphNode):
        self._builder = builder
        self._node = node
        # O(1) duplicate-access detection (the linear scans measured on the
        # per-frame host path at ~15 reads/frame on the deferred scene).
        self._seen_reads: set = set()
        self._seen_writes: set = set()

    def read(
        self,
        resource: RenderGraphResource,
        mip: "Optional[int]" = None,
        layer: "Optional[int]" = None,
        brange: "Optional[Tuple[int, int]]" = None,
    ) -> RenderGraphResourceAccess:
        """Declare a read; ``mip``/``layer``/``brange`` select a
        sub-resource (texture.rs:536-559, buffer.rs:276-322)."""
        access = RenderGraphResourceAccess(
            resource, ViewKind.SRV, self._node.index, mip, layer, brange
        )
        key = (resource.id, mip, layer, brange)
        if key in self._seen_reads:
            logger.warning(
                "node '%s': duplicate read of resource #%d", self._node.name, resource.id
            )
            return access
        self._seen_reads.add(key)
        self._node.inputs.append(
            ResourceAccessStorage(resource.id, ViewKind.SRV, mip, layer, brange)
        )
        return access

    def write(
        self,
        resource: RenderGraphResource,
        mip: "Optional[int]" = None,
        layer: "Optional[int]" = None,
        brange: "Optional[Tuple[int, int]]" = None,
    ) -> RenderGraphResourceAccess:
        """Declare a write; ``mip``/``layer`` select the render-to
        sub-resource (render-to-mip bloom chains, render-to-layer cube
        faces / shadow cascades)."""
        access = RenderGraphResourceAccess(
            resource, ViewKind.UAV, self._node.index, mip, layer, brange
        )
        key = (resource.id, mip, layer, brange)
        if key in self._seen_writes:
            logger.warning(
                "node '%s': duplicate write of resource #%d", self._node.name, resource.id
            )
            return access
        self._seen_writes.add(key)
        self._node.outputs.append(
            ResourceAccessStorage(resource.id, ViewKind.UAV, mip, layer, brange)
        )
        return access

    def execute(self, job: Callable[[Any], Any]) -> None:
        """Store the record closure. It runs at TRACE time: it must be pure
        jnp + context ops, and must not capture per-frame Python values —
        declare those with builder.set_dynamic / ctx.dynamic."""
        self._node.job = job


class AttachmentBinder:
    """Collects color/depth attachments then finalizes the pipeline desc
    (builder.rs:341-427). Usable as a context manager; ``finish`` is also
    called automatically by ``build()`` if omitted."""

    def __init__(
        self,
        builder: "RenderGraphBuilder",
        node: GraphNode,
        shader_input: GraphicShaderInput,
        state: GraphicPipelineState,
    ):
        self._builder = builder
        self._node = node
        self._shader_input = shader_input
        self._state = state
        self._finished = False

    def push_color(
        self, access: RenderGraphResourceAccess, desc: ColorAttachmentDesc
    ) -> "AttachmentBinder":
        self._node.color_attachments.append(
            (access.id, desc, access.mip or 0, access.layer)
        )
        return self

    def set_depth(
        self, access: RenderGraphResourceAccess, desc: DepthStencilDesc
    ) -> "AttachmentBinder":
        self._node.depth_attachment = (
            access.id, desc, access.mip or 0, access.layer
        )
        return self

    def set_stencil(
        self, access: RenderGraphResourceAccess
    ) -> "AttachmentBinder":
        """Bind the stencil plane (reference binds stencil_format beside
        depth_format, pipeline.rs:23-28,60-61). Stencil test/op state lives
        in the depth attachment's DepthStencilDesc (set_depth)."""
        self._node.stencil_attachment = access.id
        return self

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        color_formats = []
        for rid, *_ in self._node.color_attachments:
            tdesc = self._builder.resources[rid].texture_desc()
            assert tdesc is not None, "color attachment must be a texture"
            color_formats.append(tdesc.format)
        depth_format = None
        stencil_format = None
        state = self._state
        if self._node.stencil_attachment is not None:
            tdesc = self._builder.resources[self._node.stencil_attachment].texture_desc()
            assert tdesc is not None and tdesc.format.is_stencil, (
                "stencil attachment must be an S8-format texture"
            )
            stencil_format = tdesc.format
        if self._node.depth_attachment is not None:
            rid, ddesc, *_ = self._node.depth_attachment
            tdesc = self._builder.resources[rid].texture_desc()
            assert tdesc is not None and tdesc.format.is_depth, (
                "depth attachment must be a depth-format texture"
            )
            depth_format = tdesc.format
            # The attachment's DepthStencilDesc carries test/write state into
            # the pipeline (reference keeps them in one struct too).
            from dataclasses import replace

            state = replace(state, depth_stencil=ddesc)
        from zenith.rhi.pipeline import intern_desc

        self._node.pipeline_desc = intern_desc(GraphicPipelineDesc(
            shader_input=self._shader_input,
            state=state,
            attachments=GraphicPipelineAttachments(
                color_formats=tuple(color_formats),
                depth_format=depth_format,
                stencil_format=stencil_format,
            ),
            color_attachment_descs=tuple(
                d for _, d, *_ in self._node.color_attachments
            ),
            depth_attachment_desc=(
                self._node.depth_attachment[1] if self._node.depth_attachment else None
            ),
        ))

    def __enter__(self) -> "AttachmentBinder":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class GraphicNodeBuilder(NodeBuilder):
    def pipeline(
        self, shader_input: GraphicShaderInput, state: GraphicPipelineState
    ) -> AttachmentBinder:
        binder = AttachmentBinder(self._builder, self._node, shader_input, state)
        self._builder._pending_binders.append(binder)
        return binder

    def set_band_hint(self, spans) -> None:
        """Advise the SPMD auto-decomposition (CompileOptions
        parallel="auto"): ``spans`` = iterable of (triangle_count, y0, y1)
        with y0/y1 the draw's fractional screen-row extent in [0, 1]
        (project the object AABB; use (0, 1) when unknown) — or a
        zero-argument callable returning that iterable, evaluated only
        when compile actually runs in auto mode (renderers pay no hint
        cost otherwise). Performance metadata only — it never affects the
        rendered result (sort-first and sort-last are bit-equal); the
        RESOLVED choice enters the structure key (see CompileOptions)."""
        if callable(spans):
            self._node.band_hint = spans
            return
        self._node.band_hint = [
            (int(t), float(y0), float(y1)) for t, y0, y1 in spans
        ]


class LambdaNodeBuilder(NodeBuilder):
    pass


class RenderGraphBuilder:
    """(builder.rs:22-140)"""

    def __init__(self) -> None:
        self.resources: List[InitialResourceStorage] = []
        self.nodes: List[GraphNode] = []
        self.exports: List[int] = []
        self.dynamics: Dict[str, Any] = {}
        self._pending_binders: List[AttachmentBinder] = []

    # -- resources -----------------------------------------------------------

    def create(self, desc: "Union[BufferDesc, TextureDesc]") -> RenderGraphResource:
        """Declare a graph-managed transient resource (builder.rs:37-47)."""
        rid = len(self.resources)
        self.resources.append(InitialResourceStorage(desc=desc))
        kind = "texture" if isinstance(desc, TextureDesc) else "buffer"
        return RenderGraphResource(rid, kind)

    def import_resource(
        self, resource: "Union[Buffer, Texture]"
    ) -> RenderGraphResource:
        """Import a live resource; it becomes a frame-program input
        (builder.rs:50-60; initial-state tracking dissolves)."""
        rid = len(self.resources)
        self.resources.append(InitialResourceStorage(imported=resource))
        kind = "texture" if isinstance(resource, Texture) else "buffer"
        return RenderGraphResource(rid, kind)

    def export(self, resource: RenderGraphResource) -> RenderGraphResource:
        """Mark a resource's final contents as a frame-program output
        (the reference left this unimplemented!, interface.rs:105-107)."""
        if resource.id not in self.exports:
            self.exports.append(resource.id)
        return resource

    # -- per-frame dynamic values ---------------------------------------------

    def set_dynamic(self, name: str, value: Any) -> None:
        """Declare a per-frame value (time, camera matrices, light params).
        Closures read it back with ``ctx.dynamic(name)``; it becomes a traced
        argument of the compiled frame program, so changing it does NOT
        recompile. The analog of writing a uniform buffer each frame
        (reference triangle.rs:131-138)."""
        self.dynamics[name] = np.asarray(value, dtype=np.float32) if not hasattr(
            value, "dtype"
        ) else value

    # -- nodes ----------------------------------------------------------------

    def add_graphic_node(self, name: str) -> GraphicNodeBuilder:
        node = GraphNode(name=name, index=len(self.nodes), kind="graphic")
        self.nodes.append(node)
        return GraphicNodeBuilder(self, node)

    def add_lambda_node(self, name: str) -> LambdaNodeBuilder:
        node = GraphNode(name=name, index=len(self.nodes), kind="lambda")
        self.nodes.append(node)
        return LambdaNodeBuilder(self, node)

    def add_compute_node(self, name: str) -> LambdaNodeBuilder:
        """Compute node — first-class here, a permanently-invalid stub in the
        reference (node.rs:24-28, 38-40 'Compute pipelines are not
        implemented'). Here a compute dispatch IS a traced array program,
        so compute nodes share the lambda execution context; the separate
        name exists for API parity and intent."""
        node = GraphNode(name=name, index=len(self.nodes), kind="lambda")
        self.nodes.append(node)
        return LambdaNodeBuilder(self, node)

    # -- build ----------------------------------------------------------------

    def build(self) -> "RenderGraph":
        from zenith.rendergraph.graph import RenderGraph

        for binder in self._pending_binders:
            binder.finish()
        self._pending_binders.clear()
        return RenderGraph(self)
