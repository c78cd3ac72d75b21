"""Per-frame declarative pass DAG → one jitted XLA frame program.

Mirrors zenith-rendergraph (reference zenith-rendergraph/src/lib.rs:7-25):
builder with typed handles, graphic/lambda nodes, compile/execute/present/
retire — with barriers, fences, and resource states replaced by traced
dataflow (SURVEY.md §2.9).
"""

from zenith.rendergraph.builder import (
    AttachmentBinder,
    GraphicNodeBuilder,
    GraphNode,
    LambdaNodeBuilder,
    RenderGraphBuilder,
    ResourceAccessStorage,
)
from zenith.rendergraph.graph import (
    CompiledRenderGraph,
    CompileOptions,
    GraphicNodeExecutionContext,
    LambdaNodeExecutionContext,
    RenderGraph,
    RetiredRenderGraph,
    clear_frame_program_cache,
    set_frame_program_cache_limit,
    frame_program_cache_size,
)
from zenith.rendergraph.resource import (
    RenderGraphResource,
    RenderGraphResourceAccess,
    ViewKind,
)

__all__ = [name for name in dir() if not name.startswith("_")]
