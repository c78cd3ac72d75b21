"""Engine — owns device, swapchain, caches; drives the frame
(reference zenith/src/engine.rs).

Frame flow (engine.rs:88-112 → SURVEY.md §3.2):
  begin_frame → new builder → app.render (declares nodes) → build →
  compile (structure-cached → jitted frame program) → execute (one async
  dispatch) → present (async readback ring) → end_frame.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from zenith.app import RenderableApp, RenderContext
from zenith.core import log
from zenith.rendergraph import (
    CompileOptions,
    RenderGraphBuilder,
    RetiredRenderGraph,
    frame_program_cache_size,
)
from zenith.rhi.device import RenderDevice, RhiCore, select_physical_device
from zenith.rhi.pipeline import PipelineCache
from zenith.rhi.swapchain import Swapchain, SwapchainConfig
from zenith.window import Window

logger = log.get(__name__)

_compile_cache_ready = False

# The checkout's own cache directory: resolved from the package, so every
# entry point shares it whatever the working directory.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def ensure_persistent_compile_cache() -> "str | None":
    """XLA persistent compilation cache — the analog of the serializable
    vk::PipelineCache blob (pipeline_cache.rs:74-76), but actually persisted.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    directory is set here; otherwise the cache is ``<checkout>/.jax_cache``.
    Returns the directory in use."""
    global _compile_cache_ready
    if not _compile_cache_ready:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _compile_cache_ready = True
    return jax.config.jax_compilation_cache_dir


class Engine:
    """(engine.rs:10-23, 26-82)"""

    def __init__(
        self,
        window: Window,
        swapchain_config: Optional[SwapchainConfig] = None,
        compile_options: CompileOptions = CompileOptions(),
    ):
        ensure_persistent_compile_cache()
        self.window = window
        core = RhiCore()
        self.render_device: RenderDevice = core.create_render_device()
        config = swapchain_config or SwapchainConfig(
            width=window.width,
            height=window.height,
            readback_interval=int(os.environ.get("ZENITH_READBACK_INTERVAL", "1")),
        )
        self.swapchain = Swapchain(self.render_device, config, on_present=window.present)
        self.pipeline_cache = PipelineCache()
        self.compile_options = compile_options
        self.last_retired: Optional[RetiredRenderGraph] = None
        # Retained-mode state: (compiled graph, swapchain output handle),
        # kept only for apps that implement update_dynamics().
        self._retained: Optional[tuple] = None
        self._budget_capped = False
        self._elapsed = 0.0
        logger.info(
            "Engine up: %s, %dx%d %s",
            self.render_device.physical.name,
            config.width,
            config.height,
            config.format,
        )

    # -- stats (engine.rs:136-147) ---------------------------------------------

    @property
    def pipeline_cache_size(self) -> int:
        return len(self.pipeline_cache)

    @property
    def frame_program_count(self) -> int:
        return frame_program_cache_size()

    @property
    def elapsed(self) -> float:
        return self._elapsed

    def tick(self, delta_time: float) -> None:
        self._elapsed += delta_time

    def invalidate_retained(self) -> None:
        """Drop the retained compiled graph (hot-reload, external structure
        change) so the next frame takes the rebuild path."""
        self._retained = None

    # Budget growth stops here: overflow that doubling cannot absorb (more
    # peel layers than a draw resolves) would otherwise recompile forever.
    MAX_BUDGET_SCALE = 16

    def grow_entry_budget(self) -> int:
        """Double every draw's entry budget (called by the loop when a frame
        reports bin overflow — dropped triangles), up to MAX_BUDGET_SCALE.
        Changes the structure key, so the next frame compiles one larger
        program variant and the cycle converges, exactly like
        pipeline-cache misses."""
        from dataclasses import replace

        scale = self.compile_options.budget_scale
        if scale >= self.MAX_BUDGET_SCALE:
            if not self._budget_capped:
                self._budget_capped = True
                logger.warning(
                    "bin overflow persists at entry budgets ×%d; not "
                    "growing further (raise SceneObject.entry_budget)", scale
                )
            return scale
        new_scale = scale * 2
        self.compile_options = replace(
            self.compile_options, budget_scale=new_scale
        )
        self._retained = None  # must recompile at the new budget
        logger.warning(
            "bin overflow: growing entry budgets ×%d (recompiling)", new_scale
        )
        return new_scale

    # -- frame (engine.rs:88-112) ------------------------------------------------

    def render(self, app: RenderableApp) -> None:
        device = self.render_device
        device.begin_frame()

        # RETAINED MODE (beyond the reference's per-frame rebuild): an app that implements update_dynamics() re-executes the
        # previously compiled frame program with fresh per-frame values —
        # one pack + one transfer + one dispatch of host work. Constraints:
        # graph structure must be static, and attachments must not LOAD
        # frame N-1 swapchain contents (the import array is from build time).
        update_dynamics = getattr(app, "update_dynamics", None)
        if self._retained is not None and update_dynamics is not None:
            dyn = update_dynamics()
            if dyn is not None:
                compiled, handle, requested = self._retained
                self.swapchain.acquire_next_image()  # ring backpressure
                self.last_retired = compiled.execute(device, dynamics=dyn)
                self._deliver_outputs(app, compiled, requested)
                if handle is not None:
                    compiled.present(self.swapchain, handle)
                device.end_frame()
                return

        image_index, swap_texture = self.swapchain.acquire_next_image()
        builder = RenderGraphBuilder()
        context = RenderContext(builder, swap_texture, self.swapchain.extent)
        app.render(context)

        graph = builder.build()
        compiled = graph.compile(device, self.pipeline_cache, self.compile_options)
        self.last_retired = compiled.execute(device)
        self._deliver_outputs(app, compiled, context.requested_outputs)

        # Present: the app's declared present source (PresentEncode output)
        # wins; otherwise find the imported swapchain texture that some node
        # wrote (the reference splits nodes at the first swapchain write,
        # graph.rs:156-180; here we just fetch its final value).
        outputs = compiled._outputs or {}
        handle = None
        if context.present_source is not None:
            if str(context.present_source.id) in outputs:
                handle = context.present_source
            else:
                logger.warning(
                    "present_from(#%d): resource is not a frame output — "
                    "did you forget builder.export()? Falling back to the "
                    "swapchain texture.",
                    context.present_source.id,
                )
        if handle is None:
            for rid, st in enumerate(graph.resources):
                if st.imported is swap_texture:
                    if str(rid) in outputs:
                        from zenith.rendergraph.resource import (
                            RenderGraphResource,
                        )

                        handle = RenderGraphResource(rid, "texture")
                    break
        if handle is not None:
            compiled.present(self.swapchain, handle)
        if update_dynamics is not None:
            self._retained = (compiled, handle, dict(context.requested_outputs))
        device.end_frame()

    @staticmethod
    def _deliver_outputs(app, compiled, requested) -> None:
        """Hand requested exported values back to the app (cross-frame
        feedback: TAA history, auto-exposure state) — async device arrays,
        no host sync."""
        if not requested:
            return
        cb = getattr(app, "on_frame_outputs", None)
        if cb is None:
            logger.warning(
                "request_output(%s) but the app defines no on_frame_outputs "
                "hook — feedback values dropped", sorted(requested)
            )
            return
        values = {}
        for name, res in requested.items():
            try:
                values[name] = compiled.value(res)
            except KeyError:
                logger.warning(
                    "request_output('%s'): resource #%d is not a frame "
                    "output — did you forget builder.export()? Dropped.",
                    name, res.id,
                )
        if values:
            cb(values)

    def resize(self, width: int, height: int) -> None:
        """(engine.rs:114-133)"""
        self.window.width = width
        self.window.height = height
        self.swapchain.resize(width, height)
        self._retained = None  # structure changed; rebuild next frame

    def shutdown(self) -> None:
        self.swapchain.flush()
