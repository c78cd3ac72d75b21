"""zenith — a real-time rendering framework in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of RustyFan/zenith
(a Rust + Vulkan renderer).

Layer map (mirrors the reference's crate layering, SURVEY.md §1):

    sandbox apps                 — user code
    zenith (facade)          — launch / App / Engine / EngineLoop
    zenith.renderer          — feature renderers (triangle, mesh, …)
    zenith.asset             — asset registry, glTF loader, bake cache
    zenith.rendergraph       — per-frame declarative pass DAG → one jitted fn
    zenith.rhi               — "hardware interface": device, resources,
                                   shaders-as-functions, pipeline state
    zenith.ops               — the rasterizer: Pallas/XLA compute kernels
    zenith.core              — foundation: log, cli, math, camera, input
    jax / XLA / Pallas           — platform

Where the reference speaks Vulkan (buffers, barriers, layouts, fences), this
framework speaks XLA: resources are `jax.Array`s, pass ordering is dataflow,
frame pacing is JAX async dispatch, and the GPU fixed-function rasterizer is
a software rasterizer whose inner loop is a Pallas kernel (Triton on the
GPU).
"""

import importlib
from typing import Any

__version__ = "0.1.0"

# Lazy facade: sub-layers import heavyweight deps (jax) only when touched,
# mirroring the reference's module_facade! re-exports (zenith/src/lib.rs:14-28).
_FACADE = {
    "App": "zenith.app",
    "Args": "zenith.app",
    "RenderableApp": "zenith.app",
    "RenderContext": "zenith.app",
    "Engine": "zenith.engine",
    "EngineLoop": "zenith.main_loop",
    "launch": "zenith.launch",
}
_SUBMODULES = (
    "core",
    "rhi",
    "ops",
    "rendergraph",
    "renderer",
    "asset",
    "parallel",
    "app",
    "engine",
    "launch",
    "main_loop",
    "window",
)

__all__ = sorted(set(_FACADE) | set(_SUBMODULES))


def __getattr__(name: str) -> Any:
    if name in _FACADE:
        module = importlib.import_module(_FACADE[name])
        return getattr(module, name)
    if name in _SUBMODULES:
        return importlib.import_module(f"zenith.{name}")
    raise AttributeError(f"module 'zenith' has no attribute {name!r}")
