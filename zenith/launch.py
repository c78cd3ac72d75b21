"""Engine entry point (reference zenith/src/lib.rs:31-44)."""

from __future__ import annotations

from typing import Optional, Type

from zenith.app import RenderableApp
from zenith.core import log, profile
from zenith.core.cli import EngineArgs
from zenith.main_loop import EngineLoop
from zenith.window import Window


def launch(
    app_class: "Type[RenderableApp]",
    argv: "Optional[list[str]]" = None,
    window: "Optional[Window]" = None,
    max_frames: "Optional[int]" = None,
    serve: "Optional[int]" = None,
    fps_cap: float = 60.0,
) -> EngineLoop:
    """Parse args → init logging/profiling/assets → construct app → run the
    loop (lib.rs:31-44). Returns the loop for inspection (tests/benches).

    ``serve=PORT`` runs the session interactively instead: an HTTP viewer
    (zenith.viewer) streams presented frames to a browser and feeds
    its keyboard/mouse back into the window's event queue, paced to
    ``fps_cap`` — every sandbox app exposes it as ``--serve [PORT]``."""
    args = EngineArgs.parse_args(argv)
    profile.initialize()
    log.initialize(args.log_level.to_logging_level())
    # Debug log level turns validation on (the reference's validation layers
    # are a debug-build default, zenith-rhi/Cargo.toml:23); an explicit
    # ZENITH_VALIDATE env setting still wins inside core.validate.enabled().
    import os

    from zenith.core import validate
    from zenith.core.cli import LogLevel

    if (
        args.log_level in (LogLevel.DEBUG, LogLevel.TRACE)
        and "ZENITH_VALIDATE" not in os.environ
    ):
        validate.force(True)

    from zenith import asset

    asset.initialize()

    app = app_class(args)
    loop = EngineLoop(app, window=window)
    if serve is None:
        loop.run(max_frames=max_frames)
        return loop
    from zenith.viewer import serve_loop

    serve_loop(loop, port=serve, fps_cap=fps_cap, max_frames=max_frames)
    return loop
