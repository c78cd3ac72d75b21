"""SimpleApp — clear-screen demo (reference zenith-sandbox/src/main.rs).

The reference clears the swapchain image to blue via a lambda node using the
encoder's `custom` escape hatch (cmd_clear_color_image, main.rs:33-47); here
the lambda node writes a cleared array — the same node type, same color.

Run:  python -m zenith.sandbox.simple -- --frames 60 --out /tmp/clear.png
"""

from __future__ import annotations

import argparse

from zenith.app import Args, RenderableApp, RenderContext
from zenith.ops import clear_color


class SimpleApp(RenderableApp):
    def __init__(self, args: Args):
        super().__init__(args)

    def render(self, context: RenderContext) -> None:
        width, height = context.extent
        if width == 0 or height == 0:
            return  # zero-sized window skip (main.rs:17-19)

        output = context.swapchain_texture()
        builder = context.builder()
        out = builder.import_resource(output)

        node = builder.add_lambda_node("clear")
        output_access = node.write(out)

        def record(ctx):
            ctx.set(output_access, clear_color(height, width, (0.2, 0.3, 0.8, 1.0)))

        node.execute(record)


def main() -> None:
    import sys

    from zenith.launch import launch
    from zenith.window import Window

    parser = argparse.ArgumentParser("zenith-sandbox simple")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--readback-interval", type=int, default=1,
                        help="deliver every Nth frame to the host sink")
    parser.add_argument(
        "--serve", type=int, nargs="?", const=8089, default=None,
        metavar="PORT",
        help="interactive browser viewer on PORT (default 8089); "
        "runs until closed unless --frames is also given",
    )
    parser.add_argument("--fps-cap", type=float, default=60.0,
                        help="frame pacing for --serve")
    known, rest = parser.parse_known_args()
    import os
    os.environ.setdefault("ZENITH_READBACK_INTERVAL", str(known.readback_interval))

    window = Window(width=known.width, height=known.height, title="simple")
    loop = launch(SimpleApp, argv=rest, window=window,
                  max_frames=None if known.serve is not None else known.frames,
                  serve=known.serve, fps_cap=known.fps_cap)
    if known.out and window.last_frame is not None:
        window.write_png(known.out, window.last_frame)
        print(f"wrote {known.out}")
    print(f"rendered {loop.frames_rendered} frames, presented {window.presented_frames}")


if __name__ == "__main__":
    main()
