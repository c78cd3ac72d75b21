"""MeshApp — cerberus forward-lit demo (BASELINE.md config #2).

Loads the reference's cerberus glTF through the asset pipeline (bake cache +
registry), frames it with the zenith camera (Z-up, infinite-reverse-Z), and
renders a Blinn-Phong forward pass with depth.

Run:  python -m zenith.sandbox.mesh -- --frames 120 --out /tmp/mesh.png
"""

from __future__ import annotations

import argparse
import math
import os
from pathlib import Path
from typing import Optional

import numpy as np

from zenith.app import Args, RenderableApp, RenderContext
from zenith.asset import AssetManager, AssetUrl, Mesh, registry
from zenith.core import mathtypes as m
from zenith.core.camera import Camera
from zenith.core.mathtypes import Degree
from zenith.renderer.mesh import MeshRenderer
from zenith.rhi import TextureDesc


def default_content_root() -> str:
    """ZENITH_CONTENT, else the repo, else the mounted reference content."""
    env = os.environ.get("ZENITH_CONTENT")
    if env:
        return env
    for cand in (Path.cwd(), Path("/root/reference")):
        if (cand / "content").is_dir():
            return str(cand)
    return str(Path.cwd())


# glTF is y-up; zenith world is Z-up RH (camera.rs:1-20): rotate X +90°.
YUP_TO_ZUP = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32
)


def frame_camera(bounds_min: np.ndarray, bounds_max: np.ndarray,
                 aspect: float) -> "tuple[Camera, np.ndarray]":
    """Model matrix centering the mesh at the origin (z-up) + a camera on
    -Y looking at it, sized to the bounding radius."""
    center = 0.5 * (bounds_min + bounds_max)
    radius = 0.5 * float(np.linalg.norm(bounds_max - bounds_min))
    model = YUP_TO_ZUP @ m.mat4_translation(-center)
    cam = Camera(fov_y=Degree(30.0), aspect_ratio=aspect)
    dist = radius / math.tan(math.radians(15.0)) * 1.1
    cam.set_position(np.array([0.0, -dist, radius * 0.15], np.float32))
    return cam, model


class MeshApp(RenderableApp):
    def __init__(self, args: Args):
        super().__init__(args)
        self.mesh_renderer: Optional[MeshRenderer] = None
        self.camera: Optional[Camera] = None
        self.orbit = 0.0
        self.orbit_speed = float(os.environ.get("ZENITH_ORBIT_SPEED", "0.5"))
        self._radius = 1.0
        self._height = 0.0

    def prepare(self, render_device, window) -> None:
        mgr = AssetManager(
            root=default_content_root(),
            cache_dir=os.environ.get("ZENITH_CACHE", "cache"),
        )
        handle = mgr.request_load("mesh/cerberus/scene.gltf")
        collection = handle.get()
        mesh = registry().get(AssetUrl(collection.mesh_urls[0]), Mesh)
        bounds_min = mesh.vertices[:, :3].min(axis=0)
        bounds_max = mesh.vertices[:, :3].max(axis=0)
        aspect = window.width / max(window.height, 1)
        self.camera, model = frame_camera(bounds_min, bounds_max, aspect)
        self._radius = float(np.linalg.norm(self.camera.location))
        self._height = float(self.camera.location[2])
        self.mesh_renderer = MeshRenderer(
            render_device,
            mesh,
            base_color_factor=(0.55, 0.5, 0.48, 1.0),
            model_matrix=model,
        )

    def tick(self, delta_time: float) -> None:
        # Slow orbit so motion is visible across dumped frames.
        self.orbit += delta_time * self.orbit_speed
        x = math.sin(self.orbit) * self._radius
        y = -math.cos(self.orbit) * self._radius
        self.camera.set_position(np.array([x, y, self._height], np.float32))
        from zenith.core.mathtypes import Radians

        # Camera at (sin·r, −cos·r) looks at the origin: forward(yaw) =
        # (−sin yaw, cos yaw, 0) ⇒ yaw = orbit.
        self.camera.set_yaw_pitch(Radians(self.orbit), Radians(0.0))

    def render(self, context: RenderContext) -> None:
        width, height = context.extent
        if width == 0 or height == 0:
            return
        builder = context.builder()
        out = builder.import_resource(context.swapchain_texture())
        depth = builder.create(TextureDesc.depth("scene.depth", width, height))
        self.mesh_renderer.render_to(builder, out, depth, self.camera)


def main() -> None:
    from zenith.launch import launch
    from zenith.window import Window

    parser = argparse.ArgumentParser("zenith-sandbox mesh")
    parser.add_argument("--frames", type=int, default=120)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--readback-interval", type=int, default=1)
    parser.add_argument(
        "--serve", type=int, nargs="?", const=8089, default=None,
        metavar="PORT",
        help="interactive browser viewer on PORT (default 8089); "
        "runs until closed unless --frames is also given",
    )
    parser.add_argument("--fps-cap", type=float, default=60.0,
                        help="frame pacing for --serve")
    known, rest = parser.parse_known_args()
    os.environ.setdefault("ZENITH_READBACK_INTERVAL", str(known.readback_interval))

    window = Window(width=known.width, height=known.height, title="mesh")
    loop = launch(MeshApp, argv=rest, window=window,
                  max_frames=None if known.serve is not None else known.frames,
                  serve=known.serve, fps_cap=known.fps_cap)
    if known.out and window.last_frame is not None:
        window.write_png(known.out, window.last_frame)
        print(f"wrote {known.out}")
    print(f"rendered {loop.frames_rendered} frames")


if __name__ == "__main__":
    main()
