"""TerrainApp — procedural heightmap terrain flyover (stress demo).

A single contiguous multi-million-triangle mesh (default 768x768 grid =
1.18M triangles; ``--grid 1200`` = 2.88M) driven through the FULL engine
path: shadow pass + deferred G-buffer + tiled lights + atmosphere sky +
bloom/tonemap. This is the complement to the instanced 1M-triangle scene
(sandbox.scene --gun-instances): one huge draw instead of many instances — the
binner sees one dense record stream with heavy per-tile occupancy.

Everything procedural and host-cheap at startup: fbm value-noise
heightmap, gradient normals, a height/slope-colored albedo texture
(grass/rock/snow) sampled through the standard atlas path.

Run:  python -m zenith.sandbox.terrain -- --frames 120 \
          --out /tmp/terrain.png -- --grid 768
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional

import numpy as np

from zenith.app import Args, RenderableApp, RenderContext
from zenith.core.camera import Camera
from zenith.core.mathtypes import Degree, Radians
from zenith.rhi import Format, TextureDesc


def fbm_heightmap(n: int, octaves: int = 6, seed: int = 7) -> np.ndarray:
    """(n, n) fractal value noise in [0, 1] (host NumPy; ~100 ms at 1k²)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, n), np.float64)
    amp, freq, total = 1.0, 4, 0.0
    for _ in range(octaves):
        g = rng.random((freq + 1, freq + 1))
        # Smoothstep-interpolated bilinear upsample of the lattice.
        t = np.linspace(0.0, freq, n, endpoint=False)
        i = np.minimum(t.astype(np.int64), freq - 1)
        f = t - i
        f = f * f * (3.0 - 2.0 * f)
        gx0 = g[i, :][:, i]
        gx1 = g[i + 1, :][:, i]
        gy0 = gx0 * (1 - f[:, None]) + gx1 * f[:, None]
        gx0b = g[i, :][:, i + 1]
        gx1b = g[i + 1, :][:, i + 1]
        gy1 = gx0b * (1 - f[:, None]) + gx1b * f[:, None]
        out += amp * (gy0 * (1 - f[None, :]) + gy1 * f[None, :])
        total += amp
        amp *= 0.5
        freq *= 2
    out /= total
    # Gentle shaping: valleys flatten, peaks sharpen.
    return (out ** 1.6).astype(np.float32)


def terrain_mesh(height: np.ndarray, extent: float, zscale: float):
    """Grid mesh over the heightmap: (V, 8) float32 vertices
    (pos3/normal3/uv2) and (T, 3) int32 indices."""
    n = height.shape[0]
    xs = np.linspace(-extent, extent, n, dtype=np.float32)
    px, py = np.meshgrid(xs, xs, indexing="xy")
    z = height * zscale
    # Gradient normals (central differences, world-scaled).
    cell = 2.0 * extent / (n - 1)
    dzdx = np.gradient(z, cell, axis=1)
    dzdy = np.gradient(z, cell, axis=0)
    nrm = np.stack([-dzdx, -dzdy, np.ones_like(z)], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uv = np.stack(
        np.meshgrid(np.linspace(0, 1, n, dtype=np.float32),
                    np.linspace(0, 1, n, dtype=np.float32), indexing="xy"),
        axis=-1,
    )
    verts = np.concatenate(
        [np.stack([px, py, z], -1), nrm.astype(np.float32), uv], axis=-1
    ).reshape(-1, 8).astype(np.float32)

    idx = np.arange(n * n, dtype=np.int32).reshape(n, n)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    tris = np.concatenate(
        [np.stack([a, b, c], -1), np.stack([b, d, c], -1)], axis=0
    ).astype(np.int32)
    return verts, tris


def terrain_albedo(height: np.ndarray, zscale: float,
                   size: int = 1024) -> np.ndarray:
    """(size, size, 4) uint8 albedo: grass on low flats, rock on slopes,
    snow above the snowline — the classic height/slope terrain shader,
    baked to a texture on the host."""
    n = height.shape[0]
    # Resample the heightmap to the texture grid (nearest is fine).
    ii = np.minimum((np.arange(size) * n) // size, n - 1)
    h = height[ii, :][:, ii]
    gy, gx = np.gradient(h * zscale)
    slope = np.sqrt(gx * gx + gy * gy)
    grass = np.array([0.20, 0.34, 0.12])
    rock = np.array([0.38, 0.33, 0.30])
    snow = np.array([0.92, 0.93, 0.95])
    steep = np.clip(slope * 6.0, 0.0, 1.0)[..., None]
    high = np.clip((h - 0.55) * 8.0, 0.0, 1.0)[..., None]
    col = grass * (1 - steep) + rock * steep
    col = col * (1 - high) + snow * high * (1 - steep * 0.6)
    # Cheap variation so mip levels resolve visibly.
    rng = np.random.default_rng(3)
    col *= (0.92 + 0.16 * rng.random((size, size, 1)))
    rgba = np.concatenate(
        [np.clip(col, 0, 1), np.ones((size, size, 1))], axis=-1
    )
    return (rgba * 255).astype(np.uint8)


class TerrainApp(RenderableApp):
    def __init__(self, args: Args):
        super().__init__(args)
        parser = argparse.ArgumentParser("terrain")
        parser.add_argument("--grid", type=int, default=768,
                            help="heightmap resolution N (2(N-1)^2 tris)")
        parser.add_argument("--extent", type=float, default=400.0)
        parser.add_argument("--zscale", type=float, default=70.0)
        parser.add_argument("--no-sky", action="store_true",
                            help="flat background instead of the "
                                 "procedural atmosphere")
        parser.add_argument("--contact-shadows", action="store_true")
        parser.add_argument("--seed", type=int, default=7)
        ns, _ = parser.parse_known_args(args.app_args)
        self.ns = ns
        self.renderer = None
        self.post = None
        self.camera: Optional[Camera] = None
        self.orbit = float(os.environ.get("ZENITH_ORBIT_START", "0.0"))
        self.orbit_speed = float(os.environ.get("ZENITH_ORBIT_SPEED", "0.1"))
        self.tri_count = 0
        # Interactive take-over (same contract as sandbox.scene/fly): the
        # first input event switches the scripted flyover to fly controls.
        from zenith.core.camera import CameraController
        from zenith.core.events import KeyCode
        from zenith.core.input import InputActionMapper

        self.controller = CameraController(mouse_sensitivity=0.4)
        self.controller.move_speed = 80.0
        self.mapper = InputActionMapper()
        self.mapper.register_axis(
            "forward", [KeyCode.KEY_W], [KeyCode.KEY_S], 0.5)
        self.mapper.register_axis(
            "right", [KeyCode.KEY_D], [KeyCode.KEY_A], 0.5)
        self.mapper.register_axis("up", [KeyCode.KEY_E], [KeyCode.KEY_Q], 0.5)
        self.mapper.register_action("quit", [KeyCode.ESCAPE])
        self._interactive = False
        self._window = None

    def prepare(self, render_device, window) -> None:
        from zenith.renderer import (
            Atmosphere,
            DeferredRenderer,
            DirectionalLight,
            PostProcess,
            Scene,
            SceneObject,
        )
        from zenith.rhi import BufferUsage
        from zenith.rhi.resource import Texture

        ns = self.ns
        height = fbm_heightmap(ns.grid, seed=ns.seed)
        verts, tris = terrain_mesh(height, ns.extent, ns.zscale)
        self.tri_count = len(tris)
        albedo = terrain_albedo(height, ns.zscale)
        terrain = SceneObject(
            name="terrain",
            vertex_buffer=render_device.upload_buffer(
                "terrain.vb", verts, BufferUsage.VERTEX
            ),
            index_buffer=render_device.upload_buffer(
                "terrain.ib", tris, BufferUsage.INDEX
            ),
            model_matrix=np.eye(4, dtype=np.float32),
            roughness=0.9,
            base_color_texture=Texture.from_numpy(
                "terrain.albedo", albedo, Format.RGBA8_SRGB,
                generate_mips=True,
            ),
            # A big mesh close to the camera bins wide: give the segmented
            # binner a deep entry budget up front: 2× triangles (overflow
            # is counted).
            bin_capacity=4096,
            entry_budget=max(2 * self.tri_count, 1 << 20),
        )
        sun = DirectionalLight(
            direction=(0.45, -0.35, 0.55), intensity=3.0,
            shadow_extent=ns.extent * 1.2, shadow_far=1200.0,
            shadow_map_size=2048,
            contact_shadows=ns.contact_shadows,
        )
        scene = Scene(
            objects=[terrain], sun=sun,
            atmosphere=None if ns.no_sky else Atmosphere(),
            skybox=None,
        )
        self.renderer = DeferredRenderer(scene)
        self.post = PostProcess()
        self.camera = Camera(
            fov_y=Degree(45.0),
            aspect_ratio=window.width / max(window.height, 1),
        )
        self._window = window
        self._place_camera()

    def _place_camera(self) -> None:
        r = self.ns.extent * 0.55
        x = math.sin(self.orbit) * r
        y = -math.cos(self.orbit) * r
        self.camera.set_position(
            np.array([x, y, self.ns.zscale * 1.6], np.float32)
        )
        self.camera.set_yaw_pitch(
            Radians(self.orbit), Radians(-0.28)
        )

    def on_window_event(self, event) -> None:
        from zenith.core.events import KeyboardInput, MouseInput

        if isinstance(event, (KeyboardInput, MouseInput)):
            self._interactive = True
        self.mapper.on_window_event(event)
        self.controller.on_window_event(event)

    def on_device_event(self, event) -> None:
        self.controller.on_device_event(event)

    def tick(self, dt: float) -> None:
        if self._interactive:
            self.mapper.tick(dt)
            if (self.mapper.is_action_just_pressed("quit")
                    and self._window is not None):
                self._window.request_close()
            self.controller.update_cameras(
                dt,
                self.mapper.get_axis("forward"),
                self.mapper.get_axis("right"),
                self.mapper.get_axis("up"),
                [self.camera],
            )
        else:
            self.orbit += self.orbit_speed * dt
            self._place_camera()

    def render(self, context: RenderContext) -> None:
        width, height = context.extent
        if width == 0 or height == 0:
            return
        builder = context.builder()
        out = builder.import_resource(context.swapchain_texture())
        hdr = builder.create(
            TextureDesc.color("terrain.hdr", width, height, Format.RGBA32F)
        )
        self.renderer.render_to(builder, hdr, self.camera, width, height)
        self.post.render_to(builder, hdr, out)


def main() -> None:
    from zenith.launch import launch
    from zenith.window import Window

    parser = argparse.ArgumentParser("zenith-sandbox terrain")
    parser.add_argument("--frames", type=int, default=60)
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
    os.environ.setdefault(
        "ZENITH_READBACK_INTERVAL", str(known.readback_interval)
    )
    window = Window(width=known.width, height=known.height, title="terrain")
    loop = launch(TerrainApp, argv=rest, window=window,
                  max_frames=None if known.serve is not None else known.frames,
                  serve=known.serve, fps_cap=known.fps_cap)
    if known.out and window.last_frame is not None:
        window.write_png(known.out, window.last_frame)
        print(f"wrote {known.out}")
    print(f"rendered {loop.frames_rendered} frames "
          f"({loop.app.tri_count} triangles)")


if __name__ == "__main__":
    main()
