"""SceneApp — the full sandbox scene (BASELINE.md configs #3/#4/#5).

cerberus + ground plane, sun with PCF shadows, ~100 point lights, rendered
either forward (shadow + Blinn-Phong lit pass, config #3) or deferred
(G-buffer + GGX PBR lighting, config #4) with a tonemap/bloom post chain
(config #5) — all passes in ONE jitted frame program.

Run:  python -m zenith.sandbox.scene -- --mode deferred --lights 100 \\
          --frames 60 --out /tmp/scene.png
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional

import numpy as np

from zenith.app import Args, RenderableApp, RenderContext
from zenith.asset import AssetManager, AssetUrl, Mesh, registry
from zenith.core.camera import Camera
from zenith.core.events import (
    DeviceEvent,
    KeyboardInput,
    KeyCode,
    MouseInput,
    WindowEvent,
)
from zenith.core.mathtypes import Degree, Radians
from zenith.renderer import (
    DeferredRenderer,
    DirectionalLight,
    ForwardShadowRenderer,
    PointLight,
    PostProcess,
    Scene,
    SceneObject,
)
from zenith.rhi import Format, Texture, TextureDesc
from zenith.sandbox.mesh import YUP_TO_ZUP, default_content_root
from zenith.core import mathtypes as m


def checker_texture(size: int = 512, cells: int = 16,
                    a=(200, 202, 208), b=(90, 94, 104)) -> Texture:
    """Procedural sRGB checker with a full mip chain (the cerberus PNGs are
    stripped from the reference checkout, .MISSING_LARGE_BLOBS)."""
    yy, xx = np.mgrid[0:size, 0:size]
    cell = ((yy // (size // cells) + xx // (size // cells)) % 2).astype(np.uint8)
    px = np.empty((size, size, 4), np.uint8)
    for c in range(3):
        px[..., c] = np.where(cell == 0, a[c], b[c])
    px[..., 3] = 255
    return Texture.from_numpy("checker", px, Format.RGBA8_SRGB, generate_mips=True)


def bump_normal_texture(size: int = 256, bumps: int = 10) -> Texture:
    """Tangent-space normal map: a grid of spherical bumps (linear
    RGBA8_UNORM — normal maps are never sRGB). Exercises the deferred
    renderer's derivative-reconstructed tangent frame."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    fx = (xs / size * bumps) % 1.0 - 0.5
    fy = (ys / size * bumps) % 1.0 - 0.5
    r2 = fx * fx + fy * fy
    br = 0.4
    inside = r2 < br * br
    nz = np.sqrt(np.clip(br * br - r2, 0.0, None))
    n = np.stack(
        [np.where(inside, -fx, 0.0), np.where(inside, -fy, 0.0),
         np.where(inside, nz, 1.0)],
        axis=-1,
    )
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    px = np.concatenate(
        [((n * 0.5 + 0.5) * 255).astype(np.uint8),
         np.full((size, size, 1), 255, np.uint8)],
        axis=-1,
    )
    return Texture.from_numpy("bumps", px, Format.RGBA8_UNORM)


def mra_stripe_texture(size: int = 256, stripes: int = 8) -> Texture:
    """glTF metallic-roughness map (B=metallic, G=roughness): alternating
    rough-dielectric / polished-metal stripes."""
    ys = np.mgrid[0:size, 0:size][0]
    band = ((ys * stripes) // size) % 2 == 0
    px = np.zeros((size, size, 4), np.uint8)
    px[..., 0] = 255  # occlusion (unused) = 1
    px[..., 1] = np.where(band, 230, 60)  # roughness
    px[..., 2] = np.where(band, 0, 255)  # metallic
    px[..., 3] = 255
    return Texture.from_numpy("mra.stripes", px, Format.RGBA8_UNORM)


def brushed_texture(size: int = 256, rng=None) -> Texture:
    """Procedural brushed-metal stripes (subtle horizontal noise bands)."""
    rng = rng or np.random.default_rng(7)
    rows = rng.uniform(0.75, 1.0, size=(size, 1)).astype(np.float32)
    field = np.repeat(rows, size, axis=1)
    field += rng.uniform(-0.03, 0.03, size=(size, size)).astype(np.float32)
    val = np.clip(field * 255, 0, 255).astype(np.uint8)
    px = np.stack([val, val, val, np.full_like(val, 255)], axis=-1)
    return Texture.from_numpy("brushed", px, Format.RGBA8_SRGB, generate_mips=True)


def skinned_tube(bones: int = 5, rings: int = 24, sides: int = 16,
                 radius: float = 4.0, height: float = 42.0):
    """Procedural skinned cylinder ("tentacle"): a bone chain along +Z,
    each vertex weighted between its two nearest joints, plus a waving
    AnimationClip (per-joint X-axis rotation keyframes with a phase
    offset). Exercises the full skinning pipeline with zero content
    dependencies."""
    from zenith.asset import AssetUrl
    from zenith.asset.render_types import (
        AnimationChannel,
        AnimationClip,
        Mesh as MeshAsset,
        Skin,
    )

    # Geometry: rings+1 circles of `sides` vertices.
    verts = []
    jw = []
    seg = height / (bones - 1)
    for r in range(rings + 1):
        z = height * r / rings
        v = r / rings
        for s in range(sides):
            a = 2 * math.pi * s / sides
            nx, ny = math.cos(a), math.sin(a)
            verts.append([radius * nx, radius * ny, z, nx, ny, 0.0,
                          s / sides, v])
            f = min(z / seg, bones - 1 - 1e-4)
            j0 = int(f)
            w1 = f - j0
            jw.append([j0, min(j0 + 1, bones - 1), 0, 0,
                       1.0 - w1, w1, 0.0, 0.0])
    tris = []
    for r in range(rings):
        for s in range(sides):
            a0 = r * sides + s
            a1 = r * sides + (s + 1) % sides
            b0 = a0 + sides
            b1 = a1 + sides
            tris += [[a0, a1, b0], [a1, b1, b0]]

    # Bone chain: joint k at world z = k·seg; locals are pure +Z offsets.
    rest_t = np.zeros((bones, 3), np.float32)
    rest_t[1:, 2] = seg
    rest_r = np.tile(np.asarray([0, 0, 0, 1], np.float32), (bones, 1))
    rest_s = np.ones((bones, 3), np.float32)
    inv_bind = np.stack([np.eye(4, dtype=np.float32) for _ in range(bones)])
    for k in range(bones):
        inv_bind[k, 2, 3] = -k * seg
    skin = Skin(inv_bind, np.arange(-1, bones - 1, dtype=np.int32),
                rest_t, rest_r, rest_s)

    # Wave clip: X-axis rotation keyframes, phase-shifted down the chain.
    duration = 2.0
    keys = np.linspace(0.0, duration, 17).astype(np.float32)
    channels = []
    for k in range(1, bones):
        amp = 0.35
        ang = amp * np.sin(2 * np.pi * keys / duration + 0.8 * k)
        quats = np.stack([
            np.sin(ang / 2), np.zeros_like(ang), np.zeros_like(ang),
            np.cos(ang / 2),
        ], axis=1).astype(np.float32)
        channels.append(AnimationChannel(k, "rotation", keys, quats))
    clip = AnimationClip("wave", channels, duration)

    return MeshAsset(
        AssetUrl("procedural/tentacle"),
        np.asarray(verts, np.float32),
        np.asarray(tris, np.int32),
        skin_vertex_data=np.asarray(jw, np.float32),
        skin=skin,
        clips=[clip],
    )



def morphing_blob(rings: int = 24, sides: int = 32, radius: float = 9.0):
    """Procedural morph-target demo: a UV sphere with two POSITION-delta
    targets (a polar spike and an equatorial bulge) and a looping
    "pulse" weights clip — exercises the morph pipeline with zero content
    dependencies."""
    from zenith.asset import AssetUrl
    from zenith.asset.render_types import (
        AnimationChannel,
        AnimationClip,
        Mesh as MeshAsset,
    )

    verts = []
    for r in range(rings + 1):
        theta = math.pi * r / rings  # 0 at +Z pole
        for s in range(sides):
            phi = 2 * math.pi * s / sides
            nx = math.sin(theta) * math.cos(phi)
            ny = math.sin(theta) * math.sin(phi)
            nz = math.cos(theta)
            verts.append([radius * nx, radius * ny, radius * nz,
                          nx, ny, nz, s / sides, r / rings])
    v = np.asarray(verts, np.float32)
    tris = []
    for r in range(rings):
        for s in range(sides):
            a0 = r * sides + s
            a1 = r * sides + (s + 1) % sides
            b0 = a0 + sides
            b1 = a1 + sides
            if r > 0:
                tris.append([a0, a1, b0])
            if r < rings - 1:
                tris.append([a1, b1, b0])
    n_verts = v.shape[0]
    nrm = v[:, 3:6]
    z = v[:, 2] / radius
    # Target 0: polar spike (outward push, concentrated at the +Z pole).
    spike = nrm * (radius * 0.9 * np.clip(z, 0.0, 1.0) ** 4)[:, None]
    # Target 1: equatorial bulge (radial push where |z| is small).
    radial = np.concatenate([v[:, :2], np.zeros((n_verts, 1), np.float32)], 1)
    rn = np.linalg.norm(radial, axis=1, keepdims=True)
    radial = radial / np.where(rn > 1e-6, rn, 1.0)
    bulge = radial * (radius * 0.45 * np.exp(-(z * 2.2) ** 2))[:, None]
    deltas = np.stack([spike, bulge]).astype(np.float32)

    times = np.array([0.0, 0.75, 1.5, 2.25, 3.0], np.float32)
    weights = np.array(
        [[0, 0], [1, 0], [0, 0], [0, 1], [0, 0]], np.float32
    )
    clip = AnimationClip("pulse", [
        AnimationChannel(-1, "weights", times, weights)
    ], 3.0)
    return MeshAsset(
        AssetUrl("procedural/blob"),
        v, np.asarray(tris, np.int32),
        morph_deltas=deltas, clips=[clip],
    )


def sky_cube_pixels(size: int = 64) -> np.ndarray:
    """Procedural gradient sky (6, S, S, 4) linear radiance: zenith→horizon
    gradient with a warm sun glow."""
    u = (np.arange(size, dtype=np.float32) + 0.5) / size * 2 - 1
    uu, vv = np.meshgrid(u, u)
    ones = np.ones_like(uu)
    # Direction per texel per face (+X -X +Y -Y +Z -Z, Vulkan 16.5.4).
    face_dirs = [
        np.stack([ones, -vv, -uu], -1),
        np.stack([-ones, -vv, uu], -1),
        np.stack([uu, ones, vv], -1),
        np.stack([uu, -ones, -vv], -1),
        np.stack([uu, -vv, ones], -1),
        np.stack([-uu, -vv, -ones], -1),
    ]
    sun_dir = np.array([0.35, -0.3, 0.88], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    zenith = np.array([0.18, 0.32, 0.62], np.float32)
    horizon = np.array([0.55, 0.62, 0.75], np.float32)
    below = np.array([0.12, 0.11, 0.10], np.float32)
    faces = []
    for d in face_dirs:
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        up = np.clip(d[..., 2:3], 0.0, 1.0)
        sky = horizon + (zenith - horizon) * np.sqrt(up)
        col = np.where(d[..., 2:3] >= 0.0, sky, below)
        glow = np.clip(np.sum(d * sun_dir, axis=-1, keepdims=True), 0, 1) ** 64
        col = col + glow * np.array([3.0, 2.6, 2.0], np.float32)
        faces.append(
            np.concatenate([col, np.ones_like(up)], -1).astype(np.float32)
        )
    return np.stack(faces)


def sky_cube_texture(size: int = 64):
    """The procedural sky as a cube-map Texture — exercises the cube-map
    sampling path end-to-end (reference texture.rs:94-105)."""
    from zenith.rhi import Format, Texture

    return Texture.from_numpy_layers(
        "sky", sky_cube_pixels(size), Format.RGBA32F, cube=True
    )


def build_scene(render_device, num_lights: int, rng: np.random.Generator,
                textured: bool = False, skybox: bool = True,
                instances: int = 0, gun_instances: int = 0,
                glass: bool = False, glass_textured: bool = False,
                ibl: bool = False,
                skinned: bool = False, morph: bool = False) -> Scene:
    mgr = AssetManager(
        root=default_content_root(),
        cache_dir=os.environ.get("ZENITH_CACHE", "cache"),
    )
    collection = mgr.request_load("mesh/cerberus/scene.gltf").get()
    mesh = registry().get(AssetUrl(collection.mesh_urls[0]), Mesh)
    bmin = mesh.vertices[:, :3].min(axis=0)
    bmax = mesh.vertices[:, :3].max(axis=0)
    center = 0.5 * (bmin + bmax)
    model = YUP_TO_ZUP @ m.mat4_translation(-center)

    # Ground sits just under the mesh's lowest point after the transform.
    corners = np.stack(np.meshgrid(*zip(bmin, bmax), indexing="ij"), -1).reshape(-1, 3)
    z_min = min(
        float(m.transform_point(model, c)[2]) for c in corners
    )

    # gun_instances > 0: the geometry-scaling configuration (VERDICT r2
    # #10 — prove ~1M-triangle frames end-to-end). The cerberus draws as
    # ONE instanced draw of N copies on a ring (33.5k tris each; 30 copies
    # ≈ 1M submitted triangles through shadow + G-buffer + lighting).
    gun_offsets = None
    gun_budget = 16 * mesh.num_triangles
    if gun_instances > 0:
        ring = float(np.linalg.norm(bmax - bmin)) * 1.1
        offs = [[0.0, 0.0, 0.0]]
        for i in range(1, gun_instances):
            a = 2 * math.pi * i / gun_instances
            r = ring * (1.0 + 0.15 * ((i * 7) % 3))
            offs.append([r * math.cos(a), r * math.sin(a),
                         2.0 * ((i * 5) % 4)])
        gun_offsets = np.asarray(offs, np.float32)
        gun_budget = None  # default 2x records scales with instance count
    gun = SceneObject.from_mesh(
        render_device, mesh, "cerberus", model_matrix=model,
        base_color=(0.62, 0.57, 0.55, 1.0), metallic=0.85, roughness=0.45,
        entry_budget=gun_budget,
        base_color_texture=brushed_texture(rng=rng) if textured else None,
        instance_offsets=gun_offsets,
    )
    ground = SceneObject.quad(
        render_device, "ground", size=400.0, z=z_min - 2.0,
        base_color=(0.9, 0.9, 0.95, 1.0) if textured else (0.28, 0.3, 0.33, 1.0),
        metallic=0.0 if not textured else 0.6,  # modulated by the MRA map
        roughness=0.9,
        base_color_texture=checker_texture() if textured else None,
        # Full material set in textured mode: bump normal map + MRA
        # stripes on the ground (visible response under the point lights).
        normal_texture=bump_normal_texture() if textured else None,
        mra_texture=mra_stripe_texture() if textured else None,
    )

    lights = []
    radius_xy = float(np.linalg.norm(bmax - bmin)) * 0.7
    for i in range(num_lights):
        ang = 2 * math.pi * i / max(num_lights, 1)
        r = radius_xy * (0.4 + 0.6 * rng.uniform())
        hue = rng.uniform(0, 1)
        col = np.array(
            [abs(math.sin(hue * math.pi * 2)), abs(math.sin((hue + 1 / 3) * math.pi * 2)),
             abs(math.sin((hue + 2 / 3) * math.pi * 2))],
            np.float32,
        )
        lights.append(
            PointLight(
                position=(r * math.cos(ang), r * math.sin(ang),
                          z_min + 4.0 + 20.0 * rng.uniform()),
                color=tuple(col),
                intensity=400.0 + 600.0 * rng.uniform(),
                radius=60.0,
            )
        )

    objects = [gun, ground]
    if glass:
        # Two standing translucent panes in front of the gun — drawn by the
        # deferred renderer's glass node (in-order blend kernel, or the
        # depth-peeled fragment-rate path when textured).
        glass_tex = None
        if glass_textured:
            from zenith.rhi import Format
            from zenith.rhi.resource import Texture as _Tex

            yy, xx = np.mgrid[0:64, 0:64]
            c = ((xx // 4 + yy // 4) % 2).astype(np.float32)
            px = np.stack(
                [0.4 + 0.6 * c, 1.0 - 0.5 * c, np.full_like(c, 0.8),
                 np.ones_like(c)], axis=-1,
            ).astype(np.float32)
            glass_tex = _Tex.from_numpy("pane.checker", px, Format.RGBA32F)
        span = float(np.linalg.norm(bmax - bmin))
        for gi, (dx, tint) in enumerate([
            (-0.4 * span, (0.4, 0.7, 1.0, 0.35)),
            (0.4 * span, (1.0, 0.5, 0.4, 0.45)),
        ]):
            pane = SceneObject.quad(
                render_device, f"pane{gi}", size=span * 0.6,
                z=0.0, base_color=tint, translucent=True,
                base_color_texture=glass_tex,
            )
            # Stand the quad up (rotate about X) and place it.
            rot = np.array(
                [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                np.float32,
            )
            trans = m.mat4_translation(
                np.array([dx, -0.4 * span, z_min + 0.4 * span], np.float32)
            )
            pane.model_matrix = (trans @ rot).astype(np.float32)
            objects.append(pane)
    if instances > 0:
        # Instanced rock field: ONE draw, N instances (SceneObject
        # .instance_offsets → the deferred renderer's *.inst nodes).
        ring = float(np.linalg.norm(bmax - bmin)) * 0.9
        offs = []
        for i in range(instances):
            a = 2 * math.pi * i / instances + 0.35
            r = ring * (0.8 + 0.5 * rng.uniform())
            offs.append([r * math.cos(a), r * math.sin(a), z_min - 2.0])
        objects.append(
            SceneObject.cube(
                render_device, "rocks", size=9.0, z0=0.0,
                base_color=(0.35, 0.33, 0.3, 1.0), roughness=0.85,
                instance_offsets=np.asarray(offs, np.float32),
            )
        )

    if skinned:
        # A waving skinned tentacle beside the gun (full skeletal pipeline:
        # SkinnedVertex buffers, joint-palette dynamics, skinned shadow +
        # G-buffer nodes; renderer/animation.AnimationPlayer drives it).
        span = float(np.linalg.norm(bmax - bmin))
        tube = skinned_tube()
        objects.append(SceneObject.from_mesh(
            render_device, tube, "tentacle",
            model_matrix=m.mat4_translation(
                np.array([-0.75 * span, 0.25 * span, z_min], np.float32)
            ),
            base_color=(0.45, 0.75, 0.5, 1.0), metallic=0.1, roughness=0.5,
        ))

    if morph:
        # A pulsing morph-target blob on the other side (POSITION-delta
        # targets + a looping weights clip; weights ride dynamics).
        span = float(np.linalg.norm(bmax - bmin))
        blob = morphing_blob()
        objects.append(SceneObject.from_mesh(
            render_device, blob, "blob",
            model_matrix=m.mat4_translation(
                np.array([0.8 * span, 0.3 * span, z_min + 10.0], np.float32)
            ),
            base_color=(0.8, 0.55, 0.3, 1.0), metallic=0.2, roughness=0.35,
        ))

    environment = None
    if ibl:
        # Split-sum IBL from the same procedural sky: SH diffuse +
        # GGX-prefiltered specular replace the flat ambient, and the env
        # cube doubles as the background (no separate skybox texture).
        from zenith.renderer import EnvironmentLight

        environment = EnvironmentLight.from_cube_pixels(
            "sky.env", sky_cube_pixels(), num_mips=5, samples=64
        )
    return Scene(
        objects=objects,
        sun=DirectionalLight(
            direction=(0.35, -0.3, 0.88),
            intensity=2.5,
            shadow_map_size=1024,
            shadow_extent=90.0,
        ),
        point_lights=lights,
        ambient=(0.02, 0.02, 0.03),
        skybox=sky_cube_texture() if (skybox and not ibl) else None,
        environment=environment,
    )


class SceneApp(RenderableApp):
    def __init__(self, args: Args):
        super().__init__(args)
        parser = argparse.ArgumentParser("scene-app")
        parser.add_argument("--mode", choices=["forward", "deferred"], default="deferred")
        parser.add_argument("--lights", type=int, default=100)
        parser.add_argument("--no-post", action="store_true")
        parser.add_argument("--textured", action="store_true")
        parser.add_argument("--bloom-mips", type=int, default=0,
                            help="bloom via a real downsampled mip chain "
                                 "(render-to-mip sub-resource writes); "
                                 "0 = single-node bloom")
        parser.add_argument("--glass", action="store_true",
                            help="two translucent panes through the "
                                 "in-order blend kernel")
        parser.add_argument("--glass-textured", action="store_true",
                            help="checker-textured panes (auto-selects the "
                                 "depth-peeled fragment-rate glass path)")
        parser.add_argument("--glass-mode",
                            choices=["auto", "kernel", "peel"],
                            default="auto",
                            help="translucency path: in-order blend kernel "
                                 "(vertex-rate textures) vs depth peeling "
                                 "(per-pixel textures, exact ≤K layers)")
        parser.add_argument("--ibl", action="store_true",
                            help="image-based lighting from the procedural "
                                 "sky (SH diffuse + prefiltered GGX "
                                 "specular; deferred mode)")
        parser.add_argument("--ssao", action="store_true",
                            help="screen-space ambient occlusion on the "
                                 "ambient/IBL terms (deferred mode)")
        parser.add_argument("--fxaa", action="store_true",
                            help="FXAA-class post AA on the tonemapped "
                                 "output (gather-free; the deferred path's "
                                 "anti-aliasing)")
        parser.add_argument("--taa", action="store_true",
                            help="temporal AA: Halton-jittered projection + "
                                 "G-buffer reprojection + clamped history "
                                 "blend (deferred mode)")
        parser.add_argument("--ssr", action="store_true",
                            help="screen-space reflections: G-buffer ray "
                                 "march + Fresnel-weighted add on smooth "
                                 "surfaces (deferred mode, pre-TAA)")
        parser.add_argument("--fog", action="store_true",
                            help="volumetric height fog + sun shafts "
                                 "(shadow-marched single scattering; "
                                 "deferred mode, pre-TAA)")
        parser.add_argument("--dof", action="store_true",
                            help="depth of field (gather-free mip-blend "
                                 "bokeh; focus params ride a dynamic — "
                                 "racking focus never recompiles)")
        parser.add_argument("--motion-blur", action="store_true",
                            help="camera motion blur (G-buffer reprojection "
                                 "velocity + N-tap streak; shutter params "
                                 "ride a dynamic; deferred mode)")
        parser.add_argument("--velocity", action="store_true",
                            help="per-draw velocity G-buffer plane "
                                 "(DeferredRenderer(velocity=True)): TAA "
                                 "reprojects and motion blur streaks "
                                 "correctly for MOVING objects (skinned/"
                                 "morphed/instanced too); auto-enabled when "
                                 "--taa or --motion-blur runs with animated "
                                 "content")
        parser.add_argument("--soft-shadows", action="store_true",
                            help="VSM soft sun shadows (blurred depth "
                                 "moments + Chebyshev visibility; "
                                 "deferred mode, single map)")
        parser.add_argument("--probe", action="store_true",
                            help="reflection probe: capture the scene into "
                                 "a cube map on device, preintegrate it, "
                                 "and light with it (deferred mode)")
        parser.add_argument("--grade", action="store_true",
                            help="cinematic color grade (warm white "
                                 "balance, contrast, saturation, vignette "
                                 "— packed dynamic, live-tweakable)")
        parser.add_argument("--hud", action="store_true",
                            help="on-screen debug HUD: FPS + object "
                                 "count, host-rasterized bitfont riding "
                                 "a dynamic (text changes never "
                                 "recompile)")
        parser.add_argument("--film", action="store_true",
                            help="film effects bundle: chromatic "
                                 "aberration + CAS sharpen + animated "
                                 "grain after the tonemap (packed "
                                 "dynamic, live-tweakable)")
        parser.add_argument("--contact-shadows", action="store_true",
                            help="screen-space contact shadows: short "
                                 "G-buffer march toward the sun closes "
                                 "the shadow-map bias leak at contacts "
                                 "(deferred only)")
        parser.add_argument("--point-shadows", action="store_true",
                            help="one shadow-casting point light (omni cube "
                                 "shadow: 6 render-to-layer depth faces + "
                                 "cube PCF; deferred mode)")
        parser.add_argument("--particles", type=int, default=0,
                            help="N GPU-simulated spark particles (compute "
                                 "node in the frame program + instanced "
                                 "draw; deferred mode)")
        parser.add_argument("--morph", action="store_true",
                            help="add a pulsing morph-target blob (POSITION "
                                 "deltas + weights clip; deferred mode)")
        parser.add_argument("--spots", type=int, default=0,
                            help="N colored spot lights aimed at the ground "
                                 "(tiled-culled cone lights; deferred mode)")
        parser.add_argument("--skinned", action="store_true",
                            help="add a waving skinned tentacle (skeletal "
                                 "animation: joint palettes ride dynamics, "
                                 "zero recompiles; deferred mode)")
        parser.add_argument("--cascades", type=int, default=1,
                            help="cascaded shadow maps: N camera-frustum-fit "
                                 "depth layers instead of the one "
                                 "fixed-extent sun map (deferred mode)")
        parser.add_argument("--auto-exposure", action="store_true",
                            help="eye adaptation: log-average-luminance "
                                 "driven exposure, adapted on device across "
                                 "frames (feedback path, no host readback)")
        parser.add_argument("--gun-instances", type=int, default=0,
                            help="instanced cerberus copies (geometry "
                                 "scaling; 30 ~= 1M submitted tris)")
        parser.add_argument("--instances", type=int, default=0,
                            help="N instanced rocks around the gun (one draw)")
        parser.add_argument("--wireframe", action="store_true",
                            help="LINE polygon mode on the lit/G-buffer "
                                 "pass (wireframe debug view)")
        parser.add_argument("--msaa", type=int, default=1,
                            choices=[1, 2, 4, 8],
                            help="multisampling on the forward lit pass "
                                 "(forward mode only)")
        parser.add_argument(
            "--sky", action="store_true",
            help="procedural atmosphere sky (deferred): single-scatter "
                 "Rayleigh+Mie background from the sun direction; drops "
                 "the sun toward the horizon for a sunset (combine with "
                 "--flare)",
        )
        parser.add_argument(
            "--flare", action="store_true",
            help="lens flare: procedural ghosts/halo/streak on the HDR "
                 "frame with an occlusion brightness probe at the sun "
                 "(needs post processing, i.e. not --no-post)",
        )
        parser.add_argument(
            "--decals", type=int, default=0,
            help="N projected decals stamped in a ring on the ground "
                 "(deferred): G-buffer albedo rewrite before lighting — "
                 "lit and shadowed like painted surface detail",
        )
        parser.add_argument(
            "--pick", action="store_true",
            help="object picking (deferred): export the G-buffer object-id "
                 "plane each frame and log the object under the screen "
                 "center when it changes (costs one id-plane readback per "
                 "frame — a demo of DeferredRenderer(id_buffer=True))",
        )
        parser.add_argument(
            "--retained", action="store_true",
            help="(default; kept for compatibility) retained mode: build "
                 "the graph once, re-execute with fresh dynamics",
        )
        parser.add_argument(
            "--no-retained", action="store_true",
            help="disable auto-retained execution: rebuild the graph every "
                 "frame (the reference's per-frame rebuild, engine.rs:93-102 "
                 "— useful for benchmarking the rebuild path)",
        )
        ns, _ = parser.parse_known_args(args.app_args)
        self.textured = ns.textured
        # AUTO-RETAINED is the default: the frame structure is static
        # across frames (every per-frame value rides a dynamic), so the
        # engine re-executes the cached program — the XLA way to match the
        # reference's negligible per-frame rebuild cost (engine.rs:93-102).
        # A structural scene edit calls mark_structure_dirty() and the
        # next frame transparently takes the rebuild path.
        self.retained = not ns.no_retained
        self._structure_dirty = False
        self.instances = ns.instances
        self.gun_instances = ns.gun_instances
        self.glass = ns.glass or ns.glass_textured
        self.glass_textured = ns.glass_textured
        self.glass_mode = ns.glass_mode
        self.ibl = ns.ibl
        self.ssao = ns.ssao
        self.fxaa = ns.fxaa
        self.use_taa = ns.taa and ns.mode == "deferred"
        self.taa = None
        self.auto_exposure = ns.auto_exposure
        self.cascades = ns.cascades
        self.skinned = ns.skinned and ns.mode == "deferred"
        self.morph = ns.morph and ns.mode == "deferred"
        self.n_particles = ns.particles if ns.mode == "deferred" else 0
        self.point_shadows = ns.point_shadows and ns.mode == "deferred"
        self.use_grade = ns.grade
        self.use_film = ns.film
        self.hud = None
        self.use_hud = ns.hud
        self._hud_fps = 0.0
        self.contact_shadows = ns.contact_shadows and ns.mode == "deferred"
        self.use_probe = ns.probe and ns.mode == "deferred"
        self.soft_shadows = ns.soft_shadows and ns.mode == "deferred"
        self.n_decals = ns.decals if ns.mode == "deferred" else 0
        self.use_sky = ns.sky and ns.mode == "deferred"
        self.use_flare = ns.flare
        self.flare = None
        self._sun_dir = (0.35, -0.3, 0.88)
        self.use_pick = ns.pick and ns.mode == "deferred"
        self._picked_name: "str | None" = None
        self.use_ssr = ns.ssr and ns.mode == "deferred"
        self.ssr = None
        self.use_fog = ns.fog and ns.mode == "deferred"
        self.fog = None
        self.use_dof = ns.dof and ns.mode == "deferred"
        self.dof = None
        self.use_mblur = ns.motion_blur and ns.mode == "deferred"
        self.mblur = None
        # Per-draw velocity: explicit flag forces it on; otherwise the
        # RENDERER's auto default decides (velocity=None: on when the
        # scene contains skins/morphs/GPU-instanced motion — the cases
        # where camera-only reprojection is wrong for TAA/motion blur).
        self.use_velocity = (
            True if (ns.velocity and ns.mode == "deferred") else None
        )
        self.psys = None
        self._dt = 1.0 / 60.0
        self.spots = ns.spots if ns.mode == "deferred" else 0
        self._players = []  # (AnimationPlayer, SceneObject)
        self._morphers = []  # (AnimationClip, SceneObject)
        self._anim_t = 0.0
        self.wireframe = ns.wireframe
        self.msaa = ns.msaa
        self.bloom_mips = ns.bloom_mips
        self.mode = ns.mode
        self.num_lights = ns.lights if self.mode == "deferred" else 0
        self.post_enabled = not ns.no_post
        self.renderer = None
        self.post: Optional[PostProcess] = None
        self.camera: Optional[Camera] = None
        # ZENITH_ORBIT_START pins the camera's initial orbit angle (rad) —
        # deterministic viewpoints for gallery captures and demos.
        self.orbit = float(os.environ.get("ZENITH_ORBIT_START", "0.0"))
        self._radius = 120.0
        self._height = 20.0
        # Interactive take-over: the first real input event (from the
        # browser viewer or any other front-end) switches the scripted
        # orbit to fly controls — same contract as sandbox.fly.
        from zenith.core.camera import CameraController
        from zenith.core.input import InputActionMapper

        self.controller = CameraController(mouse_sensitivity=0.4)
        self.controller.move_speed = 60.0
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
        rng = np.random.default_rng(42)
        scene = build_scene(render_device, self.num_lights, rng,
                            textured=self.textured and self.mode == "deferred",
                            instances=self.instances,
                            gun_instances=self.gun_instances,
                            glass=self.glass and self.mode == "deferred",
                            glass_textured=(self.glass_textured
                                            and self.mode == "deferred"),
                            ibl=self.ibl and self.mode == "deferred",
                            skinned=self.skinned, morph=self.morph)
        if self.n_decals:
            from zenith.renderer import Decal

            palette = [(1.0, 0.2, 0.15, 0.85), (0.2, 0.9, 1.0, 0.85),
                       (1.0, 0.8, 0.2, 0.85), (0.6, 0.3, 1.0, 0.85)]
            for k in range(self.n_decals):
                a = 2.0 * math.pi * k / self.n_decals
                # A deep box so the down-projection reaches the ground
                # plane wherever build_scene put it.
                scene.decals.append(Decal(
                    f"mark{k}",
                    position=(85.0 * math.cos(a), 85.0 * math.sin(a), 0.0),
                    size=(26.0, 26.0, 120.0),
                    color=palette[k % len(palette)],
                ))
        if self.use_probe:
            from zenith.renderer import capture_reflection_probe

            # Capture at a point above the ground near the gun BEFORE the
            # probe becomes the scene's own environment.
            scene.environment = capture_reflection_probe(
                render_device, scene, (0.0, -30.0, 25.0), size=64
            )
            scene.skybox = None  # the probe's level 0 becomes the sky
        if self.point_shadows:
            from zenith.renderer import PointLight

            scene.point_lights.append(PointLight(
                position=(-35.0, -25.0, 30.0),
                color=(1.0, 0.8, 0.55), intensity=2500.0, radius=160.0,
                cast_shadows=True, shadow_map_size=256,
            ))
        if self.n_particles > 0:
            from zenith.renderer import ParticleSystem

            self.psys = ParticleSystem(
                self.n_particles, emitter=(40.0, 30.0, 3.0)
            )
            scene.objects.append(SceneObject.cube(
                render_device, "sparks", size=1.0, z0=-0.5,
                base_color=(1.0, 0.75, 0.3, 1.0), roughness=0.4,
                emissive=(4.0, 2.4, 0.8),
                instance_offsets=self.psys.positions,
            ))
        if self.spots > 0:
            from zenith.renderer import SpotLight

            span = 120.0
            for i in range(self.spots):
                a = 2 * math.pi * i / self.spots + 0.8
                hue = [(3.0, 0.6, 0.5), (0.5, 3.0, 0.8), (0.6, 0.9, 3.0)][i % 3]
                scene.spot_lights.append(SpotLight(
                    position=(span * 0.5 * math.cos(a),
                              span * 0.5 * math.sin(a), 45.0),
                    direction=(0.25 * math.cos(a + 2), 0.25 * math.sin(a + 2),
                               -1.0),
                    color=hue, intensity=1800.0, radius=130.0,
                    inner_deg=14.0, outer_deg=22.0,
                ))
        if self.skinned:
            from zenith.renderer.animation import AnimationPlayer

            for obj in scene.objects:
                if obj.skin is not None and obj.clips:
                    player = AnimationPlayer(obj.skin, obj.clips[0])
                    obj.joint_matrices = player.joint_matrices(0.0)
                    self._players.append((player, obj))
        if self.morph:
            for obj in scene.objects:
                if obj.morph_deltas is not None and obj.clips:
                    self._morphers.append((obj.clips[0], obj))
        if self.cascades > 1 and scene.sun is not None:
            from dataclasses import replace as _dc_replace

            scene.sun = _dc_replace(scene.sun, cascades=self.cascades)
        if self.soft_shadows and scene.sun is not None:
            from dataclasses import replace as _dc_replace

            scene.sun = _dc_replace(scene.sun, soft_shadows=True)
        if self.contact_shadows and scene.sun is not None:
            from dataclasses import replace as _dc_replace

            scene.sun = _dc_replace(scene.sun, contact_shadows=True)
        if self.mode == "deferred":
            from zenith.renderer import SSAOOptions

            self.renderer = DeferredRenderer(
                scene, wireframe=self.wireframe,
                ssao=SSAOOptions(radius=6.0) if self.ssao else False,
                id_buffer=self.use_pick,
                velocity=self.use_velocity,
                glass_mode=self.glass_mode,
            )
        else:
            self.renderer = ForwardShadowRenderer(
                scene, wireframe=self.wireframe, msaa=self.msaa
            )
        grade = None
        if self.use_grade:
            from zenith.renderer import ColorGrade

            grade = ColorGrade(exposure_ev=0.15, contrast=1.08,
                               saturation=1.12, temperature=0.35,
                               tint=-0.05, vignette=0.45)
        film = None
        if self.use_film:
            from zenith.renderer import FilmEffects

            film = FilmEffects(chromatic_aberration=2.5, sharpen=0.4,
                               grain=0.035)
        self.post = (
            PostProcess(bloom_mips=self.bloom_mips, fxaa=self.fxaa,
                        auto_exposure=self.auto_exposure, grade=grade,
                        film=film)
            if self.post_enabled else None
        )
        if (self.use_sky or self.use_flare) and scene.sun is not None:
            from dataclasses import replace as _dc_replace

            # Sunset demo: drop the sun toward the horizon so it actually
            # enters the orbit camera's 35-degree frame (the default sun
            # sits at ~62 degrees elevation, permanently out of view).
            scene.sun = _dc_replace(scene.sun, direction=(0.8, -0.55, 0.1))
            self._sun_dir = scene.sun.direction
        if self.use_sky and scene.environment is None:
            from zenith.renderer import Atmosphere

            # The procedural sky replaces the demo cube skybox.
            scene.skybox = None
            scene.atmosphere = Atmosphere()
        if self.use_flare and self.post is not None and scene.sun is not None:
            from zenith.renderer import LensFlare

            self.flare = LensFlare()
        if self.use_hud:
            from zenith.renderer.hud import HudOverlay

            self.hud = HudOverlay(max_chars=24, scale=2,
                                  overflow_indicator=True)
            self.hud.set_text("FPS ----")
        self.camera = Camera(
            fov_y=Degree(35.0), aspect_ratio=window.width / max(window.height, 1)
        )
        if self.use_taa:
            from zenith.renderer import TemporalAA

            self.taa = TemporalAA()
        if self.use_ssr:
            from zenith.renderer import ScreenSpaceReflections

            self.ssr = ScreenSpaceReflections()
        if self.use_fog:
            from zenith.renderer import VolumetricFog

            self.fog = VolumetricFog()
        if self.use_dof:
            from zenith.renderer import DepthOfField

            self.dof = DepthOfField(focus_distance=170.0, focal_range=30.0,
                                    strength=1.4)
        if self.use_mblur:
            from zenith.renderer import MotionBlur

            self.mblur = MotionBlur(strength=1.0, max_radius=32.0)
        self._extent = (window.width, window.height)
        self._window = window
        self._radius = 170.0
        self._height = 25.0
        self._update_camera()

    def on_window_event(self, event: WindowEvent) -> None:
        if isinstance(event, (KeyboardInput, MouseInput)):
            self._interactive = True
        self.mapper.on_window_event(event)
        self.controller.on_window_event(event)

    def on_device_event(self, event: DeviceEvent) -> None:
        self.controller.on_device_event(event)

    def resize(self, width: int, height: int) -> None:
        self._extent = (width, height)
        if self.taa is not None:
            self.taa.reset()  # history shape changes; jitter scale follows
        if self.mblur is not None:
            self.mblur.reset()

    def tick(self, delta_time: float) -> None:
        if self._interactive:
            self.mapper.tick(delta_time)
            if (self.mapper.is_action_just_pressed("quit")
                    and self._window is not None):
                self._window.request_close()
            self.controller.update_cameras(
                delta_time,
                self.mapper.get_axis("forward"),
                self.mapper.get_axis("right"),
                self.mapper.get_axis("up"),
                [self.camera],
            )
        else:
            self.orbit += delta_time * float(
                os.environ.get("ZENITH_ORBIT_SPEED", "0.4"))
            self._update_camera()
        if self.taa is not None:
            self.taa.jitter_camera(self.camera, *self._extent)
        if self.post is not None and self.post.auto_exposure:
            self.post.set_delta_time(delta_time)
        self._anim_t += delta_time
        self._dt = delta_time
        if self.hud is not None and delta_time > 0.0:
            # Exp-smoothed FPS; set_text caches, so equal strings are free
            # and the bitmap only re-rasterizes when the number moves.
            inst = 1.0 / delta_time
            self._hud_fps = (
                inst if self._hud_fps == 0.0
                else self._hud_fps + 0.05 * (inst - self._hud_fps)
            )
            n_obj = (len(self.renderer.scene.objects)
                     if self.renderer is not None else 0)
            self.hud.set_text(f"FPS {self._hud_fps:5.0f}  OBJ {n_obj}")
        if self.psys is not None:
            for obj in (self.renderer.scene.objects
                        if self.renderer is not None else []):
                if obj.name == "sparks":
                    obj.instance_offsets = self.psys.positions
        for player, obj in self._players:
            obj.joint_matrices = player.joint_matrices(self._anim_t)
        for clip, obj in self._morphers:
            from zenith.renderer.animation import sample_morph_weights

            obj.morph_weights = sample_morph_weights(
                clip, self._anim_t, obj.morph_deltas.shape[0]
            )

    def _update_camera(self) -> None:
        x = math.sin(self.orbit) * self._radius
        y = -math.cos(self.orbit) * self._radius
        self.camera.set_position(np.array([x, y, self._height], np.float32))
        pitch = -math.atan2(self._height - 5.0, self._radius)
        self.camera.set_yaw_pitch(Radians(self.orbit), Radians(pitch))

    def mark_structure_dirty(self) -> None:
        """Call after a STRUCTURAL scene edit (object added/removed, a
        classifying field flipped: translucent / skin / morph / instancing
        None-ness, texture swapped): the next update_dynamics returns None
        once, which routes that frame through the rebuild path (app.render
        → build → compile at the new structure) and re-caches the retained
        program. Value changes (transforms, visibility, materials, light
        params, animation) ride dynamics and never need this."""
        self._structure_dirty = True

    def update_dynamics(self):
        """Auto-retained hook (engine.py): per-frame values only — the
        frame STRUCTURE is static, so the engine re-executes the cached
        program. Returns None (→ rebuild path) when --no-retained or after
        mark_structure_dirty()."""
        if not self.retained or self.renderer is None:
            return None
        if self._structure_dirty:
            self._structure_dirty = False
            return None
        # include_models: transforms + visibility toggles keep flowing in
        # retained mode (one (N,4,4) np.stack per frame — host-cheap).
        d = (
            self.renderer.frame_dynamics(self.camera, include_models=True)
            if self.mode == "deferred"
            else self.renderer.frame_dynamics(self.camera)
        )
        if self.taa is not None:
            d.update(self.taa.frame_dynamics(self.camera))
        if self.post is not None:
            # frame_dynamics covers BOTH auto-exposure state and the
            # grade vector (empty dict when neither is configured).
            d.update(self.post.frame_dynamics())
        if self.ssr is not None:
            d.update(self.ssr.frame_dynamics(self.camera))
        if self.fog is not None:
            d.update(self.fog.frame_dynamics(self.camera))
        if self.dof is not None:
            d.update(self.dof.frame_dynamics())
        if self.mblur is not None:
            d.update(self.mblur.frame_dynamics(self.camera))
        if self.flare is not None:
            d.update(self.flare.sun_dynamics(self.camera, self._sun_dir))
        if self.hud is not None:
            d.update(self.hud.frame_dynamics())
        if self.psys is not None:
            d.update(self.psys.frame_dynamics(self._dt))
            d["def.inst.sparks"] = self.psys.positions
        return d

    def on_frame_outputs(self, outputs) -> None:
        """Engine feedback (request_output): TAA history, adapted exposure,
        particle state for next frame."""
        if self.psys is not None and "psys.state" in outputs:
            self.psys.feedback(outputs["psys.state"], outputs["psys.pos"])
        if self.use_pick and "object_id" in outputs:
            import numpy as _np

            ids = _np.asarray(outputs["object_id"])
            obj = self.renderer.pick(ids, ids.shape[1] // 2, ids.shape[0] // 2)
            name = obj.name if obj is not None else None
            if name != self._picked_name:
                self._picked_name = name
                import logging

                logging.getLogger(__name__).info(
                    "pick: screen center is over %s", name or "<background>"
                )
        if self.taa is not None and "taa.history" in outputs:
            self.taa.feedback(outputs["taa.history"])
        if self.post is not None and "post.ae" in outputs:
            self.post.feedback(outputs["post.ae"])

    def render(self, context: RenderContext) -> None:
        width, height = context.extent
        if width == 0 or height == 0:
            return
        builder = context.builder()
        out = builder.import_resource(context.swapchain_texture())

        # Ordered post chain: (name, render(src, dst), exports_history).
        # Built ONCE per frame so the intermediate-vs-swapchain decision is
        # positional — every stage except the final swapchain writer gets a
        # fresh intermediate, and a history-exporting stage (TAA) never
        # shares its output with a later in-place writer (HUD):
        # request_output captures a resource's FINAL contents, so aliasing
        # would feed the overlay back as next frame's history.
        chain = []
        if self.ssr is not None:
            # Reflections resolve on the LIT frame before TAA so they get
            # anti-aliased (and jitter-dithered) like everything else.
            chain.append(("ssr", lambda src, dst: self.ssr.render_to(
                builder, src, dst, self.camera,
                self.renderer.gbuffer_handles), False))
        if self.fog is not None:
            # Volumetric scattering over the lit (and reflected) frame;
            # pre-TAA so the march dither resolves temporally.
            chain.append(("fog", lambda src, dst: self.fog.render_to(
                builder, src, dst, self.camera,
                self.renderer.gbuffer_handles,
                sun=self.renderer.scene.sun), False))
        if self.taa is not None:
            def _taa_stage(src, dst):
                self.taa.render_to(
                    builder, src, dst, self.camera, width, height,
                    self.renderer.gbuffer_handles,
                )
                context.request_output("taa.history", dst)
            chain.append(("taa", _taa_stage, True))
        if self.mblur is not None:
            # Blur the anti-aliased frame (post-TAA), before DoF/post.
            chain.append(("mblur", lambda src, dst: self.mblur.render_to(
                builder, src, dst, self.camera,
                self.renderer.gbuffer_handles), False))
        if self.dof is not None:
            chain.append(("dof", lambda src, dst: self.dof.render_to(
                builder, src, dst, self.renderer.gbuffer_handles), False))

        if chain or self.post is not None:
            target = builder.create(
                TextureDesc.color("scene.hdr", width, height, Format.RGBA32F)
            )
        else:
            target = out

        if self.mode == "deferred":
            self.renderer.render_to(builder, target, self.camera, width, height)
            if self.use_pick:
                context.request_output("object_id", self.renderer.id_resource)
        else:
            depth = builder.create(TextureDesc.depth("scene.depth", width, height))
            self.renderer.render_to(builder, target, depth, self.camera)

        if self.psys is not None:
            state_h, pos_h = self.psys.sim_to(builder, self._dt)
            context.request_output("psys.state", state_h)
            context.request_output("psys.pos", pos_h)

        if self.flare is not None:
            # Lens flare on the HDR frame after scene effects, before TAA
            # (the ghosts anti-alias and stabilize like scene content).
            # In-place on the current target: it never moves the chain.
            def _flare_inplace(tgt):
                for k, v in self.flare.sun_dynamics(
                    self.camera, self._sun_dir
                ).items():
                    builder.set_dynamic(k, v)
                self.flare.render_to(builder, tgt,
                                     sun_color=(1.0, 0.92, 0.8))
        else:
            _flare_inplace = None

        # flare slots in after fog (or after the scene render if no
        # ssr/fog), before TAA — find its position in the chain.
        flare_after = sum(1 for name, _, _ in chain if name in ("ssr", "fog"))

        for i, (name, render_stage, exports) in enumerate(chain):
            if _flare_inplace is not None and i == flare_after:
                _flare_inplace(target)
                _flare_inplace = None
            last_writer = (i == len(chain) - 1) and self.post is None
            # An exporting stage may only write the swapchain directly if
            # nothing composites onto it afterwards.
            if last_writer and not (exports and self.hud is not None):
                dst = out
            else:
                dst = builder.create(TextureDesc.color(
                    f"scene.{name}", width, height, Format.RGBA32F
                ))
            render_stage(target, dst)
            target = dst
        if _flare_inplace is not None:
            _flare_inplace(target)

        if self.post is not None:
            self.post.render_to(builder, target, out)
            target = out
            if self.post.exposure_out is not None:
                context.request_output("post.ae", self.post.exposure_out)

        if self.hud is not None:
            # On-screen stats, last: composited over the final LDR image.
            # When the chain's last stage kept a private history resource,
            # the HUD bridges it to the swapchain (read target, write out).
            self.hud.render_to(
                builder, out, source=target if target is not out else None
            )


def main() -> None:
    from zenith.launch import launch
    from zenith.window import Window

    parser = argparse.ArgumentParser("zenith-sandbox scene")
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
    os.environ.setdefault("ZENITH_READBACK_INTERVAL", str(known.readback_interval))

    window = Window(width=known.width, height=known.height, title="scene")
    loop = launch(SceneApp, argv=rest, window=window,
                  max_frames=None if known.serve is not None else known.frames,
                  serve=known.serve, fps_cap=known.fps_cap)
    if known.out and window.last_frame is not None:
        window.write_png(known.out, window.last_frame)
        print(f"wrote {known.out}")
    print(f"rendered {loop.frames_rendered} frames")


if __name__ == "__main__":
    main()
