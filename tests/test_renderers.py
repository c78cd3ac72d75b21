"""Feature-renderer tests: shadow+forward, deferred PBR, post chain.

Tiny framebuffers on the CPU interpreter; semantic checks (occlusion darkens,
lights illuminate, tonemap bounds) rather than golden images.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from zenith.asset.render_types import Mesh as MeshAsset
from zenith.asset import AssetUrl
from zenith.core.camera import Camera
from zenith.core.mathtypes import Degree, Radians
from zenith.rendergraph import CompileOptions, RenderGraphBuilder
from zenith.renderer import (
    DeferredRenderer,
    DirectionalLight,
    ForwardShadowRenderer,
    PointLight,
    PostProcess,
    Scene,
    SceneObject,
)
from zenith.rhi import Format, PipelineCache, RhiCore, TextureDesc

W, H = 128, 64
OPTS = CompileOptions(tile_h=8, tile_w=128)


def make_cube(size=10.0, z0=10.0):
    """Axis-aligned cube as a Mesh asset (z-up world), wound CW-on-screen
    (front faces outward under the glTF pipeline state)."""
    s = size / 2.0
    cz = z0 + s
    # 6 faces × 4 verts (pos, normal, uv)
    faces = []
    idx = []
    defs = [
        ((0, 0, 1), [(-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]),
        ((0, 0, -1), [(-s, s, -s), (s, s, -s), (s, -s, -s), (-s, -s, -s)]),
        ((1, 0, 0), [(s, -s, -s), (s, s, -s), (s, s, s), (s, -s, s)]),
        ((-1, 0, 0), [(-s, s, -s), (-s, -s, -s), (-s, -s, s), (-s, s, s)]),
        ((0, 1, 0), [(s, s, -s), (-s, s, -s), (-s, s, s), (s, s, s)]),
        ((0, -1, 0), [(-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s)]),
    ]
    for f, (n, quad) in enumerate(defs):
        base = 4 * f
        for px, py, pz in quad:
            faces.append([px, py, pz + cz, *n, 0.0, 0.0])
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return MeshAsset(
        AssetUrl("test/cube.mesh"),
        np.asarray(faces, np.float32),
        np.asarray(idx, np.int32),
    )


@pytest.fixture
def device():
    return RhiCore().create_render_device()


def make_camera():
    cam = Camera(fov_y=Degree(45.0), aspect_ratio=W / H)
    cam.set_position(np.array([0.0, -60.0, 25.0], np.float32))
    cam.set_yaw_pitch(Radians(0.0), Radians(-0.25))
    return cam


def build_test_scene(device, num_lights=0, sun_intensity=2.5):
    cube = SceneObject.from_mesh(
        device, make_cube(size=14.0, z0=8.0), "cube",
        base_color=(0.8, 0.2, 0.2, 1.0), metallic=0.0, roughness=0.5,
        bin_capacity=64,
    )
    ground = SceneObject.quad(
        device, "ground", size=200.0, z=0.0,
        base_color=(0.4, 0.4, 0.4, 1.0), roughness=0.9,
    )
    lights = [
        PointLight(position=(20.0 * math.cos(a), 20.0 * math.sin(a), 12.0),
                   color=(1.0, 0.8, 0.5), intensity=300.0, radius=60.0)
        for a in np.linspace(0, 2 * math.pi, num_lights, endpoint=False)
    ]
    return Scene(
        objects=[cube, ground],
        sun=DirectionalLight(direction=(0.05, -0.05, 1.0), intensity=sun_intensity,
                             shadow_map_size=128, shadow_extent=60.0),
        point_lights=lights,
        ambient=(0.05, 0.05, 0.05),
    )


def run_graph(device, build_fn):
    builder = RenderGraphBuilder()
    out_handle = build_fn(builder)
    builder.export(out_handle)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    return np.asarray(compiled.value(out_handle))


class TestForwardShadow:
    def test_shadow_darkens_occluded_ground(self, device):
        scene = build_test_scene(device)
        renderer = ForwardShadowRenderer(scene)
        cam = make_camera()

        def build(builder):
            color = builder.create(TextureDesc.color("rt", W, H))
            depth = builder.create(TextureDesc.depth("ds", W, H))
            renderer.render_to(builder, color, depth, cam)
            return color

        img = run_graph(device, build)
        assert img.shape == (H, W, 4)

        # Project known world points: ground under the cube (shadowed) vs
        # ground far to the side at similar depth (lit).
        def px_of(world):
            clip = cam.render_view_projection @ np.array([*world, 1.0], np.float32)
            ndc = clip[:3] / clip[3]
            return int((ndc[1] + 1) * 0.5 * H), int((ndc[0] + 1) * 0.5 * W)

        sy, sx = px_of((0.0, 0.0, 0.0))  # directly under the floating cube
        ly, lx = px_of((40.0, 0.0, 0.0))  # same depth, outside the shadow
        shadow_px = img[sy, sx, :3].sum()
        lit_px = img[ly, lx, :3].sum()
        assert lit_px > shadow_px * 1.5, (lit_px, shadow_px)

    def test_cube_visible_and_background_clear(self, device):
        scene = build_test_scene(device)
        renderer = ForwardShadowRenderer(scene)
        cam = make_camera()

        def build(builder):
            color = builder.create(TextureDesc.color("rt", W, H))
            depth = builder.create(TextureDesc.depth("ds", W, H))
            renderer.render_to(builder, color, depth, cam, clear_color=(0, 0, 1, 1))
            return color

        img = run_graph(device, build)
        # Sky (top rows) = clear blue; cube (center) = reddish.
        np.testing.assert_allclose(img[2, 2, :3], [0, 0, 1], atol=1e-5)
        center = img[H // 2, W // 2, :3]
        assert center[0] > center[2]  # red cube

    def test_forward_msaa_softens_silhouettes_only(self, device):
        """ForwardShadowRenderer(msaa=4): the lit pass rasterizes per
        sample and the graph resolves for consumers — silhouette pixels
        change (anti-aliasing), the image interior stays put."""
        scene = build_test_scene(device)
        cam = make_camera()

        def render(renderer):
            def build(builder):
                color = builder.create(TextureDesc.color("rt", W, H))
                depth = builder.create(TextureDesc.depth("ds", W, H))
                renderer.render_to(builder, color, depth, cam)
                return color

            return run_graph(device, build)

        img1 = render(ForwardShadowRenderer(scene))
        img4 = render(ForwardShadowRenderer(scene, msaa=4))
        assert np.isfinite(img4).all()
        diff = np.abs(img4[..., :3] - img1[..., :3]).max(axis=-1)
        changed = diff > 5e-3
        assert changed.any(), "4x MSAA changed nothing — not multisampling"
        # Only a thin band of edge pixels may differ.
        assert changed.mean() < 0.15, (
            f"{changed.mean():.1%} of pixels changed — MSAA should only "
            "touch silhouettes"
        )


class TestWireframe:
    def test_forward_wireframe_outlines_only(self, device):
        """wireframe=True puts the lit pass in LINE polygon mode: the cube
        renders as lit edges — far fewer covered pixels than FILL, and the
        face centers show the clear color."""
        scene = build_test_scene(device)
        cam = make_camera()

        def build_with(renderer):
            def build(builder):
                color = builder.create(TextureDesc.color("rt", W, H))
                depth = builder.create(TextureDesc.depth("ds", W, H))
                renderer.render_to(builder, color, depth, cam,
                                   clear_color=(0, 0, 1, 1))
                return color
            return build

        filled = run_graph(
            device, build_with(ForwardShadowRenderer(scene))
        )
        wire = run_graph(
            device,
            build_with(ForwardShadowRenderer(scene, wireframe=True)),
        )
        filled_cube = (filled[..., 0] > filled[..., 2]).sum()
        wire_cube = (wire[..., 0] > wire[..., 2]).sum()
        assert 0 < wire_cube < 0.6 * filled_cube, (wire_cube, filled_cube)
        # Cube face center is clear-blue in wireframe, red when filled.
        c = wire[H // 2, W // 2, :3]
        assert c[2] > c[0]

    def test_deferred_wireframe_outlines_only(self, device):
        scene = build_test_scene(device, num_lights=2)
        cam = make_camera()

        def build_with(renderer):
            def build(builder):
                color = builder.create(TextureDesc.color("rt", W, H))
                renderer.render_to(builder, color, cam, W, H)
                return color
            return build

        filled = run_graph(device, build_with(DeferredRenderer(scene)))
        wire = run_graph(
            device, build_with(DeferredRenderer(scene, wireframe=True))
        )
        # Wire pixels receive full deferred lighting (non-black), and the
        # covered area shrinks to the edges.
        filled_lum = filled[..., :3].sum(-1)
        wire_lum = wire[..., :3].sum(-1)
        bg = filled_lum[2, 2]
        filled_cov = (filled_lum > bg + 0.05).sum()
        wire_cov = (wire_lum > bg + 0.05).sum()
        assert 0 < wire_cov < 0.6 * filled_cov, (wire_cov, filled_cov)


class TestDeferred:
    def test_skybox_background_cube_sampled(self, device):
        """Background pixels sample the scene's cube map by view ray
        (texture.rs:94-105 proven through the full deferred graph)."""
        from zenith.ops.sampling import sample_cube
        from zenith.rhi import Texture

        # Distinct constant color per face.
        faces = np.zeros((6, 8, 8, 4), np.float32)
        for f in range(6):
            faces[f, :, :, :3] = (f + 1) / 6.0 * np.array(
                [1.0, 0.5, 0.25], np.float32
            )
            faces[f, :, :, f % 3] = 1.0
        sky = Texture.from_numpy_layers("sky", faces, Format.RGBA32F, cube=True)

        scene = build_test_scene(device, sun_intensity=0.0)
        scene.skybox = sky
        renderer = DeferredRenderer(scene, shadows=False)
        cam = make_camera()

        def build(builder):
            color = builder.create(TextureDesc.color("rt", W, H))
            renderer.render_to(builder, color, cam, W, H)
            return color

        img = run_graph(device, build)
        # A known sky pixel (top-left corner, far above the ground plane):
        # compute its view ray and compare with a direct cube sample.
        inv_vp = np.linalg.inv(
            np.asarray(cam.render_view_projection, np.float64)
        )
        px, py = 2, 2
        ndc = np.array(
            [(px + 0.5) / W * 2 - 1, (py + 0.5) / H * 2 - 1, 0.5, 1.0]
        )
        p = inv_vp @ ndc
        d = (p[:3] / p[3]) - np.asarray(cam.location, np.float64)
        expected = np.asarray(
            sample_cube(
                jnp.asarray(faces), jnp.asarray(d[None, :], jnp.float32)
            )
        )[0]
        # The resolve writes alpha=1 unconditionally; compare RGB.
        np.testing.assert_allclose(img[py, px, :3], expected[:3], atol=1e-4)

    def test_point_lights_add_energy(self, device):
        cam = make_camera()

        def render(num_lights):
            scene = build_test_scene(device, num_lights=num_lights, sun_intensity=0.5)
            renderer = DeferredRenderer(scene)

            def build(builder):
                color = builder.create(TextureDesc.color("rt", W, H))
                renderer.render_to(builder, color, cam, W, H)
                return color

            return run_graph(device, build)

        img0 = render(0)
        img8 = render(8)
        # Scene energy strictly increases with lights; background unchanged.
        assert img8[..., :3].sum() > img0[..., :3].sum() * 1.2
        np.testing.assert_allclose(img0[2, 2, :3], img8[2, 2, :3], atol=1e-5)

    def test_gbuffer_background_vs_coverage(self, device):
        scene = build_test_scene(device)
        renderer = DeferredRenderer(scene, shadows=False)
        cam = make_camera()

        def build(builder):
            color = builder.create(TextureDesc.color("rt", W, H))
            renderer.render_to(builder, color, cam, W, H, background=(1, 0, 1))
            return color

        img = run_graph(device, build)
        np.testing.assert_allclose(img[1, 1, :3], [1, 0, 1], atol=1e-5)
        assert not np.allclose(img[H // 2, W // 2, :3], [1, 0, 1])


class TestPost:
    def test_tonemap_bounds_and_bloom(self, device):
        # HDR input with a hot spot → output in [0,1], bloom spreads energy
        # to neighbors of the hot spot.
        hdr = np.zeros((H, W, 4), np.float32)
        hdr[..., 3] = 1.0
        hdr[H // 2, W // 2, :3] = 50.0
        hdr[:, :, :3] += 0.2

        from zenith.rhi import Texture

        tex = Texture(
            TextureDesc.color("hdr", W, H), jnp.asarray(hdr)
        )

        def build(builder):
            src = builder.import_resource(tex)
            dst = builder.create(TextureDesc.color("ldr", W, H))
            PostProcess().render_to(builder, src, dst)
            return dst

        img = run_graph(device, build)
        assert img[..., :3].max() <= 1.0 + 1e-5
        # Neighbor of the hot pixel picked up bloom vs far away.
        near = img[H // 2 + 3, W // 2, :3].sum()
        far = img[4, 8, :3].sum()
        assert near > far + 1e-3


class TestTexturedDeferred:
    def test_checker_albedo_modulates(self, device):
        """Textured G-buffer: a UV-checkered ground modulates albedo; texture
        resources (mip tuples) flow through graph import → bind → sample."""
        import jax.numpy as jnp
        from zenith.rhi import Format, Texture

        # 32×32-cell checker (cells small enough to alternate within the
        # visible ground span), no mips.
        n = 64
        yy, xx = np.mgrid[0:n, 0:n]
        cell = (((yy // 2) + (xx // 2)) % 2).astype(np.uint8)
        px = np.zeros((n, n, 4), np.uint8)
        px[..., :3] = (cell * 255)[..., None]
        px[..., 3] = 255
        checker = Texture.from_numpy("chk", px, Format.RGBA8_UNORM)
        white = Texture.from_numpy(
            "white", np.full((1, 1, 4), 255, np.uint8), Format.RGBA8_UNORM
        )

        cube = SceneObject.from_mesh(
            device, make_cube(size=14.0, z0=8.0), "cube",
            base_color=(1, 1, 1, 1), bin_capacity=64, base_color_texture=white,
        )
        ground = SceneObject.quad(
            device, "ground", size=200.0, z=0.0,
            base_color=(1, 1, 1, 1), base_color_texture=checker,
        )
        scene = Scene(
            objects=[cube, ground],
            sun=DirectionalLight(direction=(0.0, 0.0, 1.0), intensity=2.0,
                                 cast_shadows=False),
            ambient=(0.1, 0.1, 0.1),
        )
        renderer = DeferredRenderer(scene, shadows=False)
        assert renderer.textured
        cam = make_camera()

        def build(builder):
            color = builder.create(TextureDesc.color("rt", W, H))
            renderer.render_to(builder, color, cam, W, H)
            return color

        img = run_graph(device, build)
        # Ground rows must alternate bright/dark along x (checker), i.e. show
        # big brightness variance vs the untextured cube face.
        row = img[H - 6, :, :3].sum(-1)
        ground_px = row[row > 0.01]
        assert ground_px.std() > 0.2 * ground_px.mean()


class TestVisibilityToggle:
    def test_hide_without_recompile(self, device):
        """SceneObject.visible=False removes the object (and its shadow)
        from the frame WITHOUT a new frame program: visibility rides the
        model-matrix dynamic (zero matrix -> clipped at w=0), so the
        structure key is unchanged."""
        from zenith.rendergraph.graph import frame_program_cache_size

        scene = build_test_scene(device)
        renderer = DeferredRenderer(scene)
        cam = make_camera()

        def build(builder):
            color = builder.create(TextureDesc.color("rt", W, H))
            renderer.render_to(builder, color, cam, W, H)
            return color

        shown = run_graph(device, build)
        programs_after_first = frame_program_cache_size()
        scene.objects[0].visible = False  # hide the cube
        hidden = run_graph(device, build)
        assert frame_program_cache_size() == programs_after_first
        scene.objects[0].visible = True
        shown_again = run_graph(device, build)
        assert frame_program_cache_size() == programs_after_first

        cy, cx = H // 2, W // 2  # cube silhouette center
        assert not np.allclose(shown[cy, cx], hidden[cy, cx])
        np.testing.assert_allclose(shown_again, shown, atol=1e-6)
        # The cube's shadow on the ground is gone too: the ground directly
        # beneath it brightens when hidden.
        def px_of(world):
            clip = cam.render_view_projection @ np.array([*world, 1.0], np.float32)
            ndc = clip[:3] / clip[3]
            return int((ndc[1] + 1) * 0.5 * H), int((ndc[0] + 1) * 0.5 * W)

        sy, sx = px_of((0.0, 0.0, 0.0))
        assert hidden[sy, sx, :3].sum() > shown[sy, sx, :3].sum() * 1.2
        assert np.isfinite(hidden).all()

    def test_retained_visibility_via_models_dynamic(self, device):
        """Retained execution: frame_dynamics(include_models=True) carries
        visibility/motion through the stacked model-matrix dynamic -- the
        SAME compiled program re-executes with the object hidden."""
        from zenith.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith.rhi import PipelineCache

        scene = build_test_scene(device)
        renderer = DeferredRenderer(scene)
        cam = make_camera()
        builder = RenderGraphBuilder()
        color = builder.create(TextureDesc.color("rt", W, H))
        builder.export(color)
        renderer.render_to(builder, color, cam, W, H)
        compiled = builder.build().compile(device, PipelineCache(), OPTS)
        compiled.execute(device)
        shown = np.asarray(compiled.value(color))
        scene.objects[0].visible = False
        compiled.execute(
            device,
            dynamics=renderer.frame_dynamics(cam, include_models=True),
        )
        hidden = np.asarray(compiled.value(color))
        cy, cx = H // 2, W // 2
        assert not np.allclose(shown[cy, cx], hidden[cy, cx])
        assert np.isfinite(hidden).all()
