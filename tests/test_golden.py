"""Golden-image regression: the triangle demo frame must stay byte-stable.

The golden was produced by the oracle-verified implementation (rasterizer
semantics validated against the independent NumPy reference in
test_raster.py); this test pins the END-TO-END byte output — graph, raster,
shading, blending, sRGB encode — against drift.
"""

from pathlib import Path

import numpy as np

from zenith.rhi import (
    Buffer,
    Format,
    PipelineCache,
    RhiCore,
    Texture,
    TextureDesc,
    encode_present,
)

GOLDEN = Path(__file__).parent / "golden" / "triangle_128x32_t1_25.npy"


def test_triangle_frame_matches_golden():
    from test_rendergraph import OPTS, TRI_IB, TRI_VB, H, W, build_triangle_graph

    device = RhiCore().create_render_device()
    vb = Buffer.from_numpy("tri.vb", TRI_VB)
    ib = Buffer.from_numpy("tri.ib", TRI_IB)
    tex = Texture(TextureDesc.color("swap", W, H))
    graph, out = build_triangle_graph(vb, ib, tex, 1.25)
    compiled = graph.compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    img = np.asarray(encode_present(compiled.value(out), Format.RGBA8_SRGB))

    golden = np.load(GOLDEN)
    # Allow ±1 LSB for cross-backend float rounding; byte-exact on CPU.
    diff = np.abs(img.astype(np.int16) - golden.astype(np.int16))
    assert diff.max() <= 1, f"golden drift: max LSB diff {diff.max()}"
    assert (diff > 0).mean() < 0.01


SCENE_GOLDEN = Path(__file__).parent / "golden" / "deferred_scene_128x64.npy"


def _render_scene_frame():
    """Deferred multi-pass frame: shadow → batched G-buffer MRT → tiled
    lighting (8 point lights) → skybox background → bloom+ACES post →
    sRGB encode, at 128×64 on the CPU backend."""
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    from test_renderers import H, OPTS, W, build_test_scene, make_camera

    from zenith.renderer import DeferredRenderer, PostProcess
    from zenith.rendergraph import RenderGraphBuilder
    from zenith.sandbox.scene import sky_cube_texture

    device = RhiCore().create_render_device()
    scene = build_test_scene(device, num_lights=8)
    import dataclasses

    scene = dataclasses.replace(scene, skybox=sky_cube_texture(16))
    renderer = DeferredRenderer(scene)
    post = PostProcess()
    cam = make_camera()

    builder = RenderGraphBuilder()
    hdr = builder.create(TextureDesc.color("hdr", W, H, Format.RGBA32F))
    out = builder.create(TextureDesc.color("ldr", W, H, Format.RGBA32F))
    builder.export(out)
    renderer.render_to(builder, hdr, cam, W, H)
    post.render_to(builder, hdr, out)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    return np.asarray(encode_present(compiled.value(out), Format.RGBA8_SRGB))


def test_deferred_scene_matches_golden():
    """End-to-end golden for the flagship multi-pass path (the triangle
    golden covers the basic pipeline; this one pins shadows, the batched
    MRT G-buffer, the tiled-lighting kernel, cube sampling, and post).

    Regenerate after an INTENTIONAL rendering change (with the oracle suite
    green): ZENITH_REGEN_GOLDEN=1 pytest tests/test_golden.py
    """
    import os

    img = _render_scene_frame()
    if os.environ.get("ZENITH_REGEN_GOLDEN"):
        np.save(SCENE_GOLDEN, img)
    golden = np.load(SCENE_GOLDEN)
    diff = np.abs(img.astype(np.int16) - golden.astype(np.int16))
    assert diff.max() <= 1, f"golden drift: max LSB diff {diff.max()}"
    assert (diff > 0).mean() < 0.01


TEXTURED_GOLDEN = Path(__file__).parent / "golden" / "textured_scene_128x64.npy"


def _render_textured_frame():
    """Textured deferred frame: two checker/brushed-textured quads through
    the batched G-buffer (per-draw texture select by draw id), mip-mapped
    sampling, lighting, post."""
    import math
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    from test_renderers import H, OPTS, W, make_camera

    from zenith.renderer import (
        DeferredRenderer,
        DirectionalLight,
        PostProcess,
        Scene,
        SceneObject,
    )
    from zenith.rendergraph import RenderGraphBuilder
    from zenith.sandbox.scene import brushed_texture, checker_texture

    device = RhiCore().create_render_device()
    rng = np.random.default_rng(7)
    ground = SceneObject.quad(
        device, "ground", size=200.0, z=0.0,
        base_color=(0.9, 0.9, 0.95, 1.0), roughness=0.9,
        base_color_texture=checker_texture(64, 8),
    )
    panel = SceneObject.quad(
        device, "panel", size=30.0, z=12.0,
        base_color=(0.9, 0.6, 0.4, 1.0), metallic=0.6, roughness=0.4,
        base_color_texture=brushed_texture(64, rng=rng),
    )
    scene = Scene(
        objects=[panel, ground],
        sun=DirectionalLight(direction=(0.05, -0.05, 1.0), intensity=2.5,
                             shadow_map_size=128, shadow_extent=60.0),
        ambient=(0.05, 0.05, 0.05),
    )
    renderer = DeferredRenderer(scene)
    post = PostProcess()
    cam = make_camera()

    builder = RenderGraphBuilder()
    hdr = builder.create(TextureDesc.color("hdr", W, H, Format.RGBA32F))
    out = builder.create(TextureDesc.color("ldr", W, H, Format.RGBA32F))
    builder.export(out)
    renderer.render_to(builder, hdr, cam, W, H)
    post.render_to(builder, hdr, out)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    return np.asarray(encode_present(compiled.value(out), Format.RGBA8_SRGB))


def test_textured_scene_matches_golden():
    """Pins per-draw texture selection (PerDraw + draw-id), mip-mapped
    sampling, and the white-fallback-free textured G-buffer path."""
    import os

    img = _render_textured_frame()
    if os.environ.get("ZENITH_REGEN_GOLDEN"):
        np.save(TEXTURED_GOLDEN, img)
    golden = np.load(TEXTURED_GOLDEN)
    diff = np.abs(img.astype(np.int16) - golden.astype(np.int16))
    assert diff.max() <= 1, f"golden drift: max LSB diff {diff.max()}"
    assert (diff > 0).mean() < 0.01
