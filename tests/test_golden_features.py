"""Per-feature golden images (VERDICT r3 next #10): small end-to-end
goldens for the round-3 screen-space features so refactors can't silently
shift their output. Each config renders ONE deterministic 128x64 frame
through the PRODUCTION wiring (the same graph assembly as
sandbox.scene) and pins the sRGB bytes.

Regenerate after an INTENTIONAL rendering change (with the oracle suite
green):  ZENITH_REGEN_GOLDEN=1 pytest tests/test_golden_features.py
"""

from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

GOLDEN_DIR = Path(__file__).parent / "golden"

CONFIGS = ("ssr", "fog", "sky", "flare", "film", "contact", "decals")


def _render(cfg: str) -> np.ndarray:
    from test_renderers import H, OPTS, W, build_test_scene, make_camera

    from zenith.renderer import DeferredRenderer, PostProcess
    from zenith.rendergraph import RenderGraphBuilder
    from zenith.rhi import (
        Format,
        PipelineCache,
        RhiCore,
        TextureDesc,
        encode_present,
    )
    from zenith.sandbox.scene import sky_cube_texture

    device = RhiCore().create_render_device()
    scene = build_test_scene(device, num_lights=8)
    if cfg == "ssr":
        # SSR needs a smooth receiver whose reflection rays HIT on-screen
        # geometry: a glossy floor mirrors the cube. (The default matte
        # ground is roughness 0.9 — past the 0.6 gate — and the cube's
        # own rays reflect sky and miss, so SSR would be a no-op and the
        # golden would pin nothing.)
        from zenith.renderer import SceneObject

        mirror = SceneObject.quad(
            device, "mirror", size=200.0, z=0.0,
            base_color=(0.6, 0.6, 0.65, 1.0), metallic=0.8, roughness=0.1,
        )
        scene = dataclasses.replace(
            scene, objects=[scene.objects[0], mirror]
        )
    if cfg != "sky":
        scene = dataclasses.replace(scene, skybox=sky_cube_texture(16))
    if cfg in ("flare", "sky"):
        # Sun low on the horizon so the flare/atmosphere is in frame.
        scene.sun = dataclasses.replace(
            scene.sun, direction=(0.8, -0.55, 0.1)
        )
    if cfg == "contact":
        scene.sun = dataclasses.replace(scene.sun, contact_shadows=True)
    if cfg == "sky":
        from zenith.renderer import Atmosphere

        scene = dataclasses.replace(scene, skybox=None)
        scene.atmosphere = Atmosphere()
    if cfg == "decals":
        from zenith.renderer.decal import Decal

        scene.decals.append(Decal(
            name="splat0", position=(0.0, -20.0, 0.1),
            size=(22.0, 22.0, 4.0), color=(0.9, 0.25, 0.2, 0.85),
        ))
        scene.decals.append(Decal(
            name="splat1", position=(18.0, 0.0, 0.1),
            size=(14.0, 14.0, 4.0), color=(0.2, 0.4, 0.9, 0.7),
        ))

    renderer = DeferredRenderer(scene)
    if cfg == "film":
        from zenith.renderer import FilmEffects

        post = PostProcess(film=FilmEffects(
            chromatic_aberration=2.5, sharpen=0.4, grain=0.035
        ))
    else:
        post = PostProcess()
    ssr = fog = flare = None
    if cfg == "ssr":
        from zenith.renderer import ScreenSpaceReflections

        ssr = ScreenSpaceReflections()
    if cfg == "fog":
        from zenith.renderer import VolumetricFog

        fog = VolumetricFog()
    if cfg == "flare":
        from zenith.renderer import LensFlare

        flare = LensFlare()

    cam = make_camera()
    builder = RenderGraphBuilder()
    hdr = builder.create(TextureDesc.color("hdr", W, H, Format.RGBA32F))
    out = builder.create(TextureDesc.color("ldr", W, H, Format.RGBA32F))
    builder.export(out)
    renderer.render_to(builder, hdr, cam, W, H)
    post_in = hdr
    if ssr is not None:
        ssr_out = builder.create(
            TextureDesc.color("ssr", W, H, Format.RGBA32F))
        ssr.render_to(builder, post_in, ssr_out, cam,
                      renderer.gbuffer_handles)
        post_in = ssr_out
    if fog is not None:
        fog_out = builder.create(
            TextureDesc.color("fog", W, H, Format.RGBA32F))
        fog.render_to(builder, post_in, fog_out, cam,
                      renderer.gbuffer_handles, sun=scene.sun)
        post_in = fog_out
    if flare is not None:
        for k, v in flare.sun_dynamics(cam, scene.sun.direction).items():
            builder.set_dynamic(k, v)
        flare.render_to(builder, post_in, sun_color=(1.0, 0.92, 0.8))
    post.render_to(builder, post_in, out)
    compiled = builder.build().compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    return np.asarray(
        encode_present(compiled.value(out), Format.RGBA8_SRGB)
    )


@pytest.mark.parametrize("cfg", CONFIGS)
def test_feature_matches_golden(cfg):
    path = GOLDEN_DIR / f"feat_{cfg}_128x64.npy"
    img = _render(cfg)
    if os.environ.get("ZENITH_REGEN_GOLDEN"):
        np.save(path, img)
    assert path.exists(), (
        f"golden missing — regenerate: ZENITH_REGEN_GOLDEN=1 "
        f"pytest {__file__}::test_feature_matches_golden"
    )
    golden = np.load(path)
    diff = np.abs(img.astype(np.int16) - golden.astype(np.int16))
    assert diff.max() <= 1, f"{cfg} golden drift: max LSB diff {diff.max()}"
    assert (diff > 0).mean() < 0.01, f"{cfg}: {100 * (diff > 0).mean():.2f}% changed"


def test_feature_goldens_differ_from_base():
    """Each feature golden must actually differ from the base render —
    a golden that equals base pins nothing."""
    base = _render_base()
    for cfg in CONFIGS:
        path = GOLDEN_DIR / f"feat_{cfg}_128x64.npy"
        if not path.exists():
            pytest.skip("goldens not generated yet")
        golden = np.load(path)
        assert (golden != base).any(), f"{cfg} golden identical to base"


def _render_base() -> np.ndarray:
    # Same scene, no feature: the differ-from-base reference.
    from test_renderers import H, OPTS, W, build_test_scene, make_camera

    from zenith.renderer import DeferredRenderer, PostProcess
    from zenith.rendergraph import RenderGraphBuilder
    from zenith.rhi import (
        Format, PipelineCache, RhiCore, TextureDesc, encode_present,
    )
    from zenith.sandbox.scene import sky_cube_texture

    device = RhiCore().create_render_device()
    scene = build_test_scene(device, num_lights=8)
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
    return np.asarray(
        encode_present(compiled.value(out), Format.RGBA8_SRGB)
    )
