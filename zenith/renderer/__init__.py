"""Feature renderers (reference zenith-renderer/src/lib.rs:1-3, widened to
the BASELINE.md config ladder: triangle → mesh → shadow+forward → deferred
PBR → post)."""

from zenith.ops.atmosphere import Atmosphere
from zenith.renderer.decal import Decal
from zenith.renderer.deferred import DeferredRenderer, SSAOOptions
from zenith.renderer.dof import DepthOfField
from zenith.renderer.environment import EnvironmentLight
from zenith.renderer.flare import LensFlare
from zenith.renderer.forward import ForwardShadowRenderer
from zenith.renderer.mesh import MeshRenderer
from zenith.renderer.motion_blur import MotionBlur
from zenith.renderer.particles import ParticleSystem
from zenith.renderer.probe import capture_reflection_probe
from zenith.renderer.post import (
    ColorGrade,
    FilmEffects,
    PostProcess,
    PresentEncode,
)
from zenith.renderer.ssr import ScreenSpaceReflections
from zenith.renderer.volumetric import VolumetricFog
from zenith.renderer.taa import TemporalAA
from zenith.renderer.scene import (
    DirectionalLight,
    PointLight,
    Scene,
    SceneObject,
    SpotLight,
)
from zenith.renderer.triangle import TriangleRenderer

__all__ = [
    "Atmosphere",
    "DeferredRenderer",
    "DepthOfField",
    "ColorGrade",
    "DirectionalLight",
    "EnvironmentLight",
    "FilmEffects",
    "ForwardShadowRenderer",
    "LensFlare",
    "MeshRenderer",
    "MotionBlur",
    "ParticleSystem",
    "PointLight",
    "PostProcess",
    "Decal",
    "PresentEncode",
    "capture_reflection_probe",
    "SSAOOptions",
    "Scene",
    "ScreenSpaceReflections",
    "SceneObject",
    "SpotLight",
    "TemporalAA",
    "TriangleRenderer",
    "VolumetricFog",
]
