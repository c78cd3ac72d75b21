"""Environment lighting — a preintegrated image-based light for the
deferred PBR resolve.

The reference has no environment-lighting system (zenith-renderer only
ships TriangleRenderer, lib.rs:1-40); this supplies the standard split-sum
IBL a full PBR configuration implies, built on ops.ibl:

- diffuse: 9 SH coefficients (host-computed — they ride as a (9, 3)
  dynamic, never touching the device→host path),
- specular: a GGX-prefiltered cube mip chain, computed ONCE on device at
  build (one jitted program per mip) and kept device-resident as a mipped
  cube Texture the render graph imports like any other texture.

Usage::

    env = EnvironmentLight.from_cube_pixels("sky", pixels)  # (6, S, S, C)
    scene.environment = env      # DeferredRenderer picks it up
"""

from __future__ import annotations

import numpy as np

from zenith.ops.ibl import irradiance_sh9_host, prefilter_ggx
from zenith.rhi.formats import Format
from zenith.rhi.resource import Texture, TextureDesc, TextureUsage


class EnvironmentLight:
    """Preintegrated environment: ``texture`` is a mipped cube Texture whose
    level m is the GGX convolution at roughness m/(mips−1) (level 0 = the
    raw environment, also usable as the skybox); ``sh9`` is the (9, 3)
    host-side diffuse irradiance projection."""

    def __init__(self, texture: Texture, sh9):
        self.texture = texture
        # Host environments keep host SH (packed dynamic); DEVICE-captured
        # probes keep a jax.Array — converting it here would force a
        # device→host copy, which permanently degrades async dispatch
        # (PERF.md traps). Both kinds ride set_dynamic unchanged.
        if isinstance(sh9, np.ndarray) or not hasattr(sh9, "devices"):
            sh9 = np.ascontiguousarray(sh9, np.float32)
        self.sh9 = sh9
        assert tuple(self.sh9.shape) == (9, 3), self.sh9.shape

    @property
    def num_mips(self) -> int:
        return self.texture.desc.mip_levels

    @staticmethod
    def from_cube_pixels(
        name: str,
        pixels: np.ndarray,  # (6, S, S, C) linear radiance, host
        num_mips: int = 5,
        samples: int = 64,
        intensity: float = 1.0,
    ) -> "EnvironmentLight":
        pixels = np.asarray(pixels, np.float32)
        assert pixels.ndim == 4 and pixels.shape[0] == 6, pixels.shape
        assert pixels.shape[1] == pixels.shape[2], "cube faces must be square"
        if intensity != 1.0:
            pixels = pixels.copy()
            pixels[..., :3] *= np.float32(intensity)
        sh9 = irradiance_sh9_host(pixels)
        mips = prefilter_ggx(pixels, num_mips=num_mips, samples=samples)
        size = int(pixels.shape[1])
        desc = TextureDesc(
            name, size, size, Format.RGBA32F, TextureUsage.SAMPLED,
            mip_levels=len(mips), array_layers=6,
        )
        tex = Texture(desc, mips[0], mips=list(mips),
                      host_pixels=np.ascontiguousarray(pixels))
        return EnvironmentLight(tex, sh9)

    @staticmethod
    def from_device_cube(
        name: str,
        faces,  # (6, S, S, C) linear radiance, DEVICE-resident jax.Array
        num_mips: int = 5,
        samples: int = 64,
    ) -> "EnvironmentLight":
        """Fully-device preintegration (reflection probes,
        renderer/probe.py): the SH projection and the GGX prefilter both
        run on the device arrays — no host round trip anywhere."""
        import jax.numpy as jnp

        from zenith.ops.ibl import irradiance_sh9

        faces = jnp.asarray(faces)
        assert faces.ndim == 4 and faces.shape[0] == 6, faces.shape
        assert faces.shape[1] == faces.shape[2], "cube faces must be square"
        sh9 = irradiance_sh9(faces)
        mips = prefilter_ggx(faces, num_mips=num_mips, samples=samples)
        size = int(faces.shape[1])
        desc = TextureDesc(
            name, size, size, Format.RGBA32F, TextureUsage.SAMPLED,
            mip_levels=len(mips), array_layers=6,
        )
        tex = Texture(desc, mips[0], mips=list(mips))
        return EnvironmentLight(tex, sh9)

    @staticmethod
    def from_texture(texture: Texture, num_mips: int = 5,
                     samples: int = 64) -> "EnvironmentLight":
        """Preintegrate an existing cube Texture (e.g. a loaded skybox).
        Requires a host pixel copy (Texture.from_numpy_* keeps none for
        layered uploads — prefer ``from_cube_pixels``)."""
        pixels = texture.host_linear()
        return EnvironmentLight.from_cube_pixels(
            f"{texture.desc.name}.env", pixels, num_mips=num_mips,
            samples=samples,
        )
