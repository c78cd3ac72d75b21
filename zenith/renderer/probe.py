"""Reflection probes: render the scene into a cube map, preintegrate it,
light with it — entirely on device.

Ties three existing subsystems together:

- render-to-cube: six face renders through the normal deferred pipeline
  (one compiled frame program reused for all six faces — the face camera
  is a dynamic);
- IBL preintegration (ops.ibl): SH9 diffuse projection and the GGX
  specular mip chain, both running on the DEVICE arrays the faces come
  back as — the probe never touches the host (no device→host readback);
- EnvironmentLight: the probe drops into ``Scene.environment`` like any
  other environment, so probe-lit objects reflect the actual scene.

Face cameras use the same Vulkan cube-face basis as the omni shadows and
the cube sampler (ops.sampling.cube_direction_to_face_uv), so "render
face k" and "sample by direction" agree by construction — but with the
engine's reverse-Z infinite projection, since these faces go through the
full rasterizer (whose depth states are reverse-Z).
"""

from __future__ import annotations

import numpy as np

from zenith.core import mathtypes as m
from zenith.core.mathtypes import Radians
from zenith.renderer.omni import _FACE_BASIS


class _ProbeCamera:
    """Minimal Camera stand-in for one cube face: precomputed matrices,
    satisfying exactly what DeferredRenderer reads per frame."""

    def __init__(self, face: int, position, near: float = 0.05):
        eye = np.asarray(position, np.float64).reshape(3)
        fwd, ua, va = (np.asarray(v, np.float64) for v in _FACE_BASIS[face])
        # View rows [u; -v; -fwd]: with the engine's flip @ P(90°) this
        # lands pixel (u, v) exactly on the Vulkan face-table direction
        # (ndc_x = (u·d)/(fwd·d), ndc_y = (v·d)/(fwd·d)) — verified by the
        # colored-wall probe test.
        rot = np.stack([ua, -va, -fwd])
        view = np.eye(4)
        view[:3, :3] = rot
        view[:3, 3] = -rot @ eye
        proj = m.perspective_infinite_reverse_rh(
            Radians(np.pi / 2.0), 1.0, near
        ).astype(np.float64)
        rvp = m.VULKAN_Y_FLIP.astype(np.float64) @ proj @ view
        self.render_view_projection = rvp.astype(np.float32)
        self.render_inv_view_projection = np.linalg.inv(rvp).astype(
            np.float32
        )
        self.location = eye.astype(np.float32)
        self.forward = fwd.astype(np.float32)
        self.z_near = float(near)


def capture_reflection_probe(
    device,
    scene,
    position,
    *,
    size: int = 64,
    num_mips: int = 5,
    samples: int = 64,
    shadows: bool = False,
    name: str = "probe",
):
    """Render six faces of ``scene`` from ``position`` and preintegrate
    them into an EnvironmentLight (device-resident; zero host copies).

    One-time cost at prepare; the six faces share one compiled frame
    program (the camera rides dynamics). ``shadows=False`` by default —
    probes are low-frequency; the sun term stays, its shadowing rarely
    survives the GGX convolution."""
    import jax.numpy as jnp

    from zenith.renderer.deferred import DeferredRenderer
    from zenith.renderer.environment import EnvironmentLight
    from zenith.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith.rhi import Format, PipelineCache, TextureDesc

    renderer = DeferredRenderer(scene, shadows=shadows,
                            winding_flip=True)
    cache = PipelineCache()
    # Probe faces are small: shrink the tile so binning stays efficient.
    options = CompileOptions(tile_h=8, tile_w=min(128, size))
    faces = []
    for k in range(6):
        cam = _ProbeCamera(k, position)
        builder = RenderGraphBuilder()
        out = builder.create(
            TextureDesc.color(f"{name}.face", size, size, Format.RGBA32F)
        )
        builder.export(out)
        renderer.render_to(builder, out, cam, size, size)
        compiled = builder.build().compile(device, cache, options)
        compiled.execute(device)
        faces.append(compiled.value(out))
    cube = jnp.stack(faces)
    return EnvironmentLight.from_device_cube(
        name, cube, num_mips=num_mips, samples=samples
    )
