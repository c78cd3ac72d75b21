"""Texture/attachment formats and sRGB transfer functions.

Mirrors the reference's use of vk::Format (zenith-rhi re-exports ash::vk
wholesale, lib.rs:31; texture.rs:494-505 maps format→aspect). Here, device
pixels live as float channels in **linear** space; `Format` governs channel
count, storage dtype at rest, sRGB encode/decode at the host boundary, and
aspect classification (color vs depth) for the render graph.
"""

from __future__ import annotations

import enum

from zenith.core.collections import FastEnum
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


class FormatAspect(FastEnum):
    COLOR = "color"
    DEPTH = "depth"
    STENCIL = "stencil"


@dataclass(frozen=True)
class FormatInfo:
    channels: int
    storage_dtype: str  # numpy dtype name for host-at-rest representation
    srgb: bool
    aspect: FormatAspect


class Format(FastEnum):
    """Subset of vk::Format the framework speaks (reference swapchain prefers
    B8G8R8A8_SRGB, swapchain.rs:72; assets use R8G8B8A8 variants,
    zenith-asset/src/render.rs:72-108)."""

    R8_UNORM = "r8_unorm"
    RG8_UNORM = "rg8_unorm"
    RGBA8_UNORM = "rgba8_unorm"
    RGBA8_SRGB = "rgba8_srgb"
    BGRA8_SRGB = "bgra8_srgb"
    RGBA16F = "rgba16f"
    RG16F = "rg16f"
    R32F = "r32f"
    RG32F = "rg32f"
    RGBA32F = "rgba32f"
    D32F = "d32f"
    S8 = "s8"  # stencil plane (reference stencil_format, pipeline.rs:27,61)

    @property
    def info(self) -> FormatInfo:
        return _FORMAT_INFO[self]

    @property
    def channels(self) -> int:
        return self.info.channels

    @property
    def is_srgb(self) -> bool:
        return self.info.srgb

    @property
    def is_depth(self) -> bool:
        return self.info.aspect == FormatAspect.DEPTH

    @property
    def is_stencil(self) -> bool:
        return self.info.aspect == FormatAspect.STENCIL

    @property
    def compute_dtype(self) -> jnp.dtype:
        """Dtype used for on-device render work (float32 for color/depth;
        int32 for stencil — 8-bit semantics on a 32-bit plane)."""
        if self.is_stencil:
            return jnp.int32
        return jnp.float32


_FORMAT_INFO = {
    Format.R8_UNORM: FormatInfo(1, "uint8", False, FormatAspect.COLOR),
    Format.RG8_UNORM: FormatInfo(2, "uint8", False, FormatAspect.COLOR),
    Format.RGBA8_UNORM: FormatInfo(4, "uint8", False, FormatAspect.COLOR),
    Format.RGBA8_SRGB: FormatInfo(4, "uint8", True, FormatAspect.COLOR),
    Format.BGRA8_SRGB: FormatInfo(4, "uint8", True, FormatAspect.COLOR),
    Format.RGBA16F: FormatInfo(4, "float16", False, FormatAspect.COLOR),
    Format.RG16F: FormatInfo(2, "float16", False, FormatAspect.COLOR),
    Format.R32F: FormatInfo(1, "float32", False, FormatAspect.COLOR),
    Format.RG32F: FormatInfo(2, "float32", False, FormatAspect.COLOR),
    Format.RGBA32F: FormatInfo(4, "float32", False, FormatAspect.COLOR),
    Format.D32F: FormatInfo(1, "float32", False, FormatAspect.DEPTH),
    Format.S8: FormatInfo(1, "uint8", False, FormatAspect.STENCIL),
}


# ---------------------------------------------------------------------------
# sRGB transfer functions (IEC 61966-2-1), exact piecewise curves — required
# for per-pixel parity with a B8G8R8A8_SRGB Vulkan swapchain.
# ---------------------------------------------------------------------------


def linear_to_srgb(x: jnp.ndarray) -> jnp.ndarray:
    x = jnp.clip(x, 0.0, 1.0)
    return jnp.where(
        x <= 0.0031308,
        x * 12.92,
        1.055 * jnp.power(x, 1.0 / 2.4) - 0.055,
    )


def srgb_to_linear(x: jnp.ndarray) -> jnp.ndarray:
    x = jnp.clip(x, 0.0, 1.0)
    return jnp.where(
        x <= 0.04045,
        x / 12.92,
        jnp.power((x + 0.055) / 1.055, 2.4),
    )


def srgb_to_linear_np(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4).astype(
        np.float32
    )


def encode_present(linear_rgba: jnp.ndarray, fmt: Format) -> jnp.ndarray:
    """Encode a linear float framebuffer to its at-rest representation for
    presentation/readback (the swapchain-store step of the Vulkan pipeline)."""
    info = fmt.info
    if linear_rgba.shape[-1] < info.channels:
        raise ValueError(
            f"framebuffer has {linear_rgba.shape[-1]} channels; present format "
            f"{fmt} needs {info.channels}"
        )
    x = linear_rgba[..., : info.channels]
    if info.storage_dtype == "uint8":
        if info.srgb:
            # Alpha stays linear even in sRGB formats (Vulkan semantics).
            rgb = linear_to_srgb(x[..., :3])
            x = jnp.concatenate([rgb, jnp.clip(x[..., 3:], 0.0, 1.0)], axis=-1) \
                if info.channels == 4 else rgb
        else:
            x = jnp.clip(x, 0.0, 1.0)
        if fmt == Format.BGRA8_SRGB:
            x = x[..., jnp.array([2, 1, 0, 3])]
        return jnp.round(x * 255.0).astype(jnp.uint8)
    return x.astype(jnp.dtype(info.storage_dtype))


def decode_stored(stored: np.ndarray, fmt: Format) -> np.ndarray:
    """Decode an at-rest (host) image to linear float32 — the texture-sample
    decode step. Used when uploading sRGB assets."""
    info = fmt.info
    if info.storage_dtype == "uint8":
        x = stored.astype(np.float32) / 255.0
        if fmt == Format.BGRA8_SRGB:
            x = x[..., [2, 1, 0, 3]]
        if info.srgb:
            rgb = srgb_to_linear_np(x[..., :3])
            if info.channels == 4:
                x = np.concatenate([rgb, x[..., 3:]], axis=-1)
            else:
                x = rgb
        return x.astype(np.float32)
    return stored.astype(np.float32)
