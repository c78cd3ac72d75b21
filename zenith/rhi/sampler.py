"""Sampler configuration (reference zenith-rhi/src/sampler.rs:10-142).

A `SamplerConfig` is pure state here — texture sampling is executed by
`zenith.ops.sampling` which interprets this config (filter, mip mode,
address modes, anisotropy, compare-for-shadow). Hashable so it can be part
of pipeline/shader cache keys.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Optional, Tuple

from zenith.rhi.state import CompareOp


class Filter(enum.Enum):
    NEAREST = "nearest"
    LINEAR = "linear"


class MipmapMode(enum.Enum):
    NEAREST = "nearest"
    LINEAR = "linear"


class AddressMode(enum.Enum):
    REPEAT = "repeat"
    MIRRORED_REPEAT = "mirrored_repeat"
    CLAMP_TO_EDGE = "clamp_to_edge"
    CLAMP_TO_BORDER = "clamp_to_border"


class BorderColor(enum.Enum):
    TRANSPARENT_BLACK = (0.0, 0.0, 0.0, 0.0)
    OPAQUE_BLACK = (0.0, 0.0, 0.0, 1.0)
    OPAQUE_WHITE = (1.0, 1.0, 1.0, 1.0)


@dataclass(frozen=True)
class SamplerConfig:
    mag_filter: Filter = Filter.LINEAR
    min_filter: Filter = Filter.LINEAR
    mipmap_mode: MipmapMode = MipmapMode.LINEAR
    address_mode_u: AddressMode = AddressMode.REPEAT
    address_mode_v: AddressMode = AddressMode.REPEAT
    address_mode_w: AddressMode = AddressMode.REPEAT
    mip_lod_bias: float = 0.0
    anisotropy_enable: bool = False
    max_anisotropy: float = 1.0
    compare_enable: bool = False
    compare_op: CompareOp = CompareOp.NEVER
    min_lod: float = 0.0
    max_lod: float = 1000.0
    border_color: BorderColor = BorderColor.TRANSPARENT_BLACK

    # Presets mirroring sampler.rs `linear/nearest/anisotropic`.
    @staticmethod
    def linear() -> "SamplerConfig":
        return SamplerConfig()

    @staticmethod
    def nearest() -> "SamplerConfig":
        return SamplerConfig(
            mag_filter=Filter.NEAREST,
            min_filter=Filter.NEAREST,
            mipmap_mode=MipmapMode.NEAREST,
        )

    @staticmethod
    def anisotropic(max_anisotropy: float = 8.0) -> "SamplerConfig":
        return SamplerConfig(anisotropy_enable=True, max_anisotropy=max_anisotropy)

    @staticmethod
    def shadow_pcf() -> "SamplerConfig":
        """Compare sampler for shadow maps (reverse-Z: GREATER passes lit)."""
        return SamplerConfig(
            address_mode_u=AddressMode.CLAMP_TO_EDGE,
            address_mode_v=AddressMode.CLAMP_TO_EDGE,
            compare_enable=True,
            compare_op=CompareOp.GREATER_OR_EQUAL,
            border_color=BorderColor.OPAQUE_WHITE,
        )

    def clamped(self) -> "SamplerConfig":
        return replace(
            self,
            address_mode_u=AddressMode.CLAMP_TO_EDGE,
            address_mode_v=AddressMode.CLAMP_TO_EDGE,
        )


class Sampler:
    """Named sampler object for binder parity (reference sampler.rs:86-142)."""

    def __init__(self, name: str, config: SamplerConfig):
        self.name = name
        self.config = config
