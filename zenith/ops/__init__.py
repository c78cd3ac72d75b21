"""The rasterizer — Pallas/XLA compute kernels.

This package is the replacement for the entire GPU fixed-function pipeline
the reference reaches through Vulkan (SURVEY.md §2.10): vertex transform and
triangle setup (geometry), the coarse rasterizer (binning), the fine
rasterizer + early-Z as a Pallas kernel (raster), attribute
interpolation (shade), the texture sampler (sampling), and the output merger
(blend) — composed per draw call by ``draw``.
"""

from zenith.ops import binning, blend, draw, geometry, raster, runtime, sampling, shade
from zenith.ops.binning import SegmentedBins, TileGrid, bin_segmented
from zenith.ops.blend import apply_color_output, clear_color, clear_depth
from zenith.ops.draw import DEFAULT_BIN_CAPACITY, DrawStats, draw_indexed
from zenith.ops.geometry import (
    TriangleRecords,
    clip_near_w,
    corner_attributes,
    setup_triangles,
    setup_with_attrs,
    transform_vertices,
)
from zenith.ops.raster import raster_segmented, raster_segmented_xla
from zenith.ops.sampling import (
    PackedMips,
    pack_mips,
    sample_2d,
    sample_2d_lod,
    sample_shadow_pcf,
    screen_space_lod,
)
from zenith.ops.shade import finalize_attrs, resolve_varyings

__all__ = [name for name in dir() if not name.startswith("_")]
