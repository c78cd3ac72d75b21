"""Multi-chip SPMD rendering over a jax device mesh.

The reference is single-GPU (SURVEY.md §2.9); this framework scales the
frame across chips with sort-first parallel rendering: the framebuffer is
sharded in row bands over a 1-D mesh axis, geometry processing is replicated
(cheap relative to rasterization), and each chip bins + rasterizes + shades
only its band. The only cross-chip communication is the optional final
gather for presentation — rasterization itself needs none, which is the
ideal interconnect profile.
"""

from zenith.parallel.sharding import (
    ORDER_BACKGROUND,
    composite_depth_planes,
    default_mesh,
    make_row_sharded_frame,
    halo_exchange_rows,
    make_sort_last_frame,
    row_sharding,
)

__all__ = [
    "ORDER_BACKGROUND",
    "composite_depth_planes",
    "default_mesh",
    "make_row_sharded_frame",
    "make_sort_last_frame",
    "halo_exchange_rows",
    "row_sharding",
]
