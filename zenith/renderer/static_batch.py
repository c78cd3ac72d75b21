"""Static scene batching: N plain draws' geometry rides TWO imported buffers.

Rationale. The reference binds one vertex/index buffer per draw
at near-zero CPU cost (vkCmdBindIndexBuffer into a command buffer,
zenith-rendergraph/src/graph.rs draw recording). Here every per-object
buffer costs per-frame Python on the REBUILD path — an import, a node
read, and a structure-key entry each (~5 µs/object/frame adds up: the
64-object scene spent ~40% of its host frame on per-object bookkeeping).
Concatenating the static geometry ONCE collapses that to O(1) imports per
node; each record slices its draw's `(voff, vcount, ioff, icount)` range
at trace time (static offsets — XLA slices fuse into the vertex stage, so
the device-side work per draw is unchanged).

Indices stay UNREBASED: a record pairs `vb[voff:voff+vcount]` with its
original index values, so the draw is bit-identical to the per-object
path.

The cache keys on the identity of every participating Buffer and holds
strong references to them — ids are only unique among live objects
(CPython recycles freed slots), so an id key alone could false-hit after
an app swaps an object's buffers (the `point_light_arrays` lesson,
renderer/scene.py). Replacing any object's vertex/index buffer (e.g. via
asset hot-reload) therefore rebuilds the concatenation automatically on
the next frame.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from zenith.rhi.resource import Buffer, BufferDesc, BufferUsage


class StaticGeometry:
    """Concatenated vertex/index buffers + per-draw ranges.

    ``ranges[k] = (voff, vcount, ioff, icount)`` for the k-th batched
    object (in the index order the cache was queried with).
    """

    __slots__ = ("vb", "ib", "ranges", "_ck")

    def __init__(self, vb: Buffer, ib: Buffer,
                 ranges: "Tuple[Tuple[int, int, int, int], ...]"):
        self.vb = vb
        self.ib = ib
        self.ranges = ranges
        # Capture-key protocol (rendergraph.graph._capture_key): the only
        # trace-shaping content is the range table (slice offsets baked
        # into the trace); buffer CONTENTS ride as program arguments via
        # import_resource, so they must not key the frame program. A flat
        # int tuple hashes at C speed — returning the nested ranges would
        # make the per-frame capture walk O(N) again.
        flat: List[int] = []
        for r in ranges:
            flat.extend(r)
        self._ck = ("cap-static-geo", vb.desc.shape[1], tuple(flat))

    def __zenith_capture_key__(self) -> tuple:
        return self._ck


class StaticGeometryCache:
    """Per-renderer memo: rebuilt only when the participating buffers
    change identity (object list edits, hot-reload buffer swaps)."""

    __slots__ = ("_key", "_geo", "_refs")

    def __init__(self) -> None:
        self._key: Optional[tuple] = None
        self._geo: Optional[StaticGeometry] = None
        self._refs: list = []

    def get(self, objects, ixs: "List[int]") -> Optional[StaticGeometry]:
        """StaticGeometry for ``[objects[i] for i in ixs]``, or None when
        batching does not apply (fewer than 2 draws, or non-uniform
        vertex layouts)."""
        if len(ixs) < 2:
            return None
        key = tuple(
            (i, id(objects[i].vertex_buffer), id(objects[i].index_buffer))
            for i in ixs
        )
        if self._key == key:
            return self._geo
        vbs = [objects[i].vertex_buffer for i in ixs]
        ibs = [objects[i].index_buffer for i in ixs]
        stride = vbs[0].desc.shape[1]
        if any(
            len(vb.desc.shape) != 2 or vb.desc.shape[1] != stride
            or vb.desc.dtype != vbs[0].desc.dtype
            or ib.desc.dtype != ibs[0].desc.dtype
            for vb, ib in zip(vbs, ibs)
        ):
            return None  # mixed layouts: fall back to per-object buffers
        import jax.numpy as jnp

        ranges: List[Tuple[int, int, int, int]] = []
        vo = io = 0
        for vb, ib in zip(vbs, ibs):
            vc, ic = vb.desc.shape[0], ib.desc.shape[0]
            ranges.append((vo, vc, io, ic))
            vo += vc
            io += ic
        mega_vb = Buffer(
            BufferDesc("scene.static.vb", (vo, stride), vbs[0].desc.dtype,
                       BufferUsage.VERTEX),
            jnp.concatenate([b.array for b in vbs], axis=0),
        )
        mega_ib = Buffer(
            BufferDesc("scene.static.ib", (io,), ibs[0].desc.dtype,
                       BufferUsage.INDEX),
            jnp.concatenate([b.array for b in ibs], axis=0),
        )
        geo = StaticGeometry(mega_vb, mega_ib, tuple(ranges))
        self._key = key
        self._geo = geo
        # Strong refs keep the keyed buffers' ids from being recycled
        # while this cache entry lives.
        self._refs = vbs + ibs
        return geo
