"""Native (C++) runtime helpers with pure-Python fallbacks.

Builds native.cpp into libzenith_native.so with g++ on first use (cached
beside the source), loads it via ctypes, and exposes:

- ``fast_hash(data, seed=0) -> int`` — 64-bit content hash (the render
  graph's per-frame structure key; foldhash analog).
- ``encode_png(pixels) -> bytes`` — RGB/RGBA8 PNG encoding for frame dumps
  (the `image` crate analog).

Fallbacks (hashlib blake2b / a zlib+struct PNG writer) keep everything
working where a C++ toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "native.cpp"
_SO = Path(__file__).parent / "libzenith_native.so"
_lib: "Optional[ctypes.CDLL]" = None
_tried = False


def _load() -> "Optional[ctypes.CDLL]":
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", str(_SRC),
                 "-o", str(_SO), "-lz"],
                check=True,
                capture_output=True,
                timeout=120,
            )
        lib = ctypes.CDLL(str(_SO))
        lib.zn_hash64.restype = ctypes.c_uint64
        lib.zn_hash64.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64]
        lib.zn_png_bound.restype = ctypes.c_size_t
        lib.zn_png_bound.argtypes = [ctypes.c_uint32] * 3
        lib.zn_encode_png.restype = ctypes.c_size_t
        lib.zn_encode_png.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        _lib = lib
        logger.debug("zenith native module loaded: %s", _SO)
    except Exception as e:  # toolchain missing etc. → fallbacks
        logger.info("zenith native module unavailable (%s); using fallbacks", e)
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def fast_hash(data: bytes, seed: int = 0) -> int:
    lib = _load()
    if lib is not None:
        return int(lib.zn_hash64(data, len(data), seed & 0xFFFFFFFFFFFFFFFF))
    import hashlib

    h = hashlib.blake2b(data, digest_size=8, key=seed.to_bytes(8, "little"))
    return int.from_bytes(h.digest(), "little")


def encode_png(pixels: np.ndarray) -> bytes:
    """Encode (H, W, 3|4) uint8 pixels to PNG bytes."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    assert pixels.ndim == 3 and pixels.shape[2] in (3, 4), pixels.shape
    h, w, c = pixels.shape
    lib = _load()
    if lib is not None:
        cap = lib.zn_png_bound(w, h, c)
        out = ctypes.create_string_buffer(cap)
        n = lib.zn_encode_png(
            pixels.tobytes(), w, h, c, out, cap
        )
        if n:
            return out.raw[:n]
    return _encode_png_py(pixels)


def _encode_png_py(pixels: np.ndarray) -> bytes:
    """Stdlib PNG writer: 8-bit RGB/RGBA, filter 0 on every row, one zlib
    IDAT chunk."""
    import struct
    import zlib

    h, w, c = pixels.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), pixels.reshape(h, w * c)], axis=1
    )
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))
