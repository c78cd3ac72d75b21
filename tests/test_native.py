"""Native module tests: build, hash stability, PNG round trip, parity shims."""

import numpy as np
import pytest

from zenith.native import encode_png, fast_hash, native_available


class TestNative:
    def test_builds_on_this_image(self):
        # The baked toolchain has g++ and zlib; the native path must be live.
        assert native_available()

    def test_hash_stable_and_spread(self):
        a = fast_hash(b"hello world")
        assert a == fast_hash(b"hello world")
        assert a != fast_hash(b"hello worle")
        assert fast_hash(b"", seed=1) != fast_hash(b"", seed=2)
        # Long input exercises the 32-byte lane path.
        long = bytes(range(256)) * 33
        assert fast_hash(long) == fast_hash(long)
        assert fast_hash(long) != fast_hash(long[:-1])

    def test_png_roundtrip(self, rng):
        from PIL import Image
        import io

        for c in (3, 4):
            px = rng.integers(0, 256, size=(17, 23, c)).astype(np.uint8)
            data = encode_png(px)
            assert data[:8] == bytes([137, 80, 78, 71, 13, 10, 26, 10])
            back = np.asarray(Image.open(io.BytesIO(data)))
            np.testing.assert_array_equal(back, px)

    @pytest.mark.parametrize("c", [3, 4])
    def test_stdlib_png_fallback_roundtrip(self, rng, c):
        """The no-toolchain PNG writer (zlib + struct) decodes to the same
        pixels, read back with zlib alone."""
        import struct
        import zlib

        from zenith.native import _encode_png_py

        px = rng.integers(0, 256, size=(9, 13, c)).astype(np.uint8)
        data = _encode_png_py(px)
        assert data[:8] == bytes([137, 80, 78, 71, 13, 10, 26, 10])
        pos, chunks = 8, {}
        while pos < len(data):
            (n,) = struct.unpack(">I", data[pos:pos + 4])
            kind = data[pos + 4:pos + 8]
            body = data[pos + 8:pos + 8 + n]
            (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
            assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
            chunks[kind] = body
            pos += 12 + n
        w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
        assert (w, h, depth, ctype) == (13, 9, 8, 6 if c == 4 else 2)
        raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
        raw = raw.reshape(9, 1 + 13 * c)
        assert (raw[:, 0] == 0).all()
        np.testing.assert_array_equal(raw[:, 1:].reshape(9, 13, c), px)


class TestCommandShims:
    def test_upload_pool_batches(self):
        from zenith.rhi import RhiCore
        from zenith.rhi.command import ImmediateCommandEncoder, UploadPool

        device = RhiCore().create_render_device()
        pool = UploadPool(device)
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        b = np.arange(6, dtype=np.int32)
        pool.enqueue_copy("a", a)
        pool.enqueue_copy("b", b)
        out = pool.flush()
        np.testing.assert_array_equal(out["a"].read_back(), a)
        np.testing.assert_array_equal(out["b"].read_back(), b)

        # Immediate submit blocks on outputs.
        import jax.numpy as jnp

        enc = ImmediateCommandEncoder(device)
        result = enc.submit_and_wait(lambda e: e.custom(lambda d: jnp.ones((4,)) * 2))
        np.testing.assert_array_equal(np.asarray(result), 2.0)

    def test_defer_release_stats(self):
        from zenith.rhi import Buffer, BufferDesc
        from zenith.rhi.command import DeferReleaseQueue

        q = DeferReleaseQueue(num_frames=3)
        q.defer(Buffer(BufferDesc("x", (4,))))
        # Two frames later the slot comes around again.
        assert q.begin_frame().buffers == 0
        assert q.begin_frame().buffers == 0
        stats = q.begin_frame()
        assert stats.buffers == 1 and stats.names == ["x"]


class TestVertexDerive:
    def test_derive_and_pack(self):
        from zenith.rhi.derive import vec3, vertex_layout

        @vertex_layout
        class Vertex:
            position: vec3
            color: vec3

        assert Vertex.layout.stride_floats == 6
        vb = Vertex.pack([((0, 0.5, 0), (1, 0, 0)), ((-0.5, -0.5, 0), (0, 1, 0))])
        assert vb.shape == (2, 6)
        fields = Vertex.unpack(vb)
        np.testing.assert_array_equal(fields["color"][0], [1, 0, 0])

    def test_rejects_unknown_type(self):
        from zenith.rhi.derive import vertex_layout

        with pytest.raises(TypeError, match="unsupported"):
            @vertex_layout
            class Bad:
                weird: str


class TestDoctests:
    def test_module_doctests(self):
        """The reference's only tests are two doctests (SURVEY §4); run ours
        (AssetUrl example + the vertex_layout derive example, which also
        pins PEP-563 string-annotation handling)."""
        import doctest

        import zenith.asset as asset_mod
        import zenith.rhi.derive as derive_mod

        for mod in (asset_mod, derive_mod):
            result = doctest.testmod(mod)
            assert result.failed == 0, f"doctest failures in {mod.__name__}"
        assert result.attempted > 0
