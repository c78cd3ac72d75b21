"""DDS container + BCn block decode (asset.dds).

The vectorized decoders are checked against an independent per-texel
scalar oracle on random blocks, plus hand-crafted blocks with known
answers and full in-memory DDS files (legacy and DX10 headers, mip
chains, cube maps, error paths).
"""

import struct

import numpy as np
import pytest

from zenith.asset.dds import (
    DDSFile,
    decode_bc1,
    decode_bc2,
    decode_bc3,
    decode_bc4,
    decode_bc5,
    parse_dds,
)

# ---------------------------------------------------------------- oracle --


def expand565(v):
    r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
    return ((r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2))


def oracle_color_block(block8, force_four):
    c0, c1 = struct.unpack_from("<HH", block8, 0)
    idx = struct.unpack_from("<I", block8, 4)[0]
    p0, p1 = expand565(c0), expand565(c1)
    if force_four or c0 > c1:
        pal = [
            (*p0, 255), (*p1, 255),
            (*[(2 * a + b + 1) // 3 for a, b in zip(p0, p1)], 255),
            (*[(a + 2 * b + 1) // 3 for a, b in zip(p0, p1)], 255),
        ]
    else:
        pal = [
            (*p0, 255), (*p1, 255),
            (*[(a + b) // 2 for a, b in zip(p0, p1)], 255),
            (0, 0, 0, 0),
        ]
    return [pal[(idx >> (2 * t)) & 3] for t in range(16)]


def oracle_alpha_block(block8):
    a0, a1 = block8[0], block8[1]
    bits = int.from_bytes(bytes(block8[2:8]), "little")
    if a0 > a1:
        pal = [a0, a1] + [((8 - k) * a0 + (k - 1) * a1 + 3) // 7 for k in range(2, 8)]
    else:
        pal = [a0, a1] + [((6 - k) * a0 + (k - 1) * a1 + 2) // 5 for k in range(2, 6)] + [0, 255]
    return [pal[(bits >> (3 * t)) & 7] for t in range(16)]


def texels_to_image(texels, w=4, h=4):
    return np.asarray(texels, np.uint8).reshape(h, w, -1)


# ----------------------------------------------------------------- tests --


class TestBC1:
    def test_flat_color(self):
        red = 0xF800
        block = struct.pack("<HHI", red, red, 0)
        img = decode_bc1(block, 4, 4)
        assert img.shape == (4, 4, 4)
        np.testing.assert_array_equal(img[..., 0], 255)
        np.testing.assert_array_equal(img[..., 1:3], 0)
        np.testing.assert_array_equal(img[..., 3], 255)

    def test_punch_through_alpha(self):
        # c0 <= c1 selects 3-color mode; selector 3 = transparent black.
        block = struct.pack("<HHI", 0x001F, 0xF800, 0xFFFFFFFF)
        img = decode_bc1(block, 4, 4)
        np.testing.assert_array_equal(img, 0)

    def test_matches_oracle_on_random_blocks(self):
        rng = np.random.default_rng(0)
        raw = rng.integers(0, 256, size=(64, 8), dtype=np.uint8).tobytes()
        img = decode_bc1(raw, 32, 32)  # 8x8 blocks
        for bi in range(64):
            block = raw[bi * 8:(bi + 1) * 8]
            expect = texels_to_image(oracle_color_block(block, False))
            by, bx = bi // 8, bi % 8
            np.testing.assert_array_equal(
                img[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4], expect
            )

    def test_non_multiple_of_four_crops(self):
        raw = bytes(8)
        img = decode_bc1(raw, 3, 2)
        assert img.shape == (2, 3, 4)


class TestBC2:
    def test_explicit_alpha_nibbles(self):
        # Alpha nibble t = t (0..15) → replicated to 8 bits.
        alpha = bytes(
            (t | ((t + 1) << 4)) for t in range(0, 16, 2)
        )
        color = struct.pack("<HHI", 0xFFFF, 0x0000, 0)
        img = decode_bc2(alpha + color, 4, 4)
        flat = img[..., 3].reshape(-1)
        expect = np.asarray([t | (t << 4) for t in range(16)], np.uint8)
        np.testing.assert_array_equal(flat, expect)

    def test_color_always_four_mode(self):
        # c0 <= c1 with selector 3 must still be opaque interpolated color.
        color = struct.pack("<HHI", 0x0000, 0xF800, 0xFFFFFFFF)
        img = decode_bc2(bytes(8) + color, 4, 4)
        assert (img[..., 0] > 0).all()  # (0 + 2*red)/3


class TestBC3:
    def test_alpha_eight_mode(self):
        # a0 > a1: 8 interpolated entries.
        sel = 0
        for t in range(16):
            sel |= (t % 8) << (3 * t)
        ab = bytes([210, 10]) + sel.to_bytes(6, "little")
        color = struct.pack("<HHI", 0, 0, 0)
        img = decode_bc3(ab + color, 4, 4)
        got = img[..., 3].reshape(-1)
        expect = np.asarray(oracle_alpha_block(ab), np.uint8)
        np.testing.assert_array_equal(got, expect)

    def test_alpha_six_mode_endpoints(self):
        # a0 <= a1: selectors 6 and 7 are hard 0 and 255.
        sel = 6 | (7 << 3)
        ab = bytes([100, 200]) + sel.to_bytes(6, "little")
        img = decode_bc3(ab + struct.pack("<HHI", 0, 0, 0), 4, 4)
        a = img[..., 3].reshape(-1)
        assert a[0] == 0 and a[1] == 255
        assert (a[2:] == 100).all()  # selector 0 = a0

    def test_matches_oracle_on_random_blocks(self):
        rng = np.random.default_rng(1)
        raw = rng.integers(0, 256, size=(32, 16), dtype=np.uint8).tobytes()
        img = decode_bc3(raw, 16, 32)  # 4x8 blocks
        for bi in range(32):
            block = raw[bi * 16:(bi + 1) * 16]
            rgb = texels_to_image(oracle_color_block(block[8:], True))
            a = np.asarray(oracle_alpha_block(block[:8]), np.uint8).reshape(4, 4)
            by, bx = bi // 4, bi % 4
            tile = img[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
            np.testing.assert_array_equal(tile[..., :3], rgb[..., :3])
            np.testing.assert_array_equal(tile[..., 3], a)


class TestBC45:
    def test_bc4_single_channel(self):
        ab = bytes([50, 40]) + bytes(6)  # sel 0 everywhere → a0
        img = decode_bc4(ab, 4, 4)
        assert img.shape == (4, 4, 1)
        np.testing.assert_array_equal(img[..., 0], 50)

    def test_bc5_two_channels(self):
        r = bytes([11, 10]) + bytes(6)
        g = bytes([222, 10]) + bytes(6)
        img = decode_bc5(r + g, 4, 4)
        assert img.shape == (4, 4, 2)
        np.testing.assert_array_equal(img[..., 0], 11)
        np.testing.assert_array_equal(img[..., 1], 222)


# ------------------------------------------------------------- container --


def make_dds(fourcc: bytes, w, h, mips, payload, caps2=0, dx10=None):
    header = struct.pack(
        "<4sI I II III 11I",
        b"DDS ", 124,
        0x1 | 0x2 | 0x4 | 0x1000,  # caps|height|width|pixelformat
        h, w, 0, 0, mips,
        *([0] * 11),
    )
    pf = struct.pack("<II4s5I", 32, 0x4, fourcc, 0, 0, 0, 0, 0)
    caps = struct.pack("<4I I", 0x1000, caps2, 0, 0, 0)
    out = header + pf + caps
    assert len(out) == 128
    if dx10 is not None:
        out += struct.pack("<5I", *dx10)
    return out + payload


class TestContainer:
    def test_bad_magic(self):
        with pytest.raises(ValueError, match="magic"):
            parse_dds(b"notadds" + bytes(200))

    def test_legacy_dxt5_mip_chain(self):
        rng = np.random.default_rng(2)
        payload = b""
        w, h = 16, 8
        for _ in range(3):
            n = ((w + 3) // 4) * ((h + 3) // 4) * 16
            payload += rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            w, h = max(1, w // 2), max(1, h // 2)
        dds = parse_dds(make_dds(b"DXT5", 16, 8, 3, payload))
        assert dds.mode == "bc3" and dds.srgb and not dds.is_cube
        assert dds.mip_count == 3
        assert dds.faces[0][0].shape == (8, 16, 4)
        assert dds.faces[0][1].shape == (4, 8, 4)
        assert dds.faces[0][2].shape == (2, 4, 4)

    def test_dx10_bc1_srgb(self):
        payload = struct.pack("<HHI", 0xF800, 0, 0) * 4
        raw = make_dds(b"DX10", 8, 8, 1, payload,
                       dx10=(72, 3, 0, 1, 0))  # BC1_UNORM_SRGB
        dds = parse_dds(raw)
        assert dds.mode == "bc1" and dds.srgb
        np.testing.assert_array_equal(dds.faces[0][0][..., 0], 255)

    def test_dx10_bc7_rejected(self):
        raw = make_dds(b"DX10", 4, 4, 1, bytes(16), dx10=(98, 3, 0, 1, 0))
        with pytest.raises(ValueError, match="BC6H/"):
            parse_dds(raw)

    def test_uncompressed_rejected(self):
        header = make_dds(b"\0\0\0\0", 4, 4, 1, bytes(64))
        # Clear the FOURCC flag in the pixel format.
        raw = bytearray(header)
        raw[80:84] = struct.pack("<I", 0x40)  # DDPF_RGB
        with pytest.raises(ValueError, match="uncompressed"):
            parse_dds(bytes(raw))

    def test_truncated_payload(self):
        with pytest.raises(ValueError, match="truncated"):
            parse_dds(make_dds(b"DXT1", 16, 16, 1, bytes(10)))

    def test_cube_six_faces_in_order(self):
        # Six flat-color BC4 faces with values 10,20,...,60.
        payload = b"".join(
            bytes([v, 0]) + bytes(6) for v in (10, 20, 30, 40, 50, 60)
        )
        dds = parse_dds(
            make_dds(b"ATI1", 4, 4, 1, payload, caps2=0x200 | 0xFE00)
        )
        assert dds.is_cube and len(dds.faces) == 6
        for f, v in enumerate((10, 20, 30, 40, 50, 60)):
            np.testing.assert_array_equal(dds.faces[f][0][..., 0], v)


class TestDeviceUpload:
    def test_to_texture_2d_mips(self):
        payload = b""
        w, h = 8, 8
        for _ in range(2):
            n = ((w + 3) // 4) * ((h + 3) // 4) * 8
            payload += struct.pack("<HHI", 0xFFFF, 0, 0) * (n // 8)
            w, h = w // 2, h // 2
        dds = parse_dds(make_dds(b"DXT1", 8, 8, 2, payload))
        tex = dds.to_texture("t")
        assert tex.desc.mip_levels == 2
        assert tex.mips[1].shape == (4, 4, 4)

    def test_to_texture_cube(self):
        payload = (struct.pack("<HHI", 0xF800, 0, 0)) * 6
        dds = parse_dds(
            make_dds(b"DXT1", 4, 4, 1, payload, caps2=0x200 | 0xFE00)
        )
        tex = dds.to_texture("c")
        assert tex.desc.array_layers == 6
        assert tex.array.shape == (6, 4, 4, 4)

    def test_to_texture_asset_formats(self):
        bc4 = parse_dds(make_dds(b"ATI1", 4, 4, 1, bytes(8)))
        bc5 = parse_dds(make_dds(b"ATI2", 4, 4, 1, bytes(16)))
        from zenith.asset.render_types import TextureFormat

        assert bc4.to_texture_asset("a.tex").format == TextureFormat.R8
        assert bc5.to_texture_asset("b.tex").format == TextureFormat.RG8
