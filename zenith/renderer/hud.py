"""Debug HUD overlay: host-rasterized text composited onto the frame.

Every engine ships an on-screen stats overlay (FPS counter, debug lines).
The design: the HOST rasterizes the text into a small
fixed-size alpha bitmap (a 5x7 public-domain-style bitfont, pure NumPy —
text changes are host work measured in microseconds), and that bitmap
rides the frame program as ONE dynamic. The device side is a single
elementwise composite over the HUD's corner region — no gathers, no
per-glyph draws, and changing the text NEVER recompiles (the bitmap is a
dynamic with a fixed shape).

The reference logs its stats line to stderr (zenith/src/main_loop.rs:
146-162); this puts the same line on screen.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from zenith.rendergraph import RenderGraphBuilder
from zenith.rendergraph.resource import RenderGraphResource

# 5x7 bitfont: per printable ASCII char (32..127), 7 rows x 5 bits,
# row-major MSB-left, packed as 7 ints. Derived from the classic public-
# domain 5x7 LCD/terminal glyph shapes (hand-encoded here).
_FONT: "dict[str, tuple[int, ...]]" = {
    " ": (0, 0, 0, 0, 0, 0, 0),
    "!": (0b00100,) * 5 + (0, 0b00100),
    '"': (0b01010, 0b01010, 0, 0, 0, 0, 0),
    "%": (0b11001, 0b11010, 0b00010, 0b00100, 0b01000, 0b01011, 0b10011),
    "'": (0b00100, 0b00100, 0, 0, 0, 0, 0),
    "(": (0b00010, 0b00100, 0b01000, 0b01000, 0b01000, 0b00100, 0b00010),
    ")": (0b01000, 0b00100, 0b00010, 0b00010, 0b00010, 0b00100, 0b01000),
    "+": (0, 0b00100, 0b00100, 0b11111, 0b00100, 0b00100, 0),
    ",": (0, 0, 0, 0, 0, 0b00100, 0b01000),
    "-": (0, 0, 0, 0b11111, 0, 0, 0),
    ".": (0, 0, 0, 0, 0, 0b00110, 0b00110),
    "/": (0b00001, 0b00010, 0b00010, 0b00100, 0b01000, 0b01000, 0b10000),
    "0": (0b01110, 0b10001, 0b10011, 0b10101, 0b11001, 0b10001, 0b01110),
    "1": (0b00100, 0b01100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110),
    "2": (0b01110, 0b10001, 0b00001, 0b00110, 0b01000, 0b10000, 0b11111),
    "3": (0b01110, 0b10001, 0b00001, 0b00110, 0b00001, 0b10001, 0b01110),
    "4": (0b00010, 0b00110, 0b01010, 0b10010, 0b11111, 0b00010, 0b00010),
    "5": (0b11111, 0b10000, 0b11110, 0b00001, 0b00001, 0b10001, 0b01110),
    "6": (0b00110, 0b01000, 0b10000, 0b11110, 0b10001, 0b10001, 0b01110),
    "7": (0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b01000, 0b01000),
    "8": (0b01110, 0b10001, 0b10001, 0b01110, 0b10001, 0b10001, 0b01110),
    "9": (0b01110, 0b10001, 0b10001, 0b01111, 0b00001, 0b00010, 0b01100),
    ":": (0, 0b00110, 0b00110, 0, 0b00110, 0b00110, 0),
    "=": (0, 0, 0b11111, 0, 0b11111, 0, 0),
    ">": (0b01000, 0b00100, 0b00010, 0b00001, 0b00010, 0b00100, 0b01000),
    "<": (0b00010, 0b00100, 0b01000, 0b10000, 0b01000, 0b00100, 0b00010),
    "A": (0b01110, 0b10001, 0b10001, 0b11111, 0b10001, 0b10001, 0b10001),
    "B": (0b11110, 0b10001, 0b10001, 0b11110, 0b10001, 0b10001, 0b11110),
    "C": (0b01110, 0b10001, 0b10000, 0b10000, 0b10000, 0b10001, 0b01110),
    "D": (0b11100, 0b10010, 0b10001, 0b10001, 0b10001, 0b10010, 0b11100),
    "E": (0b11111, 0b10000, 0b10000, 0b11110, 0b10000, 0b10000, 0b11111),
    "F": (0b11111, 0b10000, 0b10000, 0b11110, 0b10000, 0b10000, 0b10000),
    "G": (0b01110, 0b10001, 0b10000, 0b10111, 0b10001, 0b10001, 0b01111),
    "H": (0b10001, 0b10001, 0b10001, 0b11111, 0b10001, 0b10001, 0b10001),
    "I": (0b01110, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110),
    "J": (0b00111, 0b00010, 0b00010, 0b00010, 0b00010, 0b10010, 0b01100),
    "K": (0b10001, 0b10010, 0b10100, 0b11000, 0b10100, 0b10010, 0b10001),
    "L": (0b10000, 0b10000, 0b10000, 0b10000, 0b10000, 0b10000, 0b11111),
    "M": (0b10001, 0b11011, 0b10101, 0b10101, 0b10001, 0b10001, 0b10001),
    "N": (0b10001, 0b11001, 0b10101, 0b10011, 0b10001, 0b10001, 0b10001),
    "O": (0b01110, 0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01110),
    "P": (0b11110, 0b10001, 0b10001, 0b11110, 0b10000, 0b10000, 0b10000),
    "Q": (0b01110, 0b10001, 0b10001, 0b10001, 0b10101, 0b10010, 0b01101),
    "R": (0b11110, 0b10001, 0b10001, 0b11110, 0b10100, 0b10010, 0b10001),
    "S": (0b01111, 0b10000, 0b10000, 0b01110, 0b00001, 0b00001, 0b11110),
    "T": (0b11111, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100),
    "U": (0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01110),
    "V": (0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01010, 0b00100),
    "W": (0b10001, 0b10001, 0b10001, 0b10101, 0b10101, 0b10101, 0b01010),
    "X": (0b10001, 0b10001, 0b01010, 0b00100, 0b01010, 0b10001, 0b10001),
    "Y": (0b10001, 0b10001, 0b01010, 0b00100, 0b00100, 0b00100, 0b00100),
    "Z": (0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b10000, 0b11111),
}
GLYPH_W, GLYPH_H = 6, 8  # 5x7 glyph + 1px spacing


class HudOverlay:
    """A fixed-size text overlay line (top-left by default).

    ``max_chars`` bounds the bitmap width (trace-shaping); the text itself
    is a dynamic. ``scale`` integer-upsamples the bitfont on the host
    (2 → 10x14 glyphs at 1080p readability)."""

    def __init__(self, max_chars: int = 48, scale: int = 2,
                 color=(1.0, 1.0, 1.0), background: float = 0.45,
                 margin: int = 8, overflow_indicator: bool = False):
        self.max_chars = int(max_chars)
        self.scale = int(scale)
        self.color = tuple(float(c) for c in color)
        self.background = float(background)
        self.margin = int(margin)
        # In-band bin-overflow telemetry: composites a red bar under the
        # text whose width grows with log2 of the frame's running overflow
        # count (ctx.frame_overflow — the traced scalar already in the
        # frame program). ZERO host reads — the on-screen analog of the reference's perf-hazard warning
        # (graph.rs:383-385). Zero overflow → zero pixels touched.
        self.overflow_indicator = bool(overflow_indicator)
        self._text = ""
        self._bitmap = np.zeros(self.bitmap_shape, np.float32)

    @property
    def bitmap_shape(self) -> "tuple[int, int]":
        return (GLYPH_H * self.scale,
                GLYPH_W * self.scale * self.max_chars)

    def __zenith_capture_key__(self):
        # The text rides a dynamic; geometry/config shape the trace.
        return ("HudOverlay", self.max_chars, self.scale, self.color,
                self.background, self.margin, self.overflow_indicator)

    # -- host side -----------------------------------------------------------

    def set_text(self, text: str) -> None:
        """Host-rasterize ``text`` into the alpha bitmap (cached: setting
        the same string is free)."""
        if text == self._text:
            return
        self._text = text
        self._bitmap = render_text_bitmap(
            text, self.max_chars, self.scale
        )

    def frame_dynamics(self) -> dict:
        return {"hud.bitmap": self._bitmap}

    # -- graph node ----------------------------------------------------------

    def render_to(self, builder: RenderGraphBuilder,
                  target: RenderGraphResource,
                  source: "RenderGraphResource | None" = None) -> None:
        """Composite the overlay into ``target`` (LDR, post-tonemap) in
        place, or — when ``source`` is given — read ``source`` and write
        the composite into ``target`` (copy+overlay: lets a history-
        exporting stage like TAA keep its own clean output while the HUD
        bridges it to the swapchain). Call AFTER PostProcess, BEFORE
        PresentEncode."""
        builder.set_dynamic("hud.bitmap", self._bitmap)
        node = builder.add_lambda_node("hud")
        src = node.read(source if source is not None else target)
        dst = node.write(target)
        bh, bw = self.bitmap_shape
        margin = self.margin
        color = np.asarray(self.color, np.float32)
        bg = self.background
        overflow_indicator = self.overflow_indicator

        def record(ctx):
            import jax

            img = ctx.get(src)
            bitmap = ctx.dynamic("hud.bitmap")  # (bh, bw) alpha in [0,1]
            h, w = img.shape[0], img.shape[1]
            row0 = 0
            if ctx.sharded and ctx.num_shards > 1:
                row0 = jax.lax.axis_index(ctx.shard_axis) * h
            # The overlay's global row window is [margin, margin+bh); this
            # band sees global rows [row0, row0+h). Build the band-local
            # alpha planes by slicing an h-padded bitmap at a traced
            # offset — static shapes, elementwise math, identical sharded
            # or not. dynamic_slice clamps out-of-range starts, which
            # lands fully-outside bands exactly on the zero padding.
            planes = jnp.stack(
                [bitmap, jnp.ones_like(bitmap)], axis=-1
            )  # text alpha + background-box mask
            padded = jnp.pad(planes, ((h, h), (0, 0), (0, 0)))
            start = h + jnp.asarray(row0, jnp.int32) - margin
            band = jax.lax.dynamic_slice(
                padded, (start, jnp.int32(0), jnp.int32(0)), (h, bw, 2)
            )
            if bw >= w:
                band = band[:, :w]
            else:
                x0 = min(margin, w - bw)
                band = jnp.pad(band, ((0, 0), (x0, w - x0 - bw), (0, 0)))
            text_a = band[..., 0:1]
            box_a = band[..., 1:2]
            rgb = img[..., :3] * (1.0 - bg * box_a)  # dim the box
            rgb = rgb * (1.0 - text_a) + color * text_a
            if overflow_indicator:
                # Red bar under the text line: width ∝ log2(overflow).
                # All elementwise; the traced scalar needs no host fetch.
                ovf = ctx.frame_overflow().astype(jnp.float32)
                frac = jnp.clip(jnp.log2(1.0 + ovf) / 24.0, 0.0, 1.0)
                bar_y0 = margin + bh + 2
                bar_h = max(2, bh // 4)
                gy = row0 + jnp.arange(h, dtype=jnp.int32)[:, None]
                gx = jnp.arange(w, dtype=jnp.int32)[None, :]
                bar_w = frac * (w - 2 * margin)
                in_bar = (
                    (gy >= bar_y0) & (gy < bar_y0 + bar_h)
                    & (gx >= margin)
                    & (gx.astype(jnp.float32) < margin + bar_w)
                    & (ovf > 0)
                )
                bar_a = in_bar.astype(jnp.float32)[..., None]
                warn = jnp.asarray([1.0, 0.15, 0.1], jnp.float32)
                rgb = rgb * (1.0 - bar_a) + warn * bar_a
            ctx.set(dst, jnp.concatenate([rgb, img[..., 3:]], axis=-1))

        node.execute(record)


def render_text_bitmap(text: str, max_chars: int, scale: int) -> np.ndarray:
    """Host rasterization: (GLYPH_H*scale, GLYPH_W*scale*max_chars) alpha
    bitmap. Unknown characters render as blank; lowercase maps to the
    uppercase glyphs."""
    bitmap = np.zeros((GLYPH_H, GLYPH_W * max_chars), np.float32)
    for i, ch in enumerate(text[:max_chars]):
        rows = _FONT.get(ch) or _FONT.get(ch.upper())
        if rows is None:
            continue
        for r, bits in enumerate(rows):
            for c in range(5):
                if bits & (1 << (4 - c)):
                    bitmap[r, i * GLYPH_W + c] = 1.0
    if scale > 1:
        bitmap = np.repeat(np.repeat(bitmap, scale, 0), scale, 1)
    return bitmap
