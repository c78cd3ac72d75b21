"""Post-processing chain: bloom + tonemap (BASELINE.md config #5).

Pure dense image ops — exactly what XLA eats for breakfast. Declared as one
lambda node reading the HDR scene color and writing the LDR output:

- bright-pass → 2× downsample → separable 9-tap gaussian (two 1-D convs —
  matmul-friendly) → upsample → additive bloom;
- ACES filmic tonemap (Narkowicz approximation) → linear LDR (the swapchain
  present encode applies the sRGB transfer).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from zenith.rendergraph import RenderGraphBuilder
from zenith.rhi.formats import Format, encode_present
from zenith.rendergraph.resource import RenderGraphResource

_GAUSS9 = np.array(
    [0.0162162, 0.0540541, 0.1216216, 0.1945946, 0.2270270,
     0.1945946, 0.1216216, 0.0540541, 0.0162162],
    np.float32,
)


def _blur_axis(img: jnp.ndarray, axis: int) -> jnp.ndarray:
    """9-tap separable gaussian along one axis (edge-clamped)."""
    out = jnp.zeros_like(img)
    for i, w in enumerate(_GAUSS9):
        shift = i - 4
        rolled = jnp.roll(img, shift, axis=axis)
        out = out + rolled * w
    return out


def _downsample2(img: jnp.ndarray) -> jnp.ndarray:
    h, w = img.shape[0] & ~1, img.shape[1] & ~1
    x = img[:h, :w]
    return x.reshape(h // 2, 2, w // 2, 2, -1).mean(axis=(1, 3))


def _upsample2(img: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    up = jnp.repeat(jnp.repeat(img, 2, axis=0), 2, axis=1)
    # Odd targets: 2x-repeat of floor(n/2) rows yields n-1 — edge-pad the
    # short side (1080p mip chains hit odd heights: 1080→540→270→135→67).
    pad_h = max(0, h - up.shape[0])
    pad_w = max(0, w - up.shape[1])
    if pad_h or pad_w:
        up = jnp.pad(up, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
    return up[:h, :w]


class ColorGrade:
    """Gather-free color grading (no 3D LUT: trilinear LUT lookups are 8
    gathers/pixel, while these analytic
    knobs cover the common grade and fuse into the tonemap for free).

    The knobs pack into a (7,) float32 DYNAMIC, so live-tweaking a grade
    never recompiles the frame program.

    - ``exposure_ev``: pre-tonemap exposure in stops.
    - ``contrast``: log-space contrast around the 0.18 mid-gray pivot.
    - ``saturation``: post-tonemap, around Rec.709 luma.
    - ``temperature``/``tint``: white balance (warm/cool, green/magenta)
      as per-channel linear gains.
    - ``vignette``: corner darkening strength (smooth radial falloff).
    """

    def __init__(self, exposure_ev: float = 0.0, contrast: float = 1.0,
                 saturation: float = 1.0, temperature: float = 0.0,
                 tint: float = 0.0, vignette: float = 0.0):
        self.exposure_ev = float(exposure_ev)
        self.contrast = float(contrast)
        self.saturation = float(saturation)
        self.temperature = float(temperature)
        self.tint = float(tint)
        self.vignette = float(vignette)

    def pack(self) -> np.ndarray:
        return np.asarray(
            [self.exposure_ev, self.contrast, self.saturation,
             self.temperature, self.tint, self.vignette, 0.0],
            np.float32,
        )

    def __zenith_capture_key__(self):
        # Values ride the packed dynamic; only EXISTENCE is trace-shaping.
        return ("ColorGrade",)


class FilmEffects:
    """Lens/film finishing: chromatic aberration + CAS-style sharpen +
    animated film grain, applied after the tonemap (and FXAA) in that
    order — the classic end-of-chain "filmic look" bundle GPU engines put
    in the tonemapper pass.

    All VALUES ride one packed (5,) dynamic ("post.film"), so tuning any
    knob — or the grain's per-frame seed — never recompiles. Only CA's
    ENABLEMENT is trace-shaping: on, it costs two bilinear fetches per
    pixel (8 gathers — R and B resampled at radially scaled coordinates)
    and routes the SPMD post node through the gather-full path (its
    displacement can exceed the bloom halo); off, the trace skips the
    gathers entirely. Sharpen is a gather-free 4-neighbor unsharp mask;
    grain is the SSAO-style integer-coordinate hash (global rows, so SPMD
    bands dither identically) remixed by a per-frame seed.

    - ``chromatic_aberration``: max per-channel displacement at the image
      corner, in pixels.
    - ``sharpen``: unsharp-mask amount (0.3-0.8 is CAS-like).
    - ``grain``: noise amplitude in LDR units (0.02-0.06 is filmic).
    - ``grain_response``: how much grain fades in highlights (0 = flat).
    """

    def __init__(self, chromatic_aberration: float = 0.0,
                 sharpen: float = 0.0, grain: float = 0.0,
                 grain_response: float = 0.8):
        self.chromatic_aberration = float(chromatic_aberration)
        self.sharpen = float(sharpen)
        self.grain = float(grain)
        self.grain_response = float(grain_response)
        self._seed = 0

    def pack(self) -> np.ndarray:
        """The per-frame dynamic; advances the grain seed (each frame's
        noise is a fresh decorrelated field, like a real film stock)."""
        self._seed = (self._seed + 1) % 4096
        return np.asarray(
            [self.chromatic_aberration, self.sharpen, self.grain,
             float(self._seed), self.grain_response],
            np.float32,
        )

    def __zenith_capture_key__(self):
        # Values ride the dynamic; CA enablement shapes the trace.
        return ("FilmEffects", self.chromatic_aberration > 0.0)


def _bilinear_plane(plane: jnp.ndarray, sy: jnp.ndarray,
                    sx: jnp.ndarray) -> jnp.ndarray:
    """Bilinear fetch of a (H, W) plane at float coords (4 gathers)."""
    h, w = plane.shape
    x0 = jnp.clip(jnp.floor(sx).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(sy).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(sx - x0.astype(jnp.float32), 0.0, 1.0)
    fy = jnp.clip(sy - y0.astype(jnp.float32), 0.0, 1.0)
    flat = plane.reshape(-1)

    def gather(yy, xx):
        return jnp.take(flat, (yy * w + xx).reshape(-1), axis=0).reshape(
            plane.shape
        )

    p00 = gather(y0, x0)
    p01 = gather(y0, x0 + 1)
    p10 = gather(y0 + 1, x0)
    p11 = gather(y0 + 1, x0 + 1)
    return (p00 * (1 - fx) + p01 * fx) * (1 - fy) \
        + (p10 * (1 - fx) + p11 * fx) * fy


def apply_film(mapped: jnp.ndarray, f: jnp.ndarray, ca_enabled: bool,
               row0=0, full_h: "int | None" = None) -> jnp.ndarray:
    """The FilmEffects chain on tonemapped LDR rgb. ``f`` is the packed
    (5,) vector. With ``ca_enabled`` the input must be the FULL surface
    (the radial resample reaches across row bands). ``row0``/``full_h``
    are the band contract shared with apply_grade_post: ``row0`` seeds the
    grain hash with GLOBAL rows; ``full_h`` is accepted for symmetry (the
    grain needs only row0 — nothing here depends on the surface height)."""
    h, w = mapped.shape[0], mapped.shape[1]
    if ca_enabled:
        # Lateral CA: R sampled outward, B inward, scaled about the image
        # center with a quadratic radial profile.
        ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h * 2.0 - 1.0
        xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w * 2.0 - 1.0
        py = jnp.broadcast_to(ys[:, None], (h, w))
        px = jnp.broadcast_to(xs[None, :], (h, w))
        r2 = px * px + py * py
        # f[0] px at the corner (r2 = 2): scale s.t. the corner pixel's
        # displacement magnitude is f[0].
        k = f[0] / float(np.hypot(w, h))
        scale = k * r2
        cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
        ix = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
        iy = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
        rx, ry = ix - cx, iy - cy
        r = _bilinear_plane(mapped[..., 0], iy + ry * scale, ix + rx * scale)
        b = _bilinear_plane(mapped[..., 2], iy - ry * scale, ix - rx * scale)
        mapped = jnp.stack([r, mapped[..., 1], b], axis=-1)
    # CAS-style sharpen: gather-free 4-neighbor unsharp mask.
    blur = 0.25 * (
        jnp.roll(mapped, 1, axis=0) + jnp.roll(mapped, -1, axis=0)
        + jnp.roll(mapped, 1, axis=1) + jnp.roll(mapped, -1, axis=1)
    )
    mapped = jnp.clip(mapped + f[1] * (mapped - blur), 0.0, 1.0)
    # Film grain: the shared screen-dither hash over GLOBAL rows, remixed
    # by the per-frame seed, attenuated in highlights by grain_response.
    from zenith.ops.ssao import _pixel_hash_bits

    bits = _pixel_hash_bits(
        h, w, jnp.asarray(row0, jnp.int32).astype(jnp.uint32),
        seed=f[3].astype(jnp.uint32),
    )
    noise = bits.astype(jnp.float32) / 65535.0 - 0.5
    lw = jnp.asarray([0.2126, 0.7152, 0.0722], jnp.float32)
    luma = jnp.sum(mapped * lw, axis=-1)
    amp = f[2] * (1.0 - f[4] * jnp.clip(luma, 0.0, 1.0))
    return jnp.clip(mapped + (noise * amp)[..., None], 0.0, 1.0)


def apply_grade_pre(rgb: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Pre-tonemap half of the grade: exposure, white balance, contrast
    (linear HDR in/out). ``g`` is the packed (7,) vector."""
    rgb = rgb * jnp.exp2(g[0])
    # White balance: temperature tilts r/b, tint tilts g (small-signal
    # linear gains, normalized to keep mid-gray luma roughly fixed).
    t, ti = g[3], g[4]
    gains = jnp.stack([1.0 + 0.25 * t, 1.0 + 0.25 * ti, 1.0 - 0.25 * t])
    lw = jnp.asarray([0.2126, 0.7152, 0.0722], jnp.float32)
    gains = gains / jnp.maximum(jnp.sum(gains * lw), 1e-4)
    rgb = rgb * gains
    # Log-space contrast around mid-gray 0.18.
    pivot = 0.18
    safe = jnp.maximum(rgb, 1e-6)
    rgb = jnp.where(
        rgb > 0.0,
        jnp.exp2((jnp.log2(safe) - np.log2(pivot)) * g[1] + np.log2(pivot)),
        rgb,
    )
    return rgb


def apply_grade_post(mapped: jnp.ndarray, g: jnp.ndarray,
                     row0=0, full_h: "int | None" = None) -> jnp.ndarray:
    """Post-tonemap half: saturation + vignette (LDR in/out). Under SPMD
    row bands the vignette needs GLOBAL rows: pass the band's first global
    row (traced ok) and the full surface height."""
    lw = jnp.asarray([0.2126, 0.7152, 0.0722], jnp.float32)
    luma = jnp.sum(mapped * lw, axis=-1, keepdims=True)
    mapped = luma + (mapped - luma) * g[2]
    h, w = mapped.shape[0], mapped.shape[1]
    if full_h is None:
        full_h = h
    ys = (row0 + jnp.arange(h, dtype=jnp.float32) + 0.5) / full_h * 2.0 - 1.0
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w * 2.0 - 1.0
    r2 = (ys * ys)[:, None] + (xs * xs)[None, :]
    fall = 1.0 - g[5] * jnp.clip(r2 * 0.5, 0.0, 1.0) ** 1.5
    return jnp.clip(mapped * fall[..., None], 0.0, 1.0)


def aces_tonemap(x: jnp.ndarray) -> jnp.ndarray:
    """Narkowicz ACES filmic approximation (linear HDR → linear LDR)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def reinhard_tonemap(x: jnp.ndarray) -> jnp.ndarray:
    return x / (1.0 + x)


def tone_and_bloom(
    hdr: jnp.ndarray,  # (H, W, 4) linear HDR
    bloom_threshold: float = 1.0,
    bloom_strength: float = 0.35,
    tonemap: str = "aces",
    fxaa: bool = False,
    exposure=None,  # traced scalar (auto-exposure) | None
    grade=None,  # packed (7,) ColorGrade vector (traced) | None
    film=None,  # packed (5,) FilmEffects vector (traced) | None
    film_ca: bool = False,  # CA enabled (requires the FULL surface)
    row0=0,  # global first row (SPMD bands; vignette coordinates)
    full_h: "int | None" = None,
) -> jnp.ndarray:
    rgb = hdr[..., :3]
    if exposure is not None:
        rgb = rgb * exposure
    if grade is not None:
        rgb = apply_grade_pre(rgb, grade)
    h, w = rgb.shape[0], rgb.shape[1]

    luma = jnp.sum(rgb * jnp.asarray([0.2126, 0.7152, 0.0722]), axis=-1,
                   keepdims=True)
    bright = rgb * jnp.maximum(luma - bloom_threshold, 0.0) / jnp.maximum(
        luma, 1e-4
    )
    half = _downsample2(bright)
    half = _blur_axis(_blur_axis(half, 0), 1)
    half = _blur_axis(_blur_axis(half, 0), 1)  # wider kernel via 2 passes
    bloom = _upsample2(half, h, w)

    combined = rgb + bloom * bloom_strength
    mapped = aces_tonemap(combined) if tonemap == "aces" else reinhard_tonemap(combined)
    if grade is not None:
        mapped = apply_grade_post(mapped, grade, row0=row0, full_h=full_h)
    if fxaa:
        from zenith.ops.aa import post_aa

        mapped = post_aa(mapped)
    if film is not None:
        mapped = apply_film(mapped, film, film_ca, row0=row0)
    return jnp.concatenate([mapped, hdr[..., 3:4]], axis=-1)


# Cross-band reach of the bloom chain in full-res rows: one 2× downsample,
# then two 9-tap passes (radius 4 each) at half res = 8 half-rows.
BLOOM_HALO = 16


def tone_and_bloom_banded(
    hdr_band: jnp.ndarray,  # (bh, W, 4) this device's row band
    axis_name: str,
    bloom_threshold: float = 1.0,
    bloom_strength: float = 0.35,
    tonemap: str = "aces",
    fxaa: bool = False,
    exposure=None,
    grade=None,
    film=None,
) -> jnp.ndarray:
    """SPMD row-banded tone_and_bloom: ring halo exchange (ppermute) extends
    the band by BLOOM_HALO rows each side, the full chain runs on the
    extended band, and the result crops back — bit-exact with the
    single-device output (the halo wraps at the frame edges exactly like
    jnp.roll does; the FXAA pass reaches 1 row, well inside the halo).
    Requires an even band height ≥ BLOOM_HALO."""
    from zenith.parallel.sharding import halo_exchange_rows

    bh = hdr_band.shape[0]
    assert bh % 2 == 0 and bh >= BLOOM_HALO, (
        f"banded bloom needs an even band height >= {BLOOM_HALO}, got {bh}"
    )
    import jax

    ext = halo_exchange_rows(hdr_band, axis_name, BLOOM_HALO)
    n = jax.lax.psum(1, axis_name)
    row0 = jax.lax.axis_index(axis_name) * bh - BLOOM_HALO
    out = tone_and_bloom(
        ext,
        bloom_threshold=bloom_threshold,
        bloom_strength=bloom_strength,
        tonemap=tonemap,
        fxaa=fxaa,
        exposure=exposure,
        grade=grade,
        film=film,  # CA routes through the gather-full path, never here
        film_ca=False,
        row0=row0,
        full_h=bh * n,
    )
    return out[BLOOM_HALO:BLOOM_HALO + bh]


class PostProcess:
    """Declares the post node(s): HDR color in → LDR swapchain image out.

    Two bloom implementations:

    - default (``bloom_mips=0``): single lambda node, one half-res blur —
      the round-1 design, cheapest host-side.
    - ``bloom_mips=N`` (N ≥ 2): a REAL downsampled mip chain through
      render-to-mip sub-resource writes (texture.rs:536-559): bright-pass
      into mip 0 of a graph-managed mip texture, then N-1 downsample+blur
      nodes each writing mip k from mip k-1, then an upsample-accumulate
      walk back to mip 0 — the standard production bloom (wide, stable
      highlights from the coarse levels). All nodes trace into the ONE
      jitted frame program like everything else.
    """

    def __init__(self, bloom_threshold: float = 1.0, bloom_strength: float = 0.35,
                 tonemap: str = "aces", bloom_mips: int = 0,
                 fxaa: bool = False, auto_exposure: bool = False,
                 exposure_key: float = 0.18, adapt_speed: float = 1.5,
                 exposure_min: float = 0.05, exposure_max: float = 16.0,
                 grade: "ColorGrade | None" = None,
                 film: "FilmEffects | None" = None):
        self.bloom_threshold = bloom_threshold
        self.bloom_strength = bloom_strength
        self.tonemap = tonemap
        self.bloom_mips = bloom_mips
        # FXAA-class post AA on the tonemapped output (ops.aa.post_aa) —
        # the deferred path's anti-aliasing story (its G-buffer can't MSAA
        # economically; forward mode has real MSAA instead).
        self.fxaa = fxaa
        # Auto-exposure (eye adaptation): log-average scene luminance drives
        # a temporally smoothed exposure multiplier applied before bloom +
        # tonemap. The adapted value lives on DEVICE and rides the engine's
        # feedback path (request_output → on_frame_outputs → feedback()):
        # the frame program exports a (1,) buffer, the app hands it back as
        # next frame's "post.ae_prev" dynamic — no host readback, one cached
        # program for every frame (a "post.ae_valid" scalar gates frame 0).
        self.auto_exposure = auto_exposure
        self.exposure_key = float(exposure_key)
        self.adapt_speed = float(adapt_speed)
        self.exposure_min = float(exposure_min)
        self.exposure_max = float(exposure_max)
        self._ae_state = None  # (1,) jax.Array from last frame's feedback
        self._dt = 1.0 / 60.0
        self.exposure_out = None  # graph handle, set per render_to
        # Color grading (ColorGrade): knobs ride a packed dynamic — mutate
        # self.grade's fields (or swap the object) and the next frame picks
        # the values up without recompiling.
        self.grade = grade
        # Film effects (FilmEffects): CA + sharpen + grain after the
        # tonemap; values ride a packed dynamic like the grade.
        self.film = film

    def __zenith_capture_key__(self):
        """Structure-key identity: the trace-shaping config only. The
        per-frame state (_ae_state, _dt) rides dynamics — keying it here
        would recompile every frame (None → array on frame 1)."""
        return (
            "PostProcess", self.bloom_threshold, self.bloom_strength,
            self.tonemap, self.bloom_mips, self.fxaa, self.auto_exposure,
            self.exposure_key, self.adapt_speed, self.exposure_min,
            self.exposure_max, self.grade is not None,
            None if self.film is None else self.film.__zenith_capture_key__(),
        )

    # -- auto-exposure cross-frame state -----------------------------------

    def set_delta_time(self, dt: float) -> None:
        """Frame delta for the adaptation rate (call from app.tick)."""
        self._dt = max(float(dt), 1e-4)

    def feedback(self, exposure) -> None:
        """Engine feedback: this frame's adapted exposure → next frame."""
        self._ae_state = exposure

    def frame_dynamics(self) -> dict:
        """Retained-mode per-frame values (merge into update_dynamics)."""
        if not self.auto_exposure:
            d = {}
            if self.grade is not None:
                d["post.grade"] = self.grade.pack()
            if self.film is not None:
                d["post.film"] = self.film.pack()
            return d
        d = {
            "post.ae_dt": np.float32(self._dt),
            "post.ae_valid": np.float32(
                0.0 if self._ae_state is None else 1.0
            ),
        }
        if self._ae_state is not None:
            d["post.ae_prev"] = self._ae_state
        if self.grade is not None:
            d["post.grade"] = self.grade.pack()
        if self.film is not None:
            d["post.film"] = self.film.pack()
        return d

    def _declare_ae(self, builder: RenderGraphBuilder):
        """Dynamics + the exported (1,) state buffer for auto-exposure."""
        from zenith.rhi.resource import BufferDesc

        prev = (
            self._ae_state if self._ae_state is not None
            else jnp.ones((1,), jnp.float32)
        )
        builder.set_dynamic("post.ae_prev", prev)
        builder.set_dynamic("post.ae_dt", np.float32(self._dt))
        builder.set_dynamic("post.ae_valid", np.float32(
            0.0 if self._ae_state is None else 1.0
        ))
        ae = builder.create(BufferDesc.storage("post.ae", (1,)))
        builder.export(ae)
        self.exposure_out = ae
        return ae

    def _adapted_exposure(self, ctx, rgb: jnp.ndarray) -> jnp.ndarray:
        """Traced scalar: exposure adapted toward key/avg-luminance.
        ``rgb`` may be a row band under SPMD — the log-average is pmean'd
        over the mesh axis so every band adapts identically."""
        luma = jnp.sum(rgb * jnp.asarray([0.2126, 0.7152, 0.0722]), axis=-1)
        log_avg = jnp.mean(jnp.log(luma + 1e-4))
        if ctx.sharded and ctx.num_shards > 1:
            import jax

            log_avg = jax.lax.pmean(log_avg, ctx.shard_axis)
        target = jnp.clip(
            self.exposure_key / jnp.maximum(jnp.exp(log_avg), 1e-4),
            self.exposure_min, self.exposure_max,
        )
        prev = ctx.dynamic("post.ae_prev")[0]
        k = 1.0 - jnp.exp(-ctx.dynamic("post.ae_dt") * self.adapt_speed)
        return jnp.where(
            ctx.dynamic("post.ae_valid") > 0.0,
            prev + (target - prev) * k,
            target,
        )

    def render_to(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
    ) -> None:
        if self.bloom_mips >= 2:
            self._render_mip_chain(builder, hdr_input, output)
            return
        self._render_single_node(builder, hdr_input, output)

    def _render_mip_chain(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
    ) -> None:
        from zenith.rhi.resource import TextureDesc as _TD

        storage = builder.resources[hdr_input.id]
        tdesc = storage.texture_desc()
        assert tdesc is not None, "post input must be a texture"
        h, w = tdesc.height, tdesc.width
        n_mips = self.bloom_mips
        assert min(h, w) >> n_mips >= 1, (
            f"bloom_mips={n_mips} too deep for {w}x{h}"
        )
        chain = builder.create(_TD(
            "bloom.chain", w, h, tdesc.format, mip_levels=n_mips + 1
        ))

        # Node: bright-pass into mip 0 (+ the adapted-exposure scalar, which
        # scales the scene BEFORE thresholding so bloom tracks adaptation).
        ae = self._declare_ae(builder) if self.auto_exposure else None
        if self.grade is not None:
            builder.set_dynamic("post.grade", self.grade.pack())
        if self.film is not None:
            builder.set_dynamic("post.film", self.film.pack())
        has_grade = self.grade is not None
        has_film = self.film is not None
        film_ca = has_film and self.film.chromatic_aberration > 0.0
        node = builder.add_lambda_node("post.bright")
        src = node.read(hdr_input)
        dst0 = node.write(chain, mip=0)
        ae_w = node.write(ae) if ae is not None else None
        threshold = self.bloom_threshold

        def record_bright(ctx):
            assert not (ctx.sharded and ctx.num_shards > 1), (
                "bloom_mips >= 2 (the render-to-mip chain) is single-chip; "
                "use the default single-node bloom under an SPMD mesh"
            )
            rgb = ctx.get(src)[..., :3]
            if ae_w is not None:
                exposure = self._adapted_exposure(ctx, rgb)
                ctx.set(ae_w, exposure[None])
                rgb = rgb * exposure
            luma = jnp.sum(
                rgb * jnp.asarray([0.2126, 0.7152, 0.0722]), axis=-1,
                keepdims=True,
            )
            bright = rgb * jnp.maximum(luma - threshold, 0.0) / jnp.maximum(
                luma, 1e-4
            )
            ctx.set(dst0, jnp.concatenate(
                [bright, jnp.zeros_like(bright[..., :1])], axis=-1
            ))

        node.execute(record_bright)

        # Downsample+blur cascade: mip k-1 → mip k.
        for k in range(1, n_mips + 1):
            node = builder.add_lambda_node(f"post.down{k}")
            src_k = node.read(chain, mip=k - 1)
            dst_k = node.write(chain, mip=k)

            def record_down(ctx, src_k=src_k, dst_k=dst_k):
                img = _downsample2(ctx.get(src_k))
                ctx.set(dst_k, _blur_axis(_blur_axis(img, 0), 1))

            node.execute(record_down)

        # Upsample-accumulate + tonemap combine.
        node = builder.add_lambda_node("post.combine")
        hdr_in = node.read(hdr_input)
        mip_reads = [node.read(chain, mip=k) for k in range(n_mips + 1)]
        ae_r = node.read(ae) if ae is not None else None
        dst = node.write(output)
        strength = self.bloom_strength
        tonemap = self.tonemap
        fxaa = self.fxaa

        def record_combine(ctx):
            hdr = ctx.get(hdr_in)
            grade_vec = ctx.dynamic("post.grade") if has_grade else None
            if ae_r is not None:
                exposure = ctx.get(ae_r)[0]
                hdr = jnp.concatenate(
                    [hdr[..., :3] * exposure, hdr[..., 3:4]], axis=-1
                )
            if grade_vec is not None:
                # Grade around the tonemap; the bloom chain itself sees
                # exposure only (single-node path grades before the
                # bright pass too — a documented small divergence).
                hdr = jnp.concatenate(
                    [apply_grade_pre(hdr[..., :3], grade_vec),
                     hdr[..., 3:4]], axis=-1
                )
            # Coarse→fine accumulation (each level upsampled into the next).
            acc = ctx.get(mip_reads[-1])[..., :3]
            for k in range(n_mips - 1, -1, -1):
                lvl = ctx.get(mip_reads[k])[..., :3]
                acc = lvl + _upsample2(acc, lvl.shape[0], lvl.shape[1])
            bloom = _upsample2(acc, hdr.shape[0], hdr.shape[1]) \
                if acc.shape[:2] != hdr.shape[:2] else acc
            combined = hdr[..., :3] + bloom * (strength / (n_mips + 1))
            mapped = (
                aces_tonemap(combined) if tonemap == "aces"
                else reinhard_tonemap(combined)
            )
            if grade_vec is not None:
                mapped = apply_grade_post(mapped, grade_vec)
            if fxaa:
                from zenith.ops.aa import post_aa

                mapped = post_aa(mapped)
            if has_film:
                mapped = apply_film(mapped, ctx.dynamic("post.film"), film_ca)
            ctx.set(dst, jnp.concatenate([mapped, hdr[..., 3:4]], axis=-1))

        node.execute(record_combine)

    def _render_single_node(
        self,
        builder: RenderGraphBuilder,
        hdr_input: RenderGraphResource,
        output: RenderGraphResource,
    ) -> None:
        ae = self._declare_ae(builder) if self.auto_exposure else None
        if self.grade is not None:
            builder.set_dynamic("post.grade", self.grade.pack())
        if self.film is not None:
            builder.set_dynamic("post.film", self.film.pack())
        has_grade = self.grade is not None
        has_film = self.film is not None
        film_ca = has_film and self.film.chromatic_aberration > 0.0
        node = builder.add_lambda_node("post")
        src = node.read(hdr_input)
        dst = node.write(output)
        ae_w = node.write(ae) if ae is not None else None
        kwargs = dict(
            bloom_threshold=self.bloom_threshold,
            bloom_strength=self.bloom_strength,
            tonemap=self.tonemap,
            fxaa=self.fxaa,
        )

        def record(ctx):
            hdr = ctx.get(src)
            banded = ctx.sharded and ctx.num_shards > 1
            exposure = None
            grade_vec = ctx.dynamic("post.grade") if has_grade else None
            film_vec = ctx.dynamic("post.film") if has_film else None
            if ae_w is not None:
                exposure = self._adapted_exposure(ctx, hdr[..., :3])
                ctx.set(ae_w, exposure[None])
            if banded and not film_ca and hdr.shape[0] >= BLOOM_HALO \
                    and hdr.shape[0] % 2 == 0:
                # Row-banded under a mesh: halo-exchange instead of the
                # row-local contract (bloom's blur crosses band boundaries).
                out = tone_and_bloom_banded(hdr, ctx.shard_axis,
                                            exposure=exposure,
                                            grade=grade_vec, film=film_vec,
                                            **kwargs)
            elif banded:
                # Bands thinner than the halo (or odd), or chromatic
                # aberration (whose radial reach exceeds the halo): gather
                # the whole surface, compute, slice back.
                import jax

                full = tone_and_bloom(ctx.get_full(src), exposure=exposure,
                                      grade=grade_vec, film=film_vec,
                                      film_ca=film_ca, **kwargs)
                y0 = jax.lax.axis_index(ctx.shard_axis) * hdr.shape[0]
                out = jax.lax.dynamic_slice_in_dim(full, y0, hdr.shape[0], 0)
            else:
                out = tone_and_bloom(hdr, exposure=exposure, grade=grade_vec,
                                     film=film_vec, film_ca=film_ca, **kwargs)
            ctx.set(dst, out)

        node.execute(record)


class PresentEncode:
    """Folds the swapchain present encode (linear → sRGB swapchain format)
    into the frame program as a lambda node — one dispatch per frame instead
    of a second jit call at present time (reference analog: the display
    engine's scanout conversion; here encode_present, formats.py).

    The output texture must be created with the swapchain's at-rest format
    (e.g. Format.BGRA8_SRGB). Swapchain.present detects pre-encoded uint8
    frames and skips its own encode.
    """

    def __init__(self, fmt=None):
        self.format = fmt if fmt is not None else Format.BGRA8_SRGB

    def render_to(
        self,
        builder: RenderGraphBuilder,
        linear_input: RenderGraphResource,
        output: RenderGraphResource,
    ) -> None:
        node = builder.add_lambda_node("present.encode")
        src = node.read(linear_input)
        dst = node.write(output)
        fmt = self.format

        def record(ctx):
            ctx.set(dst, encode_present(ctx.get(src), fmt))

        node.execute(record)
