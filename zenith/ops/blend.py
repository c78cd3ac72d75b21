"""Output-merger stage: blending + write masks + clears.

Interprets ColorAttachmentDesc (reference pipeline.rs:337-412) on dense
(H, W, 4) linear float images. All of this fuses into the frame program.
"""

from __future__ import annotations

import jax.numpy as jnp

from zenith.rhi.state import BlendFactor, BlendOp, ColorAttachmentDesc


def clear_color(height: int, width: int, value) -> jnp.ndarray:
    v = jnp.asarray(value, dtype=jnp.float32)
    return jnp.broadcast_to(v, (height, width, 4)).astype(jnp.float32)


def clear_depth(height: int, width: int, value: float) -> jnp.ndarray:
    return jnp.full((height, width), value, dtype=jnp.float32)


def _factor(f: BlendFactor, src: jnp.ndarray, dst: jnp.ndarray, constants) -> jnp.ndarray:
    """Blend factor as a broadcastable (H, W, 4) array."""
    ones = jnp.ones_like(src)
    sa = jnp.broadcast_to(src[..., 3:4], src.shape)
    da = jnp.broadcast_to(dst[..., 3:4], dst.shape)
    return {
        BlendFactor.ZERO: lambda: jnp.zeros_like(src),
        BlendFactor.ONE: lambda: ones,
        BlendFactor.SRC_COLOR: lambda: src,
        BlendFactor.ONE_MINUS_SRC_COLOR: lambda: ones - src,
        BlendFactor.DST_COLOR: lambda: dst,
        BlendFactor.ONE_MINUS_DST_COLOR: lambda: ones - dst,
        BlendFactor.SRC_ALPHA: lambda: sa,
        BlendFactor.ONE_MINUS_SRC_ALPHA: lambda: ones - sa,
        BlendFactor.DST_ALPHA: lambda: da,
        BlendFactor.ONE_MINUS_DST_ALPHA: lambda: ones - da,
    }[f]()


def _blend_op(op: BlendOp, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return {
        BlendOp.ADD: lambda: a + b,
        BlendOp.SUBTRACT: lambda: a - b,
        BlendOp.REVERSE_SUBTRACT: lambda: b - a,
        BlendOp.MIN: lambda: jnp.minimum(a, b),
        BlendOp.MAX: lambda: jnp.maximum(a, b),
    }[op]()


def blend_colors(
    dst: jnp.ndarray,  # (..., 4)
    src: jnp.ndarray,  # (..., 4)
    desc: ColorAttachmentDesc,
    blend_constants=(0.0, 0.0, 0.0, 0.0),
) -> jnp.ndarray:
    """The blend equation + static write mask, WITHOUT coverage masking —
    split out so the in-order blend kernel can apply its own per-channel
    2-D select (Mosaic cannot insert a minor dim on a bool mask)."""
    src = src.astype(jnp.float32)
    dst = dst.astype(jnp.float32)
    if desc.blend_enable:
        scf = _factor(desc.src_color_blend, src, dst, blend_constants)
        dcf = _factor(desc.dst_color_blend, src, dst, blend_constants)
        saf = _factor(desc.src_alpha_blend, src, dst, blend_constants)
        daf = _factor(desc.dst_alpha_blend, src, dst, blend_constants)
        rgb = _blend_op(
            desc.color_blend_op,
            src[..., :3] * scf[..., :3],
            dst[..., :3] * dcf[..., :3],
        )
        alpha = _blend_op(
            desc.alpha_blend_op,
            src[..., 3:4] * saf[..., 3:4],
            dst[..., 3:4] * daf[..., 3:4],
        )
        out = jnp.concatenate([rgb, alpha], axis=-1)
    else:
        out = src

    # Write mask applied STATICALLY per channel (desc.write_mask is a
    # Python tuple): no (4,) constant array materializes, which also keeps
    # this body kernel-safe for the in-order blend kernel (Pallas rejects
    # captured non-scalar constants).
    if not all(desc.write_mask):
        out = jnp.concatenate(
            [
                out[..., k:k + 1] if desc.write_mask[k] else dst[..., k:k + 1]
                for k in range(4)
            ],
            axis=-1,
        )
    return out


def apply_color_output(
    dst: jnp.ndarray,  # (H, W, 4) current attachment contents
    src: jnp.ndarray,  # (H, W, 4) fragment shader output (linear)
    mask: jnp.ndarray,  # (H, W) bool coverage
    desc: ColorAttachmentDesc,
    blend_constants=(0.0, 0.0, 0.0, 0.0),
) -> jnp.ndarray:
    """Blend + write-mask covered pixels of src over dst (Vulkan output
    merger semantics, in linear space)."""
    out = blend_colors(dst, src, desc, blend_constants)
    return jnp.where(mask[..., None], out, dst.astype(jnp.float32))
