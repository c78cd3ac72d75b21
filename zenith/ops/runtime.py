"""Platform routing for the rasterizer's Pallas kernels.

Every ``pl.pallas_call`` in ops names its route through this module. The
default device's platform picks it:

- ``"gpu"``: compiled through Triton (``backend="triton"``);
- ``"cpu"``: the Pallas interpreter, which is how the tests run the
  kernels without a card;
- anything else: an error, never a quiet fallback to the interpreter.
"""

from __future__ import annotations

import functools

import jax
from jax.experimental.pallas import triton as plt

TRITON = "triton"


def default_device() -> jax.Device:
    dev = jax.config.jax_default_device
    return dev if dev is not None else jax.devices()[0]


def default_platform() -> str:
    return default_device().platform


def pallas_interpret(platform: "str | None" = None) -> bool:
    """Whether pl.pallas_call runs in interpreter mode on ``platform``
    (default: the default device's): True on the CPU, False on the GPU."""
    platform = default_platform() if platform is None else platform
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"no Pallas route for platform {platform!r}: the kernels compile "
        "for 'gpu' (Triton) and run interpreted on 'cpu' (tests)"
    )


def triton_params(num_warps: int = 4, num_stages: int = 1):
    """Compiler parameters for a Triton-route kernel."""
    return plt.CompilerParams(num_warps=num_warps, num_stages=num_stages)


def highest_precision(fn):
    """Trace ``fn`` under float32 ("highest") matmul precision: the GPU
    would otherwise run float32 products in TF32, which moves clip-space
    positions by ~5e-4 relative (about half a pixel at 1080p)."""

    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return traced


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
