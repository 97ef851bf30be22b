"""Matmul precision modes of the JAX package, as the card runs them.

The JAX package names a float32 product's precision "default", "high" or
"highest".  On a TPU, "highest" is an IEEE float32 product, "high" three
bf16 passes and "default" one.  The card's reduced format is TF32 (10
explicit mantissa bits, as against bf16's 7), so the port maps:

* "highest" and ``None``: the IEEE float32 product (the package clears TF32
  at import);
* "default": one TF32 product, as XLA runs both lower modes on a CUDA
  device;
* "high": three TF32 products of the operands split into a TF32 head and
  its remainder, a_hi·b_hi + (a_hi·b_lo + a_lo·b_hi), which keeps about 21
  bits as TPU's three bf16 passes keep about 16.

One TF32 pass is too coarse for the two places the JAX package runs below
"highest" (measured on an H100, ``chip_smoke.py``): the PH solver's lift
loop at 8 × 2304 gave eigenvalues 6.3 off (the sign of the levels near zero
is lost, and the floor guard does not see it), and the polish rotations at
16×16 gave a cheap-anchor bias of 0.25 against 6e-4.  So "high" takes the
three passes and "default" stays the single one.

``matmul_precision`` scopes a mode: inside it, on a CUDA device,
``torch.backends.cuda.matmul.allow_tf32`` is set (torch 2.11 honours this
flag for float32 cuBLAS products; it is the legacy spelling of
``torch.backends.cuda.matmul.fp32_precision`` "tf32" against "ieee"), and
the caller's value comes back on exit, also when the body raises.
``product(precision)`` is the product the body uses for its products at
that precision.  A bfloat16 or float64 product and every product on the CPU
stay as they are, as JAX's lower modes are float32 products on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

#: the JAX precision names a product may ask for
PRECISIONS = ("default", "high", "highest")


def _check(precision) -> None:
    if precision is not None and precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}: expected one of "
                         f"{PRECISIONS} or None")


def _reduced(precision, device) -> bool:
    return (precision in ("default", "high")
            and torch.device(device).type == "cuda")


@contextlib.contextmanager
def matmul_precision(precision, device):
    """Run the body's float32 products on ``device`` at ``precision``:
    TF32 allowed on a CUDA device for "high" and "default", IEEE otherwise.
    Any other name raises ``ValueError``."""
    _check(precision)
    if not _reduced(precision, device):
        yield
        return
    flags = torch.backends.cuda.matmul
    prior = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        yield
    finally:
        flags.allow_tf32 = prior


def tf32_head(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (10 explicit
    mantissa bits): the low 13 bits of each float rounded off."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from three TF32 products of the split operands (call it with
    TF32 allowed): the head products carry 11 bits each, the two cross
    terms the next 11; the remainders' product (about 2⁻²² relative) is
    dropped."""
    a_hi, b_hi = tf32_head(a), tf32_head(b)
    return (a_hi @ (b - b_hi) + (a - a_hi) @ b_hi) + a_hi @ b_hi


def product(precision):
    """The product for ``precision`` inside ``matmul_precision``:
    ``tf32x3_matmul`` for "high" on CUDA float32 operands, else
    ``torch.matmul``."""
    _check(precision)
    if precision != "high":
        return torch.matmul

    def mm(a, b):
        if a.is_cuda and a.dtype == torch.float32:
            return tf32x3_matmul(a, b)
        return torch.matmul(a, b)
    return mm
