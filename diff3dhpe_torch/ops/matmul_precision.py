"""The session matmul precision: ``Config.matmul_precision``.

The JAX package sets ``jax_default_matmul_precision`` from the field
(diff3dhpe_tpu/engine/runner.py:93). On the TPU that setting decides how
every float32 product that names no precision of its own contracts: the
plain module's dense layers, attention and weighted mean, the fast path's
dense layers and head outside the fused kernels, and the float32 operands
of the attention kernels B3, B4 and B6, which pass ``precision=None``
(diff3dhpe_tpu/ops/attention.py:103-117, :277-282). JAX's transpose of
``dot_general`` keeps the precision, so the backward of those products
contracts at it too.

- "highest": exact float32.
- "default" and "bfloat16": the MXU's one bf16 pass. Both float32 operands
  are rounded to bf16 (nearest even), their products are exact, and the
  sums are float32. This is ``ops.fused_block.contract`` at "default".

The fused blocks B1, B2 and B5 pin their own mode (``f32_prec``, JAX's
``_dot_f32``) and do not move with it, and bfloat16 operands contract in
one bf16 pass whatever it is (JAX pins ``Precision.DEFAULT`` for them).

The port keeps no global state for it: the precision travels as the
``matmul_precision`` argument of the functions that contract, from the
``Runner`` down, and its default "highest" computes what the port computed
without it, bit for bit.
"""
from __future__ import annotations

import torch

MATMUL_PRECISIONS = ("highest", "default", "bfloat16")


def check_matmul_precision(matmul_precision):
    """Returns ``matmul_precision``; a ValueError names the field for a
    value other than "highest", "default" or "bfloat16" (JAX's "high" has
    no kernel counterpart there either: Mosaic rejects
    ``Precision.HIGH``)."""
    if matmul_precision not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {MATMUL_PRECISIONS}, "
                         f"got {matmul_precision!r}")
    return matmul_precision


def session_mode(matmul_precision):
    """The float32 contraction mode (``ops.fused_block.F32_MODES``) that
    ``matmul_precision`` gives an f32 product: "highest" or "default"."""
    return "highest" if check_matmul_precision(matmul_precision) == "highest" else "default"


def bf16_round(a):
    """a rounded to bf16 (nearest even), in float32."""
    return a.to(torch.bfloat16).float()


def _sum_to(g, shape):
    """g summed over the dimensions that torch.matmul broadcast to reach it
    from ``shape``."""
    while g.ndim > len(shape):
        g = g.sum(0)
    for i, size in enumerate(shape):
        if size == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _OnePass(torch.autograd.Function):
    """a @ b in one bf16 pass, forward and backward: the gradient products
    round their operands too (JAX's transpose keeps ``precision=None``)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(bf16_round(a), bf16_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = bf16_round(g)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _sum_to(torch.matmul(g, bf16_round(b).transpose(-1, -2)), a.shape)
        if ctx.needs_input_grad[1]:
            gb = _sum_to(torch.matmul(bf16_round(a).transpose(-1, -2), g), b.shape)
        return ga, gb


def matmul(a, b, matmul_precision="highest"):
    """``torch.matmul(a, b)`` at the session precision: float32 operands at
    "default" or "bfloat16" contract in one bf16 pass (its backward too,
    under autograd); "highest", and any operand below float32, is
    ``torch.matmul`` itself."""
    if (session_mode(matmul_precision) == "highest" or a.dtype != torch.float32
            or b.dtype != torch.float32):
        return torch.matmul(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _OnePass.apply(a, b)
    return torch.matmul(bf16_round(a), bf16_round(b))
