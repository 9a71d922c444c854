"""The ``diff3dhpe`` operator namespace: the kernel wrappers that the eval
paths call (B1 ``fused_transformer_block``, B2 ``fused_temporal_block_cols``
and the attention dispatcher ``fused_grand_attention``) as ``torch.library``
operators, so that ``torch.export`` traces an eval step through them
(``io.export``) as JAX's export serializes its kernels as custom calls.

Each operator takes flat tensors, floats and ints, and has three
implementations: a fake one (the output's shape, dtype and strides, for
tracing), a CPU one (the kernel's plain version) and a CUDA one (the
kernel, counted on its wrapper's ``.launches``). The Python wrappers keep
their signatures, checks, counters and autograd refusal, and call the
operator.
"""
from __future__ import annotations

import torch

NAMESPACE = "diff3dhpe"
LIB = torch.library.Library(NAMESPACE, "DEF")


def register(schema: str, cpu, cuda, fake):
    """Defines ``diff3dhpe::<name>`` by its schema, with its CPU, CUDA and
    fake implementations; returns the operator."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
