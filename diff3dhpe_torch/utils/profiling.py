"""Cost accounting for the CLI's ``Params | FLOPs/forward`` printout.

The JAX package reads the FLOPs of one forward from XLA's compiled cost
analysis (``diff3dhpe_tpu/utils/profiling.py::flops_of``); PyTorch has no
compiled program to ask, and ``torch.utils.flop_counter`` does not see the
port's own kernels, so the port counts by formula from the architecture
constants (``denoiser_matmul_flops``, the JAX package's analytic count).
"""
from __future__ import annotations


def denoiser_matmul_flops(
    frames: int,
    joints: int = 17,
    embed: int = 512,
    depth: int = 8,
    mlp_ratio: float = 2.0,
    in_chans: int = 2,
) -> float:
    """Matmul + attention FLOPs of ONE MixSTE denoiser forward on one
    sequence (batch row): each depth level has a spatial and a temporal
    transformer block (four GEMMs and the QKᵀ and AV products each), plus
    the fusion layer and the head. The time MLP (per sample, not per token)
    is left out."""
    tokens = frames * joints
    c = embed
    hidden = int(mlp_ratio * c)
    per_token_gemms = 2 * c * (3 * c) + 2 * c * c + 2 * c * hidden + 2 * hidden * c
    attn = lambda n: 2 * 2 * tokens * n * c  # QKᵀ + AV per token group
    total = tokens * 2 * (in_chans + 3) * c  # fusion layer
    total += depth * (2 * tokens * per_token_gemms + attn(joints) + attn(frames))
    total += tokens * 2 * c * 3  # head
    return float(total)


def clever_format(value: float) -> str:
    """Human-readable count (reference uses thop.clever_format)."""
    if value is None or value != value:
        return "n/a"
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(value) < 1000:
            return f"{value:.1f}{unit}"
        value /= 1000
    return f"{value:.1f}E"
