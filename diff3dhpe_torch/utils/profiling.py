"""Cost accounting and tracing: the CLI's ``Params | FLOPs/forward``
printout, the FLOP basis of the benches' MFU, and a profiler context.

The JAX package reads the FLOPs of one forward from XLA's compiled cost
analysis (``diff3dhpe_tpu/utils/profiling.py::flops_of``); PyTorch has no
compiled program to ask, and ``torch.utils.flop_counter`` does not see the
port's own kernels (``ctypes`` calls, not aten operators), so the fused
paths count by formula from the architecture constants
(``denoiser_matmul_flops``, the JAX package's analytic count). ``flops_of``
counts what the counter sees: plain PyTorch code, such as the module.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
from typing import Callable, Optional

import torch

# Dense peaks of the cards the port runs on (NVIDIA data sheets, full power
# limit): float32 outside the tensor cores, bf16 on the tensor cores, and
# device-memory bandwidth. The same table as chip_smoke.py's CARD_PEAKS.
CARD_PEAKS = {  # name fragment -> (f32 FLOP/s, bf16 FLOP/s, bytes/s)
    "H100 PCIe": (51e12, 756e12, 2.0e12),
    "H100 NVL": (60e12, 835e12, 3.9e12),
    "H200": (67e12, 989e12, 4.8e12),
    "H100": (67e12, 989e12, 3.35e12),  # SXM
}


def card_info(device="cuda") -> dict:
    """The card a measurement ran on: its name, its power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them, and its dense
    f32 and bf16 peaks (TFLOP/s) from ``CARD_PEAKS`` (None for a card not
    in the table). A CPU device gives name "cpu" and no limit or peaks."""
    device = torch.device(device)
    if device.type != "cuda":
        return dict(name="cpu", power_limit=None, peak_f32_tflops=None, peak_bf16_tflops=None)
    index = device.index if device.index is not None else torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    smi = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True)
    line = smi.stdout.strip().splitlines()[0]
    peaks = next((v for k, v in CARD_PEAKS.items() if k in name), None)
    return dict(name=name, power_limit=line.rsplit(",", 1)[-1].strip(), nvidia_smi=line,
                peak_f32_tflops=peaks[0] / 1e12 if peaks else None,
                peak_bf16_tflops=peaks[1] / 1e12 if peaks else None)


def param_count(params) -> int:
    """Number of values in a module's parameters or in a state dict."""
    tensors = params.parameters() if isinstance(params, torch.nn.Module) else params.values()
    return sum(t.numel() for t in tensors)


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


def flops_of(fn: Callable, *example_args) -> Optional[float]:
    """FLOPs of one call ``fn(*example_args)`` under autograd-free
    execution, as ``torch.utils.flop_counter.FlopCounterMode`` counts them
    (matrix products, convolutions, attention: the aten operators it has
    formulas for). None where it counts nothing, e.g. a call that runs only
    the port's kernels."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*example_args)
    total = counter.get_total_flops()
    return float(total) if total > 0 else None


def clever_format(value: float) -> str:
    """Human-readable count (reference uses thop.clever_format)."""
    if value is None or value != value:
        return "n/a"
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(value) < 1000:
            return f"{value:.1f}{unit}"
        value /= 1000
    return f"{value:.1f}E"


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` context over the CPU and, where there is one, the
    card; on exit it writes a Chrome trace (``*.pt.trace.json``, viewable
    in TensorBoard's profiler or chrome://tracing) into ``log_dir``. Yields
    the profiler, whose ``key_averages()`` sums the time by operator."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
