"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/diff3dhpe_torch/<name>-<hash>.so``
at first use, where the hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one loads from the cache. The libraries
have a plain C interface (no PyTorch headers), so a build takes seconds.
Nothing here runs at import time: this module imports on machines without
nvcc or a GPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "diff3dhpe_torch"
SOURCES = ("fused_block", "grand_attention")
# No --use_fast_math: exact erff/expf/sqrtf are part of the numerics.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes per exported function. Every pointer and the stream go as
# c_void_p: a bare Python int would be passed as a 32-bit int.
SIGNATURES = {
    "fused_block": {
        name: (
            [_P, _P, _I, _P]                   # x, t_rows, rows_per_item, dp
            + [_P, _P, _F]                     # ln1 w, b, eps
            + [_P, _P, _P, _P]                 # qkv w, b; proj w, b
            + [_P, _P, _F]                     # ln2 w, b, eps
            + [_P, _P, _P, _P]                 # fc1 w, b; fc2 w, b
            + [_P, _P, _F]                     # out-LN w, b, eps
            + [_P] * 7                         # xs, xn, qkv, attn, h1, mid, out
            + [_I] * 7 + [_F]                  # R, C, hidden, n, n_pad, j_groups, heads, scale
            + [ctypes.POINTER(_I), _P]         # launches, stream
        )
        for name in ("diff3dhpe_fused_block_f32", "diff3dhpe_fused_block_bf16")
    } | {
        name: (
            [_P, _P, _P, _F]                   # x; ln w, b, eps
            + [_P, _P, _P, _P]                 # qkv w, b; proj w, b
            + [_P] * 4                         # xn, qkv, attn, out
            + [_I] * 4 + [_F]                  # R, C, n, heads, scale
            + [ctypes.POINTER(_I), _P]         # launches, stream
        )
        for name in ("diff3dhpe_fused_attn_block_f32", "diff3dhpe_fused_attn_block_bf16")
    } | {
        "diff3dhpe_attn_head_dim": [],
        "diff3dhpe_attn_max_n": [],
    },
    "grand_attention": {
        "diff3dhpe_grand_attn_fwd_f32": (
            [_P] * 4 + [_I] * 3                # q, k, v, out; B, H, n
            + [_L] * 12                        # (b, h, n) strides of q, k, v, out
            + [_F, ctypes.POINTER(_I), _P]     # scale, launches, stream
        ),
        "diff3dhpe_grand_attn_small_f32": (
            [_P] * 4 + [_I] * 3                # q, k, v, out; B, H, n (n <= 64)
            + [_L] * 12                        # (b, h, n) strides of q, k, v, out
            + [_F, ctypes.POINTER(_I), _P]     # scale, launches, stream
        ),
        "diff3dhpe_grand_attn_bwd_f32": (
            [_P] * 8 + [_I] * 3                # q, k, v, dO, dq, dk, dv, stats; B, H, n
            + [_L] * 21                        # (b, h, n) strides of q, k, v, dO, dq, dk, dv
            + [_F, ctypes.POINTER(_I), _P]     # scale, launches, stream
        ),
        "diff3dhpe_grand_head_dim": [],
        "diff3dhpe_grand_max_n": [],
        "diff3dhpe_grand_small_max_n": [],
    },
}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one nvcc per source, all started
    together. Returns {name: ptxas report} for the sources built now.
    Raises with nvcc's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built first if missing),
    with argtypes and restype set for every exported function."""
    build_all((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib
