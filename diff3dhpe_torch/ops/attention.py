"""GRAND-modified multi-head attention: out = softmax(q kᵀ · scale) v − v.

The identity subtraction of the GRAND graph-diffusion term (reference:
common/nets/model_conditional_diffusion_mixste_s2s_grand_linLift.py:82-83)
is algebraically (attn @ v) − v, so no [N, N] identity is materialised.
Port of ``diff3dhpe_tpu/ops/attention.py``:

- ``grand_attention``: plain PyTorch, any shape;
- ``grand_attention_fullseq`` (B3, port of ``grand_attention_pallas_3d``),
  ``grand_attention_bwd`` (B4, port of ``grand_attention_bwd_pallas``) and
  ``packed_grand_attention`` (B6, port of ``packed_grand_attention``, the
  forward for many small groups): the kernels of
  ``csrc/grand_attention.cu`` for CUDA tensors, each with a plain version
  (``*_ref``) that runs for CPU tensors;
- ``fused_grand_attention``: the dispatcher over [B, H, N, D];
- ``grand_attention_trainable``: the same function with the hand-written
  backward, a ``torch.autograd.Function`` (JAX's custom VJP).

The kernels take head_dim 64 and n <= 256 (B6: n <= 64) and read their
operands through strides (unit stride on the head dim), so views of a qkv
projection go in without a copy.
"""
from __future__ import annotations

import ctypes

import torch

# n at or below which the dispatcher sends a group to B6 and the trainable
# backward stays on the plain formulas (JAX ops/attention.py:240, :401-402).
SMALL_N = 64


def grand_attention(q, k, v, scale=None):
    """q, k, v: [..., N, head_dim] -> [..., N, head_dim] in the input dtype.

    The softmax runs in float32 whatever the activation dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(attn, v) - v


grand_attention_fullseq_ref = grand_attention  # the plain version of B3
packed_grand_attention_ref = grand_attention   # and of B6


def grand_attention_bwd_ref(q, k, v, do, scale=None):
    """(dq, dk, dv) of ``grand_attention`` given the output gradient ``do``:
    the port of JAX's ``_grand_attention_bwd_xla`` (P recomputed)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float() * scale, dim=-1)
    dp = torch.matmul(do, v.transpose(-1, -2)).float()
    dsum = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - dsum) * scale).to(q.dtype)
    pq = p.to(q.dtype)
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dv = torch.matmul(pq.transpose(-1, -2), do) - do
    return dq, dk, dv


def grand_attention_fullseq(q, k, v, scale=None):
    """B3: GRAND attention on q, k, v [G, N, D] (or [B, H, N, D]).

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (``grand_attention_fullseq.launches`` counts launches) or raises."""
    if q.device.type == "cpu":
        return grand_attention_fullseq_ref(q, k, v, scale)
    q4, k4, v4 = (_as4d(t) for t in (q, k, v))
    out = _empty_like_heads(q4)
    _launch_fwd(q4, k4, v4, out, scale)
    return out.view(q.shape) if q.ndim == 3 else out


grand_attention_fullseq.launches = 0


def packed_grand_attention(q, k, v, scale=None):
    """B6: GRAND attention for many small groups, q, k, v [G, N, D] (or
    [B, H, N, D]) with N <= 64.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (``packed_grand_attention.launches`` counts launches) or raises. The
    name is JAX's, whose kernel packs groups into one tile of its matrix
    unit; this kernel gives each (group, head) a warp and packs nothing."""
    if q.shape[-2] > SMALL_N:
        raise ValueError(f"packed_grand_attention takes n <= {SMALL_N}, got n {q.shape[-2]}")
    if q.device.type == "cpu":
        return packed_grand_attention_ref(q, k, v, scale)
    q4, k4, v4 = (_as4d(t) for t in (q, k, v))
    out = _empty_like_heads(q4)
    _launch_fwd(q4, k4, v4, out, scale, small=True)
    return out.view(q.shape) if q.ndim == 3 else out


packed_grand_attention.launches = 0


def fused_grand_attention(q, k, v, scale=None):
    """q, k, v [B, H, N, D] -> [B, H, N, D]: N <= 64 through B6, larger N
    through B3.

    JAX's dispatcher keeps N <= 64 on its plain formulas, because its
    packed kernel needs a relayout of [G, 17, 64] into 119-row tiles first
    (ops/attention.py:240-246). B6 reads the qkv projection through strides
    and needs none, so the port sends small N to its kernel."""
    if q.shape[-2] <= SMALL_N:
        return packed_grand_attention(q, k, v, scale)
    return grand_attention_fullseq(q, k, v, scale)


def grand_attention_bwd(q, k, v, do, scale=None):
    """B4: (dq, dk, dv) of GRAND attention on [G, N, D] (or [B, H, N, D])
    operands, given the output gradient ``do``.

    A CPU tensor runs the plain version. A CUDA tensor launches the two
    kernels of the backward (``grand_attention_bwd.launches`` counts them)
    or raises."""
    if q.device.type == "cpu":
        return grand_attention_bwd_ref(q, k, v, do, scale)
    q4, k4, v4, do4 = (_as4d(t) for t in (q, k, v, do))
    dq, dk, dv = (_empty_like_heads(q4) for _ in range(3))
    _launch_bwd(q4, k4, v4, do4, dq, dk, dv, scale)
    if q.ndim == 3:
        return tuple(t.view(q.shape) for t in (dq, dk, dv))
    return dq, dk, dv


grand_attention_bwd.launches = 0


class _GrandAttentionTrainable(torch.autograd.Function):
    """Port of JAX's ``grand_attention_trainable`` custom VJP: the forward
    through ``fused_grand_attention`` (B6 or B3), the backward through B4
    for N > 64 and through the plain formulas for N <= 64 (JAX ``_gat_bwd``:
    there is no small-N backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return fused_grand_attention(q, k, v)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if q.shape[-2] <= SMALL_N:
            return grand_attention_bwd_ref(q, k, v, do)
        return grand_attention_bwd(q, k, v, do)


def grand_attention_trainable(q, k, v):
    """GRAND attention on [B, H, N, D] with the hand-written backward."""
    return _GrandAttentionTrainable.apply(q, k, v)


def _as4d(t):
    if t.ndim == 3:
        return t.unsqueeze(1)
    if t.ndim != 4:
        raise ValueError(f"expected [G, N, D] or [B, H, N, D], got {tuple(t.shape)}")
    return t


def _empty_like_heads(t):
    """[B, H, N, D] output buffer laid out [B, N, H, D] (what the caller's
    transpose back to rows wants), returned as the [B, H, N, D] view."""
    b, h, n, d = t.shape
    return torch.empty((b, n, h, d), device=t.device, dtype=torch.float32).permute(0, 2, 1, 3)


def _kernel_operand(t, like):
    """t as the kernels read it: f32 on like's device, shaped like ``like``,
    unit stride on the head dim, other strides multiples of 4 floats and a
    16-byte aligned base (copied into that layout where it is not)."""
    if t.dtype != torch.float32 or t.device != like.device or t.shape != like.shape:
        raise ValueError(
            f"attention operands must be float32 on {like.device} with shape "
            f"{tuple(like.shape)}, got {t.dtype} on {t.device} with {tuple(t.shape)}"
        )
    if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        t = t.contiguous()
    return t


def _strides(t):
    return [ctypes.c_longlong(s) for s in t.stride()[:3]]


def _library(q, scale, small=False):
    """The loaded library and the scale, after checking what the kernel
    takes (B6's bound on n with ``small``)."""
    from diff3dhpe_torch.ops._build import load_library

    if q.device.type != "cuda":
        raise ValueError(f"the attention kernels run on cuda, not {q.device}")
    lib = load_library("grand_attention")
    b, h, n, d = q.shape
    max_n = lib.diff3dhpe_grand_small_max_n() if small else lib.diff3dhpe_grand_max_n()
    if d != lib.diff3dhpe_grand_head_dim() or not 0 < n <= max_n:
        raise ValueError(
            f"the CUDA kernel takes head_dim {lib.diff3dhpe_grand_head_dim()} and "
            f"0 < n <= {max_n}, got head_dim {d} and n {n}"
        )
    return lib, d ** -0.5 if scale is None else float(scale)


def _launch_fwd(q, k, v, out, scale, small=False):
    """Launches B3, or B6 with ``small``, and counts it on its wrapper."""
    lib, scale = _library(q, scale, small)
    q, k, v = (_kernel_operand(t, q) for t in (q, k, v))
    b, h, n, _ = q.shape
    wrapper, fn = ((packed_grand_attention, lib.diff3dhpe_grand_attn_small_f32) if small
                   else (grand_attention_fullseq, lib.diff3dhpe_grand_attn_fwd_f32))
    launched = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n,
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            scale, ctypes.byref(launched), torch.cuda.current_stream(q.device).cuda_stream,
        )
    wrapper.launches += launched.value
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel failed: cudaError_t {err}")


def _launch_bwd(q, k, v, do, dq, dk, dv, scale):
    lib, scale = _library(q, scale)
    q, k, v, do = (_kernel_operand(t, q) for t in (q, k, v, do))
    b, h, n, _ = q.shape
    stats = torch.empty((3, b * h * n), device=q.device, dtype=torch.float32)
    launched = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        err = lib.diff3dhpe_grand_attn_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, h, n,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do),
            *_strides(dq), *_strides(dk), *_strides(dv),
            scale, ctypes.byref(launched), torch.cuda.current_stream(q.device).cuda_stream,
        )
    grand_attention_bwd.launches += launched.value
    if err:
        raise RuntimeError(f"grand_attention backward kernels failed: cudaError_t {err}")
