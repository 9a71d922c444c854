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

A kernel writes into a buffer that autograd does not see, so B3, B6 and the
dispatcher refuse to run where autograd would record them
(``refuse_autograd``), on the CPU too: training goes through
``grand_attention_trainable``, as ``jax.grad`` through JAX's kernels
raises.

The forward kernels (B3, B6) take every head_dim that is a multiple of 8
from 8 to 128 (``takes_head_dim``; compiled for 64 and 128, a narrower
width runs on the next one with its columns past head_dim zero-filled in
shared memory), the backward (B4) head_dim 64 or 128 (``BWD_HEAD_DIMS``),
and all of them n <= ``MAX_N`` keys (B6: n <= 64). They read
their operands through strides (unit stride on the head dim), so views of a
qkv projection go in without a copy. B3 and B6 also take bfloat16 (JAX's
take q's dtype): the tensor-core kernel of ``csrc/grand_attn_bf16.cuh``,
which rounds P to bf16 after the normalisation and the output once, as
``grand_attention_stored`` does. So does B4: the ``wgmma`` backward of
``csrc/grand_attn_bwd_bf16.cuh``, at the rounding points of JAX's Pallas
tile (``grand_attention_bwd_ref``).

At float32 every function here takes the session matmul precision
(``matmul_precision``, ``ops.matmul_precision``), as JAX's kernels and
formulas honour ``jax_default_matmul_precision`` for float32 operands:
"highest" (the default) is exact float32; "default" or "bfloat16" rounds
the operands of every product to bf16 (on the card, B3 and B6 run the
kernels' one-bf16-pass instances, above 32 keys the tensor-core kernel of
``csrc/grand_attn_mode.cuh``, and B4 its ``kDefault`` instances). JAX's
dispatcher sends n <= 64 to its plain formulas, which round the normalised
P at "default"; the port's B6 (and its plain version) rounds the
unnormalised exponentials, as JAX's packed kernel and B3 do.
"""
from __future__ import annotations

import ctypes

import torch

from diff3dhpe_torch.ops._library import register
from diff3dhpe_torch.ops.matmul_precision import matmul, session_mode

# n at or below which the dispatcher sends a group to B6 and the trainable
# backward stays on the plain formulas (JAX ops/attention.py:240, :401-402).
SMALL_N = 64
# The most keys a group every attention kernel takes (B1, B2, B5, B3, B4,
# B6: each keeps a whole score row or pair resident;
# csrc/grand_attn.cuh::kMaxN, which the libraries report as
# diff3dhpe_grand_max_n and diff3dhpe_attn_max_n).
MAX_N = 256
# The forward kernels' head widths, in words (``takes_head_dim``).
HEAD_DIM_RULE = "a multiple of 8 from 8 to 128"
# Head widths the backward kernels (B4) take, at float32 and at bfloat16
# (the library's diff3dhpe_grand_bwd_takes_head_dim).
BWD_HEAD_DIMS = (64, 128)
# The session modes by the index the kernels take (csrc/grand_attn.cuh::F32Mode).
_MODE_INDEX = {"highest": 0, "default": 2}


def takes_head_dim(d: int) -> bool:
    """True for a head width the forward attention kernels take, at every
    dtype and contraction mode (B1, B2, B5, B3, B6): a multiple of 8 from 8
    to 128, as csrc/grand_attn.cuh::takes_head_dim, which the libraries
    export as diff3dhpe_grand_takes_head_dim and
    diff3dhpe_attn_takes_head_dim for the wrappers to ask."""
    return d % 8 == 0 and 8 <= d <= 128


def refuse_autograd(op: str, *tensors,
                    route="grand_attention_trainable (Config.fast_train with fast_train_attn_bwd)"):
    """Raises a RuntimeError where autograd would record ``op``: grad mode
    on and any of ``tensors`` (None is skipped) requiring grad. ``op``
    launches kernels into buffers autograd does not see, so the gradient to
    those inputs would be lost without an error; the plain version that
    stands in for the kernel on a CPU tensor raises the same way, as
    ``jax.grad`` through JAX's kernel does. ``route``: what trains instead."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} has no backward: its kernel would drop the gradient to its inputs. "
            f"Call it under torch.no_grad(), or train through {route}")


def grand_attention(q, k, v, scale=None, matmul_precision="highest", drop=None):
    """q, k, v: [..., N, head_dim] -> [..., N, head_dim] in the input dtype.

    The softmax runs in float32 whatever the activation dtype. Below
    float32 every other step rounds to the input dtype, as JAX's formulas
    are typed, the scale too (a Python float is weakly typed in JAX: a
    constant of the input dtype). At float32 both products contract at
    ``matmul_precision`` (JAX's einsums at the session precision: at
    "default" the normalised P is rounded). ``drop``: a function applied
    to the probabilities in q's dtype before the second product (the
    module's attention dropout, JAX mixste.py:138-144)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.dtype != torch.float32:  # the scale rounded to q's dtype, as a host float
        scale = float(torch.tensor(scale, dtype=q.dtype))
    logits = matmul(q, k.transpose(-1, -2), matmul_precision) * scale
    attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if drop is not None:
        attn = drop(attn)
    return matmul(attn, v, matmul_precision) - v


def grand_attention_stored(q, k, v, scale, rnd, v_self=None, dot=None):
    """GRAND attention in float32 on float32 q, k, v that hold values of a
    storage type, with ``rnd`` rounding to that type where the kernels
    store: P after the normalisation, and the output (P·v − v) once. The
    attention step of the block kernels' plain versions and the plain
    version of B3 at bf16. ``v_self``: the rows subtracted where they are
    not v (B1's pad query rows attend to the real keys only).

    ``dot(a, b)``: a · bᵀ over the last dims, the caller's contraction (as
    JAX ``grand_attend_tile`` takes ``dot``), for the f32 block kernels
    under a contraction mode. With it the normalisation comes after the
    second product, as in JAX's f32 epilogue (ops/attention.py:91-94):
    out = dot(e, vᵀ) · (1 / Σ e) − v with e = exp(s − max s) unnormalised;
    the sum and the − v read the unrounded values."""
    v_self = v if v_self is None else v_self
    if dot is None:
        logits = q @ k.transpose(-1, -2) * scale
        return rnd(rnd(torch.softmax(logits, dim=-1)) @ v - v_self)
    logits = dot(q, k) * scale
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return rnd(dot(e, v.transpose(-1, -2)) * (1.0 / e.sum(dim=-1, keepdim=True)) - v_self)


def grand_attention_fullseq_ref(q, k, v, scale=None, matmul_precision="highest"):
    """The plain version of B3: at float32 ``grand_attention`` under
    "highest", and under "default" JAX's f32 epilogue contracting at one
    bf16 pass (``grand_attention_stored`` with the normalisation after
    P·V: q, k, the unnormalised exponentials and v rounded to bf16); at
    bfloat16 ``grand_attention_stored``, float32 sums of the bf16 operands
    with P and the output rounded to bf16 (JAX ``grand_attend_tile``'s bf16
    branch), whatever ``matmul_precision``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.dtype == torch.float32:
        if session_mode(matmul_precision) == "highest":
            return grand_attention(q, k, v, scale)
        return grand_attention_stored(q, k, v, scale, lambda a: a,
                                      dot=lambda a, b: matmul(a, b.transpose(-1, -2), "default"))
    rnd = lambda a: a.to(q.dtype).float()
    return grand_attention_stored(q.float(), k.float(), v.float(), scale, rnd).to(q.dtype)


# The plain version of B6: B3's, at float32 and at bfloat16 (JAX's packed
# kernel runs the same grand_attend_tile as its full-sequence one).
packed_grand_attention_ref = grand_attention_fullseq_ref


def grand_attention_bwd_xla(q, k, v, do, scale=None, matmul_precision="highest"):
    """(dq, dk, dv) of ``grand_attention`` given the output gradient ``do``:
    the port of JAX's ``_grand_attention_bwd_xla`` (P recomputed), which the
    trainable attention runs for n <= 64. Below float32 every product
    rounds its output to the input dtype, as JAX's einsums are typed (so S,
    dP and Pᵀ·do before the "− do"; B4's tile does not,
    ``grand_attention_bwd_ref``). At float32 every product contracts at
    ``matmul_precision``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mm = lambda a, b: matmul(a, b, matmul_precision)
    p = torch.softmax(mm(q, k.transpose(-1, -2)).float() * scale, dim=-1)
    dp = mm(do, v.transpose(-1, -2)).float()
    dsum = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - dsum) * scale).to(q.dtype)
    pq = p.to(q.dtype)
    dq = mm(ds, k)
    dk = mm(ds.transpose(-1, -2), q)
    dv = mm(pq.transpose(-1, -2), do) - do
    return dq, dk, dv


def grand_attention_bwd_ref(q, k, v, do, scale=None, matmul_precision="highest"):
    """The plain version of B4: (dq, dk, dv) of ``grand_attention`` given
    ``do``, as JAX's Pallas tile ``_grand_attn_bwd_tile`` forms them, P
    recomputed. Every product sums its operands in float32; S, P and dP
    stay float32, dS and P are rounded to q's dtype, dq and dk once at the
    end, and dv = Pᵀ·do − do is subtracted in float32 and rounded once. At
    float32 every product contracts at ``matmul_precision`` (JAX's tile
    passes ``precision=None``); D = Σ P∘dP and the trailing − do read the
    unrounded values."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dt = q.dtype
    mm = lambda a, b: matmul(a, b, matmul_precision if dt == torch.float32 else "highest")
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.softmax(mm(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dp = mm(dof, vf.transpose(-1, -2))
    dsum = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - dsum) * scale).to(dt).float()
    pq = p.to(dt).float()
    return (mm(ds, kf).to(dt), mm(ds.transpose(-1, -2), qf).to(dt),
            (mm(pq.transpose(-1, -2), dof) - dof).to(dt))


def grand_attention_fullseq(q, k, v, scale=None, matmul_precision="highest"):
    """B3: GRAND attention on q, k, v [G, N, D] (or [B, H, N, D]).

    q, k and v are all float32 or all bfloat16 (else ``ValueError``). A CPU
    tensor runs the plain version. A CUDA tensor launches the kernel, the
    CUDA-core one at float32 (under "default" the one-bf16-pass instances:
    above 32 keys the tensor-core kernel of ``csrc/grand_attn_mode.cuh``)
    and the tensor-core one at bfloat16 (``grand_attention_fullseq.launches``
    counts launches) or raises. ``matmul_precision``: the session precision
    of float32 operands (module doc). Under autograd it raises
    (``refuse_autograd``)."""
    _check_dtypes(q, k, v)
    session_mode(matmul_precision)
    refuse_autograd("grand_attention_fullseq", q, k, v)
    if q.device.type == "cpu":
        return grand_attention_fullseq_ref(q, k, v, scale, matmul_precision)
    return _fullseq(q, k, v, scale, matmul_precision=matmul_precision)


grand_attention_fullseq.launches = 0


def _fullseq(q, k, v, scale, stats=None, matmul_precision="highest"):
    """B3 on CUDA tensors; ``stats``: B4's statistics for B3 to fill
    (``_bwd_stats`` at float32, ``_bwd_stats_bf16`` at bfloat16), or None."""
    q4, k4, v4 = (_as4d(t) for t in (q, k, v))
    out = _empty_like_heads(q4)
    _launch_fwd(q4, k4, v4, out, scale, stats=stats, matmul_precision=matmul_precision)
    return out.view(q.shape) if q.ndim == 3 else out


def packed_grand_attention(q, k, v, scale=None, matmul_precision="highest"):
    """B6: GRAND attention for many small groups, q, k, v [G, N, D] (or
    [B, H, N, D]) with N <= 64, all float32 or all bfloat16 (else
    ``ValueError``).

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (``packed_grand_attention.launches`` counts launches, ``.launches_bf16``
    those at bf16) or raises: at float32 the small-group kernel, whose
    persistent blocks walk the (group, head) pairs; at bfloat16 B3's
    tensor-core kernel, which packs the pairs of small groups into a block.
    The name is JAX's, whose kernel packs groups into one tile of its
    matrix unit. ``matmul_precision``: as B3's (under "default" the
    small-group kernel's one-bf16-pass instance up to 32 keys, the
    tensor-core kernel of ``csrc/grand_attn_mode.cuh`` above). Under
    autograd it raises (``refuse_autograd``)."""
    if q.shape[-2] > SMALL_N:
        raise ValueError(f"packed_grand_attention takes n <= {SMALL_N}, got n {q.shape[-2]}")
    _check_dtypes(q, k, v)
    session_mode(matmul_precision)
    refuse_autograd("packed_grand_attention", q, k, v)
    if q.device.type == "cpu":
        return packed_grand_attention_ref(q, k, v, scale, matmul_precision)
    q4, k4, v4 = (_as4d(t) for t in (q, k, v))
    out = _empty_like_heads(q4)
    _launch_fwd(q4, k4, v4, out, scale, small=True, matmul_precision=matmul_precision)
    return out.view(q.shape) if q.ndim == 3 else out


packed_grand_attention.launches = 0
packed_grand_attention.launches_bf16 = 0


def fused_grand_attention(q, k, v, scale=None, matmul_precision="highest"):
    """q, k, v [B, H, N, D] -> [B, H, N, D], float32 or bfloat16: N <= 64
    through B6, larger N through B3, at the session precision
    ``matmul_precision`` (module doc).

    JAX's dispatcher keeps N <= 64 on its plain formulas, because its
    packed kernel needs a relayout of [G, 17, 64] into 119-row tiles first
    (ops/attention.py:240-246). B6 reads the qkv projection through strides
    and needs none, so the port sends small N to its kernel. Under autograd
    it raises (``refuse_autograd``)."""
    _check_dtypes(q, k, v)
    mode = _MODE_INDEX[session_mode(matmul_precision)]
    refuse_autograd("fused_grand_attention", q, k, v)
    return _DISPATCH(q, k, v, None if scale is None else float(scale), mode)


def _dispatch_impl(q, k, v, scale, f32_mode=0):
    """The dispatcher's operator: B6 or B3, their plain versions on the
    CPU, in the layout the kernels write ([B, N, H, D] seen as [B, H, N,
    D]) on both devices; ``f32_mode`` the session mode's index (0,
    "highest", where a call leaves it out: the schema's default, which a
    Python implementation is not handed)."""
    small = q.shape[-2] <= SMALL_N
    prec = "default" if f32_mode else "highest"
    out = (packed_grand_attention if small else grand_attention_fullseq)(q, k, v, scale, prec)
    if q.device.type == "cuda":
        return out
    return _dispatch_fake(q, k, v, scale, f32_mode).copy_(out)


def _dispatch_fake(q, k, v, scale, f32_mode=0):
    out = _empty_like_heads(_as4d(q))
    return out.view(q.shape) if q.ndim == 3 else out


def grand_attention_bwd(q, k, v, do, scale=None, matmul_precision="highest"):
    """B4: (dq, dk, dv) of GRAND attention on [G, N, D] (or [B, H, N, D])
    operands, given the output gradient ``do``; q, k, v and do all float32
    or all bfloat16 (else ``ValueError``), the gradients in their dtype.
    ``matmul_precision``: the session precision of float32 operands
    (module doc).

    A CPU tensor runs the plain version. A CUDA tensor launches the
    kernels of the backward (``grand_attention_bwd.launches`` counts them,
    ``.launches_bf16`` those at bf16) or raises: at float32 under
    "highest" the CUDA-core dq and dk/dv passes; at bfloat16 the dq pass
    (which also forms the rows' softmax statistics) and the dk/dv pass on
    ``wgmma``; at float32 under "default" the same two passes with float32
    outputs, after one kernel that rounds q, k and v (one for each where
    they are not views of one qkv projection) and one that rounds do to
    bf16."""
    _check_dtypes(q, k, v)
    session_mode(matmul_precision)
    if do.dtype != q.dtype:
        raise ValueError(f"do must be {q.dtype} like q, k and v, got {do.dtype}")
    if q.device.type == "cpu":
        return grand_attention_bwd_ref(q, k, v, do, scale, matmul_precision)
    return _bwd(q, k, v, do, scale, matmul_precision=matmul_precision)


def _bwd(q, k, v, do, scale, fwd=None, matmul_precision="highest"):
    """B4 on a CUDA tensor; ``fwd``: what the trainable forward kept, or
    None (``_launch_bwd``)."""
    q4, k4, v4, do4 = (_as4d(t) for t in (q, k, v, do))
    dq, dk, dv = (_empty_like_heads(q4) for _ in range(3))
    _launch_bwd(q4, k4, v4, do4, dq, dk, dv, scale, fwd, matmul_precision)
    if q.ndim == 3:
        return tuple(t.view(q.shape) for t in (dq, dk, dv))
    return dq, dk, dv


grand_attention_bwd.launches = 0
grand_attention_bwd.launches_bf16 = 0


class _GrandAttentionTrainable(torch.autograd.Function):
    """Port of JAX's ``grand_attention_trainable`` custom VJP: the forward
    through ``fused_grand_attention`` (B6 or B3), the backward through B4
    for N > 64 and through the XLA formulas for N <= 64 (JAX ``_gat_bwd``:
    there is no small-N backward kernel), in q's dtype, float32 or bfloat16,
    at the session precision ``matmul_precision``. On CUDA with N > 64, B3
    also keeps each row's softmax statistics, and B4 starts from them: at
    float32 from the max, 1/sum and B3's output instead of recomputing the
    forward (its first sweep); at bfloat16 from −max·scale and 1/sum instead
    of forming them in its dq pass (the same bits either way). Under a
    float32 "default" B4 is the bfloat16 backward's tensor-core passes on
    bf16-rounded copies of q, k, v and do, with float32 gradients, and forms
    the statistics itself: its row sums D = Σ P∘dP take the unrounded P,
    which B3's output, formed from rounded exponentials, does not give, and
    the mode forward's max and 1/sum are not those passes' bits."""

    @staticmethod
    def forward(ctx, q, k, v, matmul_precision):
        ctx.matmul_precision = matmul_precision
        if q.device.type == "cuda" and q.shape[-2] > SMALL_N and q.shape[-1] not in BWD_HEAD_DIMS:
            raise ValueError(f"the CUDA attention backward (B4) takes head_dim {BWD_HEAD_DIMS}, "
                             f"got head_dim {q.shape[-1]} at n {q.shape[-2]} > {SMALL_N}")
        f32 = q.dtype == torch.float32
        keep = not f32 or session_mode(matmul_precision) == "highest"
        if q.device.type == "cuda" and q.shape[-2] > SMALL_N and keep:
            _check_dtypes(q, k, v)
            stats = (_bwd_stats if f32 else _bwd_stats_bf16)(_as4d(q))
            out = _fullseq(q, k, v, None, stats)
            ctx.save_for_backward(q, k, v, *((out, stats) if f32 else (stats,)))
            return out
        ctx.save_for_backward(q, k, v)
        return fused_grand_attention(q, k, v, None, matmul_precision)

    @staticmethod
    def backward(ctx, do):
        q, k, v, *fwd = ctx.saved_tensors
        prec = ctx.matmul_precision
        if q.shape[-2] <= SMALL_N:
            grads = grand_attention_bwd_xla(q, k, v, do, matmul_precision=prec)
        elif fwd:
            grads = _bwd(q, k, v, do, None, fwd)
        else:
            grads = grand_attention_bwd(q, k, v, do, matmul_precision=prec)
        return (*grads, None)


def grand_attention_trainable(q, k, v, matmul_precision="highest"):
    """GRAND attention on [B, H, N, D] with the hand-written backward, at
    the session precision ``matmul_precision`` (module doc)."""
    return _GrandAttentionTrainable.apply(q, k, v, matmul_precision)


def _check_dtypes(q, k, v):
    if not q.dtype == k.dtype == v.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("q, k and v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")


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
    return torch.empty((b, n, h, d), device=t.device, dtype=t.dtype).permute(0, 2, 1, 3)


def _kernel_operand(t, like):
    """t as the kernels read it: like's dtype, on like's device, shaped like
    ``like``, unit stride on the head dim, other strides multiples of 16
    bytes and a 16-byte aligned base (copied into that layout where it is
    not)."""
    if t.dtype != like.dtype or t.device != like.device or t.shape != like.shape:
        raise ValueError(
            f"attention operands must be {like.dtype} on {like.device} with shape "
            f"{tuple(like.shape)}, got {t.dtype} on {t.device} with {tuple(t.shape)}"
        )
    step = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % step for s in t.stride()[:-1]) or t.data_ptr() % 16:
        t = t.contiguous()
    return t


def _strides(t):
    return [ctypes.c_longlong(s) for s in t.stride()[:3]]


def _library(q, scale, small=False, bwd=False):
    """The loaded library and the scale, after checking what the kernel
    takes (B6's bound on n with ``small``, B4's head widths with ``bwd``)."""
    from diff3dhpe_torch.ops._build import load_library

    if q.device.type != "cuda":
        raise ValueError(f"the attention kernels run on cuda, not {q.device}")
    lib = load_library("grand_attention")
    b, h, n, d = q.shape
    max_n = lib.diff3dhpe_grand_small_max_n() if small else lib.diff3dhpe_grand_max_n()
    takes = lib.diff3dhpe_grand_bwd_takes_head_dim if bwd else lib.diff3dhpe_grand_takes_head_dim
    if not takes(d) or not 0 < n <= max_n:
        raise ValueError(
            f"the CUDA kernel takes head_dim {BWD_HEAD_DIMS if bwd else HEAD_DIM_RULE} and "
            f"0 < n <= {max_n}, got head_dim {d} and n {n}"
        )
    return lib, d ** -0.5 if scale is None else float(scale)


def _n64(n):
    return -(-n // 64) * 64


def _bwd_stats(q):
    """What B3 at float32 hands B4 for [B, H, N, D] operands: the rows'
    softmax max and 1/sum, two planes of B·H·n64 rows (n rounded up to 64)."""
    b, h, n, _ = q.shape
    return torch.empty((2, b * h * _n64(n)), device=q.device, dtype=torch.float32)


def _bwd_stats_bf16(q):
    """What B3 at bfloat16 hands B4 for [B, H, N, D] operands: for each
    (b, h) and 64-row tile of queries, three planes of 64 floats, the rows'
    −max·scale and 1/sum (B3's launch writes them) and D = Σ P∘dP (B4's dq
    pass writes it for its dk/dv pass)."""
    b, h, n, _ = q.shape
    return torch.empty((b * h * _n64(n) * 3,), device=q.device, dtype=torch.float32)


def _launch_fwd(q, k, v, out, scale, small=False, stats=None, matmul_precision="highest"):
    """Launches B3, or B6 with ``small``, in q's dtype, and counts it on
    its wrapper. ``stats``: B4's statistics (``_bwd_stats`` at float32,
    ``_bwd_stats_bf16`` at bfloat16), which B3 fills with the rows' softmax
    statistics. ``matmul_precision``: the session precision at float32."""
    f32 = q.dtype == torch.float32
    lib, scale = _library(q, scale, small)
    q, k, v = (_kernel_operand(t, q) for t in (q, k, v))
    b, h, n, d = q.shape
    if not f32 and not scale > 0:  # the bf16 kernel takes the row max before it scales
        raise ValueError(f"the bf16 attention kernel takes a positive scale, got {scale}")
    wrapper = packed_grand_attention if small else grand_attention_fullseq
    kind, dt = "small" if small else "fwd", "f32" if f32 else "bf16"
    fn = getattr(lib, f"diff3dhpe_grand_attn_{kind}_{dt}")
    # B3's statistics pointer; at float32 the session mode's index.
    extra = [] if small else [None if stats is None else stats.data_ptr()]
    if f32:
        extra.append(_MODE_INDEX[session_mode(matmul_precision)])
    launched = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n, d,
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            scale, *extra, ctypes.byref(launched),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    wrapper.launches += launched.value
    if small and not f32:
        wrapper.launches_bf16 += launched.value
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel failed: cudaError_t {err}")


def _launch_bwd(q, k, v, do, dq, dk, dv, scale, fwd=None, matmul_precision="highest"):
    """Launches B4's kernels in q's dtype; ``fwd``: what the trainable
    forward kept (float32: B3's output and the statistics its launch wrote;
    bfloat16: the statistics) or None. At float32 under "highest" the dq
    pass hands P and dS to the dk/dv pass through a scratch of two [B·H,
    n64, n64] planes. At bfloat16, and at float32 under "default", the
    tensor-core passes run: the rows' statistics and D go from pass to pass
    through ``_bwd_stats_bf16``'s planes, whose statistics the dq pass forms
    itself where the forward did not leave them; at float32 they run on q,
    k, v and do rounded once into bf16 planes (one kernel for q, k and v
    where they are views of one qkv projection, else one each, and one for
    do). ``matmul_precision``: the session precision at float32 (under
    "default" ``fwd`` must be None)."""
    lib, scale = _library(q, scale, bwd=True)
    bf16 = q.dtype == torch.bfloat16
    mode = session_mode(matmul_precision)
    if (bf16 or mode == "default") and not scale > 0:  # the row max is taken before the scale
        raise ValueError(f"the tensor-core backward takes a positive scale, got {scale}")
    q, k, v, do = (_kernel_operand(t, q) for t in (q, k, v, do))
    b, h, n, d = q.shape
    launched = ctypes.c_int(0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if bf16:
            stats = _bwd_stats_bf16(q) if fwd is None else fwd[0]
            err = lib.diff3dhpe_grand_attn_bwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), fwd is not None, b, h, n, d,
                *_strides(q), *_strides(k), *_strides(v), *_strides(do),
                *_strides(dq), *_strides(dk), *_strides(dv), scale, ctypes.byref(launched), stream,
            )
        else:
            out, stats = (None, None) if fwd is None else (_as4d(fwd[0]), fwd[1])
            pds = planes = None
            if mode == "default":
                if fwd is not None:
                    raise ValueError("B4 under 'default' forms its own statistics: fwd must be None")
                stats = _bwd_stats_bf16(q)
                planes = torch.empty(4 * b * n * h * d, device=q.device, dtype=torch.bfloat16)
            else:
                pds = torch.empty((2, b * h, _n64(n), _n64(n)), device=q.device,
                                  dtype=torch.float32)
            ptr = lambda t: None if t is None else t.data_ptr()
            err = lib.diff3dhpe_grand_attn_bwd_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), ptr(out), ptr(stats),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ptr(pds), ptr(planes), b, h, n, d,
                *_strides(q), *_strides(k), *_strides(v), *_strides(do),
                *(_strides(out) if out is not None else [ctypes.c_longlong(0)] * 3),
                *_strides(dq), *_strides(dk), *_strides(dv),
                scale, _MODE_INDEX[mode], ctypes.byref(launched), stream,
            )
    grand_attention_bwd.launches += launched.value
    if bf16:
        grand_attention_bwd.launches_bf16 += launched.value
    if err:
        raise RuntimeError(f"grand_attention backward kernels failed: cudaError_t {err}")


_DISPATCH = register("fused_grand_attention(Tensor q, Tensor k, Tensor v, float? scale, "
                     "int f32_mode=0) -> Tensor", _dispatch_impl, _dispatch_impl, _dispatch_fake)
