"""One whole MixSTE transformer block on flat rows: the port of
``diff3dhpe_tpu/ops/fused_block.py::fused_transformer_block``.

``fused_transformer_block`` launches the hand-written CUDA kernels of
``csrc/fused_block.cu`` for a CUDA tensor and runs the plain PyTorch
version, ``fused_transformer_block_ref``, for a CPU tensor. Both compute,
on x [R, C] whose rows form groups of ``n_pad`` rows (the first ``n`` of
each group real):

    xs  = x [+ t_rows[row // rows_per_item]]
    h1  = xs + s0 * proj(GRAND(LN1(xs)))      attention within each group,
                                              over its n real keys
    out = h1 + s1 * fc2(GELU(fc1(LN2(h1))))   [then out_ln]

where s0, s1 are the row's drop-path scales ``dp_scales[row]`` (1 without).

``block`` is a ``models.mixste.Block`` (or anything with its norm1, attn.qkv,
attn.proj, norm2, mlp.fc1 and mlp.fc2); ``out_ln`` an ``nn.LayerNorm``.
"""
from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F


def _check_args(x, block, n, heads, n_pad, t_rows, rows_per_item, dp_scales):
    if x.ndim != 2:
        raise ValueError(f"x must be [R, C], got {tuple(x.shape)}")
    r, c = x.shape
    if dp_scales is not None and tuple(dp_scales.shape) != (r, 2):
        raise ValueError(f"dp_scales must be [R, 2] = [{r}, 2], got {tuple(dp_scales.shape)}")
    if c % heads:
        raise ValueError(f"C={c} is not a multiple of heads={heads}")
    if not 0 < n <= n_pad or r % n_pad:
        raise ValueError(f"need 0 < n={n} <= n_pad={n_pad} and R={r} a multiple of n_pad")
    if t_rows is not None:
        if rows_per_item is None or rows_per_item <= 0:
            raise ValueError("t_rows needs a positive rows_per_item")
        if t_rows.ndim != 2 or t_rows.shape[1] != c or (r - 1) // rows_per_item >= t_rows.shape[0]:
            raise ValueError(
                f"t_rows {tuple(t_rows.shape)} does not cover R={r} rows of "
                f"{rows_per_item} rows per item at C={c}"
            )
    hidden = block.mlp.fc1.weight.shape[0]
    expected = {
        "attn.qkv.weight": (3 * c, c), "attn.proj.weight": (c, c),
        "mlp.fc1.weight": (hidden, c), "mlp.fc2.weight": (c, hidden),
    }
    for name, shape in expected.items():
        got = tuple(block.get_parameter(name).shape)
        if got != shape:
            raise ValueError(f"block {name} has shape {got}, expected {shape}")


def fused_transformer_block_ref(x, block, n, heads, *, n_pad=None, t_rows=None,
                                rows_per_item=None, out_ln=None, dp_scales=None):
    """Plain PyTorch version of ``fused_transformer_block`` (same
    arguments, same result). Pad query rows (n..n_pad-1 of a group) attend
    to the group's real keys; their outputs are garbage the caller ignores,
    as in the JAX kernel."""
    n_pad = n if n_pad is None else n_pad
    _check_args(x, block, n, heads, n_pad, t_rows, rows_per_item, dp_scales)
    r, c = x.shape
    s_attn, s_mlp = (1.0, 1.0) if dp_scales is None else (dp_scales[:, 0:1], dp_scales[:, 1:2])
    if t_rows is not None:
        x = x + t_rows[torch.arange(r, device=x.device) // rows_per_item]
    xn = F.layer_norm(x, (c,), block.norm1.weight, block.norm1.bias, block.norm1.eps)
    qkv = F.linear(xn, block.attn.qkv.weight, block.attn.qkv.bias)
    q, k, v = qkv.reshape(r // n_pad, n_pad, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    logits = q @ k[:, :, :n].transpose(-1, -2) * (c // heads) ** -0.5
    attn = torch.softmax(logits.float(), dim=-1).to(x.dtype) @ v[:, :, :n] - v
    attn = attn.permute(0, 2, 1, 3).reshape(r, c)
    h1 = x + s_attn * F.linear(attn, block.attn.proj.weight, block.attn.proj.bias)
    hn = F.layer_norm(h1, (c,), block.norm2.weight, block.norm2.bias, block.norm2.eps)
    mid = F.gelu(F.linear(hn, block.mlp.fc1.weight, block.mlp.fc1.bias))
    out = h1 + s_mlp * F.linear(mid, block.mlp.fc2.weight, block.mlp.fc2.bias)
    if out_ln is not None:
        out = F.layer_norm(out, (c,), out_ln.weight, out_ln.bias, out_ln.eps)
    return out


def fused_transformer_block(x, block, n, heads, *, n_pad=None, t_rows=None,
                            rows_per_item=None, out_ln=None, dp_scales=None):
    """Whole transformer block on flat rows x [R, C] (see the module doc).

    ``n``: real rows per attention group; ``n_pad``: rows per group in x
    (default n; rows n..n_pad-1 are padding, masked as keys). ``t_rows``
    [B, C]: time-embedding rows added on load, row i taking
    t_rows[i // rows_per_item]. ``out_ln``: LayerNorm applied to the
    output. ``dp_scales`` [R, 2]: per-row drop-path scales of the attention
    and MLP branches (JAX ``fused_transformer_block(dp_scales=...)``).

    A CPU tensor runs the plain version. A CUDA tensor launches the
    kernels (7, or 8 with ``out_ln``; ``fused_transformer_block.launches``
    counts them) or raises."""
    if x.device.type == "cpu":
        return fused_transformer_block_ref(
            x, block, n, heads, n_pad=n_pad, t_rows=t_rows,
            rows_per_item=rows_per_item, out_ln=out_ln, dp_scales=dp_scales,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_transformer_block runs on cpu or cuda, not {x.device}")
    n_pad = n if n_pad is None else n_pad
    _check_args(x, block, n, heads, n_pad, t_rows, rows_per_item, dp_scales)
    return _launch(x, block, n, heads, n_pad, t_rows, rows_per_item, out_ln, dp_scales)


fused_transformer_block.launches = 0


def _ptr(t):
    """Device pointer of an f32 CUDA tensor the kernels may read as
    float4: on x's device, contiguous and 16-byte aligned. None -> NULL."""
    if t is None:
        return None
    if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
        raise ValueError(
            f"kernel operands must be contiguous float32 CUDA tensors, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if t.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    return t.data_ptr()


def _launch(x, block, n, heads, n_pad, t_rows, rows_per_item, out_ln, dp_scales):
    from diff3dhpe_torch.ops._build import load_library

    lib = load_library("fused_block")
    r, c = x.shape
    d = c // heads
    hidden = block.mlp.fc1.weight.shape[0]
    if d != lib.diff3dhpe_attn_head_dim() or n > lib.diff3dhpe_attn_max_n():
        raise ValueError(
            f"the CUDA kernel takes head_dim {lib.diff3dhpe_attn_head_dim()} and "
            f"n <= {lib.diff3dhpe_attn_max_n()}, got head_dim {d} and n {n}"
        )
    if c % 8 or hidden % 8:
        raise ValueError(f"the CUDA kernel needs C and hidden multiples of 8, got {c}, {hidden}")
    operands = [x, t_rows, dp_scales] + [
        getattr(m, a) if m is not None else None
        for m in (block.norm1, block.attn.qkv, block.attn.proj, block.norm2,
                  block.mlp.fc1, block.mlp.fc2, out_ln)
        for a in ("weight", "bias")
    ]
    for t in operands:
        if t is not None and t.device != x.device:
            raise ValueError(f"operand on {t.device}, x on {x.device}")
    (px, pt, pdp, ln1w, ln1b, qkvw, qkvb, projw, projb, ln2w, ln2b,
     fc1w, fc1b, fc2w, fc2b, olnw, olnb) = (_ptr(t) for t in operands)

    empty = lambda cols: torch.empty((r, cols), device=x.device, dtype=torch.float32)
    xs = empty(c) if t_rows is not None else None
    xn, qkv, attn, h1, mid, out = empty(c), empty(3 * c), empty(c), empty(c), empty(hidden), empty(c)
    launched = ctypes.c_int(0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.diff3dhpe_fused_block_f32(
            px, pt, rows_per_item or 1, pdp,
            ln1w, ln1b, block.norm1.eps,
            qkvw, qkvb, projw, projb,
            ln2w, ln2b, block.norm2.eps,
            fc1w, fc1b, fc2w, fc2b,
            olnw, olnb, out_ln.eps if out_ln is not None else 0.0,
            _ptr(xs), _ptr(xn), _ptr(qkv), _ptr(attn), _ptr(h1), _ptr(mid), _ptr(out),
            r, c, hidden, n, n_pad, heads, d ** -0.5,
            ctypes.byref(launched), stream,
        )
    fused_transformer_block.launches += launched.value
    if err:
        raise RuntimeError(f"fused_block kernel launch failed: cudaError_t {err}")
    return out
