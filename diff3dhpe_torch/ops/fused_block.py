"""One whole MixSTE transformer block on flat rows: the ports of
``diff3dhpe_tpu/ops/fused_block.py::fused_transformer_block`` (B1),
``fused_temporal_block_cols`` (B2) and ``fused_attention_block`` (B5, the
attention half alone: out = x + proj(GRAND(LN1(x)))).

Each wrapper launches the hand-written CUDA kernels of
``csrc/fused_block.cu`` for a CUDA tensor and runs its plain PyTorch
version (``*_ref``) for a CPU tensor. Both compute, on rows x [R, C] that
form attention groups:

    xs  = x [+ t_rows[row // rows_per_item]]
    h1  = xs + s0 * proj(GRAND(LN1(xs)))      attention within each group,
                                              over its n real keys
    out = h1 + s1 * fc2(GELU(fc1(LN2(h1))))   [then out_ln]

where s0, s1 are the row's drop-path scales (1 without) and the attention
scales q·kᵀ by ``scale`` (JAX's ``scale=None``: head_dim^-½). B1 takes groups
of ``n_pad`` consecutive rows; B2 the temporal group (b, j) of the
spatial-major rows (b·F + f)·J + j, with no transpose.

x is float32, or bfloat16 with float32 accumulation (JAX ``cdt = bf16``,
fused_block.py:338-374): LN parameters and biases stay float32, each step
computes in float32 from bf16-rounded operands and rounds its output to
bf16, where JAX rounds: xs, LN1, qkv (bias added first), the attention's P
and output, h1, LN2, GELU(fc1), and the output before and after the out-LN.

``block`` is a ``models.mixste.Block`` (or anything with its norm1, attn.qkv,
attn.proj, norm2, mlp.fc1 and mlp.fc2), whose GEMM weights may be float32
or already in x's dtype; ``out_ln`` an ``nn.LayerNorm``.

The kernels write into buffers autograd does not see, so the three
wrappers refuse to run where autograd would record them, on the CPU too
(``_refuse_autograd``); training runs them inside ``_FusedPair``
(``models.fast_eval``), whose backward recomputes the pair.

B1 and B2 reach their kernels (or plain versions) through the operators
``diff3dhpe::fused_transformer_block`` and
``diff3dhpe::fused_temporal_block_cols`` (``ops._library``), which take the
block's tensors one by one, so that ``torch.export`` traces through them.

At float32 every product of the three follows an explicit contraction mode
``f32_prec`` (JAX ``_dot_f32`` under ``f32_contract_mode``,
fused_block.py:84-164; ``contract`` here): "highest" (exact float32, the
default), "high3" (bf16x3: a = a_hi + a_lo, a_hi·b_hi + a_hi·b_lo +
a_lo·b_hi summed in float32) or "default" (one pass of the operands rounded
to bf16). It covers the four dense products (the bias added after), q·kᵀ,
e·v with e the unnormalised exponentials (JAX's f32 epilogue defers the
normalisation; the row sum and the trailing − v read the unrounded values),
and the time add, which reads t as JAX's one-hot gather contracts it
(bf16(t), or t_hi + t_lo). A bfloat16 x ignores the mode, as ``_dot_f32``
does for bf16 operands. JAX also reads a process-wide mode from the
environment (``DIFF_FUSED_F32_PREC``); the port takes it only as this
argument.
"""
from __future__ import annotations

import ctypes
from operator import attrgetter
from types import SimpleNamespace as _NS

import torch
from torch.nn import functional as F

from diff3dhpe_torch.ops._library import register
from diff3dhpe_torch.ops.attention import HEAD_DIM_RULE, grand_attention_stored, refuse_autograd
from diff3dhpe_torch.ops.matmul_precision import bf16_round as _bf16_round

DTYPES = (torch.float32, torch.bfloat16)
# The float32 contraction modes by the index the operators and the kernels
# take (csrc/grand_attn.cuh::F32Mode).
F32_MODES = ("highest", "high3", "default")
# The widest row the LayerNorm kernel holds (32 lanes x 16 pieces of 16
# bytes; csrc/fused_block.cu::diff3dhpe_ln_max_c).
LN_MAX_C = {torch.float32: 2048, torch.bfloat16: 4096}


def _check_device(wrapper, x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda, not {x.device}")


def _refuse_autograd(op, *inputs):
    """``refuse_autograd`` over the tensors among ``inputs`` and the
    parameters of the modules among them (the block, the out-LN)."""
    tensors = [p for a in inputs
               for p in (a.parameters() if isinstance(a, torch.nn.Module) else [a])]
    refuse_autograd(op, *tensors, route="fast_forward_denoise_train_pairs (Config.fast_train)")


def _check_block(x, block, heads):
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    if c % heads:
        raise ValueError(f"C={c} is not a multiple of heads={heads}")
    hidden = block.mlp.fc1.weight.shape[0]
    expected = {
        "attn.qkv.weight": (3 * c, c), "attn.proj.weight": (c, c),
        "mlp.fc1.weight": (hidden, c), "mlp.fc2.weight": (c, hidden),
    }
    for name, shape in expected.items():
        got = tuple(attrgetter(name)(block).shape)
        if got != shape:
            raise ValueError(f"block {name} has shape {got}, expected {shape}")


def _check_args(x, block, n, heads, n_pad, t_rows, rows_per_item, dp_scales):
    if x.ndim != 2:
        raise ValueError(f"x must be [R, C], got {tuple(x.shape)}")
    r, c = x.shape
    if dp_scales is not None and tuple(dp_scales.shape) != (r, 2):
        raise ValueError(f"dp_scales must be [R, 2] = [{r}, 2], got {tuple(dp_scales.shape)}")
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
    _check_block(x, block, heads)


def _check_cols_args(x, block, n, j_groups, heads, t_rows, dp_scales):
    if x.ndim != 2 or j_groups <= 0 or x.shape[1] % j_groups or n <= 0 or x.shape[0] % n:
        raise ValueError(f"x must be [B*F, J*C] with F = n = {n} and J = j_groups = {j_groups}, "
                         f"got {tuple(x.shape)}")
    b, c = x.shape[0] // n, x.shape[1] // j_groups
    if t_rows is not None and tuple(t_rows.shape) != (b, c):
        raise ValueError(f"t_rows must be [B, C] = [{b}, {c}], got {tuple(t_rows.shape)}")
    if dp_scales is not None and tuple(dp_scales.shape) != (b * j_groups, 2):
        raise ValueError(f"dp_scales must be [B*J, 2] = [{b * j_groups}, 2], "
                         f"got {tuple(dp_scales.shape)}")
    _check_block(x.view(-1, c), block, heads)


def f32_mode_index(f32_prec, dtype=torch.float32):
    """The index of contraction mode ``f32_prec`` in ``F32_MODES`` for
    activations of ``dtype``: bfloat16 contracts in one bf16 pass whatever
    the mode, so it maps to 0. Raises a ValueError on an unknown mode."""
    if f32_prec not in F32_MODES:
        raise ValueError(f"f32_prec must be one of {F32_MODES}, got {f32_prec!r}")
    return F32_MODES.index(f32_prec) if dtype == torch.float32 else 0


def bf16_split(a):
    """(a_hi, a_lo) in float32: a_hi = bf16(a), a_lo = bf16(a − a_hi)
    (JAX ``_dot_f32_3pass``'s casts, fused_block.py:137-140)."""
    hi = _bf16_round(a)
    return hi, _bf16_round(a - hi)


def contract(a, b, mode="highest"):
    """a [..., M, K] · b [..., N, K]ᵀ of float32 operands in float32 under
    contraction ``mode``: the port of JAX ``_dot_f32`` (fused_block.py:147-164)
    on float32 operands. "highest": exact float32; "default": the operands
    rounded to bf16, their products exact, the sums float32 (the MXU's one
    bf16 pass); "high3": a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, summed in that
    order (``_dot_f32_3pass``)."""
    if mode not in F32_MODES:
        raise ValueError(f"mode must be one of {F32_MODES}, got {mode!r}")
    if mode == "highest":
        return torch.matmul(a, b.transpose(-1, -2))
    if mode == "default":
        return torch.matmul(_bf16_round(a), _bf16_round(b).transpose(-1, -2))
    (a_hi, a_lo), (b_hi, b_lo) = bf16_split(a), bf16_split(b)
    b_hi, b_lo = b_hi.transpose(-1, -2), b_lo.transpose(-1, -2)
    return torch.matmul(a_hi, b_hi) + torch.matmul(a_hi, b_lo) + torch.matmul(a_lo, b_hi)


def time_rows_under(t, mode):
    """The float32 time rows as JAX's one-hot gather contracts them under
    ``mode`` (fused_block.py:271-281, :664-674): t, bf16(t) or t_hi + t_lo."""
    if mode == "default":
        return _bf16_round(t)
    if mode == "high3":
        hi, lo = bf16_split(t)
        return hi + lo
    return t


def _out_ln_params(out_ln):
    """(weight, bias, eps) of the out-LN, or None. Both layouts read them in
    float32. (JAX's B2 casts them to x's dtype, fused_block.py:846, where
    its B1 does not; the port keeps the model's float32 LayerNorm in both,
    so the two layouts compute the same function.)"""
    return None if out_ln is None else (out_ln.weight, out_ln.bias, out_ln.eps)


def round_to(a, dt):
    """``a`` rounded once to ``dt``, to nearest even. torch takes a float64
    to bfloat16 through float32, which would round twice, so that float32
    step rounds to odd (truncated, its last bit set where inexact), which
    the second rounding cannot turn."""
    if a.dtype != torch.float64 or dt == torch.float32:
        return a.to(dt)
    f = a.float()
    t = torch.where(f.double().abs() > a.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    return (t.view(torch.int32) | (t.double() != a).int()).view(torch.float32).to(dt)


def _ref_ops(dt, mode="highest", acc=torch.float32):
    """(rnd, lin, ln) of the plain versions for storage type ``dt``, on
    values held in ``acc``: ``rnd`` rounds to dt where a kernel stores;
    ``lin`` is a matmul in acc of the operands as the kernel sees them
    (weights rounded to dt, bias float32), at float32 under contraction
    ``mode`` (``contract``, the bias added after); ``ln`` a LayerNorm in
    acc. float64 makes them the exact-sum oracle's."""
    rnd = (lambda a: a) if dt == acc else (lambda a: round_to(a, dt).to(acc))

    def lin(a, m):
        bias = None if m.bias is None else m.bias.to(acc)
        if mode == "highest":
            return F.linear(a, rnd(m.weight.to(acc)), bias)
        out = contract(a, m.weight.float(), mode)
        return out if bias is None else out + bias

    def ln(a, m):
        return F.layer_norm(a, (a.shape[-1],), m.weight.to(acc), m.bias.to(acc), m.eps)

    return rnd, lin, ln


def _scale(scale, c, heads):
    """The attention's scale: ``scale``, or JAX's default head_dim^-½."""
    return (c // heads) ** -0.5 if scale is None else scale


def _attn_branch_ref(x, block, n, heads, n_pad, dt, mode="highest", scale=None,
                     acc=torch.float32):
    """proj(GRAND(LN1(x))) in ``acc`` on rows x [R, C] that hold values of
    type ``dt``, rounding to dt where the kernels store: the LN output, qkv
    (after the bias), P and the attention output. At float32 every product
    contracts under ``mode``."""
    rnd, lin, ln = _ref_ops(dt, mode, acc)
    r, c = x.shape
    qkv = rnd(lin(rnd(ln(x, block.norm1)), block.attn.qkv))
    q, k, v = qkv.reshape(r // n_pad, n_pad, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    dot = None if mode == "highest" else (lambda a, b: contract(a, b, mode))
    attn = grand_attention_stored(q, k[:, :, :n], v[:, :, :n], _scale(scale, c, heads), rnd,
                                  v_self=v, dot=dot)
    return lin(attn.permute(0, 2, 1, 3).reshape(r, c), block.attn.proj)


def _residual_ref(x, block, n, heads, n_pad, t_rows, rows_per_item, dp_scales, mode="highest",
                  scale=None, acc=torch.float32):
    """(the block's residual stream before the out-LN, unrounded in
    ``acc``; ``rnd``) on groups of n_pad rows. Every product is a matmul in
    acc of the operands as the kernel sees them (exact for bf16-rounded
    operands), at float32 under contraction ``mode`` (the time add too),
    and ``rnd`` rounds to x's dtype where the kernel stores."""
    dt = x.dtype
    mode = mode if dt == torch.float32 else "highest"
    rnd, lin, ln = _ref_ops(dt, mode, acc)
    r, c = x.shape
    s_attn, s_mlp = (1.0, 1.0) if dp_scales is None else (dp_scales[:, 0:1].to(acc),
                                                          dp_scales[:, 1:2].to(acc))

    x = x.to(acc)
    if t_rows is not None:
        t = time_rows_under(rnd(t_rows.to(acc)), mode)
        x = rnd(x + t[torch.arange(r, device=x.device) // rows_per_item])
    h1 = rnd(x + s_attn * _attn_branch_ref(x, block, n, heads, n_pad, dt, mode, scale, acc))
    mid = rnd(F.gelu(lin(rnd(ln(h1, block.norm2)), block.mlp.fc1)))
    return h1 + s_mlp * lin(mid, block.mlp.fc2), rnd


def _out_ln_ref(out, rnd, out_ln, dt):
    """The block's output from its residual stream ``out``: [the out-LN
    ``out_ln`` = (w, b, eps), in out's dtype, of ``rnd(out)``,] rounded to
    ``dt``."""
    if out_ln is not None:
        w, b, eps = out_ln
        out = F.layer_norm(rnd(out), (out.shape[-1],), w.to(out.dtype), b.to(out.dtype), eps)
    return round_to(out, dt)


def _block_ref(x, block, n, heads, n_pad, t_rows, rows_per_item, out_ln, dp_scales,
               mode="highest", scale=None, acc=torch.float32):
    """The plain block on groups of n_pad rows (``_residual_ref``, then
    ``_out_ln_ref``); ``out_ln`` is (w, b, eps) or None."""
    out, rnd = _residual_ref(x, block, n, heads, n_pad, t_rows, rows_per_item, dp_scales, mode,
                             scale, acc)
    return _out_ln_ref(out, rnd, out_ln, x.dtype)


def fused_transformer_block_ref(x, block, n, heads, *, n_pad=None, t_rows=None,
                                rows_per_item=None, out_ln=None, dp_scales=None,
                                f32_prec="highest", scale=None):
    """Plain PyTorch version of ``fused_transformer_block`` (same
    arguments, same result). Pad query rows (n..n_pad-1 of a group) attend
    to the group's real keys; their outputs are garbage the caller ignores,
    as in the JAX kernel."""
    n_pad = n if n_pad is None else n_pad
    _check_args(x, block, n, heads, n_pad, t_rows, rows_per_item, dp_scales)
    mode = F32_MODES[f32_mode_index(f32_prec, x.dtype)]
    return _block_ref(x, block, n, heads, n_pad, t_rows, rows_per_item,
                      _out_ln_params(out_ln), dp_scales, mode, scale)


def fused_transformer_block_exact(x, block, n, heads, *, n_pad=None, t_rows=None,
                                  rows_per_item=None, out_ln=None, dp_scales=None, scale=None):
    """B1's order-free oracle at bf16 (for checks, no model path runs it):
    the plain version with every sum in float64 and each rounding to x's
    dtype taken once from there, at the points where JAX's kernel rounds.
    Any float32 summation order, the plain version's and the kernel's
    included, turns single roundings of those points the other way; the
    kernel and its plain version are both measured from this."""
    n_pad = n if n_pad is None else n_pad
    _check_args(x, block, n, heads, n_pad, t_rows, rows_per_item, dp_scales)
    return _block_ref(x, block, n, heads, n_pad, t_rows, rows_per_item, _out_ln_params(out_ln),
                      dp_scales, scale=scale, acc=torch.float64)


def fused_transformer_block_flipped(x, block, n, heads, row, col, *, n_pad=None, t_rows=None,
                                    rows_per_item=None, out_ln=None, dp_scales=None, scale=None):
    """B1's plain version at bf16 with one rounding turned the other way
    (for checks, no model path runs it): the residual stream's element
    (``row``, ``col``) rounds to the other bf16 neighbour of its float32
    value before the out-LN. With it a check asks whether one such
    rounding accounts for a deviation of the kernel's at that element."""
    n_pad = n if n_pad is None else n_pad
    _check_args(x, block, n, heads, n_pad, t_rows, rows_per_item, dp_scales)
    out, rnd = _residual_ref(x, block, n, heads, n_pad, t_rows, rows_per_item, dp_scales,
                             scale=scale)
    near = rnd(out)
    v, r = out[row, col], near[row, col]
    step = torch.tensor(float("inf") if v >= r else float("-inf"), dtype=x.dtype)
    near[row, col] = torch.nextafter(r.to(x.dtype).cpu(), step).to(near)
    return _out_ln_ref(near, lambda a: a, _out_ln_params(out_ln), x.dtype)


def fused_transformer_block(x, block, n, heads, *, n_pad=None, t_rows=None,
                            rows_per_item=None, out_ln=None, dp_scales=None,
                            f32_prec="highest", scale=None):
    """B1: whole transformer block on flat rows x [R, C] (see the module doc).

    ``n``: real rows per attention group; ``n_pad``: rows per group in x
    (default n; rows n..n_pad-1 are padding, masked as keys). ``t_rows``
    [B, C]: time-embedding rows added on load, row i taking
    t_rows[i // rows_per_item]. ``out_ln``: LayerNorm applied to the
    output. ``dp_scales`` [R, 2]: per-row drop-path scales of the attention
    and MLP branches (JAX ``fused_transformer_block(dp_scales=...)``).
    ``f32_prec``: the contraction mode of a float32 x (module doc).
    ``scale``: the attention's, default head_dim^-½ (JAX's ``scale``).

    A CPU tensor runs the plain version. A CUDA tensor launches the
    kernels (7, or 8 with ``out_ln``; 15 and 16 under "high3" and
    "default"; ``fused_transformer_block.launches`` counts them,
    ``.launches_bf16`` those at bf16, ``.launches_ln`` the LayerNorms,
    ``.launches_gemm_f32`` the exact f32 GEMMs, ``.launches_split`` the
    splits, ``.launches_gemm_mode`` the f32-output tensor-core GEMMs of
    the two modes, and ``.launches_attn_mode`` and ``.launches_ln_mode``
    the attention's (the tensor-core kernel) and the time add's LayerNorm's
    instances under them) or raises. Under autograd it raises
    (``_refuse_autograd``)."""
    _check_device(fused_transformer_block, x)
    n_pad = n if n_pad is None else n_pad
    _check_args(x, block, n, heads, n_pad, t_rows, rows_per_item, dp_scales)
    mode = f32_mode_index(f32_prec, x.dtype)
    _refuse_autograd("fused_transformer_block", x, block, out_ln, t_rows, dp_scales)
    return _B1(x, t_rows, dp_scales, *_block_operands(block, out_ln), n, heads, n_pad,
               rows_per_item or 0, mode, *_scale_arg(scale))


def _scale_arg(scale):
    """The operators' trailing ``scale``, left out where it is None (the
    schema's default), so that a call without it traces as before."""
    return () if scale is None else (float(scale),)


def _zero_counts(wrapper):
    for kind in COUNTS:
        setattr(wrapper, kind, 0)


# The launch counters of the three block wrappers.
COUNTS = ("launches", "launches_bf16", "launches_ln", "launches_gemm_f32", "launches_split",
          "launches_gemm_mode", "launches_attn_mode", "launches_ln_mode")
_LAUNCH_KINDS = 7  # the block entry points' counts (kCounts, csrc/fused_block.cu)
_zero_counts(fused_transformer_block)


def fused_temporal_block_cols_ref(x, block, n, j_groups, heads, *, t_rows=None, out_ln=None,
                                  dp_scales=None, f32_prec="highest", scale=None):
    """Plain PyTorch version of ``fused_temporal_block_cols`` (same
    arguments, same result): the block on the transposed rows."""
    _check_cols_args(x, block, n, j_groups, heads, t_rows, dp_scales)
    mode = F32_MODES[f32_mode_index(f32_prec, x.dtype)]
    return _cols_ref(x, block, n, j_groups, heads, t_rows, _out_ln_params(out_ln), dp_scales,
                     mode, scale)


def _cols_ref(x, block, n, j_groups, heads, t_rows, out_ln, dp_scales, mode="highest",
              scale=None):
    """``fused_temporal_block_cols_ref`` on checked arguments, ``out_ln`` as
    (w, b, eps) or None."""
    rows, cols = x.shape
    b, c = rows // n, cols // j_groups
    xt = x.view(b, n, j_groups, c).transpose(1, 2).reshape(b * j_groups * n, c)
    dp = None if dp_scales is None else dp_scales.view(b * j_groups, 1, 2).expand(
        b * j_groups, n, 2).reshape(-1, 2)
    out = _block_ref(xt, block, n, heads, n, t_rows, j_groups * n, out_ln, dp, mode, scale)
    return out.view(b, j_groups, n, c).transpose(1, 2).reshape(rows, cols)


def fused_temporal_block_cols(x, block, n, j_groups, heads, *, t_rows=None, out_ln=None,
                              dp_scales=None, f32_prec="highest", scale=None):
    """B2: the temporal block over the spatial-major activations, with JAX's
    signature (without frame padding: F8 = F = n).

    x [B*F, J*C] is the [B, F, J, C] buffer seen in 2-D; the attention group
    of (sample b, joint j) is its column slice x[b*F:(b+1)*F, j*C:(j+1)*C].
    ``t_rows`` [B, C]: one time-embedding row per sample. ``out_ln``: the
    inter-block LayerNorm. ``dp_scales`` [B*J, 2]: one pair of drop-path
    scales per group (b, j), row b*J + j. The result equals B1's on the
    transposed rows (``fused_temporal_block_cols_ref``). ``f32_prec``: the
    contraction mode of a float32 x (module doc). ``scale``: the
    attention's, default head_dim^-½.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernels
    (as ``fused_transformer_block``'s, counted on
    ``fused_temporal_block_cols`` in the same counters) or raises. Under
    autograd it raises (``_refuse_autograd``)."""
    _check_device(fused_temporal_block_cols, x)
    _check_cols_args(x, block, n, j_groups, heads, t_rows, dp_scales)
    mode = f32_mode_index(f32_prec, x.dtype)
    _refuse_autograd("fused_temporal_block_cols", x, block, out_ln, t_rows, dp_scales)
    return _B2(x, t_rows, dp_scales, *_block_operands(block, out_ln), n, j_groups, heads, mode,
               *_scale_arg(scale))


_zero_counts(fused_temporal_block_cols)


# The block's tensors and LayerNorm epsilons as the two operators take them.
_BLOCK_SCHEMA = ("Tensor ln1_w, Tensor ln1_b, Tensor w_qkv, Tensor? b_qkv, Tensor w_proj, "
                 "Tensor? b_proj, Tensor ln2_w, Tensor ln2_b, Tensor w_fc1, Tensor? b_fc1, "
                 "Tensor w_fc2, Tensor? b_fc2, Tensor? oln_w, Tensor? oln_b, float eps1, "
                 "float eps2, float oln_eps")
_N_BLOCK = 17


def _block_operands(block, out_ln):
    """``block``'s tensors and epsilons in ``_BLOCK_SCHEMA``'s order."""
    attn, mlp = block.attn, block.mlp
    oln = (None, None) if out_ln is None else (out_ln.weight, out_ln.bias)
    return (block.norm1.weight, block.norm1.bias, attn.qkv.weight, attn.qkv.bias,
            attn.proj.weight, attn.proj.bias, block.norm2.weight, block.norm2.bias,
            mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias, *oln,
            float(block.norm1.eps), float(block.norm2.eps),
            0.0 if out_ln is None else float(out_ln.eps))


def _as_block(operands):
    """(block, out_ln as (w, b, eps) or None) from ``_block_operands``'s
    tuple: a namespace with the attributes the kernels and plain versions
    read."""
    (ln1_w, ln1_b, wq, bq, wp, bp, ln2_w, ln2_b, w1, b1, w2, b2,
     oln_w, oln_b, eps1, eps2, oln_eps) = operands
    lin = lambda w, b: _NS(weight=w, bias=b)
    block = _NS(norm1=_NS(weight=ln1_w, bias=ln1_b, eps=eps1),
                attn=_NS(qkv=lin(wq, bq), proj=lin(wp, bp)),
                norm2=_NS(weight=ln2_w, bias=ln2_b, eps=eps2),
                mlp=_NS(fc1=lin(w1, b1), fc2=lin(w2, b2)))
    return block, None if oln_w is None else (oln_w, oln_b, oln_eps)


def _b1_impl(x, t_rows, dp_scales, *rest):
    """B1's operator: the plain version on the CPU, the kernels on CUDA.
    A call without the trailing ``scale`` (the schema's default, which a
    Python implementation is not handed) runs head_dim^-½."""
    operands, (n, heads, n_pad, rows_per_item, mode, *scale) = rest[:_N_BLOCK], rest[_N_BLOCK:]
    block, out_ln = _as_block(operands)
    rows_per_item, scale = rows_per_item or None, scale[0] if scale else None
    if x.device.type == "cpu":
        return _block_ref(x, block, n, heads, n_pad, t_rows, rows_per_item, out_ln, dp_scales,
                          F32_MODES[mode], scale)
    return _launch(fused_transformer_block, x, block, n, heads, n_pad, 0, t_rows,
                   rows_per_item, out_ln, dp_scales, mode, scale)


def _b2_impl(x, t_rows, dp_scales, *rest):
    """B2's operator: the plain version on the CPU, the kernels on CUDA
    (``scale`` as B1's)."""
    operands, (n, j_groups, heads, mode, *scale) = rest[:_N_BLOCK], rest[_N_BLOCK:]
    block, out_ln = _as_block(operands)
    scale = scale[0] if scale else None
    if x.device.type == "cpu":
        return _cols_ref(x, block, n, j_groups, heads, t_rows, out_ln, dp_scales, F32_MODES[mode],
                         scale)
    rows, cols = x.shape
    b, c = rows // n, cols // j_groups
    dp = None if dp_scales is None else dp_scales.view(b, 1, j_groups, 2).expand(
        b, n, j_groups, 2).reshape(rows * j_groups, 2)  # per row, spatial-major order
    out = _launch(fused_temporal_block_cols, x.view(rows * j_groups, c), block, n, heads, n,
                  j_groups, t_rows, n * j_groups, out_ln, dp, mode, scale)
    return out.view(rows, cols)


def _same_as_x(x, *rest):
    return x.new_empty(x.shape)


_B1 = register("fused_transformer_block(Tensor x, Tensor? t_rows, Tensor? dp_scales, "
               f"{_BLOCK_SCHEMA}, int n, int heads, int n_pad, int rows_per_item, "
               "int f32_mode, float? scale=None) -> Tensor",
               _b1_impl, _b1_impl, _same_as_x)
_B2 = register("fused_temporal_block_cols(Tensor x, Tensor? t_rows, Tensor? dp_scales, "
               f"{_BLOCK_SCHEMA}, int n, int j_groups, int heads, int f32_mode, "
               "float? scale=None) -> Tensor",
               _b2_impl, _b2_impl, _same_as_x)


def _check_attn_args(x, block, n, heads):
    if x.ndim != 2 or n <= 0 or x.shape[0] % n:
        raise ValueError(f"x must be [R, C] with R a multiple of n={n}, got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[1]
    if c % heads:
        raise ValueError(f"C={c} is not a multiple of heads={heads}")
    for name, shape in (("qkv", (3 * c, c)), ("proj", (c, c))):
        got = tuple(getattr(block.attn, name).weight.shape)
        if got != shape:
            raise ValueError(f"block attn.{name}.weight has shape {got}, expected {shape}")


def fused_attention_block_ref(x, block, n, heads, f32_prec="highest", scale=None):
    """Plain PyTorch version of ``fused_attention_block`` (same arguments,
    same result)."""
    _check_attn_args(x, block, n, heads)
    mode = F32_MODES[f32_mode_index(f32_prec, x.dtype)]
    return (x.float() + _attn_branch_ref(x.float(), block, n, heads, n, x.dtype, mode,
                                         scale)).to(x.dtype)


def fused_attention_block(x, block, n, heads, f32_prec="highest", scale=None):
    """B5: the attention half of a block on flat rows x [R, C], groups of
    ``n`` consecutive rows: x + proj(GRAND(LN1(x))), without the time add,
    drop-path, MLP or out-LN. Reads ``block.norm1``, ``block.attn.qkv`` and
    ``block.attn.proj``. x float32 or bfloat16; bf16 rounds the LN output,
    qkv (after the bias), the attention output and the result, as JAX's
    kernel does (fused_block.py:206-228). ``f32_prec``: the contraction
    mode of a float32 x (module doc). ``scale``: the attention's, default
    head_dim^-½.

    A CPU tensor runs the plain version. A CUDA tensor launches the 4
    kernels (8 under "high3" and "default"; counted on
    ``fused_attention_block`` as ``fused_transformer_block``'s) or raises.
    Under autograd it raises (``_refuse_autograd``)."""
    _check_device(fused_attention_block, x)
    _check_attn_args(x, block, n, heads)
    mode = f32_mode_index(f32_prec, x.dtype)
    _refuse_autograd("fused_attention_block", x, block)
    if x.device.type == "cpu":
        return fused_attention_block_ref(x, block, n, heads, f32_prec, scale)
    return _launch_attn(x, block, n, heads, mode, scale)


_zero_counts(fused_attention_block)


EPILOGUES = ("bias", "gelu", "residual")  # the kernels' epilogue codes 0, 1, 2


def _epilogue_ref(acc, epilogue, res, rscale):
    """The GEMM epilogue in float32 on acc = a · wᵀ + bias."""
    if epilogue == "gelu":
        return F.gelu(acc)
    if epilogue == "residual":
        return res.float() + (acc if rscale is None else rscale[:, 0:1].float() * acc)
    return acc


def _gemm_f32_ref(a, w, bias=None, epilogue="bias", res=None, rscale=None):
    """Plain version of ``_gemm_f32``: ``F.linear`` in float32 and the
    epilogue."""
    return _epilogue_ref(F.linear(a, w, bias), epilogue, res, rscale)


def _gemm_bf16_ref(a, w, bias=None, epilogue="bias", res=None, rscale=None):
    """Plain version of ``_gemm_bf16``: a float32 matmul of the bf16
    operands, the epilogue in float32, one rounding to bf16."""
    acc = F.linear(a.float(), w.float(), None if bias is None else bias.float())
    return _epilogue_ref(acc, epilogue, res, rscale).to(torch.bfloat16)


def _gemm(wrapper, plain, dt, a, w, bias, epilogue, res, rscale):
    """Checks the arguments of a block GEMM in storage type ``dt``; runs
    ``plain`` for a CPU tensor, else launches the kernel and counts it on
    ``wrapper``."""
    (m, k), n = a.shape, w.shape[0]
    if epilogue not in EPILOGUES or (epilogue == "residual") != (res is not None):
        raise ValueError(f"epilogue must be one of {EPILOGUES}, with res for 'residual' only")
    if w.shape != (n, k) or (res is not None and res.shape != (m, n)) or (
            bias is not None and bias.shape != (n,)) or (
            rscale is not None and (res is None or rscale.shape != (m, 2))):
        raise ValueError(f"need a [M, K], w [N, K], bias [N], res [M, N], rscale [M, 2]; got a "
                         f"{tuple(a.shape)} and w {tuple(w.shape)}")
    if a.device.type == "cpu":
        return plain(a, w, bias, epilogue, res, rscale)
    from diff3dhpe_torch.ops._build import load_library

    f32 = torch.float32
    if dt == f32 and (k % 8 or n % 4):
        raise ValueError(f"the f32 CUDA kernel needs K % 8 == 0 and N % 4 == 0, got K={k}, N={n}")
    if dt != f32 and (k % 32 or n % 8):
        raise ValueError(f"the CUDA kernel needs K % 32 == 0 and N % 8 == 0, got K={k}, N={n}")
    lib = load_library("fused_block")
    fn = lib.diff3dhpe_gemm_f32 if dt == f32 else lib.diff3dhpe_gemm_bf16
    out = torch.empty((m, n), device=a.device, dtype=dt)
    launched = ctypes.c_int(0)
    with torch.cuda.device(a.device):
        err = fn(
            _ptr(a, dt), _ptr(w, dt), _ptr(bias, f32), _ptr(res, dt), _ptr(rscale, f32),
            _ptr(out, dt), m, n, k, EPILOGUES.index(epilogue), ctypes.byref(launched),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    wrapper.launches += launched.value
    if err:
        raise RuntimeError(f"the {wrapper.__name__} kernel failed: cudaError_t {err}")
    return out


def _gemm_f32(a, w, bias=None, epilogue="bias", res=None, rscale=None):
    """The block kernels' f32 GEMM alone, for tests and measurements (no
    model path calls it): epilogue(a[M, K] · w[N, K]ᵀ + bias) in exact
    float32 FMAs, with a, w, ``res`` [M, N] and ``bias`` [N] (or None)
    float32 and the epilogue one of ``EPILOGUES``: the bias only, exact
    GELU, or res + s · (…) with the row's scale s = rscale[row, 0] for
    ``rscale`` [M, 2] float32 (the layout of the block's drop-path scales)
    or 1.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (``_gemm_f32.launches`` counts launches) or raises."""
    return _gemm(_gemm_f32, _gemm_f32_ref, torch.float32, a, w, bias, epilogue, res, rscale)


_gemm_f32.launches = 0


def _gemm_bf16(a, w, bias=None, epilogue="bias", res=None, rscale=None):
    """The same for the block kernels' bf16 GEMM: bf16(epilogue(a · wᵀ +
    bias)) with a, w and ``res`` bfloat16 and ``bias`` and ``rscale``
    float32.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (``_gemm_bf16.launches`` counts launches) or raises."""
    return _gemm(_gemm_bf16, _gemm_bf16_ref, torch.bfloat16, a, w, bias, epilogue, res, rscale)


_gemm_bf16.launches = 0


def split_bf16_ref(x, lo=True):
    """Plain version of ``split_bf16``: ``bf16_split`` in bfloat16, lo or None."""
    hi, low = bf16_split(x)
    return hi.bfloat16(), low.bfloat16() if lo else None


def split_bf16(x, lo=True):
    """The split kernel of the contraction modes alone, for tests and
    measurements (the block launches the same kernel): hi = bf16(x) and,
    with ``lo``, bf16(x − hi), from float32 x whose element count is a
    multiple of 8.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (``split_bf16.launches`` counts launches) or raises."""
    if x.dtype != torch.float32 or x.numel() % 8:
        raise ValueError(f"x must be float32 with a multiple of 8 elements, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return split_bf16_ref(x, lo)
    from diff3dhpe_torch.ops._build import load_library

    bf = torch.bfloat16
    hi = torch.empty(x.shape, device=x.device, dtype=bf)
    low = torch.empty(x.shape, device=x.device, dtype=bf) if lo else None
    launched = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = load_library("fused_block").diff3dhpe_split_bf16(
            _ptr(x, torch.float32), _ptr(hi, bf), _ptr(low, bf), x.numel(), ctypes.byref(launched),
            torch.cuda.current_stream(x.device).cuda_stream)
    split_bf16.launches += launched.value
    if err:
        raise RuntimeError(f"the split_bf16 kernel failed: cudaError_t {err}")
    return hi, low


split_bf16.launches = 0


def _gemm_wgmma_f32_ref(a_hi, a_lo, w_hi, w_lo, bias=None, epilogue="bias", res=None,
                        rscale=None):
    """Plain version of ``_gemm_wgmma_f32``: the float32 matmuls of the
    bf16 passes, summed as the kernel sums them, hh + (hl + lh), then the
    epilogue."""
    acc = F.linear(a_hi.float(), w_hi.float())
    if a_lo is not None:
        acc = acc + (F.linear(a_hi.float(), w_lo.float()) + F.linear(a_lo.float(), w_hi.float()))
    return _epilogue_ref(acc if bias is None else acc + bias, epilogue, res, rscale)


def _gemm_wgmma_f32(a_hi, a_lo, w_hi, w_lo, bias=None, epilogue="bias", res=None, rscale=None):
    """The f32-output tensor-core GEMM of the contraction modes alone, for
    tests and measurements (the block launches the same kernel):
    epilogue(Σ_p A_p · W_pᵀ + bias) in float32 over the passes (a_hi,
    w_hi) + ((a_hi, w_lo) + (a_lo, w_hi)), the cross terms in their own
    accumulators ("high3"), or (a_hi, w_hi) alone with a_lo and w_lo None
    ("default"). a_* [M, K] and w_* [N, K]
    bfloat16; bias [N], res [M, N] and rscale [M, 2] float32; epilogues as
    ``_gemm_f32``'s.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (``_gemm_wgmma_f32.launches`` counts launches) or raises."""
    (m, k), n = a_hi.shape, w_hi.shape[0]
    if (a_lo is None) != (w_lo is None):
        raise ValueError("give a_lo and w_lo together (three passes) or neither (one)")
    if epilogue not in EPILOGUES or (epilogue == "residual") != (res is not None):
        raise ValueError(f"epilogue must be one of {EPILOGUES}, with res for 'residual' only")
    if a_hi.device.type == "cpu":
        return _gemm_wgmma_f32_ref(a_hi, a_lo, w_hi, w_lo, bias, epilogue, res, rscale)
    if k % 8 or n % 8:
        raise ValueError(f"the CUDA kernel needs K % 8 == 0 and N % 8 == 0, got K={k}, N={n}")
    from diff3dhpe_torch.ops._build import load_library

    bf, f32 = torch.bfloat16, torch.float32
    out = torch.empty((m, n), device=a_hi.device, dtype=f32)
    launched = ctypes.c_int(0)
    with torch.cuda.device(a_hi.device):
        err = load_library("fused_block").diff3dhpe_gemm_wgmma_f32(
            _ptr(a_hi, bf), _ptr(a_lo, bf), _ptr(w_hi, bf), _ptr(w_lo, bf), _ptr(bias, f32),
            _ptr(res, f32), _ptr(rscale, f32), _ptr(out, f32), m, n, k, EPILOGUES.index(epilogue),
            1 if a_lo is None else 3, ctypes.byref(launched),
            torch.cuda.current_stream(a_hi.device).cuda_stream)
    _gemm_wgmma_f32.launches += launched.value
    if err:
        raise RuntimeError(f"the _gemm_wgmma_f32 kernel failed: cudaError_t {err}")
    return out


_gemm_wgmma_f32.launches = 0


def block_attention_ref(qkv, n, heads, n_pad=None, f32_prec="highest", j_groups=0, scale=None):
    """Plain version of ``block_attention`` (same arguments, same result)."""
    r, c3 = qkv.shape
    if j_groups:  # the cols layout: the rows layout on the transposed rows
        b = r // (n * j_groups)
        t = qkv.view(b, n, j_groups, c3).transpose(1, 2).reshape(r, c3)
        out = block_attention_ref(t, n, heads, f32_prec=f32_prec, scale=scale)
        return out.view(b, j_groups, n, c3 // 3).transpose(1, 2).reshape(r, c3 // 3)
    c, n_pad = c3 // 3, n if n_pad is None else n_pad
    dt = qkv.dtype
    mode = F32_MODES[f32_mode_index(f32_prec)] if dt == torch.float32 else "highest"
    q, k, v = qkv.float().reshape(r // n_pad, n_pad, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    dot = None if mode == "highest" else (lambda a, b: contract(a, b, mode))
    out = grand_attention_stored(q, k[:, :, :n], v[:, :, :n], _scale(scale, c, heads),
                                 lambda a: a.to(dt).float(), v_self=v, dot=dot)
    return out.permute(0, 2, 1, 3).reshape(r, c).to(dt)


def block_attention(qkv, n, heads, n_pad=None, f32_prec="highest", j_groups=0, scale=None):
    """The block kernels' attention step alone, for tests and measurements
    (B1 and B2 launch the same kernels): GRAND attention on qkv [R, 3C]
    float32 or bfloat16 in groups of ``n_pad`` rows (default n), over each
    group's n real keys, at float32 under contraction mode ``f32_prec``
    (bfloat16 ignores it, as the blocks do); out [R, C] in qkv's dtype.
    ``j_groups`` = J > 0: B2's layout instead, the groups (b, j) of n
    frames of the spatial-major rows (b·n + f)·J + j (``n_pad`` unused).
    ``scale``: the attention's, default head_dim^-½.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (``block_attention.launches`` counts launches) or raises."""
    r, c3 = qkv.shape
    n_pad = n if n_pad is None or j_groups else n_pad
    if (qkv.dtype not in DTYPES or c3 % (3 * heads) or r % (n_pad * max(j_groups, 1))
            or not 0 < n <= n_pad):
        raise ValueError(f"qkv must be float32 or bfloat16 [R, 3C] with C a multiple of "
                         f"heads={heads} and R of n_pad={n_pad} >= n={n} (times j_groups="
                         f"{j_groups}), got {qkv.dtype} {tuple(qkv.shape)}")
    mode = f32_mode_index(f32_prec)
    if qkv.device.type == "cpu":
        return block_attention_ref(qkv, n, heads, n_pad, f32_prec, j_groups, scale)
    from diff3dhpe_torch.ops._build import load_library

    lib = load_library("fused_block")
    c, dt = c3 // 3, qkv.dtype
    if not lib.diff3dhpe_attn_takes_head_dim(c // heads) or n > lib.diff3dhpe_attn_max_n():
        raise ValueError(f"the CUDA kernel takes head_dim {HEAD_DIM_RULE} and n <= "
                         f"{lib.diff3dhpe_attn_max_n()}, got head_dim {c // heads} and n {n}")
    out = torch.empty((r, c), device=qkv.device, dtype=dt)
    launched = ctypes.c_int(0)
    extra = [mode] if dt == torch.float32 else []
    fn = lib.diff3dhpe_block_attn_f32 if dt == torch.float32 else lib.diff3dhpe_block_attn_bf16
    with torch.cuda.device(qkv.device):
        err = fn(
            _ptr(qkv, dt), _ptr(out, dt), r, c, heads, n, n_pad, j_groups,
            _scale(scale, c, heads), *extra, ctypes.byref(launched),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    block_attention.launches += launched.value
    if err:
        raise RuntimeError(f"the block_attention kernel failed: cudaError_t {err}")
    return out


block_attention.launches = 0


def _check_ln_args(x, weight, bias, t_rows, rows_per_item):
    if x.ndim != 2 or x.dtype not in DTYPES:
        raise ValueError(f"x must be [R, C] float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    r, c = x.shape
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight and bias must be [{c}], got {tuple(weight.shape)} and "
                         f"{tuple(bias.shape)}")
    if t_rows is not None and (rows_per_item is None or rows_per_item <= 0 or t_rows.ndim != 2
                               or t_rows.shape[1] != c
                               or (r - 1) // rows_per_item >= t_rows.shape[0]):
        raise ValueError(f"t_rows {tuple(t_rows.shape)} with rows_per_item {rows_per_item} does "
                         f"not cover R={r} rows at C={c}")


def layer_norm_rows_ref(x, weight, bias, eps=1e-6, *, t_rows=None, rows_per_item=None,
                        f32_prec="highest"):
    """Plain version of ``layer_norm_rows`` (same arguments, same result)."""
    _check_ln_args(x, weight, bias, t_rows, rows_per_item)
    dt = x.dtype
    mode = F32_MODES[f32_mode_index(f32_prec, dt)]
    rnd = (lambda a: a) if dt == torch.float32 else (lambda a: a.to(dt).float())
    xs = x.float()
    if t_rows is not None:
        rows = torch.arange(x.shape[0], device=x.device) // rows_per_item
        xs = rnd(xs + time_rows_under(rnd(t_rows.float()), mode)[rows])
    y = F.layer_norm(xs, (x.shape[1],), weight.float(), bias.float(), eps)
    return y.to(dt), xs.to(dt)


def layer_norm_rows(x, weight, bias, eps=1e-6, *, t_rows=None, rows_per_item=None,
                    f32_prec="highest"):
    """The block kernels' LayerNorm alone, for tests and measurements (the
    block launches the same kernel): (y, xs) with xs = x + t_rows[row //
    rows_per_item] (x itself without ``t_rows``) and y = LN(xs) · weight +
    bias, on rows x [R, C] of float32 or bfloat16. At bf16 xs is rounded to
    bf16 before the statistics (JAX's ``_layernorm_rows`` on the stored
    residual stream), which are float32, and y is rounded once. ``weight``
    and ``bias`` [C] are read as float32. At float32 the time rows are read
    under contraction mode ``f32_prec`` (``time_rows_under``).

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (``layer_norm_rows.launches`` counts launches) or raises."""
    if x.device.type == "cpu":
        return layer_norm_rows_ref(x, weight, bias, eps, t_rows=t_rows,
                                   rows_per_item=rows_per_item, f32_prec=f32_prec)
    _check_ln_args(x, weight, bias, t_rows, rows_per_item)
    mode = f32_mode_index(f32_prec, x.dtype)
    from diff3dhpe_torch.ops._build import load_library

    dt, f32 = x.dtype, torch.float32
    r, c = x.shape
    lib = load_library("fused_block")
    _ln_limits(lib, x)
    w, b, t = _as(weight, f32), _as(bias, f32), _as(t_rows, dt)
    y = torch.empty_like(x)
    xs = x if t is None else torch.empty_like(x)
    launched = ctypes.c_int(0)
    fn = lib.diff3dhpe_layer_norm_f32 if dt == f32 else lib.diff3dhpe_layer_norm_bf16
    with torch.cuda.device(x.device):
        err = fn(
            _ptr(x, dt), _ptr(t, dt), rows_per_item or 1, _ptr(w, f32), _ptr(b, f32), eps,
            None if t is None else _ptr(xs, dt), _ptr(y, dt), r, c, mode, ctypes.byref(launched),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    layer_norm_rows.launches += launched.value
    if err:
        raise RuntimeError(f"the layer_norm_rows kernel failed: cudaError_t {err}")
    return y, xs


layer_norm_rows.launches = 0


def _ptr(t, dtype):
    """Device pointer of a CUDA tensor of ``dtype`` the kernels may read 16
    bytes at a time: contiguous and 16-byte aligned. None -> NULL."""
    if t is None:
        return None
    if t.dtype != dtype or not t.is_cuda or not t.is_contiguous():
        raise ValueError(
            f"kernel operands must be contiguous {dtype} CUDA tensors, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if t.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    return t.data_ptr()


def _as(t, dtype):
    return t if t is None or t.dtype == dtype else t.to(dtype)


def _ln_limits(lib, x):
    """Raises unless the LayerNorm kernel takes rows of x's width and dtype."""
    c, dt = x.shape[1], x.dtype
    if c % (16 // x.element_size()) or c > lib.diff3dhpe_ln_max_c(x.element_size()):
        raise ValueError(f"the CUDA LayerNorm takes C in 16-byte pieces up to "
                         f"{lib.diff3dhpe_ln_max_c(x.element_size())} at {dt}, got C={c}")


def _kernel_limits(lib, x, n, heads, widths):
    """Raises unless the block kernels take this head_dim, n, LayerNorm
    width and these GEMM widths at x's dtype."""
    _ln_limits(lib, x)
    d = x.shape[1] // heads
    if not lib.diff3dhpe_attn_takes_head_dim(d) or n > lib.diff3dhpe_attn_max_n():
        raise ValueError(
            f"the CUDA kernel takes head_dim {HEAD_DIM_RULE} and "
            f"n <= {lib.diff3dhpe_attn_max_n()}, got head_dim {d} and n {n}"
        )
    step = 8 if x.dtype == torch.float32 else 32  # the bf16 GEMM takes K in steps of 32
    if any(w % step for w in widths):
        raise ValueError(f"the CUDA kernel needs C and hidden multiples of {step} at {x.dtype}, "
                         f"got {widths}")


def _count(wrapper, launched, dt):
    """Adds a block entry point's launches [all, LayerNorms, GEMMs, splits,
    f32-output tensor-core GEMMs, attention and LayerNorm instances under a
    mode] (see LaunchCount in csrc/fused_block.cu) to the wrapper's counts."""
    every, ln, gemm, split, gemm_mode, attn_mode, ln_mode = launched
    wrapper.launches += every
    wrapper.launches_ln += ln
    wrapper.launches_split += split
    wrapper.launches_gemm_mode += gemm_mode
    wrapper.launches_attn_mode += attn_mode
    wrapper.launches_ln_mode += ln_mode
    if dt == torch.float32:
        wrapper.launches_gemm_f32 += gemm
    else:
        wrapper.launches_bf16 += every


def _split_scratch(mode, r, c, hidden, device):
    """(a_split, w_split) bf16 scratch of the products' splits under mode
    index ``mode`` > 0 (csrc/fused_block.cu::ModeScratch's layout), or
    (None, None) under "highest"."""
    if mode == 0:
        return None, None
    bf = torch.bfloat16
    return (torch.empty(2 * r * max(c, hidden), device=device, dtype=bf),
            torch.empty(2 * (4 * c * c + 2 * hidden * c), device=device, dtype=bf))


def _launch_attn(x, block, n, heads, mode=0, scale=None):
    """Launches B5's kernels on rows x [R, C] and counts them."""
    from diff3dhpe_torch.ops._build import load_library

    lib = load_library("fused_block")
    r, c = x.shape
    _kernel_limits(lib, x, n, heads, (c,))
    scale = _kernel_scale(scale, x, heads)
    dt, f32 = x.dtype, torch.float32
    # Cast copies are held here until the launch is enqueued (see _launch).
    attn = block.attn
    operands = [_as(block.norm1.weight, f32), _as(block.norm1.bias, f32),
                _as(attn.qkv.weight, dt), _as(attn.qkv.bias, f32),
                _as(attn.proj.weight, dt), _as(attn.proj.bias, f32)]
    for t in operands:
        if t is not None and t.device != x.device:
            raise ValueError(f"operand on {t.device}, x on {x.device}")
    ln_w, ln_b, wq, bq, wp, bp = operands
    empty = lambda cols: torch.empty((r, cols), device=x.device, dtype=dt)
    xn, qkv, att, out = empty(c), empty(3 * c), empty(c), empty(c)
    a_split, w_split = _split_scratch(mode, r, c, c, x.device)
    launched = (ctypes.c_int * _LAUNCH_KINDS)()
    fn = lib.diff3dhpe_fused_attn_block_f32 if dt == f32 else lib.diff3dhpe_fused_attn_block_bf16
    with torch.cuda.device(x.device):
        err = fn(
            _ptr(x, dt), _ptr(ln_w, f32), _ptr(ln_b, f32), block.norm1.eps,
            _ptr(wq, dt), _ptr(bq, f32), _ptr(wp, dt), _ptr(bp, f32),
            _ptr(xn, dt), _ptr(qkv, dt), _ptr(att, dt), _ptr(out, dt),
            r, c, n, heads, scale, mode,
            _ptr(a_split, torch.bfloat16), _ptr(w_split, torch.bfloat16),
            launched, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _count(fused_attention_block, launched, dt)
    if err:
        raise RuntimeError(f"fused_attention_block kernel launch failed: cudaError_t {err}")
    return out


def _kernel_scale(scale, x, heads):
    """The attention's scale as the block kernels take it; the bf16 kernels
    take the row maximum before they scale, so they need it positive."""
    scale = _scale(scale, x.shape[1], heads)
    if x.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"the bf16 block kernels take a positive scale, got {scale}")
    return scale


def _launch(wrapper, x, block, n, heads, n_pad, j_groups, t_rows, rows_per_item, out_ln,
            dp_scales, mode=0, scale=None):
    """Launches the block kernels on rows x [R, C]: the rows layout (groups
    of n_pad rows) with j_groups == 0, else the cols layout; ``out_ln`` is
    (w, b, eps) or None, ``dp_scales`` per row, ``mode`` the contraction
    mode's index, ``scale`` the attention's (None: head_dim^-½). Counts the
    launches on ``wrapper``."""
    from diff3dhpe_torch.ops._build import load_library

    lib = load_library("fused_block")
    r, c = x.shape
    hidden = block.mlp.fc1.weight.shape[0]
    _kernel_limits(lib, x, n, heads, (c, hidden))
    scale = _kernel_scale(scale, x, heads)
    dt, f32 = x.dtype, torch.float32
    # Operands in the types the kernels read, held here until the launch
    # is enqueued (a cast copy freed earlier could be handed to the scratch
    # buffers below).
    gemms = (block.attn.qkv, block.attn.proj, block.mlp.fc1, block.mlp.fc2)
    weights = [_as(m.weight, dt) for m in gemms]
    biases = [_as(m.bias, f32) for m in gemms]
    oln = [None, None] if out_ln is None else list(out_ln[:2])
    lns = [_as(p, f32) for p in (block.norm1.weight, block.norm1.bias, block.norm2.weight,
                                 block.norm2.bias, *oln)]
    t_rows, dp_scales = _as(t_rows, dt), _as(dp_scales, f32)
    for t in [t_rows, dp_scales, *weights, *biases, *lns]:
        if t is not None and t.device != x.device:
            raise ValueError(f"operand on {t.device}, x on {x.device}")
    wq, wp, w1, w2 = (_ptr(w, dt) for w in weights)
    bq, bp, b1, b2 = (_ptr(b, f32) for b in biases)
    ln1w, ln1b, ln2w, ln2b, olnw, olnb = (_ptr(p, f32) for p in lns)

    empty = lambda cols: torch.empty((r, cols), device=x.device, dtype=dt)
    xs = empty(c) if t_rows is not None else None
    xn, qkv, attn, h1, mid, out = empty(c), empty(3 * c), empty(c), empty(c), empty(hidden), empty(c)
    a_split, w_split = _split_scratch(mode, r, c, hidden, x.device)
    launched = (ctypes.c_int * _LAUNCH_KINDS)()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = lib.diff3dhpe_fused_block_f32 if dt == f32 else lib.diff3dhpe_fused_block_bf16
    with torch.cuda.device(x.device):
        err = fn(
            _ptr(x, dt), _ptr(t_rows, dt), rows_per_item or 1, _ptr(dp_scales, f32),
            ln1w, ln1b, block.norm1.eps,
            wq, bq, wp, bp,
            ln2w, ln2b, block.norm2.eps,
            w1, b1, w2, b2,
            olnw, olnb, out_ln[2] if out_ln is not None else 0.0,
            _ptr(xs, dt), _ptr(xn, dt), _ptr(qkv, dt), _ptr(attn, dt), _ptr(h1, dt),
            _ptr(mid, dt), _ptr(out, dt),
            r, c, hidden, n, n_pad, j_groups, heads, scale, mode,
            _ptr(a_split, torch.bfloat16), _ptr(w_split, torch.bfloat16),
            launched, stream,
        )
    _count(wrapper, launched, dt)
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: cudaError_t {err}")
    return out
