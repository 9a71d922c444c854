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

where s0, s1 are the row's drop-path scales (1 without). B1 takes groups
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
"""
from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

DTYPES = (torch.float32, torch.bfloat16)


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
        got = tuple(block.get_parameter(name).shape)
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


def _out_ln_params(out_ln):
    """(weight, bias, eps) of the out-LN, or None. Both layouts read them in
    float32. (JAX's B2 casts them to x's dtype, fused_block.py:846, where
    its B1 does not; the port keeps the model's float32 LayerNorm in both,
    so the two layouts compute the same function.)"""
    return None if out_ln is None else (out_ln.weight, out_ln.bias, out_ln.eps)


def _ref_ops(dt):
    """(rnd, lin, ln) of the plain versions for storage type ``dt``: ``rnd``
    rounds to dt where a kernel stores; ``lin`` is a float32 matmul of the
    operands as the kernel sees them (weights rounded to dt, bias float32);
    ``ln`` a float32 LayerNorm."""
    rnd = (lambda a: a) if dt == torch.float32 else (lambda a: a.to(dt).float())

    def lin(a, m):
        return F.linear(a, rnd(m.weight.float()), None if m.bias is None else m.bias.float())

    def ln(a, m):
        return F.layer_norm(a, (a.shape[-1],), m.weight.float(), m.bias.float(), m.eps)

    return rnd, lin, ln


def _attn_branch_ref(x, block, n, heads, n_pad, dt):
    """proj(GRAND(LN1(x))) in float32 on float32 rows x [R, C] that hold
    values of type ``dt``, rounding to dt where the kernels store: the LN
    output, qkv (after the bias), P and the attention output."""
    rnd, lin, ln = _ref_ops(dt)
    r, c = x.shape
    qkv = rnd(lin(rnd(ln(x, block.norm1)), block.attn.qkv))
    q, k, v = qkv.reshape(r // n_pad, n_pad, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    logits = q @ k[:, :, :n].transpose(-1, -2) * (c // heads) ** -0.5
    attn = rnd(rnd(torch.softmax(logits, dim=-1)) @ v[:, :, :n] - v)
    return lin(attn.permute(0, 2, 1, 3).reshape(r, c), block.attn.proj)


def _block_ref(x, block, n, heads, n_pad, t_rows, rows_per_item, out_ln, dp_scales):
    """The plain block on groups of n_pad rows; ``out_ln`` is (w, b, eps)
    or None. Every product is a float32 matmul of the operands as the
    kernel sees them (exact for bf16-rounded operands), and ``rnd`` rounds
    to x's dtype where the kernel stores."""
    dt = x.dtype
    rnd, lin, ln = _ref_ops(dt)
    r, c = x.shape
    s_attn, s_mlp = (1.0, 1.0) if dp_scales is None else (dp_scales[:, 0:1], dp_scales[:, 1:2])

    x = x.float()
    if t_rows is not None:
        x = rnd(x + rnd(t_rows.float())[torch.arange(r, device=x.device) // rows_per_item])
    h1 = rnd(x + s_attn * _attn_branch_ref(x, block, n, heads, n_pad, dt))
    mid = rnd(F.gelu(lin(rnd(ln(h1, block.norm2)), block.mlp.fc1)))
    out = h1 + s_mlp * lin(mid, block.mlp.fc2)
    if out_ln is not None:
        w, b, eps = out_ln
        out = F.layer_norm(rnd(out), (c,), w.float(), b.float(), eps)
    return out.to(dt)


def fused_transformer_block_ref(x, block, n, heads, *, n_pad=None, t_rows=None,
                                rows_per_item=None, out_ln=None, dp_scales=None):
    """Plain PyTorch version of ``fused_transformer_block`` (same
    arguments, same result). Pad query rows (n..n_pad-1 of a group) attend
    to the group's real keys; their outputs are garbage the caller ignores,
    as in the JAX kernel."""
    n_pad = n if n_pad is None else n_pad
    _check_args(x, block, n, heads, n_pad, t_rows, rows_per_item, dp_scales)
    return _block_ref(x, block, n, heads, n_pad, t_rows, rows_per_item,
                      _out_ln_params(out_ln), dp_scales)


def fused_transformer_block(x, block, n, heads, *, n_pad=None, t_rows=None,
                            rows_per_item=None, out_ln=None, dp_scales=None):
    """B1: whole transformer block on flat rows x [R, C] (see the module doc).

    ``n``: real rows per attention group; ``n_pad``: rows per group in x
    (default n; rows n..n_pad-1 are padding, masked as keys). ``t_rows``
    [B, C]: time-embedding rows added on load, row i taking
    t_rows[i // rows_per_item]. ``out_ln``: LayerNorm applied to the
    output. ``dp_scales`` [R, 2]: per-row drop-path scales of the attention
    and MLP branches (JAX ``fused_transformer_block(dp_scales=...)``).

    A CPU tensor runs the plain version. A CUDA tensor launches the
    kernels (7, or 8 with ``out_ln``; ``fused_transformer_block.launches``
    counts them, ``.launches_bf16`` those at bf16) or raises."""
    if x.device.type == "cpu":
        return fused_transformer_block_ref(
            x, block, n, heads, n_pad=n_pad, t_rows=t_rows,
            rows_per_item=rows_per_item, out_ln=out_ln, dp_scales=dp_scales,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_transformer_block runs on cpu or cuda, not {x.device}")
    n_pad = n if n_pad is None else n_pad
    _check_args(x, block, n, heads, n_pad, t_rows, rows_per_item, dp_scales)
    return _launch(fused_transformer_block, x, block, n, heads, n_pad, 0, t_rows,
                   rows_per_item, _out_ln_params(out_ln), dp_scales)


fused_transformer_block.launches = 0
fused_transformer_block.launches_bf16 = 0


def fused_temporal_block_cols_ref(x, block, n, j_groups, heads, *, t_rows=None, out_ln=None,
                                  dp_scales=None):
    """Plain PyTorch version of ``fused_temporal_block_cols`` (same
    arguments, same result): the block on the transposed rows."""
    _check_cols_args(x, block, n, j_groups, heads, t_rows, dp_scales)
    rows, cols = x.shape
    b, c = rows // n, cols // j_groups
    xt = x.view(b, n, j_groups, c).transpose(1, 2).reshape(b * j_groups * n, c)
    dp = None if dp_scales is None else dp_scales.view(b * j_groups, 1, 2).expand(
        b * j_groups, n, 2).reshape(-1, 2)
    out = _block_ref(xt, block, n, heads, n, t_rows, j_groups * n, _out_ln_params(out_ln), dp)
    return out.view(b, j_groups, n, c).transpose(1, 2).reshape(rows, cols)


def fused_temporal_block_cols(x, block, n, j_groups, heads, *, t_rows=None, out_ln=None,
                              dp_scales=None):
    """B2: the temporal block over the spatial-major activations, with JAX's
    signature (without frame padding: F8 = F = n).

    x [B*F, J*C] is the [B, F, J, C] buffer seen in 2-D; the attention group
    of (sample b, joint j) is its column slice x[b*F:(b+1)*F, j*C:(j+1)*C].
    ``t_rows`` [B, C]: one time-embedding row per sample. ``out_ln``: the
    inter-block LayerNorm. ``dp_scales`` [B*J, 2]: one pair of drop-path
    scales per group (b, j), row b*J + j. The result equals B1's on the
    transposed rows (``fused_temporal_block_cols_ref``).

    A CPU tensor runs the plain version. A CUDA tensor launches the kernels
    (7, or 8 with ``out_ln``; ``fused_temporal_block_cols.launches`` counts
    them, ``.launches_bf16`` those at bf16) or raises."""
    if x.device.type == "cpu":
        return fused_temporal_block_cols_ref(x, block, n, j_groups, heads, t_rows=t_rows,
                                             out_ln=out_ln, dp_scales=dp_scales)
    if x.device.type != "cuda":
        raise ValueError(f"fused_temporal_block_cols runs on cpu or cuda, not {x.device}")
    _check_cols_args(x, block, n, j_groups, heads, t_rows, dp_scales)
    rows, cols = x.shape
    b, c = rows // n, cols // j_groups
    dp = None if dp_scales is None else dp_scales.view(b, 1, j_groups, 2).expand(
        b, n, j_groups, 2).reshape(rows * j_groups, 2)  # per row, spatial-major order
    out = _launch(fused_temporal_block_cols, x.view(rows * j_groups, c), block, n, heads, n,
                  j_groups, t_rows, n * j_groups, _out_ln_params(out_ln), dp)
    return out.view(rows, cols)


fused_temporal_block_cols.launches = 0
fused_temporal_block_cols.launches_bf16 = 0


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


def fused_attention_block_ref(x, block, n, heads):
    """Plain PyTorch version of ``fused_attention_block`` (same arguments,
    same result)."""
    _check_attn_args(x, block, n, heads)
    return (x.float() + _attn_branch_ref(x.float(), block, n, heads, n, x.dtype)).to(x.dtype)


def fused_attention_block(x, block, n, heads):
    """B5: the attention half of a block on flat rows x [R, C], groups of
    ``n`` consecutive rows: x + proj(GRAND(LN1(x))), without the time add,
    drop-path, MLP or out-LN. Reads ``block.norm1``, ``block.attn.qkv`` and
    ``block.attn.proj``. x float32 or bfloat16; bf16 rounds the LN output,
    qkv (after the bias), the attention output and the result, as JAX's
    kernel does (fused_block.py:206-228).

    A CPU tensor runs the plain version. A CUDA tensor launches the 4
    kernels (``fused_attention_block.launches`` counts them,
    ``.launches_bf16`` those at bf16) or raises."""
    if x.device.type == "cpu":
        return fused_attention_block_ref(x, block, n, heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_block runs on cpu or cuda, not {x.device}")
    _check_attn_args(x, block, n, heads)
    return _launch_attn(x, block, n, heads)


fused_attention_block.launches = 0
fused_attention_block.launches_bf16 = 0


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


def _kernel_limits(lib, x, n, heads, widths):
    """Raises unless the block kernels take this head_dim, n and these GEMM
    widths at x's dtype."""
    d = x.shape[1] // heads
    if d != lib.diff3dhpe_attn_head_dim() or n > lib.diff3dhpe_attn_max_n():
        raise ValueError(
            f"the CUDA kernel takes head_dim {lib.diff3dhpe_attn_head_dim()} and "
            f"n <= {lib.diff3dhpe_attn_max_n()}, got head_dim {d} and n {n}"
        )
    step = 8 if x.dtype == torch.float32 else 32  # the bf16 GEMM takes K in steps of 32
    if any(w % step for w in widths):
        raise ValueError(f"the CUDA kernel needs C and hidden multiples of {step} at {x.dtype}, "
                         f"got {widths}")


def _launch_attn(x, block, n, heads):
    """Launches B5's kernels on rows x [R, C] and counts them."""
    from diff3dhpe_torch.ops._build import load_library

    lib = load_library("fused_block")
    r, c = x.shape
    _kernel_limits(lib, x, n, heads, (c,))
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
    launched = ctypes.c_int(0)
    fn = lib.diff3dhpe_fused_attn_block_f32 if dt == f32 else lib.diff3dhpe_fused_attn_block_bf16
    with torch.cuda.device(x.device):
        err = fn(
            _ptr(x, dt), _ptr(ln_w, f32), _ptr(ln_b, f32), block.norm1.eps,
            _ptr(wq, dt), _ptr(bq, f32), _ptr(wp, dt), _ptr(bp, f32),
            _ptr(xn, dt), _ptr(qkv, dt), _ptr(att, dt), _ptr(out, dt),
            r, c, n, heads, (c // heads) ** -0.5,
            ctypes.byref(launched), torch.cuda.current_stream(x.device).cuda_stream,
        )
    fused_attention_block.launches += launched.value
    if dt != f32:
        fused_attention_block.launches_bf16 += launched.value
    if err:
        raise RuntimeError(f"fused_attention_block kernel launch failed: cudaError_t {err}")
    return out


def _launch(wrapper, x, block, n, heads, n_pad, j_groups, t_rows, rows_per_item, out_ln,
            dp_scales):
    """Launches the block kernels on rows x [R, C]: the rows layout (groups
    of n_pad rows) with j_groups == 0, else the cols layout; ``out_ln`` is
    (w, b, eps) or None, ``dp_scales`` per row. Counts the launches on
    ``wrapper``."""
    from diff3dhpe_torch.ops._build import load_library

    lib = load_library("fused_block")
    r, c = x.shape
    d = c // heads
    hidden = block.mlp.fc1.weight.shape[0]
    _kernel_limits(lib, x, n, heads, (c, hidden))
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
    launched = ctypes.c_int(0)
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
            r, c, hidden, n, n_pad, j_groups, heads, d ** -0.5,
            ctypes.byref(launched), stream,
        )
    wrapper.launches += launched.value
    if dt != f32:
        wrapper.launches_bf16 += launched.value
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: cudaError_t {err}")
    return out
