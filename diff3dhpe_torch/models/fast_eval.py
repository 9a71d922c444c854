"""Forward of the MixSTE denoiser through the fused block, for eval and
for training.

Port of ``diff3dhpe_tpu/models/fast_eval.py``. It runs the weights of a
``models.mixste.MixSTEDenoiser``, keeps tokens as flat spatial-major rows
[B*F*J, C] between blocks, and hands every transformer block to a fused
block kernel together with its per-block time-embedding rows, drop-path
scales and the inter-block LayerNorm:

  spatial blocks   ``fused_transformer_block`` (B1) on groups of J joint rows;
  temporal blocks  ``temporal_mode="rows"``: B1 on the [B, J, F, C]
                   transpose, groups of F frame rows (JAX's default);
                   ``temporal_mode="cols"``: ``fused_temporal_block_cols``
                   (B2) on the spatial-major rows themselves, no transpose.

The JAX path pads frames to a multiple of 8 for the TPU's sublanes; the
CUDA kernels take any group size, so the port does not pad, and the pair
backward below works on the same rows as its forward. The fusion layer,
time MLP, per-block time projections and head run outside the kernels, as
they do in JAX.

``dtype=torch.bfloat16`` runs the trunk at bf16 with JAX's casts: every
dense layer outside the kernels takes its weight and bias in the
activation dtype and adds the bias after the product's rounding
(``_dense``, JAX fast_eval.py:29-33), the position embeddings are added in
bf16, and ``f32_head`` casts the trunk output to float32 before the head.
``bf16_snapshot`` makes those bf16 weights once. ``f32_tail_pairs`` runs
the last block pairs and the head of a bf16 forward at float32 (JAX's
precision tail).

``matmul_precision`` (``ops.matmul_precision``), the session precision:
every float32 product outside the fused kernels (the fusion layer, the
time MLP and the blocks' time projections, the head and the s2f weighted
mean) and, in training, every float32 product of the recompute (its dense
layers and attention, forward and backward) contracts at it. The fused
blocks take ``f32_prec`` alone, as JAX's ``_dot_f32`` pins its own mode.

Training runs the fused forward with a recompute backward at float32 or
bf16, as JAX's ``FastTrainCfg.dtype_name``. The recompute is the mirror
``mirror_forward_denoise`` (JAX ``xla_forward_denoise``): the module's
blocks at JAX's ``_xla_block`` casts, whose LayerNorms return their input's
dtype, so at bf16 the whole trunk stays bf16 as the fused forward's does
(the flax module's LayerNorms return float32). Its attention runs through
``grand_attention_trainable`` (``attn_bwd``: B3 or B6 forward, B4 backward
on CUDA) or the plain formulas, whatever the module's ``use_pallas`` (JAX's
mirror ignores it too).

- ``fast_forward_denoise_train_pairs`` cuts the trunk into (spatial,
  temporal) block pairs, each a ``torch.autograd.Function`` (``_FusedPair``,
  JAX's ``_fused_pair`` custom VJP): the forward runs the fused kernels and
  keeps only the pair's input, and the backward recomputes that pair
  through the mirror under autograd (JAX ``_xla_pair``).
- ``fast_forward_denoise_train`` is one ``torch.autograd.Function`` over the
  whole fused forward (JAX's monolithic ``fast_forward_denoise_train``, the
  ``pair_vjp=False`` path) whose backward recomputes the whole mirror,
  each block under ``checkpoint`` with ``ckpt_blocks``.

Every entry point here refuses a module that sets ``qk_scale`` or a
dropout rate (``check_fused``): the fused blocks and the mirror run
head_dim^-½ and drop nothing. JAX's fused paths read only the parameters
and ``num_heads`` and run the same whatever the module says
(diff3dhpe_tpu/models/fast_eval.py:151-164, :363).
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from diff3dhpe_torch.device import to_device
from diff3dhpe_torch.models.mixste import dense as _dense
from diff3dhpe_torch.models.mixste import layer_norm, silu
from diff3dhpe_torch.ops.attention import grand_attention, grand_attention_trainable
from diff3dhpe_torch.ops.fused_block import (
    f32_mode_index, fused_temporal_block_cols, fused_transformer_block,
)

TEMPORAL_MODES = ("rows", "cols")


def _bf16_names(model, f32_head):
    """The names of the parameters the bf16 forward reads in bf16, as JAX
    casts them: the fusion layer, the time MLP and the per-block time
    projections (weights and biases), the block GEMM weights (their biases
    and every LayerNorm stay float32), the position embeddings, and the head
    projection unless ``f32_head``."""
    dense = ["fusion_layer"]
    if model.time_mlp is not None:
        dense += ["time_mlp.1", "time_mlp.3"]
    if not f32_head:
        dense.append("head.1")
    names = {"Spatial_pos_embed", "Temporal_pos_embed"}
    for kind in ("STEblocks", "TTEblocks"):
        for i, block in enumerate(getattr(model, kind)):
            if block.time_mlp is not None:
                dense.append(f"{kind}.{i}.time_mlp.1")
            names |= {f"{kind}.{i}.{m}.weight" for m in ("attn.qkv", "attn.proj", "mlp.fc1",
                                                         "mlp.fc2")}
    for prefix in dense:
        names |= {f"{prefix}.{n}" for n, _ in model.get_submodule(prefix).named_parameters()}
    return names


@torch.no_grad()
def bf16_snapshot(model, f32_head=False):
    """A copy of ``model`` with the weights the bf16 forward reads
    (``_bf16_names``) cast to bf16 and the others copied: the same modules
    with the copies in place of the parameters, for ``fast_forward_denoise``
    to read. Made with tensor ops only (no ``deepcopy``), so that an
    exported eval step (``io.export``) makes its casts inside the graph from
    the weights it is given, once per call."""
    cast = _bf16_names(model, f32_head)

    def copied(module, prefix):
        new = copy.copy(module)
        new._parameters = {
            k: None if p is None else p.detach().to(torch.bfloat16) if prefix + k in cast
            else p.detach().clone() for k, p in module._parameters.items()}
        new._modules = {k: None if m is None else copied(m, f"{prefix}{k}.")
                        for k, m in module._modules.items()}
        return new

    return copied(model, "")


def _fused_pair(model, i, shape, x_flat, t, dp_s, dp_t, temporal_mode="rows",
                f32_prec="highest", matmul_precision="highest"):
    """Block pair i on the flat spatial-major rows x_flat [B*F*J, C]
    through two fused block calls, the temporal one in ``temporal_mode``;
    returns rows in the same order. t [B, 2C] is the time embedding (or
    None); dp_s [B, F, 2], dp_t [B, J, 2] the per-group drop-path scales (or
    None), broadcast here to per-row scales as the JAX pair does.
    ``f32_prec``: the blocks' contraction mode at float32;
    ``matmul_precision``: the time projections'."""
    b, f, p = shape
    c, heads, rows_item = model.embed_dim, model.num_heads, f * p

    def time_rows(block):
        if t is None or block.time_mlp is None:
            return None
        return _dense(block.time_mlp[1], silu(t), matmul_precision=matmul_precision).contiguous()

    def dp_rows(d, groups, per_group):
        if d is None:
            return None
        return d[:, :, None, :].expand(b, groups, per_group, 2).reshape(b * rows_item, 2)

    block_s, block_t = model.STEblocks[i], model.TTEblocks[i]
    x_flat = fused_transformer_block(
        x_flat, block_s, n=p, heads=heads, t_rows=time_rows(block_s), rows_per_item=rows_item,
        out_ln=model.Spatial_norm, dp_scales=dp_rows(dp_s, f, p), f32_prec=f32_prec,
    )
    x4 = x_flat.view(b, f, p, c)
    if i == 0:
        x4 = x4 + model.Temporal_pos_embed[:, :, None, :].to(x4.dtype)
    if temporal_mode == "cols":
        x_cols = fused_temporal_block_cols(
            x4.reshape(b * f, p * c), block_t, n=f, j_groups=p, heads=heads,
            t_rows=time_rows(block_t), out_ln=model.Temporal_norm,
            dp_scales=None if dp_t is None else dp_t.reshape(b * p, 2), f32_prec=f32_prec,
        )
        return x_cols.view(b * rows_item, c)
    x_t = x4.transpose(1, 2).contiguous().view(b * rows_item, c)
    x_t = fused_transformer_block(
        x_t, block_t, n=f, heads=heads, t_rows=time_rows(block_t), rows_per_item=rows_item,
        out_ln=model.Temporal_norm, dp_scales=dp_rows(dp_t, p, f), f32_prec=f32_prec,
    )
    return x_t.view(b, p, f, c).transpose(1, 2).contiguous().view(b * rows_item, c)


def _head(model, x_flat, shape, f32_head=False, matmul_precision="highest"):
    """[s2f weighted mean], [cast to float32], head LayerNorm (computed in
    float32, stored in the activation dtype) and projection; the float32
    products at ``matmul_precision``."""
    b, f, p = shape
    x = x_flat.view(b, f, p, model.embed_dim)
    if model.mode == "s2f":
        x = model.weighted_mean_over_frames(x, matmul_precision)
    if f32_head:
        x = x.float()
    return _dense(model.head[1], layer_norm(model.head[0], x, x.dtype),
                  matmul_precision=matmul_precision)


def _check_mode(temporal_mode):
    if temporal_mode not in TEMPORAL_MODES:
        raise ValueError(f"temporal_mode must be one of {TEMPORAL_MODES}, got {temporal_mode!r}")


def _check_dtype(dtype):
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")


def check_fused(model):
    """Raises a ValueError naming the field where ``model`` (a
    MixSTEDenoiser or its ``bf16_snapshot``) sets ``qk_scale`` or a dropout
    rate above 0, which the fused paths do not run (module doc)."""
    for field in ("qk_scale", "drop_rate", "attn_drop_rate"):
        value = getattr(model, field, None)
        if value:
            raise ValueError(
                f"{field}={value!r}: the fused forward runs its attention at head_dim^-0.5 and "
                "drops nothing, so it refuses the field (JAX's fused paths ignore it); run the "
                "plain module (make_denoise_fn, make_train_denoise_fn) instead")


@torch.no_grad()
def fast_forward_denoise(model, x, time, dp_scales=None, *, dtype=torch.float32,
                         temporal_mode="rows", f32_head=False, f32_tail_pairs=0,
                         f32_model=None, f32_prec="highest", matmul_precision="highest"):
    """x [B, F, J, in_chans + 3], time [B] -> [B, F_out, J, 3] with the
    weights of ``model`` (a MixSTEDenoiser, or its ``bf16_snapshot``), no
    autograd. ``dp_scales``: None, or (dp_spatial [depth, B, F, 2],
    dp_temporal [depth, B, J, 2]). ``dtype``: the activation dtype, float32
    or bfloat16 (weights in another dtype are cast on the fly).
    ``temporal_mode``: "rows" or "cols" (module doc). ``f32_head``: the
    trunk output is cast to float32 before the head, whose output is then
    float32; else the output is in ``dtype``.

    ``f32_tail_pairs`` (JAX fast_eval.py:128-133, :210-215): with a bf16
    ``dtype``, the last this-many block pairs and the head run at float32
    activations, reading ``f32_model``'s weights (default ``model``; a bf16
    snapshot's would carry its roundings into the tail): at the first tail
    pair the rows are cast to float32 and the time embedding is recomputed
    at float32. The fusion layer stays bf16 even when the tail covers every
    pair. An eval feature: it refuses ``dp_scales``, as JAX's assert does.

    ``f32_prec`` (JAX fast_eval.py:98-112): the contraction mode of every
    fused block call at float32, the float32 forward's and the tail's
    ("highest", "high3" or "default"; ``ops.fused_block``). bf16 blocks
    ignore it. ``matmul_precision``: the session precision of the float32
    dense layers outside the kernels (module doc)."""
    _check_mode(temporal_mode)
    _check_dtype(dtype)
    f32_mode_index(f32_prec)
    check_fused(model)
    prec = matmul_precision
    b, f, p, _ = x.shape
    tail_start = model.depth
    if f32_tail_pairs and dtype == torch.bfloat16:
        if dp_scales is not None:
            raise ValueError("f32_tail_pairs is an eval-path feature: dp_scales must be None")
        tail_start = max(0, model.depth - int(f32_tail_pairs))
    dp_sp, dp_tp = (None, None) if dp_scales is None else dp_scales
    x = _dense(model.fusion_layer, x.to(dtype), matmul_precision=prec)
    t = model.time_embedding(time, dtype, prec)
    x = x + model.Spatial_pos_embed[None].to(dtype)
    x_flat = x.reshape(b * f * p, model.embed_dim).contiguous()
    weights = model
    for i in range(model.depth):
        if i == tail_start:
            weights = model if f32_model is None else f32_model
            x_flat, t = x_flat.float(), weights.time_embedding(time, torch.float32, prec)
        x_flat = _fused_pair(weights, i, (b, f, p), x_flat, t,
                             None if dp_sp is None else dp_sp[i],
                             None if dp_tp is None else dp_tp[i], temporal_mode, f32_prec, prec)
    return _head(weights, x_flat, (b, f, p), f32_head, prec)


def _mirror_pair(model, i, x4, t, dp_s, dp_t, dtype, core, ckpt_blocks=False,
                 matmul_precision="highest"):
    """Block pair i of the mirror on x4 [B, F, J, C] (JAX ``_xla_pair``):
    the spatial block, Spatial_norm, [the temporal position embedding when
    i == 0], the temporal block, Temporal_norm, the dense layers and the
    attention (``core``, called at ``matmul_precision``) in ``dtype`` and
    each LayerNorm returning its input's dtype. ``ckpt_blocks``: each block
    under ``checkpoint``."""
    prec = matmul_precision
    attn = lambda q, k, v: core(q, k, v, matmul_precision=prec)

    def block(blk, y, is_spatial, dp):
        if ckpt_blocks:
            return checkpoint(blk, y, is_spatial, t, dp, attn, dtype, prec, use_reentrant=False)
        return blk(y, is_spatial, t, dp, attn, dtype, prec)

    y = block(model.STEblocks[i], x4, True, dp_s)
    x4 = layer_norm(model.Spatial_norm, y, y.dtype)
    if i == 0:
        x4 = x4 + model.Temporal_pos_embed[:, :, None, :].to(x4.dtype)
    y = block(model.TTEblocks[i], x4, False, dp_t)
    return layer_norm(model.Temporal_norm, y, y.dtype)


def mirror_forward_denoise(model, x, time, dp_scales=None, *, dtype=torch.float32,
                           core=grand_attention, ckpt_blocks=False, matmul_precision="highest"):
    """The differentiable mirror of the fused forward (JAX
    ``xla_forward_denoise``) on the weights of ``model``: the recompute
    target of the training backward. At float32 it computes what the
    module computes; at bf16 the trunk stays bf16 (module doc). ``core``
    takes q, k, v and ``matmul_precision``, the session precision of every
    float32 product."""
    dp_sp, dp_tp = (None, None) if dp_scales is None else dp_scales
    prec = matmul_precision
    x = _dense(model.fusion_layer, x, dtype, prec)
    t = model.time_embedding(time, dtype, prec)
    x = x + model.Spatial_pos_embed[None].to(x.dtype)
    for i in range(model.depth):
        x = _mirror_pair(model, i, x, t, None if dp_sp is None else dp_sp[i],
                         None if dp_tp is None else dp_tp[i], dtype, core, ckpt_blocks, prec)
    if model.mode == "s2f":
        x = model.weighted_mean_over_frames(x, prec)
    return _dense(model.head[1], layer_norm(model.head[0], x, x.dtype), matmul_precision=prec)


class _FusedPair(torch.autograd.Function):
    """One block pair with a recompute backward (JAX ``_fused_pair``).

    A Function returns gradients only for its explicit tensor inputs, so
    the pair's parameters (``MixSTEDenoiser.pair_parameters``) are passed in
    as inputs and their gradients returned; the shared out-LNs collect one
    gradient from every pair. The drop-path scales are sampled, not
    learned, and get none. The recompute runs in the dtype of the pair's
    input rows."""

    @staticmethod
    def forward(ctx, model, i, shape, attn_bwd, temporal_mode, matmul_precision, x_flat, t, dp_s,
                dp_t, *params):
        ctx.model, ctx.i, ctx.shape, ctx.attn_bwd = model, i, shape, attn_bwd
        ctx.matmul_precision = matmul_precision
        ctx.save_for_backward(x_flat, t, dp_s, dp_t)
        return _fused_pair(model, i, shape, x_flat, t, dp_s, dp_t, temporal_mode,
                           matmul_precision=matmul_precision)

    @staticmethod
    def backward(ctx, grad):
        x_flat, t, dp_s, dp_t = ctx.saved_tensors
        model, i = ctx.model, ctx.i
        b, f, p = ctx.shape
        c = model.embed_dim
        params = model.pair_parameters(i)
        with torch.enable_grad():
            x4 = x_flat.detach().view(b, f, p, c).requires_grad_()
            tt = None if t is None else t.detach().requires_grad_()
            core = grand_attention_trainable if ctx.attn_bwd else grand_attention
            out = _mirror_pair(model, i, x4, tt, dp_s, dp_t, x4.dtype, core,
                               matmul_precision=ctx.matmul_precision)
            inputs = [x4] + ([] if tt is None else [tt]) + params
            grads = torch.autograd.grad(out, inputs, grad.view(b, f, p, c), allow_unused=True)
        d_x, grads = grads[0].reshape(b * f * p, c), list(grads[1:])
        d_t = None if tt is None else grads.pop(0)
        return (None, None, None, None, None, None, d_x, d_t, None, None, *grads)


def fast_forward_denoise_train_pairs(model, x, time, dp_scales=None, attn_bwd=False,
                                     temporal_mode="rows", dtype=torch.float32,
                                     matmul_precision="highest"):
    """Training forward (JAX ``fast_forward_denoise_train_pairs``): the
    fused forward of ``fast_forward_denoise`` in ``dtype`` (float32 or
    bfloat16; the parameters stay float32 and are cast on the way),
    differentiable, with each block pair a ``_FusedPair`` whose backward
    recomputes just that pair through the mirror. The gradients are those
    of ``mirror_forward_denoise`` with the same drop-path scales, up to
    rounding (at float32 the plain module's); autograd keeps one [B*F*J, C]
    boundary per pair plus one pair's recompute at a time. ``attn_bwd``:
    the recompute's attention runs through ``grand_attention_trainable``
    (its kernels on CUDA). ``temporal_mode`` picks the forward's layout; the
    recompute backward does not depend on it. ``matmul_precision``: the
    session precision of the float32 products outside the fused kernels
    and of the recompute's (module doc)."""
    _check_mode(temporal_mode)
    _check_dtype(dtype)
    check_fused(model)
    b, f, p, _ = x.shape
    dp_sp, dp_tp = (None, None) if dp_scales is None else dp_scales
    prec = matmul_precision
    x = _dense(model.fusion_layer, x, dtype, prec)
    t = model.time_embedding(time, dtype, prec)
    x_flat = (x + model.Spatial_pos_embed[None].to(dtype)).reshape(b * f * p, model.embed_dim)
    for i in range(model.depth):
        x_flat = _FusedPair.apply(
            model, i, (b, f, p), attn_bwd, temporal_mode, prec, x_flat, t,
            None if dp_sp is None else dp_sp[i], None if dp_tp is None else dp_tp[i],
            *model.pair_parameters(i),
        )
    return _head(model, x_flat, (b, f, p), matmul_precision=prec)


class _FusedTrain(torch.autograd.Function):
    """The whole fused forward with a recompute backward (JAX's monolithic
    ``fast_forward_denoise_train`` custom VJP, ``_fftrain_fwd`` /
    ``_fftrain_bwd``): the forward keeps only its inputs, the backward
    runs the whole mirror under autograd. Every parameter of the model is
    an input, for its gradient; x, the times and the drop-path scales get
    none (JAX returns theirs, which nothing reads)."""

    @staticmethod
    def forward(ctx, model, opts, x, time, dp_sp, dp_tp, *params):
        ctx.model, ctx.opts = model, opts
        ctx.save_for_backward(x, time, dp_sp, dp_tp)
        dp = None if dp_sp is None else (dp_sp, dp_tp)
        return fast_forward_denoise(model, x, time, dp, dtype=opts["dtype"],
                                    temporal_mode=opts["temporal_mode"],
                                    matmul_precision=opts["matmul_precision"])

    @staticmethod
    def backward(ctx, grad):
        x, time, dp_sp, dp_tp = ctx.saved_tensors
        model, opts = ctx.model, ctx.opts
        params = list(model.parameters())
        core = grand_attention_trainable if opts["attn_bwd"] else grand_attention
        with torch.enable_grad():
            out = mirror_forward_denoise(model, x, time, None if dp_sp is None else (dp_sp, dp_tp),
                                         dtype=opts["dtype"], core=core,
                                         ckpt_blocks=opts["ckpt_blocks"],
                                         matmul_precision=opts["matmul_precision"])
            grads = torch.autograd.grad(out, params, grad, allow_unused=True)
        return (None,) * 6 + tuple(grads)


def fast_forward_denoise_train(model, x, time, dp_scales=None, attn_bwd=False,
                               temporal_mode="rows", dtype=torch.float32, ckpt_blocks=False,
                               matmul_precision="highest"):
    """Training forward with the monolithic backward (JAX
    ``fast_forward_denoise_train``, ``fast_train_pair_vjp=False``): the
    fused forward of ``fast_forward_denoise`` in ``dtype``, whose backward
    recomputes the whole ``mirror_forward_denoise`` at once, so it holds a
    whole forward's activations (each block's only, with ``ckpt_blocks``,
    at the cost of one more forward). Arguments as
    ``fast_forward_denoise_train_pairs``; the same gradients up to
    rounding."""
    _check_mode(temporal_mode)
    _check_dtype(dtype)
    check_fused(model)
    dp_sp, dp_tp = (None, None) if dp_scales is None else dp_scales
    opts = dict(attn_bwd=attn_bwd, temporal_mode=temporal_mode, dtype=dtype,
                ckpt_blocks=ckpt_blocks, matmul_precision=matmul_precision)
    return _FusedTrain.apply(model, opts, x, time, dp_sp, dp_tp, *model.parameters())


def draw_drop_path_scales(generator, batch, depth, drop_path_rate, num_frame, num_joints):
    """(dp_spatial [depth, B, F, 2], dp_temporal [depth, B, J, 2]) drop-path
    scales on the generator's device, as JAX ``draw_drop_path_scales``
    draws them: the rate of block pair i is linspace(0, rate, depth)[i];
    one Bernoulli(keep) draw per attention group and residual branch, per
    (sample, frame) for spatial blocks and per (sample, joint) for temporal
    ones; a kept branch is scaled by 1/keep. The draws are torch's, not
    JAX's: tests inject the same scales into both."""
    dev = generator.device
    keep = to_device(1.0 - np.linspace(0.0, drop_path_rate, depth), dev,
                     torch.float32).view(depth, 1, 1, 1)
    u_sp = torch.rand(depth, batch, num_frame, 2, generator=generator, device=dev)
    u_tp = torch.rand(depth, batch, num_joints, 2, generator=generator, device=dev)
    zero = torch.zeros((), device=dev)
    return torch.where(u_sp < keep, 1.0 / keep, zero), torch.where(u_tp < keep, 1.0 / keep, zero)
