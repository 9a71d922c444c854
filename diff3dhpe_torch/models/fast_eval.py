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
``bf16_snapshot`` makes those bf16 weights once.

Training (``fast_forward_denoise_train_pairs``) cuts the trunk into
(spatial, temporal) block pairs, each a ``torch.autograd.Function``
(``_FusedPair``, JAX's ``_fused_pair`` custom VJP): the forward runs the
fused kernels and keeps only the pair's input, and the backward recomputes
the pair through the plain module (``MixSTEDenoiser.pair``) under autograd,
its attention through ``grand_attention_trainable`` (``attn_bwd``) or the
plain formulas, whatever the module's ``use_pallas`` (JAX's recompute
ignores it too).
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch.nn import functional as F

from diff3dhpe_torch.device import to_device
from diff3dhpe_torch.models.mixste import sinusoidal_pos_emb
from diff3dhpe_torch.ops.attention import grand_attention, grand_attention_trainable
from diff3dhpe_torch.ops.fused_block import fused_temporal_block_cols, fused_transformer_block

TEMPORAL_MODES = ("rows", "cols")


def _dense(layer, x):
    """JAX ``fast_eval._dense``: x @ W + b with W and b in x's dtype; below
    float32 the bias is added to the rounded product."""
    w = layer.weight.to(x.dtype)
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    if x.dtype == torch.float32:
        return F.linear(x, w, b)
    y = F.linear(x, w)
    return y if b is None else y + b


def _time_embedding(model, time, dtype):
    """[B] diffusion times -> [B, 2C] time embedding in ``dtype`` (None
    without), JAX ``compute_t``."""
    if model.time_mlp is None:
        return None
    tt = sinusoidal_pos_emb(time, model.embed_dim).to(dtype)
    return _dense(model.time_mlp[3], F.gelu(_dense(model.time_mlp[1], tt)))


def bf16_snapshot(model, f32_head=False):
    """A copy of ``model`` with the weights the bf16 forward reads in bf16,
    as JAX casts them: the fusion layer, the time MLP and the per-block time
    projections (weights and biases), the block GEMM weights (their biases
    and every LayerNorm stay float32), the position embeddings, and the head
    projection unless ``f32_head``."""
    snap = copy.deepcopy(model).requires_grad_(False)
    bf = torch.bfloat16
    dense = [snap.fusion_layer]
    if snap.time_mlp is not None:
        dense += [snap.time_mlp[1], snap.time_mlp[3]]
    if not f32_head:
        dense.append(snap.head[1])
    for block in [*snap.STEblocks, *snap.TTEblocks]:
        if block.time_mlp is not None:
            dense.append(block.time_mlp[1])
        for m in (block.attn.qkv, block.attn.proj, block.mlp.fc1, block.mlp.fc2):
            m.weight.data = m.weight.data.to(bf)
    for m in dense:
        for p in m.parameters():
            p.data = p.data.to(bf)
    for p in (snap.Spatial_pos_embed, snap.Temporal_pos_embed):
        p.data = p.data.to(bf)
    return snap


def _fused_pair(model, i, shape, x_flat, t, dp_s, dp_t, temporal_mode="rows"):
    """Block pair i on the flat spatial-major rows x_flat [B*F*J, C]
    through two fused block calls, the temporal one in ``temporal_mode``;
    returns rows in the same order. t [B, 2C] is the time embedding (or
    None); dp_s [B, F, 2], dp_t [B, J, 2] the per-group drop-path scales (or
    None), broadcast here to per-row scales as the JAX pair does."""
    b, f, p = shape
    c, heads, rows_item = model.embed_dim, model.num_heads, f * p

    def time_rows(block):
        if t is None or block.time_mlp is None:
            return None
        return _dense(block.time_mlp[1], F.silu(t)).contiguous()

    def dp_rows(d, groups, per_group):
        if d is None:
            return None
        return d[:, :, None, :].expand(b, groups, per_group, 2).reshape(b * rows_item, 2)

    block_s, block_t = model.STEblocks[i], model.TTEblocks[i]
    x_flat = fused_transformer_block(
        x_flat, block_s, n=p, heads=heads, t_rows=time_rows(block_s), rows_per_item=rows_item,
        out_ln=model.Spatial_norm, dp_scales=dp_rows(dp_s, f, p),
    )
    x4 = x_flat.view(b, f, p, c)
    if i == 0:
        x4 = x4 + model.Temporal_pos_embed[:, :, None, :].to(x4.dtype)
    if temporal_mode == "cols":
        x_cols = fused_temporal_block_cols(
            x4.reshape(b * f, p * c), block_t, n=f, j_groups=p, heads=heads,
            t_rows=time_rows(block_t), out_ln=model.Temporal_norm,
            dp_scales=None if dp_t is None else dp_t.reshape(b * p, 2),
        )
        return x_cols.view(b * rows_item, c)
    x_t = x4.transpose(1, 2).contiguous().view(b * rows_item, c)
    x_t = fused_transformer_block(
        x_t, block_t, n=f, heads=heads, t_rows=time_rows(block_t), rows_per_item=rows_item,
        out_ln=model.Temporal_norm, dp_scales=dp_rows(dp_t, p, f),
    )
    return x_t.view(b, p, f, c).transpose(1, 2).contiguous().view(b * rows_item, c)


def _head(model, x_flat, shape, f32_head=False):
    """[s2f weighted mean], [cast to float32], head LayerNorm (computed in
    float32, stored in the activation dtype) and projection."""
    b, f, p = shape
    x = x_flat.view(b, f, p, model.embed_dim)
    if model.mode == "s2f":
        x = model.weighted_mean_over_frames(x)
    if f32_head:
        x = x.float()
    ln = model.head[0]
    x = F.layer_norm(x.float(), (model.embed_dim,), ln.weight, ln.bias, ln.eps).to(x.dtype)
    return _dense(model.head[1], x)


def _check_mode(temporal_mode):
    if temporal_mode not in TEMPORAL_MODES:
        raise ValueError(f"temporal_mode must be one of {TEMPORAL_MODES}, got {temporal_mode!r}")


@torch.no_grad()
def fast_forward_denoise(model, x, time, dp_scales=None, *, dtype=torch.float32,
                         temporal_mode="rows", f32_head=False):
    """x [B, F, J, in_chans + 3], time [B] -> [B, F_out, J, 3] with the
    weights of ``model`` (a MixSTEDenoiser, or its ``bf16_snapshot``), no
    autograd. ``dp_scales``: None, or (dp_spatial [depth, B, F, 2],
    dp_temporal [depth, B, J, 2]). ``dtype``: the activation dtype, float32
    or bfloat16 (weights in another dtype are cast on the fly).
    ``temporal_mode``: "rows" or "cols" (module doc). ``f32_head``: the
    trunk output is cast to float32 before the head, whose output is then
    float32; else the output is in ``dtype``."""
    _check_mode(temporal_mode)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    b, f, p, _ = x.shape
    dp_sp, dp_tp = (None, None) if dp_scales is None else dp_scales
    x = _dense(model.fusion_layer, x.to(dtype))
    t = _time_embedding(model, time, dtype)
    x = x + model.Spatial_pos_embed[None].to(dtype)
    x_flat = x.reshape(b * f * p, model.embed_dim).contiguous()
    for i in range(model.depth):
        x_flat = _fused_pair(model, i, (b, f, p), x_flat, t,
                             None if dp_sp is None else dp_sp[i],
                             None if dp_tp is None else dp_tp[i], temporal_mode)
    return _head(model, x_flat, (b, f, p), f32_head)


class _FusedPair(torch.autograd.Function):
    """One block pair with a recompute backward (JAX ``_fused_pair``).

    A Function returns gradients only for its explicit tensor inputs, so
    the pair's parameters (``MixSTEDenoiser.pair_parameters``) are passed in
    as inputs and their gradients returned; the shared out-LNs collect one
    gradient from every pair. The drop-path scales are sampled, not
    learned, and get none."""

    @staticmethod
    def forward(ctx, model, i, shape, attn_bwd, temporal_mode, x_flat, t, dp_s, dp_t, *params):
        ctx.model, ctx.i, ctx.shape, ctx.attn_bwd = model, i, shape, attn_bwd
        ctx.save_for_backward(x_flat, t, dp_s, dp_t)
        return _fused_pair(model, i, shape, x_flat, t, dp_s, dp_t, temporal_mode)

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
            out = model.pair(i, x4, tt, dp_s, dp_t, core)
            inputs = [x4] + ([] if tt is None else [tt]) + params
            grads = torch.autograd.grad(out, inputs, grad.view(b, f, p, c), allow_unused=True)
        d_x, grads = grads[0].reshape(b * f * p, c), list(grads[1:])
        d_t = None if tt is None else grads.pop(0)
        return (None, None, None, None, None, d_x, d_t, None, None, *grads)


def fast_forward_denoise_train_pairs(model, x, time, dp_scales=None, attn_bwd=False,
                                     temporal_mode="rows"):
    """Training forward (JAX ``fast_forward_denoise_train_pairs``): the
    fused forward of ``fast_forward_denoise``, differentiable, with each
    block pair a ``_FusedPair`` whose backward recomputes just that pair.
    The gradients are those of the plain module with the same drop-path
    scales, up to rounding; autograd keeps one [B*F*J, C] boundary per
    pair plus one pair's recompute at a time. ``attn_bwd``: the
    recompute's attention runs through ``grand_attention_trainable`` (its
    kernels on CUDA). ``temporal_mode`` picks the forward's layout; the
    recompute backward does not depend on it. Training is float32 with
    the pair-boundary backward only."""
    _check_mode(temporal_mode)
    b, f, p, _ = x.shape
    dp_sp, dp_tp = (None, None) if dp_scales is None else dp_scales
    x = model.fusion_layer(x)
    t = model.time_embedding(time)
    x_flat = (x + model.Spatial_pos_embed[None]).reshape(b * f * p, model.embed_dim)
    for i in range(model.depth):
        x_flat = _FusedPair.apply(
            model, i, (b, f, p), attn_bwd, temporal_mode, x_flat, t,
            None if dp_sp is None else dp_sp[i], None if dp_tp is None else dp_tp[i],
            *model.pair_parameters(i),
        )
    return _head(model, x_flat, (b, f, p))


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
