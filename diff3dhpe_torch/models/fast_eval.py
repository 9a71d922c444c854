"""Forward of the MixSTE denoiser through the fused block, for eval and
for training.

Port of ``diff3dhpe_tpu/models/fast_eval.py`` in its f32
``temporal_mode="rows"`` layout. It runs the weights of a
``models.mixste.MixSTEDenoiser``, keeps tokens as flat [rows, C] between
blocks, and hands every transformer block to
``ops.fused_block.fused_transformer_block`` together with its per-block
time-embedding rows, drop-path scales and the inter-block LayerNorm:

  spatial blocks  on the [B, F, J, C] buffer: groups of J joint rows;
  temporal blocks on its [B, J, F, C] transpose: groups of F frame rows.

The JAX path pads frames to a multiple of 8 for the TPU's sublanes; the
CUDA kernel takes any group size, so the port does not pad, and the pair
backward below works on the same rows as its forward. The fusion layer,
time MLP, per-block time projections and head run outside the kernel, as
they do in JAX.

Training (``fast_forward_denoise_train_pairs``) cuts the trunk into
(spatial, temporal) block pairs, each a ``torch.autograd.Function``
(``_FusedPair``, JAX's ``_fused_pair`` custom VJP): the forward runs the
fused kernels and keeps only the pair's input, and the backward recomputes
the pair through the plain module (``MixSTEDenoiser.pair``) under autograd.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from diff3dhpe_torch.ops.fused_block import fused_transformer_block


def _fused_pair(model, i, shape, x_flat, t, dp_s, dp_t):
    """Block pair i on the flat spatial-major rows x_flat [B*F*J, C]
    through two fused block calls; returns rows in the same order. t [B, 2C]
    is the time embedding (or None); dp_s [B, F, 2], dp_t [B, J, 2] the
    per-group drop-path scales (or None), broadcast here to per-row scales
    as the JAX pair does."""
    b, f, p = shape
    c, heads, rows_item = model.embed_dim, model.num_heads, f * p

    def time_rows(block):
        if t is None or block.time_mlp is None:
            return None
        return block.time_mlp(t).contiguous()

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
        x4 = x4 + model.Temporal_pos_embed[:, :, None, :]
    x_t = x4.transpose(1, 2).contiguous().view(b * rows_item, c)
    x_t = fused_transformer_block(
        x_t, block_t, n=f, heads=heads, t_rows=time_rows(block_t), rows_per_item=rows_item,
        out_ln=model.Temporal_norm, dp_scales=dp_rows(dp_t, p, f),
    )
    return x_t.view(b, p, f, c).transpose(1, 2).contiguous().view(b * rows_item, c)


def _head(model, x_flat, shape):
    b, f, p = shape
    x = x_flat.view(b, f, p, model.embed_dim)
    if model.mode == "s2f":
        x = model.weighted_mean_over_frames(x)
    return model.head(x)


@torch.no_grad()
def fast_forward_denoise(model, x, time, dp_scales=None):
    """x [B, F, J, in_chans + 3], time [B] -> [B, F_out, J, 3] with the
    weights of ``model`` (a MixSTEDenoiser), no autograd. ``dp_scales``:
    None, or (dp_spatial [depth, B, F, 2], dp_temporal [depth, B, J, 2])."""
    b, f, p, _ = x.shape
    dp_sp, dp_tp = (None, None) if dp_scales is None else dp_scales
    x = F.linear(x, model.fusion_layer.weight, model.fusion_layer.bias)
    t = model.time_embedding(time)
    x = x + model.Spatial_pos_embed[None]
    x_flat = x.reshape(b * f * p, model.embed_dim).contiguous()
    for i in range(model.depth):
        x_flat = _fused_pair(model, i, (b, f, p), x_flat, t,
                             None if dp_sp is None else dp_sp[i],
                             None if dp_tp is None else dp_tp[i])
    return _head(model, x_flat, (b, f, p))


class _FusedPair(torch.autograd.Function):
    """One block pair with a recompute backward (JAX ``_fused_pair``).

    A Function returns gradients only for its explicit tensor inputs, so
    the pair's parameters (``MixSTEDenoiser.pair_parameters``) are passed in
    as inputs and their gradients returned; the shared out-LNs collect one
    gradient from every pair. The drop-path scales are sampled, not
    learned, and get none."""

    @staticmethod
    def forward(ctx, model, i, shape, attn_bwd, x_flat, t, dp_s, dp_t, *params):
        ctx.model, ctx.i, ctx.shape, ctx.attn_bwd = model, i, shape, attn_bwd
        ctx.save_for_backward(x_flat, t, dp_s, dp_t)
        return _fused_pair(model, i, shape, x_flat, t, dp_s, dp_t)

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
            out = model.pair(i, x4, tt, dp_s, dp_t, ctx.attn_bwd)
            inputs = [x4] + ([] if tt is None else [tt]) + params
            grads = torch.autograd.grad(out, inputs, grad.view(b, f, p, c), allow_unused=True)
        d_x, grads = grads[0].reshape(b * f * p, c), list(grads[1:])
        d_t = None if tt is None else grads.pop(0)
        return (None, None, None, None, d_x, d_t, None, None, *grads)


def fast_forward_denoise_train_pairs(model, x, time, dp_scales=None, attn_bwd=False):
    """Training forward (JAX ``fast_forward_denoise_train_pairs``): the
    fused forward of ``fast_forward_denoise``, differentiable, with each
    block pair a ``_FusedPair`` whose backward recomputes just that pair.
    The gradients are those of the plain module with the same drop-path
    scales, up to rounding; autograd keeps one [B*F*J, C] boundary per
    pair plus one pair's recompute at a time. ``attn_bwd``: the
    recompute's attention runs through ``grand_attention_trainable`` (its
    kernels on CUDA). The port has only JAX's f32 rows layout with the
    pair-boundary backward."""
    b, f, p, _ = x.shape
    dp_sp, dp_tp = (None, None) if dp_scales is None else dp_scales
    x = model.fusion_layer(x)
    t = model.time_embedding(time)
    x_flat = (x + model.Spatial_pos_embed[None]).reshape(b * f * p, model.embed_dim)
    for i in range(model.depth):
        x_flat = _FusedPair.apply(
            model, i, (b, f, p), attn_bwd, x_flat, t,
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
    keep = torch.tensor(1.0 - np.linspace(0.0, drop_path_rate, depth), dtype=torch.float32,
                        device=dev).view(depth, 1, 1, 1)
    u_sp = torch.rand(depth, batch, num_frame, 2, generator=generator, device=dev)
    u_tp = torch.rand(depth, batch, num_joints, 2, generator=generator, device=dev)
    zero = torch.zeros((), device=dev)
    return torch.where(u_sp < keep, 1.0 / keep, zero), torch.where(u_tp < keep, 1.0 / keep, zero)
