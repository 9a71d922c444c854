"""PyTorch/CUDA port of diff3dhpe_tpu for one NVIDIA H100.

Imports torch and numpy only: never jax, flax or the JAX package. Plain
tensor code is PyTorch; the TPU's Pallas kernels become CUDA kernels for
Hopper under ``csrc/``, each with a plain PyTorch version beside it that
runs for CPU tensors.
"""
from diff3dhpe_torch.diffusion import GaussianDiffusion, ddim_time_pairs
from diff3dhpe_torch.engine import (
    flip_pose,
    make_denoise_fn,
    make_eval_step,
    make_fast_denoise_fn,
    make_fast_train_denoise_fn,
    make_mixed_diffusion,
    make_optimizer,
    make_train_denoise_fn,
    make_train_step,
)
from diff3dhpe_torch.engine.runner import Runner, RunLogger
from diff3dhpe_torch.io import load_torch_state_dict, state_dict_from_flax
from diff3dhpe_torch.models import (
    HPE_model,
    MixSTEDenoiser,
    bf16_snapshot,
    draw_drop_path_scales,
    draw_dropout_masks,
    fast_forward_denoise,
    fast_forward_denoise_train,
    fast_forward_denoise_train_pairs,
)
from diff3dhpe_torch.ops import (
    fused_attention_block,
    fused_attention_block_ref,
    fused_grand_attention,
    fused_temporal_block_cols,
    fused_temporal_block_cols_ref,
    fused_transformer_block,
    fused_transformer_block_ref,
    grand_attention,
    grand_attention_bwd,
    grand_attention_bwd_ref,
    grand_attention_fullseq,
    grand_attention_fullseq_ref,
    grand_attention_trainable,
    packed_grand_attention,
    packed_grand_attention_ref,
)

__all__ = [
    "GaussianDiffusion", "HPE_model", "MixSTEDenoiser", "RunLogger", "Runner", "bf16_snapshot",
    "ddim_time_pairs", "draw_drop_path_scales", "draw_dropout_masks", "fast_forward_denoise",
    "fast_forward_denoise_train", "fast_forward_denoise_train_pairs", "flip_pose", "fused_attention_block",
    "fused_attention_block_ref", "fused_grand_attention", "fused_temporal_block_cols",
    "fused_temporal_block_cols_ref", "fused_transformer_block", "fused_transformer_block_ref",
    "grand_attention", "grand_attention_bwd", "grand_attention_bwd_ref",
    "grand_attention_fullseq", "grand_attention_fullseq_ref", "grand_attention_trainable",
    "load_torch_state_dict", "make_denoise_fn", "make_eval_step", "make_fast_denoise_fn",
    "make_fast_train_denoise_fn", "make_mixed_diffusion", "make_optimizer",
    "make_train_denoise_fn", "make_train_step", "packed_grand_attention",
    "packed_grand_attention_ref", "state_dict_from_flax",
]
