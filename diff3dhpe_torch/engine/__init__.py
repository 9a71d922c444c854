from diff3dhpe_torch.engine.steps import (
    flip_pose,
    make_denoise_fn,
    make_eval_step,
    make_fast_denoise_fn,
    make_fast_train_denoise_fn,
    make_mixed_diffusion,
    make_optimizer,
    make_train_denoise_fn,
    make_train_step,
    make_val_step,
)

__all__ = [
    "flip_pose", "make_denoise_fn", "make_eval_step", "make_fast_denoise_fn",
    "make_fast_train_denoise_fn", "make_mixed_diffusion", "make_optimizer", "make_train_denoise_fn", "make_train_step",
    "make_val_step",
]
