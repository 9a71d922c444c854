from diff3dhpe_torch.models.fast_eval import (
    bf16_snapshot,
    draw_drop_path_scales,
    fast_forward_denoise,
    fast_forward_denoise_train_pairs,
)
from diff3dhpe_torch.models.mixste import MixSTEDenoiser, sinusoidal_pos_emb

__all__ = [
    "MixSTEDenoiser", "bf16_snapshot", "draw_drop_path_scales", "fast_forward_denoise",
    "fast_forward_denoise_train_pairs", "sinusoidal_pos_emb",
]
