from diff3dhpe_torch.models.fast_eval import (
    bf16_snapshot,
    draw_drop_path_scales,
    fast_forward_denoise,
    fast_forward_denoise_train_pairs,
)
from diff3dhpe_torch.models.mixste import MixSTEDenoiser, sinusoidal_pos_emb
from diff3dhpe_torch.models.registry import MODEL_REGISTRY, HPE_model

__all__ = [
    "HPE_model", "MODEL_REGISTRY", "MixSTEDenoiser", "bf16_snapshot", "draw_drop_path_scales",
    "fast_forward_denoise", "fast_forward_denoise_train_pairs", "sinusoidal_pos_emb",
]
