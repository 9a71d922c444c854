from diff3dhpe_torch.io.checkpoint import (
    load_torch_state_dict,
    restore_checkpoint,
    rng_state_from_json,
    rng_state_to_json,
    save_checkpoint,
)
from diff3dhpe_torch.io.convert import load_matching_params, state_dict_from_flax

__all__ = [
    "load_matching_params", "load_torch_state_dict", "restore_checkpoint", "rng_state_from_json",
    "rng_state_to_json", "save_checkpoint", "state_dict_from_flax",
]
