from diff3dhpe_torch.io.checkpoint import load_torch_state_dict
from diff3dhpe_torch.io.convert import state_dict_from_flax

__all__ = ["load_torch_state_dict", "state_dict_from_flax"]
