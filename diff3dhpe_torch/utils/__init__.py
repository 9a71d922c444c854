from diff3dhpe_torch.utils.misc import deterministic_random

__all__ = ["deterministic_random"]
