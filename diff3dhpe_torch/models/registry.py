"""Model registry (reference: common/nets/load_net.py:5-10).

Maps the reference's model-name strings to constructors of the one unified
MixSTE module with the appropriate output mode, so reference configs work
unchanged.
"""
from __future__ import annotations

import functools

from diff3dhpe_torch.models.mixste import MixSTEDenoiser

MODEL_REGISTRY = {
    "ConditionalDiffusionMixSTES2SGRANDLinLift": functools.partial(MixSTEDenoiser, mode="s2s"),
    "ConditionalDiffusionMixSTES2FGRANDLinLift": functools.partial(MixSTEDenoiser, mode="s2f"),
}


def HPE_model(name: str):
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}"
        ) from None
