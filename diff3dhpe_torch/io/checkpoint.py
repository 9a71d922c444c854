"""Loading of reference ``.bin`` checkpoints.

Port of the ``.bin`` branch of ``diff3dhpe_tpu/io/checkpoint.py``
(``load_torch_model_params``) and of ``io/torch_convert.py::_strip_prefixes``.
The reference saves ``torch.save({'model_diffusion':
DataParallel(GaussianDiffusion(MixSTE)).state_dict(), ...})``, so keys look
like ``module.model.STEblocks.0.attn.qkv.weight``, beside schedule buffers
(``module.betas``, ``module.alphas_cumprod`` ...) that
``diffusion.schedules`` recomputes. The port's module uses the reference's
parameter names, so loading is a prefix strip and a strict
``load_state_dict``; no layout conversion is needed.

Saving, restoring and resuming training state are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch


def strip_prefixes(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The denoiser's entries of ``state`` under the names of its own
    ``state_dict()``: the ``module.`` prefix of DataParallel goes; where the
    diffusion wrapper's ``model.`` prefix is present, only the entries under
    it stay (what lies beside them are the wrapper's schedule buffers:
    betas, the ``*alphas*`` tables and what is derived from them)."""
    state = {k[len("module."):] if k.startswith("module.") else k: v for k, v in state.items()}
    if any(k.startswith("model.") for k in state):
        return {k[len("model."):]: v for k, v in state.items() if k.startswith("model.")}
    return state


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The denoiser's state dict from a reference ``.bin`` checkpoint (a
    bare state dict, or a ``{"model_diffusion": state_dict, ...}``
    checkpoint), on the CPU, for ``load_state_dict(strict=True)``
    (``Runner.set_params``): a missing, unexpected or mis-shaped parameter
    raises there."""
    checkpoint = torch.load(path, map_location="cpu", weights_only=False)
    return strip_prefixes(checkpoint.get("model_diffusion", checkpoint))
