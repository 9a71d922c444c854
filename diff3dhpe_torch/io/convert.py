"""flax MixSTEDenoiser param tree -> reference state-dict names.

The port's own copy of the mapping in
``diff3dhpe_tpu/io/torch_convert.py::convert_params_to_torch_state_dict``:
it takes the JAX param tree as nested dicts of numpy arrays (anything
``np.asarray`` accepts) and returns float32 torch tensors under the names
of ``ConditionalDiffusionMixSTES2SGRANDLinLift.state_dict()``, which
``models.mixste.MixSTEDenoiser`` also uses. Dense kernels are transposed
from flax [in, out] to torch [out, in].

A JAX gradient tree has the param tree's structure, so the same call maps
gradients to the names of the port's parameters (and their ``.grad``).

``load_matching_params`` is the port of JAX's tolerant partial loading.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32)  # a contiguous copy


def _linear(sd: dict, layer: Mapping, name: str):
    sd[f"{name}.weight"] = _tensor(np.asarray(layer["kernel"]).T)
    if "bias" in layer:
        sd[f"{name}.bias"] = _tensor(layer["bias"])


def _layernorm(sd: dict, ln: Mapping, name: str):
    sd[f"{name}.weight"] = _tensor(ln["scale"])
    sd[f"{name}.bias"] = _tensor(ln["bias"])


def state_dict_from_flax(
    params: Mapping, depth: int, with_time_emb: bool = True, mode: str = "s2s",
) -> Dict[str, torch.Tensor]:
    """flax param tree -> {reference name: float32 tensor}, loadable with
    ``MixSTEDenoiser.load_state_dict(sd, strict=True)``."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, params["fusion_layer"], "fusion_layer")
    if with_time_emb:
        _linear(sd, params["time_mlp_1"], "time_mlp.1")
        _linear(sd, params["time_mlp_2"], "time_mlp.3")
    sd["Spatial_pos_embed"] = _tensor(params["spatial_pos_embed"])
    sd["Temporal_pos_embed"] = _tensor(params["temporal_pos_embed"])

    for kind, prefix in (("ste_block", "STEblocks"), ("tte_block", "TTEblocks")):
        for i in range(depth):
            blk = params[f"{kind}_{i}"]
            tp = f"{prefix}.{i}"
            _layernorm(sd, blk["norm1"], f"{tp}.norm1")
            _layernorm(sd, blk["norm2"], f"{tp}.norm2")
            _linear(sd, blk["attn"]["qkv"], f"{tp}.attn.qkv")
            _linear(sd, blk["attn"]["proj"], f"{tp}.attn.proj")
            _linear(sd, blk["mlp"]["fc1"], f"{tp}.mlp.fc1")
            _linear(sd, blk["mlp"]["fc2"], f"{tp}.mlp.fc2")
            if with_time_emb and "time_proj" in blk:
                _linear(sd, blk["time_proj"], f"{tp}.time_mlp.1")

    _layernorm(sd, params["spatial_norm"], "Spatial_norm")
    _layernorm(sd, params["temporal_norm"], "Temporal_norm")
    _layernorm(sd, params["head_norm"], "head.0")
    _linear(sd, params["head"], "head.1")

    if mode == "s2f":
        w = np.asarray(params["weighted_mean_kernel"], np.float32)
        sd["weighted_mean.weight"] = _tensor(w.reshape(1, -1, 1))
        sd["weighted_mean.bias"] = _tensor(np.asarray(params["weighted_mean_bias"]).reshape(1))
    return sd


def load_matching_params(target: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor]):
    """Tolerant partial loading (JAX ``io/torch_convert.py::load_matching_params``;
    reference common/utils.py load_pretrained_weights:51-81) on state dicts:
    every entry of ``source`` whose name and shape match one of ``target``
    replaces it; the rest of ``target`` stays. Returns (merged, matched,
    discarded), the last two lists of ``source``'s names."""
    merged, matched, discarded = dict(target), [], []
    for name, value in source.items():
        if name in target and tuple(value.shape) == tuple(target[name].shape):
            merged[name] = value
            matched.append(name)
        else:
            discarded.append(name)
    return merged, matched, discarded
