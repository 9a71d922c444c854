"""Checkpoints: reference ``.bin`` loading, and the port's own training
checkpoints with save, restore and the shuffle-RNG state for resume.

Port of ``diff3dhpe_tpu/io/checkpoint.py`` and of
``io/torch_convert.py::_strip_prefixes``.

A reference ``.bin`` is ``torch.save({'model_diffusion':
DataParallel(GaussianDiffusion(MixSTE)).state_dict(), ...})``, so keys look
like ``module.model.STEblocks.0.attn.qkv.weight``, beside schedule buffers
(``module.betas``, ``module.alphas_cumprod`` ...) that
``diffusion.schedules`` recomputes. The port's module uses the reference's
parameter names, so loading is a prefix strip and a strict
``load_state_dict``; no layout conversion is needed.

A training checkpoint is a directory, as in JAX (``epoch_{n}/``,
``best_epoch/``), holding ``meta.json`` with JAX's keys (``epoch``,
``best_epoch``, ``min_loss``, ``min_train_loss``, ``shuffle_rng_state``)
and ``STATE_FILE``, one ``torch.save`` dict of ``model_diffusion`` (the
denoiser's state dict under the reference's names), ``optimizer``,
``lr_scheduler`` and ``step``. Where JAX keeps params and optimizer state in
orbax, the port keeps torch's; because the weights sit under
``model_diffusion``, JAX's ``load_torch_model_params`` reads the file as it
reads a reference ``.bin``. The file holds the whole module at any mesh:
a tensor-parallel run gathers its shards (and AdamW's moments) before rank
0 writes, and shards what it restores (``engine.runner.Runner.fit``), as
JAX's checkpoints hold global arrays.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

STATE_FILE = "checkpoint.bin"


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
    checkpoint, which the port's ``STATE_FILE`` also is), on the CPU, for
    ``load_state_dict(strict=True)`` (``Runner.set_params``): a missing,
    unexpected or mis-shaped parameter raises there."""
    checkpoint = torch.load(path, map_location="cpu", weights_only=False)
    return strip_prefixes(checkpoint.get("model_diffusion", checkpoint))


def save_checkpoint(path: str, state: Mapping[str, Any], meta: dict) -> None:
    """Writes ``state`` (the ``STATE_FILE`` dict) and ``meta`` under the
    directory ``path``, replacing what is there; each file is written
    beside its place and moved in, so an interrupted save leaves the old
    file whole."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    torch.save(dict(state), target + ".tmp")
    os.replace(target + ".tmp", target)
    with open(os.path.join(path, "meta.json.tmp"), "w") as f:
        json.dump(meta, f, default=_json_default)
    os.replace(os.path.join(path, "meta.json.tmp"), os.path.join(path, "meta.json"))


def restore_checkpoint(path: str, field: str = "resume"):
    """(state, meta) of the checkpoint directory ``path``, tensors on the
    CPU. A directory without ``STATE_FILE`` (a JAX orbax checkpoint, for
    one) raises a ValueError that starts with ``field`` (the setting that
    named the path)."""
    target = os.path.join(path, STATE_FILE)
    if not os.path.isfile(target):
        raise ValueError(
            f"{field}={path!r} holds no {STATE_FILE}: evaluate, resume and pretrained_model "
            "take a checkpoint directory the port wrote or a reference .bin file (a JAX "
            "orbax directory is not read)")
    state = torch.load(target, map_location="cpu", weights_only=False)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return state, meta


def _json_default(o: Any):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def rng_state_to_json(rng: np.random.Generator) -> dict:
    state = rng.bit_generator.state
    return json.loads(json.dumps(state, default=_json_default))


def rng_state_from_json(state: dict) -> np.random.Generator:
    rng = np.random.default_rng()
    # numpy accepts the state dict back verbatim (keys: bit_generator, state, ...)
    fixed = dict(state)
    if isinstance(fixed.get("state"), dict) and isinstance(fixed["state"].get("key"), list):
        fixed["state"] = dict(fixed["state"])
        fixed["state"]["key"] = np.array(fixed["state"]["key"], dtype=np.uint64)
    rng.bit_generator.state = fixed
    return rng
