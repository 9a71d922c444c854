"""Tensor parallelism on the plain module: the ``model`` axis of a
``mesh_shape`` "data:N,model:M".

Port of ``diff3dhpe_tpu/parallel/mesh.py::param_sharding_rules`` and
``shard_params`` (:52-99; ``param_shardings`` has no counterpart, since a
rank holds its shards and not a placement), Megatron's column and row
split of each block:

- ``*.attn.qkv`` and ``*.mlp.fc1`` (weight and bias) are split by output
  rows, torch's dim 0 of [out, in] (JAX's column split of its [in, out]
  kernel, ``P(None, "model")``, and of the bias, ``P("model")``);
- ``*.attn.proj.weight`` and ``*.mlp.fc2.weight`` by input columns, dim 1
  (JAX's ``P("model", None)``);
- everything else is replicated: the biases of ``proj`` and ``fc2``, the
  LayerNorms, the blocks' and the global ``time_mlp``, ``fusion_layer``,
  ``head``, the position embeddings.

JAX's column split of the fused qkv kernel cuts across q, k and v, and XLA
reshards at the reshape to heads. Here rank m of M takes whole heads of
each of q, k and v: rows s·C + [m·C/M, (m+1)·C/M) for s = 0, 1, 2, so its
local reshape to (b, n, 3, H/M, D) holds, D = C/H the global head width.

On the model group the module's forward runs two autograd functions
(``models.mixste``): ``copy_to_model`` before each column-parallel product
(identity forward, all-reduce backward: the input's gradient made whole)
and ``reduce_from_model`` after each row-parallel one (all-reduce forward,
identity backward), the bias added once after it. A replicated parameter
then gets the same gradient on every rank of a model group. Every
collective is an ``all_reduce``, which ``gloo`` also takes on CUDA tensors.

The fused paths run whole weights (JAX's XLA gathers the sharded
parameters for its Pallas calls): the fused eval and the export on a
replica loaded with the gathered shards, and the fused training step
through ``WholeWeights``, which loads that replica before every step and
hands each shard its slice of the whole gradient after the backward.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

# Parameter-name endings split by output rows (dim 0) and by input columns
# (dim 1); the rest is replicated.
COLUMN_PARALLEL = (".attn.qkv.weight", ".attn.qkv.bias", ".mlp.fc1.weight", ".mlp.fc1.bias")
ROW_PARALLEL = (".attn.proj.weight", ".mlp.fc2.weight")


def param_sharding_rules(name: str) -> Optional[int]:
    """The dim of the parameter ``name`` (a state-dict name of
    ``models.mixste.MixSTEDenoiser``) that the model axis splits: 0, 1, or
    None where it is replicated."""
    if name.endswith(COLUMN_PARALLEL):
        return 0
    if name.endswith(ROW_PARALLEL):
        return 1
    return None


def check_divisible(num_heads: int, hidden: int, model_size: int, spec: str) -> None:
    """Raises a ValueError naming ``num_heads`` (or ``mlp_ratio``) and
    ``mesh_shape`` unless the model axis divides the heads and the MLP's
    hidden width."""
    if num_heads % model_size:
        raise ValueError(f"num_heads={num_heads} does not divide over the model axis of "
                         f"mesh_shape={spec!r} ({model_size}): each model rank takes whole heads")
    if hidden % model_size:
        raise ValueError(f"mlp_ratio: the MLP's hidden width {hidden} does not divide over the "
                         f"model axis of mesh_shape={spec!r} ({model_size})")


def _local_index(name: str, length: int, model_size: int, model_rank: int) -> torch.Tensor:
    """The indices along the split dim (of ``length``) that ``model_rank``
    holds: whole heads of each of q, k and v for qkv, a contiguous block
    otherwise."""
    if ".attn.qkv." in name:
        c = length // 3
        w = c // model_size
        return torch.cat([torch.arange(s * c + model_rank * w, s * c + (model_rank + 1) * w)
                          for s in range(3)])
    w = length // model_size
    return torch.arange(model_rank * w, (model_rank + 1) * w)


def shard_params(state: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The shards of a whole state dict that ``mesh``'s model rank holds
    (contiguous copies; replicated entries as they are), in ``state``'s
    order. Also takes any tensors keyed and shaped like the parameters
    (AdamW's moments, gradients)."""
    m, size = mesh.model_rank, mesh.model_size
    out = {}
    for name, value in state.items():
        dim = param_sharding_rules(name) if size > 1 else None
        if dim is None:
            out[name] = value
            continue
        idx = _local_index(name, value.shape[dim], size, m).to(value.device)
        out[name] = value.index_select(dim, idx).contiguous()
    return out


def gather_params(state: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The whole state dict from each model rank's shards, the exact
    inverse of ``shard_params``, on every rank of the model group: one sum
    all-reduce over the group of zero-filled whole tensors that each rank
    fills at its own indices, exact since every element has one non-zero
    term (a -0.0 comes back as 0.0). Replicated entries are this rank's.
    In ``state``'s order, the reference's."""
    size = mesh.model_size
    split = [n for n in state if size > 1 and param_sharding_rules(n) is not None]
    if not split:
        return dict(state)
    full = {}
    for name in split:
        local, dim = state[name], param_sharding_rules(name)
        shape = list(local.shape)
        shape[dim] *= size
        whole = local.new_zeros(shape)
        idx = _local_index(name, shape[dim], size, mesh.model_rank).to(local.device)
        whole.index_copy_(dim, idx, local.detach())
        full[name] = whole
    # One buffer per dtype, in the order of first use: one all-reduce each.
    for dtype in dict.fromkeys(t.dtype for t in full.values()):
        names = [n for n in split if full[n].dtype == dtype]
        flat = torch.cat([full[n].reshape(-1) for n in names])
        mesh.sum_(flat, mesh.model_group)
        for n, part in zip(names, flat.split([full[n].numel() for n in names])):
            full[n] = part.view_as(full[n])
    return {n: full.get(n, v) for n, v in state.items()}


def shard_dropout_masks(masks: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The model rank's part of whole dropout masks
    (``models.mixste.draw_dropout_masks``): its heads of the attention
    probabilities' masks (``attn_*``, dim 3) and its hidden columns of
    fc1's (``fc1_*``, the last dim); the masks of whole-width outputs stay
    whole."""
    m, size = mesh.model_rank, mesh.model_size
    out = {}
    for name, mask in masks.items():
        dim = {"attn": 3, "fc1": mask.ndim - 1}.get(name.split("_")[0])
        if dim is None:
            out[name] = mask
            continue
        w = mask.shape[dim] // size
        out[name] = mask.narrow(dim, m * w, w)
    return out


def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Slices ``model``'s split weights in place to ``mesh``'s model rank's
    shards and sets each block's local head and hidden counts and its
    model group; with a model axis of 1 it leaves the module as it is.
    Raises as ``check_divisible`` where the axis divides neither."""
    size = mesh.model_size
    if size == 1:
        return model
    blocks = [b for b in model.modules() if hasattr(b, "attn") and hasattr(b, "mlp")]
    for blk in blocks:
        check_divisible(blk.attn.num_heads, blk.mlp.fc1.out_features, size, mesh.shape)
    local = shard_params(dict(model.named_parameters()), mesh)
    with torch.no_grad():
        for name, param in model.named_parameters():
            if param_sharding_rules(name) is not None:
                param.data = local[name].detach().clone()
    for blk in blocks:
        blk.attn.num_heads //= size
        blk.attn.model_group = mesh.model_group
        blk.mlp.model_group = mesh.model_group
    return model


def sharded_names(model: torch.nn.Module, mesh):
    """(names of ``model``'s replicated parameters, names of its split
    ones) under ``mesh``'s model axis."""
    names = [n for n, _ in model.named_parameters()]
    split = [n for n in names if mesh.model_size > 1 and param_sharding_rules(n) is not None]
    return [n for n in names if n not in set(split)], split


def check_params_replicated(model: torch.nn.Module, mesh, what: str = "parameters") -> None:
    """``DataMesh.check_replicated`` on ``model``: the replicated
    parameters across every rank, the shards across the data group."""
    params = dict(model.named_parameters())
    replicated, split = sharded_names(model, mesh)
    mesh.check_replicated([params[n] for n in replicated], what)
    if split:
        mesh.check_replicated([params[n] for n in split], f"{what} (shards)", axis="data")


def full_param_count(model: torch.nn.Module, mesh=None) -> int:
    """The parameters of the whole module, counted from its shards."""
    size = 1 if mesh is None else mesh.model_size
    return sum(p.numel() * (size if size > 1 and param_sharding_rules(n) is not None else 1)
               for n, p in model.named_parameters())


def gather_optimizer_state(optimizer_state: Mapping, names, mesh) -> dict:
    """An AdamW ``state_dict()`` of a model rank with each split
    parameter's moments (``exp_avg``, ``exp_avg_sq``) gathered whole, qkv
    regrouped back (``gather_params``); ``names``: the parameters' names in
    the optimizer's order. Collective over the model group."""
    return _map_moments(optimizer_state, names, lambda s: gather_params(s, mesh))


def shard_optimizer_state(optimizer_state: Mapping, names, mesh) -> dict:
    """The inverse of ``gather_optimizer_state``: a whole AdamW state dict
    with each split parameter's moments sliced to ``mesh``'s model rank."""
    return _map_moments(optimizer_state, names, lambda s: shard_params(s, mesh))


def _map_moments(optimizer_state, names, fn):
    """``optimizer_state`` with ``fn`` applied to each moment's {name: tensor}."""
    names = list(names)
    state = optimizer_state["state"]
    out = {i: dict(s) for i, s in state.items()}
    for key in ("exp_avg", "exp_avg_sq"):
        part = {names[i]: s[key] for i, s in state.items() if key in s}
        for name, value in fn(part).items():
            out[names.index(name)][key] = value
    return dict(optimizer_state, state=out)


class WholeWeights:
    """A whole module, ``replica``, beside a model rank's shards,
    ``model``, for a training step that runs whole weights (the fused
    training forward; JAX's jit path at "data:1,model:M", where XLA gathers
    the sharded parameters). ``load()`` fills the replica with the gathered
    shards (exact, ``gather_params``; collective over the model group) and
    clears its gradients; ``shard_grads_()``, after the backward, sets each
    shard's gradient to its slice of the replica's (``shard_params``). Every
    rank of a model group computes the same whole gradient, so the slice
    needs no sum: the transpose of a gather is a slice."""

    def __init__(self, replica: torch.nn.Module, model: torch.nn.Module, mesh):
        self.replica, self.model, self.mesh = replica, model, mesh

    def load(self) -> None:
        whole = gather_params({n: p.detach() for n, p in self.model.named_parameters()},
                              self.mesh)
        with torch.no_grad():
            for name, param in self.replica.named_parameters():
                param.copy_(whole[name])
                param.grad = None

    def shard_grads_(self) -> None:
        grads = {n: p.grad for n, p in self.replica.named_parameters() if p.grad is not None}
        local = shard_params(grads, self.mesh)
        for name, param in self.model.named_parameters():
            param.grad = local.get(name)
        for param in self.replica.parameters():
            param.grad = None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products summed over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A sum over ``group`` in a new tensor; below float32 summed in float32
    and rounded once (for 2 ranks the bf16 add of the two partials)."""
    out = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Before a column-parallel product: x itself, its gradient summed over
    ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """After a row-parallel product: the sum over ``group`` of the ranks'
    partial products, the gradient passed through."""
    return _ReduceFromModel.apply(x, group)
