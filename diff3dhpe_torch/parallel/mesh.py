"""The ranks of a run across processes, on two axes: ``data`` (the batch
split over the ranks, each holding the whole model or its shard) and
``model`` (tensor parallelism: the ranks of one model group hold shards
of the same weights and compute the same rows together;
``parallel.tensor``).

Port of ``diff3dhpe_tpu/parallel/mesh.py`` (:27-45, :91-99). JAX builds a
device mesh inside one program and lets XLA (or ``shard_map``) split the
batch and the weights; here ``torch.distributed`` runs one rank a process,
and ``DataMesh`` is what a step needs of it: the rank's rows of a global
batch, the gradient average (JAX's ``pmean``), the ordered gather of a
prediction's rows, a check that the ranks hold the same weights, and the
process group of each axis. ``mesh_shape`` "data:N,model:M" runs on N·M
ranks laid out as JAX's ``make_mesh`` lays out its devices (``reshape``
over ("data", "model")): rank = d·M + m, so the ranks of one model group
are adjacent.

The process group comes from the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from
explicit arguments (``start_ranks``). Its backend is ``nccl`` on CUDA and
``gloo`` on the CPU unless the caller names one; each rank runs on
``cuda:LOCAL_RANK`` unless the caller passes a device. Nothing falls back:
a rank that cannot start raises, and no collective's failure is caught.

Every collective here is an ``all_reduce`` or a ``broadcast``, the two
that ``gloo`` also takes on CUDA tensors (through host memory).
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from diff3dhpe_torch.device import resolve_device

AXES = ("data", "model")


def parse_mesh_shape(spec: Optional[str], world_size: int) -> dict:
    """{"data": N, "model": M} of a ``mesh_shape`` spec, "data:N" or
    "data:N,model:M" (JAX ``make_mesh``'s syntax; an axis left out has size
    1); no spec puts every rank on ``data``. A malformed spec raises a
    ValueError naming ``mesh_shape``."""
    spec = (spec or "").replace(" ", "")
    if not spec:
        return {"data": world_size, "model": 1}
    sizes = {name: 1 for name in AXES}
    for part in spec.split(","):
        name, _, size = part.partition(":")
        if name not in AXES or not size.isdigit() or int(size) < 1:
            raise ValueError(f"mesh_shape={spec!r}: expected 'data:N' or 'data:N,model:M' with "
                             f"sizes >= 1")
        sizes[name] = int(size)
    return sizes


def check_mesh_shape(spec: Optional[str], world_size: int) -> None:
    """Raises a ValueError naming ``mesh_shape`` unless the spec's ranks,
    data size N times model size M, are ``world_size``, the number of
    ranks the run was started with."""
    sizes = parse_mesh_shape(spec, world_size)
    need = sizes["data"] * sizes["model"]
    if need != world_size:
        raise ValueError(f"mesh_shape={spec!r} asks for {need} ranks ({sizes['data']} data x "
                         f"{sizes['model']} model) and this run has {world_size}: launch {need} "
                         f"ranks (torchrun --nproc-per-node {need}) or pass a mesh_shape of "
                         f"{world_size} ranks, e.g. 'data:{world_size}'")


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``device`` as given, except that "cuda"
    without an index means ``cuda:LOCAL_RANK`` (0 outside ``torchrun``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return resolve_device(device)


# An axis whose group holds this rank alone: its collectives do nothing.
ALONE = "alone"
# The axis groups of the world, by model size: (the world's process group,
# [the model group of each data index], [the data group of each model
# index]). dist.new_group is collective, so every rank makes every group,
# once, in one order; the world group is kept beside them, so that groups
# of an earlier process group are never handed out.
_AXIS_GROUPS: dict = {}


def _axis_groups(model: int, size: int):
    world = dist.group.WORLD
    hit = _AXIS_GROUPS.get(model)
    if hit is None or hit[0] is not world:
        data = size // model
        models = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
        datas = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
        hit = _AXIS_GROUPS[model] = (world, models, datas)
    return hit


class DataMesh:
    """The ranks of one run as this process sees them: its ``rank`` of
    ``size`` in the process ``group`` (None: the default group), the
    ``backend``, its ``device``, and the two axes of ``mesh_shape``
    "data:N,model:M" over that group: ``data_rank`` of ``data_size`` = N,
    ``model_rank`` of ``model_size`` = M, rank = data_rank·M + model_rank,
    and each axis's process group (``data_group``, ``model_group``; ALONE
    where the axis holds this rank alone). With M = 1 the data group is
    ``group`` itself. Built by ``start_ranks``, or on a group started
    elsewhere (``DataMesh(device)``; ``with_model_axis`` for M > 1). A
    mesh with both axes > 1 is built on the default group, whose every
    rank makes the axes' groups; with one axis of 1 the other is
    ``group``, which may be any group."""

    model_size = 1

    def __init__(self, device, group=None, model: int = 1):
        if not dist.is_initialized():
            raise RuntimeError("no process group: start one with parallel.start_ranks "
                               "(or torch.distributed.init_process_group)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)
        if model < 1 or self.size % model:
            raise ValueError(f"mesh_shape: a model axis of {model} does not divide the "
                             f"{self.size} ranks")
        self.model_size = model
        if model == 1:
            self.data_group, self.model_group = group, ALONE
        elif self.data_size == 1:  # the module takes no model group as None
            self.data_group, self.model_group = ALONE, dist.group.WORLD if group is None else group
        elif group is not None:
            raise ValueError(f"mesh_shape 'data:{self.data_size},model:{model}' is built on the "
                             f"default process group, not on a group of it")
        else:
            _, models, datas = _axis_groups(model, self.size)
            self.model_group, self.data_group = models[self.data_rank], datas[self.model_rank]

    def with_model_axis(self, model: int) -> "DataMesh":
        """This mesh's ranks laid out with a model axis of ``model``
        (collective where it makes groups: every rank calls it alike)."""
        if model == self.model_size:
            return self
        return DataMesh(self.device, self.group, model)

    @property
    def data_size(self) -> int:
        return self.size // self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that writes files and prints reports."""
        return self.rank == 0

    @property
    def shape(self) -> str:
        """The ``mesh_shape`` of this layout, "data:N,model:M"."""
        return f"data:{self.data_size},model:{self.model_size}"

    def __repr__(self):
        axes = "" if self.model_size == 1 else (
            f", data={self.data_rank}/{self.data_size}, model={self.model_rank}/{self.model_size}")
        return (f"DataMesh(rank={self.rank}, size={self.size}, backend={self.backend!r}, "
                f"device={str(self.device)!r}{axes})")

    def global_rank(self, rank: int) -> int:
        """The default group's rank of ``rank`` of ``group``."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    @staticmethod
    def sum_(t: torch.Tensor, group) -> None:
        """Sums ``t`` in place over ``group``'s ranks (nothing where ALONE)."""
        if group is not ALONE:
            dist.all_reduce(t, group=group)

    def rows(self, batch: int) -> slice:
        """This rank's contiguous rows [d·b, (d+1)·b) of a global batch of
        ``batch`` rows, d its data rank, b = batch / data_size; a batch
        that the data ranks do not divide raises a ValueError ("does not
        divide"), as JAX's shard_map paths do (engine/steps.py:251-256,
        :395-400). The ranks of one model group get the same rows."""
        if batch % self.data_size:
            raise ValueError(f"global batch {batch} does not divide the data axis "
                             f"({self.data_size} ranks); adjust batch_size / batch_size_eval or "
                             f"the number of ranks")
        b = batch // self.data_size
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def shard(self, x: torch.Tensor, batch: int, dim: int = 0) -> torch.Tensor:
        """This rank's rows of ``x``, whose axis ``dim`` holds groups of
        ``batch`` rows each, [group][row]: row d·b + i of every group. x_T
        of a flip-TTA eval with ``repeat_n`` hypotheses is ordered
        [hypothesis][normal | flipped][row], so data rank d keeps rows
        h·2B + s·B + [d·b, (d+1)·b) for every hypothesis h and half s."""
        rows = self.rows(batch)
        shape = tuple(x.shape)
        groups = shape[dim] // batch
        if groups * batch != shape[dim]:
            raise ValueError(f"axis {dim} of {shape} is not a whole number of batches of {batch}")
        x = x.reshape(shape[:dim] + (groups, batch) + shape[dim + 1:])
        x = x.narrow(dim + 1, rows.start, rows.stop - rows.start)
        return x.reshape(shape[:dim] + (groups * (rows.stop - rows.start),) + shape[dim + 1:])

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The data ranks' rows in order, [data_size·b, ...] from each
        rank's [b, ...] (the inverse of ``rows``), on every rank: a sum
        all-reduce over the data group of a zero-filled global buffer that
        each rank fills at its own rows. It is exact, since every element
        has one non-zero term (a -0.0 comes back as 0.0)."""
        b = local.shape[0]
        out = local.new_zeros((self.data_size * b,) + tuple(local.shape[1:]))
        out[self.data_rank * b:(self.data_rank + 1) * b] = local
        self.sum_(out, self.data_group)
        return out

    def average_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Replaces each tensor, in place, by its mean over the data ranks
        (JAX's ``pmean``): the tensors flattened into one buffer, one
        all-reduce, no host read."""
        tensors = list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.sum_(flat, self.data_group)
        flat /= self.data_size
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))

    def average_grads_(self, params: Iterable[torch.Tensor], loss: torch.Tensor) -> torch.Tensor:
        """After ``backward``: every parameter's gradient replaced by its
        mean over the data ranks, in place, and the loss averaged with them
        in the same all-reduce; returns the averaged loss (detached). The
        shards are equal, so the mean of the ranks' means is the mean over
        the global batch. A shard's gradient is averaged over the ranks
        that hold the same shard."""
        loss = loss.detach().reshape(1).clone()
        self.average_([p.grad for p in params if p.grad is not None] + [loss])
        return loss[0]

    def mean(self, value: torch.Tensor) -> torch.Tensor:
        """A scalar's mean over the data ranks (detached)."""
        value = value.detach().reshape(1).clone()
        self.average_([value])
        return value[0]

    def from_main(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (a host decision, such as the
        stop on ``max_time``, that every rank must take alike)."""
        t = torch.tensor([float(flag)], device=self.device)
        dist.broadcast(t, self.global_rank(0), group=self.group)
        return bool(t.item())

    def check_replicated(self, tensors: Iterable[torch.Tensor], what: str = "parameters",
                         axis: Optional[str] = None) -> None:
        """Raises a RuntimeError on every rank unless the ranks hold the
        same ``tensors`` bit for bit: every rank of ``group`` (``axis``
        None: replicated tensors), or every rank of this rank's data group
        (``axis="data"``: the shards of a model rank, which the ranks of
        other model groups hold alike). The first rank's copy is broadcast
        and compared, and the count of differing elements all-reduced over
        ``group`` (one host read)."""
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
        ref = flat.clone()
        if axis is None:
            dist.broadcast(ref, self.global_rank(0), group=self.group)
        elif self.data_group is not ALONE:
            dist.broadcast(ref, self.global_rank(self.model_rank), group=self.data_group)
        bad = (ref != flat).sum().to(torch.float32).reshape(1)
        dist.all_reduce(bad, group=self.group)
        if bad.item():
            where = "rank 0's" if axis is None else "data rank 0's"
            raise RuntimeError(f"the ranks do not hold the same {what}: {int(bad.item())} "
                               f"elements differ from {where} (load the same weights on every "
                               f"rank, or build them from the same seed)")

    def barrier(self) -> None:
        dist.barrier(group=self.group, **({"device_ids": [self.device.index]}
                                          if self.backend == "nccl" else {}))


def start_ranks(device="cuda", backend: Optional[str] = None, init_method: Optional[str] = None,
                rank: Optional[int] = None, world_size: Optional[int] = None,
                timeout: Optional[float] = None) -> DataMesh:
    """Starts this process's rank and returns its ``DataMesh``: from the
    ``torchrun`` environment, or from ``init_method`` (e.g.
    "tcp://localhost:29500" or "file:///tmp/rendezvous"), ``rank`` and
    ``world_size`` where given. ``device``: "cuda" means
    ``cuda:LOCAL_RANK``; ``backend``: default ``nccl`` on CUDA, ``gloo`` on
    the CPU; ``timeout``: seconds a collective may wait (torch's default
    where None)."""
    device = rank_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if init_method is None and "WORLD_SIZE" not in os.environ:
        raise RuntimeError("no ranks to start: run under torchrun (python -m "
                           "torch.distributed.run --nproc-per-node N ...) or pass init_method, "
                           "rank and world_size")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if init_method is not None:
        kw.update(init_method=init_method, rank=rank, world_size=world_size)
    dist.init_process_group(backend, **kw)
    return DataMesh(device)


@contextlib.contextmanager
def entry_ranks(device="cuda"):
    """The data-parallel ranks of an entry point (``cli.run.main`` and its
    kin): yields the ``DataMesh`` of the process group this process
    already belongs to, or of one started from the ``torchrun``
    environment (``WORLD_SIZE`` set), which is destroyed on exit; else
    None, one process on ``device``."""
    if dist.is_initialized():
        yield DataMesh(rank_device(device))
        return
    if "WORLD_SIZE" not in os.environ:
        yield None
        return
    mesh = start_ranks(device)
    try:
        yield mesh
    finally:
        _AXIS_GROUPS.clear()
        dist.destroy_process_group()
