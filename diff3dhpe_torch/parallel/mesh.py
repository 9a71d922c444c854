"""Data parallelism across processes: one rank per process, each holding a
full replica of the model, the batch split over the ranks.

Port of the ``data`` axis of ``diff3dhpe_tpu/parallel/mesh.py`` (:27-45,
:91-99). JAX builds a device mesh inside one program and lets XLA (or
``shard_map``) split the batch; here ``torch.distributed`` runs one rank a
process, and ``DataMesh`` is what a step needs of it: the rank's rows of a
global batch, the gradient average (JAX's ``pmean``), the ordered gather
of a prediction's rows, and a check that every rank holds the same weights.
JAX's ``model`` axis (tensor parallelism on the flax path) is not ported
(ROADMAP A.12): a ``mesh_shape`` with a ``model`` axis > 1 raises.

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
    """Raises a ValueError naming ``mesh_shape`` unless the spec is the data
    axis of this run: a ``model`` axis > 1 (tensor parallelism, ROADMAP
    A.12), or a ``data`` size other than ``world_size``, the number of
    ranks the run was started with."""
    sizes = parse_mesh_shape(spec, world_size)
    if sizes["model"] > 1:
        raise ValueError(f"mesh_shape={spec!r} is not ported: a 'model' axis of "
                         f"{sizes['model']} is tensor parallelism (ROADMAP A.12); the port runs "
                         f"data parallel, mesh_shape='data:{world_size}'")
    if sizes["data"] != world_size:
        raise ValueError(f"mesh_shape={spec!r} asks for {sizes['data']} data-parallel ranks and "
                         f"this run has {world_size}: launch {sizes['data']} ranks "
                         f"(torchrun --nproc-per-node {sizes['data']}) or pass "
                         f"mesh_shape='data:{world_size}'")


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``device`` as given, except that "cuda"
    without an index means ``cuda:LOCAL_RANK`` (0 outside ``torchrun``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return resolve_device(device)


class DataMesh:
    """The ranks of one data-parallel run as this process sees them: its
    ``rank`` of ``size``, the ``backend``, its ``device`` and the process
    ``group`` (None: the default group). Built by ``start_ranks``, or on a
    group started elsewhere (``DataMesh(device)``)."""

    def __init__(self, device, group=None):
        if not dist.is_initialized():
            raise RuntimeError("no process group: start one with parallel.start_ranks "
                               "(or torch.distributed.init_process_group)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that writes files and prints reports."""
        return self.rank == 0

    def __repr__(self):
        return (f"DataMesh(rank={self.rank}, size={self.size}, backend={self.backend!r}, "
                f"device={str(self.device)!r})")

    def rows(self, batch: int) -> slice:
        """This rank's contiguous rows [r·b, (r+1)·b) of a global batch of
        ``batch`` rows, b = batch / size; a batch that the ranks do not
        divide raises a ValueError ("does not divide"), as JAX's shard_map
        paths do (engine/steps.py:251-256, :395-400)."""
        if batch % self.size:
            raise ValueError(f"global batch {batch} does not divide the data axis ({self.size} "
                             f"ranks); adjust batch_size / batch_size_eval or the number of ranks")
        b = batch // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def shard(self, x: torch.Tensor, batch: int, dim: int = 0) -> torch.Tensor:
        """This rank's rows of ``x``, whose axis ``dim`` holds groups of
        ``batch`` rows each, [group][row]: row r·b + i of every group. x_T
        of a flip-TTA eval with ``repeat_n`` hypotheses is ordered
        [hypothesis][normal | flipped][row], so rank r keeps rows h·2B +
        s·B + [r·b, (r+1)·b) for every hypothesis h and half s."""
        rows = self.rows(batch)
        shape = tuple(x.shape)
        groups = shape[dim] // batch
        if groups * batch != shape[dim]:
            raise ValueError(f"axis {dim} of {shape} is not a whole number of batches of {batch}")
        x = x.reshape(shape[:dim] + (groups, batch) + shape[dim + 1:])
        x = x.narrow(dim + 1, rows.start, rows.stop - rows.start)
        return x.reshape(shape[:dim] + (groups * (rows.stop - rows.start),) + shape[dim + 1:])

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The ranks' rows in rank order, [size·b, ...] from each rank's
        [b, ...] (the inverse of ``rows``), on every rank: a sum
        all-reduce of a zero-filled global buffer that each rank fills at
        its own rows. It is exact, since every element has one non-zero
        term (a -0.0 comes back as 0.0)."""
        b = local.shape[0]
        out = local.new_zeros((self.size * b,) + tuple(local.shape[1:]))
        out[self.rank * b:(self.rank + 1) * b] = local
        dist.all_reduce(out, group=self.group)
        return out

    def average_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Replaces each tensor, in place, by its mean over the ranks
        (JAX's ``pmean``): the tensors flattened into one buffer, one
        all-reduce, no host read."""
        tensors = list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat /= self.size
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))

    def average_grads_(self, params: Iterable[torch.Tensor], loss: torch.Tensor) -> torch.Tensor:
        """After ``backward``: every parameter's gradient replaced by its
        mean over the ranks, in place, and the loss averaged with them in
        the same all-reduce; returns the averaged loss (detached). The
        shards are equal, so the mean of the ranks' means is the mean over
        the global batch."""
        loss = loss.detach().reshape(1).clone()
        self.average_([p.grad for p in params if p.grad is not None] + [loss])
        return loss[0]

    def mean(self, value: torch.Tensor) -> torch.Tensor:
        """A scalar's mean over the ranks (detached)."""
        value = value.detach().reshape(1).clone()
        self.average_([value])
        return value[0]

    def from_main(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (a host decision, such as the
        stop on ``max_time``, that every rank must take alike)."""
        t = torch.tensor([float(flag)], device=self.device)
        dist.broadcast(t, 0, group=self.group)
        return bool(t.item())

    def check_replicated(self, tensors: Iterable[torch.Tensor], what: str = "parameters") -> None:
        """Raises a RuntimeError on every rank unless every rank holds
        rank 0's ``tensors`` bit for bit: rank 0's copy is broadcast and
        compared, and the count of differing elements all-reduced (one
        host read)."""
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
        ref = flat.clone()
        dist.broadcast(ref, 0, group=self.group)
        bad = (ref != flat).sum().to(torch.float32).reshape(1)
        dist.all_reduce(bad, group=self.group)
        if bad.item():
            raise RuntimeError(f"the ranks do not hold the same {what}: {int(bad.item())} "
                               f"elements differ from rank 0's (load the same weights on every "
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
        dist.destroy_process_group()
