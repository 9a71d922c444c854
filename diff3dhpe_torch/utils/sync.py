"""Device synchronisation for timing windows.

PyTorch returns from a CUDA call before the card has finished it, so a host
clock read right after measures the enqueue. ``torch.cuda.synchronize``
waits for the card; the value read back to the host then comes from the
finished computation, as the JAX package's ``device_sync`` returns one
(``diff3dhpe_tpu/utils/sync.py``).
"""
from __future__ import annotations

import torch


def _leaves(x):
    """The tensors of ``x`` (a tensor, or dicts, lists and tuples of them),
    dict entries in key order as ``jax.tree.leaves`` orders them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def device_sync(x) -> float:
    """Waits until the card has finished the work queued before this call
    (for a CUDA tensor in ``x``; on the CPU nothing is pending) and returns
    the first element of the first tensor of ``x`` as a float, read to the
    host (0.0 for an empty one or none)."""
    leaves = _leaves(x)
    if not leaves:
        return 0.0
    first = leaves[0]
    if first.is_cuda:
        torch.cuda.synchronize(first.device)
    return float(first.detach().reshape(-1)[:1].float().sum())
