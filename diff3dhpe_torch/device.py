"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device. A CUDA device on a machine without one
    raises: the port never falls back to the CPU unless the caller asks for
    it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return device


def to_device(a, device, dtype=None) -> torch.Tensor:
    """``a`` (an array or a tensor) as a tensor on ``device``, in ``dtype``
    where given. A host array bound for a CUDA device goes through pinned
    memory and a non-blocking copy: PyTorch synchronises the stream after a
    copy from pageable memory, which would make the host wait for the card
    at every call on the train path."""
    device = torch.device(device)
    t = torch.as_tensor(a, dtype=dtype)
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
