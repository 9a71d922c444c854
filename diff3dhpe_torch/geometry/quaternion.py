"""Quaternion primitives.

Pure functions, written against the NumPy API so the same code runs on host
numpy arrays (data-prep path) and under any module with the NumPy API via
the ``xp`` argument. Semantics match the reference ops (reference:
common/quaternion.py:13-38) — unit quaternions in (w, x, y, z) order.
"""
from __future__ import annotations

import numpy as np


def qrot(q, v, xp=np):
    """Rotate vector(s) ``v`` by unit quaternion(s) ``q``.

    q: (*, 4), v: (*, 3) with matching leading dims. Returns (*, 3).
    Uses the Rodrigues-style expansion v + 2*(w*(qvec x v) + qvec x (qvec x v)).
    """
    assert q.shape[-1] == 4
    assert v.shape[-1] == 3
    assert q.shape[:-1] == v.shape[:-1]

    qvec = q[..., 1:]
    uv = xp.cross(qvec, v, axis=-1)
    uuv = xp.cross(qvec, uv, axis=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qinverse(q, xp=np):
    """Conjugate of a unit quaternion (== inverse for normalized q)."""
    assert q.shape[-1] == 4
    return xp.concatenate((q[..., :1], -q[..., 1:]), axis=-1)
