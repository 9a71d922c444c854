"""Evaluation metrics: Protocols #1/#2/#3 and the velocity error.

The host-side NumPy functions of ``diff3dhpe_tpu/metrics/metrics.py`` that
the evaluate path calls, operation for operation, so the two packages
report bit-equal numbers on the same arrays (reference:
common/loss.py:15-142). The remaining metrics of that module (PCK/AUC, the
device Procrustes variant, the auxiliary losses) are not ported yet.
"""
from __future__ import annotations

import numpy as np


def _norm(x, axis, xp):
    return xp.sqrt(xp.sum(x * x, axis=axis))


def mpjpe(predicted, target, reduce="mean", xp=np):
    """Protocol #1: mean per-joint position error (Euclidean distance)."""
    assert predicted.shape == target.shape
    per_joint = _norm(predicted - target, axis=-1, xp=xp)
    if reduce == "mean":
        return xp.mean(per_joint)
    elif reduce == "none":
        return xp.mean(per_joint, axis=-1)
    raise ValueError(f"Unknown reduce method: {reduce}")


def n_mpjpe(predicted, target, xp=np):
    """Protocol #3: MPJPE after optimal per-pose scale alignment."""
    assert predicted.shape == target.shape
    norm_predicted = xp.mean(
        xp.sum(predicted ** 2, axis=3, keepdims=True), axis=2, keepdims=True
    )
    norm_target = xp.mean(
        xp.sum(target * predicted, axis=3, keepdims=True), axis=2, keepdims=True
    )
    scale = norm_target / norm_predicted
    return mpjpe(scale * predicted, target, xp=xp)


def p_mpjpe(predicted, target):
    """Protocol #2: MPJPE after rigid (Procrustes) alignment. Host NumPy.

    predicted/target: (N, J, 3).

    Lineage: this is the standard numpy orthogonal-Procrustes alignment as
    published in VideoPose3D (MIT licence, facebookresearch/VideoPose3D
    common/loss.py) and carried verbatim by the reference (loss.py:43-82);
    it is kept step-identical on purpose — Protocol #2 numbers are only
    comparable if the reflection-fix and scale conventions match exactly.
    """
    assert predicted.shape == target.shape

    muX = np.mean(target, axis=1, keepdims=True)
    muY = np.mean(predicted, axis=1, keepdims=True)

    X0 = target - muX
    Y0 = predicted - muY

    normX = np.sqrt(np.sum(X0 ** 2, axis=(1, 2), keepdims=True))
    normY = np.sqrt(np.sum(Y0 ** 2, axis=(1, 2), keepdims=True))

    X0 = X0 / normX
    Y0 = Y0 / normY

    H = np.matmul(X0.transpose(0, 2, 1), Y0)
    U, s, Vt = np.linalg.svd(H)
    V = Vt.transpose(0, 2, 1)
    R = np.matmul(V, U.transpose(0, 2, 1))

    # Fix improper rotations (reflections, det(R) = -1).
    sign_detR = np.sign(np.expand_dims(np.linalg.det(R), axis=1))
    V = V.copy()
    V[:, :, -1] *= sign_detR
    s = s.copy()
    s[:, -1] *= sign_detR.flatten()
    R = np.matmul(V, U.transpose(0, 2, 1))

    tr = np.expand_dims(np.sum(s, axis=1, keepdims=True), axis=2)

    a = tr * normX / normY  # optimal scale
    t = muX - a * np.matmul(muY, R)  # optimal translation

    predicted_aligned = a * np.matmul(predicted, R) + t
    return np.mean(np.linalg.norm(predicted_aligned - target, axis=len(target.shape) - 1))


def mean_velocity_error(predicted, target):
    """MPJVE: mean Euclidean error of the first temporal derivative. Host NumPy."""
    assert predicted.shape == target.shape
    velocity_predicted = np.diff(predicted, axis=0)
    velocity_target = np.diff(target, axis=0)
    return np.mean(
        np.linalg.norm(velocity_predicted - velocity_target, axis=len(target.shape) - 1)
    )
