"""Evaluation metrics: Protocols #1/#2/#3, velocity errors, the auxiliary
bone losses, and 3DHP PCK/AUC.

``mpjpe``, ``n_mpjpe``, ``p_mpjpe`` and ``mean_velocity_error`` are the
host-side NumPy functions of ``diff3dhpe_tpu/metrics/metrics.py`` that the
evaluate path calls, operation for operation, so the two packages report
bit-equal numbers on the same arrays (reference: common/loss.py:15-142).
The rest of that module is here in torch, on tensors of any device: what
JAX runs under ``jax.numpy`` (``xp=jnp``) runs here as torch operations,
and ``p_mpjpe_device`` is the batched Procrustes on ``torch.linalg.svd``.
"""
from __future__ import annotations

import numpy as np
import torch


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


def _tnorm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _reduce(per_joint, reduce):
    if reduce == "mean":
        return per_joint.mean()
    if reduce == "none":
        return per_joint.mean(dim=-1)
    raise ValueError(f"Unknown reduce method: {reduce}")


def weighted_mpjpe(predicted, target, w, reduce="mean"):
    """MPJPE with per-joint weights ``w`` (broadcast against [..., J])."""
    assert predicted.shape == target.shape
    return _reduce(w * _tnorm(predicted - target), reduce)


def p_mpjpe_device(predicted, target):
    """Protocol #2 on the tensors' device: :func:`p_mpjpe`'s algorithm
    (reflection fix and scale included) with a batched
    ``torch.linalg.svd``. predicted/target: [N, J, 3]."""
    assert predicted.shape == target.shape
    mu_x = target.mean(dim=1, keepdim=True)
    mu_y = predicted.mean(dim=1, keepdim=True)
    x0, y0 = target - mu_x, predicted - mu_y
    norm_x = torch.sqrt((x0 ** 2).sum(dim=(1, 2), keepdim=True))
    norm_y = torch.sqrt((y0 ** 2).sum(dim=(1, 2), keepdim=True))
    x0, y0 = x0 / norm_x, y0 / norm_y

    h = x0.transpose(1, 2) @ y0
    u, s, vt = torch.linalg.svd(h)
    v = vt.transpose(1, 2)
    sign_det_r = torch.sign(torch.linalg.det(v @ u.transpose(1, 2)))
    v = torch.cat([v[:, :, :-1], v[:, :, -1:] * sign_det_r[:, None, None]], dim=2)
    s = torch.cat([s[:, :-1], s[:, -1:] * sign_det_r[:, None]], dim=1)
    r = v @ u.transpose(1, 2)

    tr = s.sum(dim=1, keepdim=True)[:, :, None]
    a = tr * norm_x / norm_y  # optimal scale
    t = mu_x - a * (mu_y @ r)  # optimal translation
    aligned = a * (predicted @ r) + t
    return _tnorm(aligned - target).mean()


def mean_velocity_error_train(predicted, target, axis=0, reduce="mean"):
    """MPJVE over ``axis`` (0 or 1) of 4-D inputs, differentiable."""
    assert predicted.shape == target.shape
    assert predicted.dim() == 4
    if axis not in (0, 1):
        raise ValueError(f"Unsupported axis {axis}")
    diff = lambda a: torch.diff(a, dim=axis)
    return _reduce(_tnorm(diff(predicted) - diff(target)), reduce)


def weighted_bonelen_loss(predict_3d_length, gt_3d_length):
    """Auxiliary bone-length penalty (reference: common/loss.py:96-98)."""
    return 0.001 * ((predict_3d_length - gt_3d_length) ** 2).mean()


def weighted_boneratio_loss(predict_3d_length, gt_3d_length):
    """Auxiliary bone-ratio penalty (reference: common/loss.py:100-102)."""
    return 0.1 * (((predict_3d_length - gt_3d_length) / gt_3d_length) ** 2).mean()


def bone_lengths(poses, parents):
    """Per-bone lengths [..., n_bones] from poses [..., J, 3] and a parent
    table (root entries with parent -1 are skipped)."""
    idx = [(j, p) for j, p in enumerate(parents) if p != -1]
    child = torch.tensor([j for j, _ in idx], device=poses.device)
    par = torch.tensor([p for _, p in idx], device=poses.device)
    return _tnorm(poses[..., child, :] - poses[..., par, :])


def l1_loss(predicted, target, reduce="mean"):
    assert predicted.shape == target.shape
    err = (predicted - target).abs()
    return err.mean() if reduce == "mean" else err


def l2_loss(predicted, target, reduce="mean"):
    assert predicted.shape == target.shape
    err = (predicted - target) ** 2
    return err.mean() if reduce == "mean" else err


def pck(predicted, target, threshold=150.0, valid_mask=None):
    """3DHP PCK: percentage of joints within ``threshold`` (mm, inclusive)
    of the ground truth. predicted/target: [N, J, 3] in millimetres;
    valid_mask: optional [N] bool of the frames to count."""
    assert predicted.shape == target.shape
    correct = (_tnorm(predicted - target) <= threshold).to(predicted.dtype)
    if valid_mask is not None:
        correct = correct[valid_mask]
    return 100.0 * correct.mean()


def auc(predicted, target, thresholds=None, valid_mask=None):
    """3DHP AUC: mean PCK over thresholds 0..150 mm, step 5 (31 points)."""
    assert predicted.shape == target.shape
    if thresholds is None:
        thresholds = np.arange(0, 151, 5, dtype=np.float64)
    dist = _tnorm(predicted - target)
    if valid_mask is not None:
        dist = dist[valid_mask]
    pcks = torch.stack([(dist <= float(th)).to(dist.dtype).mean() for th in thresholds])
    return 100.0 * pcks.mean()
