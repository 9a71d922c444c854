"""Camera-space transforms and the Human3.6M projection model.

Pure functions over NumPy (host data-prep path) with an ``xp`` escape hatch
for any module with the NumPy API. Numerics mirror the reference exactly (reference:
common/camera.py:17-92) so the global 3D-normalization scale and GT-2D
projection match bit-for-bit at float32.
"""
from __future__ import annotations

import numpy as np

from diff3dhpe_torch.geometry.quaternion import qrot, qinverse


def normalize_screen_coordinates(X, w, h):
    """Map [0, w] x [0, h] pixels to [-1, 1] x-range, preserving aspect ratio.

    The offset constant is float64 (as in the reference), so float32 inputs
    upcast during the computation and the caller decides the storage dtype.
    """
    assert X.shape[-1] == 2
    return X / w * 2 - np.array([1, h / w])


def image_coordinates(X, w, h):
    """Inverse of :func:`normalize_screen_coordinates`."""
    assert X.shape[-1] == 2
    return (X + np.array([1, h / w])) * w / 2


def _tile_quat(q, X, xp=np):
    # Broadcast a single quaternion (4,) over all leading dims of X (*, 3).
    return xp.broadcast_to(q, (*X.shape[:-1], 4))


def world_to_camera(X, R, t, xp=np):
    """World -> camera: rotate by R^{-1} after translating by -t.

    X: (*, 3) points; R: (4,) unit quaternion camera orientation; t: (3,).
    """
    Rt = qinverse(xp.asarray(R), xp=xp)
    return qrot(_tile_quat(Rt, X, xp=xp), X - t, xp=xp)


def camera_to_world(X, R, t, xp=np):
    """Camera -> world: rotate by R then translate by t."""
    return qrot(_tile_quat(xp.asarray(R), X, xp=xp), X, xp=xp) + t


def project_to_2d(X, camera_params, xp=np):
    """Project camera-space 3D points with the full H3.6M distortion model.

    X: (N, *, 3); camera_params: (N, 9) = focal(2) + center(2) + radial(3)
    + tangential(2). Matches reference common/camera.py:40-70 including the
    clamp of the normalized image coordinates to [-1, 1].
    """
    assert X.shape[-1] == 3
    assert len(camera_params.shape) == 2
    assert camera_params.shape[-1] == 9
    assert X.shape[0] == camera_params.shape[0]

    while len(camera_params.shape) < len(X.shape):
        camera_params = camera_params[:, None]

    f = camera_params[..., :2]
    c = camera_params[..., 2:4]
    k = camera_params[..., 4:7]
    p = camera_params[..., 7:]

    XX = xp.clip(X[..., :2] / X[..., 2:], -1.0, 1.0)
    r2 = xp.sum(XX[..., :2] ** 2, axis=-1, keepdims=True)

    radial = 1 + xp.sum(
        k * xp.concatenate((r2, r2 ** 2, r2 ** 3), axis=-1), axis=-1, keepdims=True
    )
    tan = xp.sum(p * XX, axis=-1, keepdims=True)

    XXX = XX * (radial + tan) + p * r2
    return f * XXX + c


def project_to_2d_linear(X, camera_params, xp=np):
    """Pinhole-only projection (focal length + principal point)."""
    assert X.shape[-1] == 3
    assert len(camera_params.shape) == 2
    assert camera_params.shape[-1] == 9
    assert X.shape[0] == camera_params.shape[0]

    while len(camera_params.shape) < len(X.shape):
        camera_params = camera_params[:, None]

    f = camera_params[..., :2]
    c = camera_params[..., 2:4]
    XX = xp.clip(X[..., :2] / X[..., 2:], -1.0, 1.0)
    return f * XX + c
