"""The ten metrics of ``diff3dhpe_tpu/metrics/metrics.py`` that the port
adds in torch (weighted MPJPE, the device Procrustes, the differentiable
velocity error, the bone losses, L1/L2, 3DHP PCK and AUC), each against
the JAX package's function on the same seeded arrays: at float64 against
its NumPy form (``xp=np``), and ``p_mpjpe_device`` also against JAX's
``jax.numpy`` version and the host ``p_mpjpe``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch import metrics as port
from diff3dhpe_tpu.metrics import metrics as ref
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _poses(seed, shape=(6, 7, 17, 3), scale=1.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * scale
    return a, a + 0.1 * scale * rng.standard_normal(shape)


def _mm(seed, n=40, j=17, spread=120.0):
    """[n, j, 3] in mm: a target and a prediction off by up to ~3 spreads."""
    rng = np.random.default_rng(seed)
    target = rng.uniform(-800, 800, (n, j, 3))
    return target + rng.standard_normal((n, j, 3)) * spread, target


def _parents():
    """The 17-joint Human3.6M skeleton's parent table."""
    return [-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15]


def _cases():
    pred, target = _poses(1)
    w = np.random.default_rng(2).uniform(0.5, 2.0, 17)
    pred_mm, target_mm = _mm(3)
    valid = np.random.default_rng(4).random(40) > 0.3
    lengths = ref.bone_lengths(target, _parents())
    lengths_pred = ref.bone_lengths(pred, _parents())
    return {
        "weighted_mpjpe": (port.weighted_mpjpe, ref.weighted_mpjpe, (pred, target, w), {}),
        "weighted_mpjpe_none": (port.weighted_mpjpe, ref.weighted_mpjpe, (pred, target, w),
                                dict(reduce="none")),
        "mean_velocity_error_train_axis0": (port.mean_velocity_error_train,
                                            ref.mean_velocity_error_train, (pred, target), {}),
        "mean_velocity_error_train_axis1_none": (
            port.mean_velocity_error_train, ref.mean_velocity_error_train, (pred, target),
            dict(axis=1, reduce="none")),
        "weighted_bonelen_loss": (port.weighted_bonelen_loss, ref.weighted_bonelen_loss,
                                  (lengths_pred, lengths), {}),
        "weighted_boneratio_loss": (port.weighted_boneratio_loss, ref.weighted_boneratio_loss,
                                    (lengths_pred, lengths), {}),
        "bone_lengths": (lambda p: port.bone_lengths(p, _parents()),
                         lambda p: ref.bone_lengths(p, _parents()), (pred,), {}),
        "l1_loss": (port.l1_loss, ref.l1_loss, (pred, target), {}),
        "l1_loss_none": (port.l1_loss, ref.l1_loss, (pred, target), dict(reduce="none")),
        "l2_loss": (port.l2_loss, ref.l2_loss, (pred, target), {}),
        "l2_loss_none": (port.l2_loss, ref.l2_loss, (pred, target), dict(reduce="none")),
        "pck": (port.pck, ref.pck, (pred_mm, target_mm), {}),
        "pck_threshold_mask": (lambda p, t: port.pck(p, t, 100.0, torch.from_numpy(valid)),
                               lambda p, t: ref.pck(p, t, 100.0, valid), (pred_mm, target_mm),
                               {}),
        "auc": (port.auc, ref.auc, (pred_mm, target_mm), {}),
        "auc_mask": (lambda p, t: port.auc(p, t, valid_mask=torch.from_numpy(valid)),
                     lambda p, t: ref.auc(p, t, valid_mask=valid), (pred_mm, target_mm), {}),
        "p_mpjpe_device": (port.p_mpjpe_device, ref.p_mpjpe, _poses(5, (64, 17, 3)), {}),
    }


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_metric_matches_jax(case):
    fn, ref_fn, args, kw = CASES[case]
    got = fn(*(torch.from_numpy(np.asarray(a)) for a in args), **kw)
    expected = ref_fn(*args, **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-12, atol=1e-12)


def test_p_mpjpe_device_matches_jax_device_and_host():
    """At float32 against JAX's on-device version, and against the host
    function at float64, with reflections among the fits: half the
    predictions are mirror images of their targets."""
    rng = np.random.default_rng(6)
    target = rng.standard_normal((32, 17, 3))
    pred = target + 0.05 * rng.standard_normal(target.shape)
    pred[::2, :, 0] *= -1  # mirrored: the best proper rotation needs the det fix
    got64 = port.p_mpjpe_device(torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(got64.numpy(), ref.p_mpjpe(pred, target), rtol=1e-12)
    p32, t32 = pred.astype(np.float32), target.astype(np.float32)
    got32 = port.p_mpjpe_device(torch.from_numpy(p32), torch.from_numpy(t32))
    expected32 = ref.p_mpjpe_device(jnp.asarray(p32), jnp.asarray(t32))
    np.testing.assert_allclose(got32.numpy(), np.asarray(expected32), rtol=1e-5)
    np.testing.assert_allclose(got32.numpy(), ref.p_mpjpe(pred, target), rtol=1e-5)


def test_metrics_keep_the_gradient():
    """The losses the reference trains with stay differentiable in torch."""
    pred, target = (torch.from_numpy(a).requires_grad_(i == 0)
                    for i, a in enumerate(_poses(7)))
    lengths = port.bone_lengths(pred, _parents())
    total = (port.weighted_mpjpe(pred, target, torch.ones(17))
             + port.mean_velocity_error_train(pred, target)
             + port.weighted_bonelen_loss(lengths, port.bone_lengths(target, _parents()))
             + port.l1_loss(pred, target) + port.l2_loss(pred, target))
    total.backward()
    assert pred.grad is not None and torch.isfinite(pred.grad).all()
