"""The port's HumanEva and custom-footage datasets against the JAX
package's on the CPU: the HumanEva cameras (intrinsics and per-subject
extrinsics), ``HumanEvaDataset`` on an archive (as tests/test_datasets.py
builds it), ``make_synthetic_humaneva``, its test windows through
``PoseDataset``, ``CustomDataset``, and ``cli.run.main`` end to end on
both (the CLI draws its own x_T, so values are compared below it)."""
import numpy as np
import pytest

from diff3dhpe_torch.cli.run import main
from diff3dhpe_torch.config import Config
from diff3dhpe_torch.data import PoseDataset
from diff3dhpe_torch.data import humaneva
from diff3dhpe_torch.data.custom import CustomDataset
from diff3dhpe_torch.data.synthetic import make_synthetic_humaneva
from diff3dhpe_tpu.config import Config as JaxConfig
from diff3dhpe_tpu.data import PoseDataset as JaxPoseDataset
from diff3dhpe_tpu.data import humaneva as jax_humaneva
from diff3dhpe_tpu.data.custom import CustomDataset as JaxCustomDataset
from diff3dhpe_tpu.data.synthetic import make_synthetic_humaneva as jax_make_synthetic_humaneva
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

CONFIG = "configs/h36m_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json"
ARGS_COMMON = [
    "--synthetic", "-frame", "9", "-s", "9", "--embed_dim", "32", "--transformer_depth", "1",
    "--num-heads", "4", "--timesteps", "20", "--sampling_timesteps", "3", "-e", "1", "-b", "8",
    "--batch-size-eval", "16",
]


def _assert_tree_equal(got, expected, where="root"):
    """Nested dicts, lists and arrays equal key for key and element for
    element, arrays in the same dtype."""
    if isinstance(expected, dict):
        assert list(got) == list(expected), where
        for k in expected:
            _assert_tree_equal(got[k], expected[k], f"{where}/{k}")
    elif isinstance(expected, (list, tuple)):
        assert len(got) == len(expected), where
        for i, (a, b) in enumerate(zip(got, expected)):
            _assert_tree_equal(a, b, f"{where}[{i}]")
    elif isinstance(expected, np.ndarray):
        assert got.dtype == expected.dtype, where
        np.testing.assert_array_equal(got, expected, err_msg=where)
    else:
        assert got == expected, where


def test_humaneva_cameras_match_jax():
    got, expected = humaneva._build_subject_cameras(), jax_humaneva._build_subject_cameras()
    _assert_tree_equal(got, expected)
    # Every prefix of every subject, and the bare names; S4 has no extrinsics.
    assert "Validate/S2" in got and "S3" in got
    assert all("orientation" in c and "translation" in c for c in got["Train/S1"])
    assert not any("orientation" in c for c in got["S4"])
    assert humaneva.humaneva_skeleton.parents().tolist() == (
        jax_humaneva.humaneva_skeleton.parents().tolist())


def test_humaneva_dataset_matches_jax(tmp_path):
    """tests/test_datasets.py::test_humaneva_dataset's archive, with a
    second subject: the scale extrema the reference never computes, the
    cameras and the positions."""
    rng = np.random.default_rng(0)
    positions = {
        "Train/S1": {"Walking 1": rng.standard_normal((50, 15, 3)).astype("float32")},
        "Validate/S2": {"Jog 1": rng.standard_normal((40, 15, 3)).astype("float32")},
    }
    path = tmp_path / "data_3d_humaneva15.npz"
    np.savez_compressed(path, positions_3d=positions)
    got, expected = humaneva.HumanEvaDataset(str(path)), jax_humaneva.HumanEvaDataset(str(path))
    assert got.skeleton().num_joints() == 15
    assert np.isfinite(got._pos_3d_min) and got._pos_3d_max > got._pos_3d_min
    assert (got._pos_3d_min, got._pos_3d_max) == (expected._pos_3d_min, expected._pos_3d_max)
    assert got.subjects() == expected.subjects()
    _assert_tree_equal(got.cameras(), expected.cameras())
    for s in expected.subjects():
        _assert_tree_equal({a: dict(v) for a, v in got[s].items()},
                           {a: dict(v) for a, v in expected[s].items()})
    with pytest.raises(KeyError, match="Unknown HumanEva subject"):
        humaneva.HumanEvaDataset(data={"S9": {}})


def _synthetic():
    kw = dict(subjects=("Train/S1", "Validate/S1"), n_frames=60, seed=0)
    return make_synthetic_humaneva(**kw), jax_make_synthetic_humaneva(**kw)


def test_make_synthetic_humaneva_matches_jax():
    (got, got_kp), (expected, expected_kp) = _synthetic()
    _assert_tree_equal(got_kp, expected_kp)
    assert got.subjects() == expected.subjects()
    for s in expected.subjects():
        for a in expected[s]:
            np.testing.assert_array_equal(got[s][a]["positions"], expected[s][a]["positions"])
    assert (got._pos_3d_min, got._pos_3d_max) == (expected._pos_3d_min, expected._pos_3d_max)


CFG = dict(stride=9, number_of_frames=9, subjects_train="Train/S1", subjects_test="Validate/S1",
           dataset="humaneva15", batch_size=8)


@pytest.mark.parametrize("split", ["train", "test"])
def test_humaneva_windows_match_jax(split):
    """The HumanEva windows (15 joints, three cameras) through PoseDataset
    equal JAX's array for array, flipped copies and camera rows included."""
    (got_ds, got_kp), (jax_ds, jax_kp) = _synthetic()
    got = PoseDataset(Config(**CFG), got_ds, "data", split, keypoints_data=got_kp)
    expected = JaxPoseDataset(JaxConfig(**CFG), jax_ds, "data", split, keypoints_data=jax_kp)
    assert (got.num_joints, len(got)) == (15, len(expected))
    assert (got.scale, got.joints_left, got.joints_right) == (
        expected.scale, expected.joints_left, expected.joints_right)
    for b, e in zip(got.batches(8), expected.batches(8), strict=True):
        for field in ("gt_3d", "gt_3d_norm", "input_2d", "input_2d_flip", "target_mask",
                      "row_mask", "cam"):
            a, x = getattr(b, field), getattr(e, field)
            if x is None:
                assert a is None, field
            else:
                np.testing.assert_array_equal(a, x, err_msg=field)
        assert b.keys == e.keys


def _write_custom(root):
    """A 2D-only archive in the layout of tests/test_datasets.py:28-47."""
    rng = np.random.default_rng(0)
    metadata = {
        "layout_name": "coco", "num_joints": 17, "keypoints_symmetry": [[1, 3, 5], [2, 4, 6]],
        "video_metadata": {"vid.mp4": {"w": 1920, "h": 1080}},
    }
    path = root / "data_2d_custom_myvideo.npz"
    np.savez_compressed(
        path,
        positions_2d={"vid.mp4": {"custom": [
            rng.uniform(0, 1080, (40, 17, 2)).astype("float32")]}},
        metadata=metadata,
    )
    return path


def test_custom_dataset_matches_jax(tmp_path):
    path = _write_custom(tmp_path)
    got, expected = CustomDataset(str(path)), JaxCustomDataset(str(path))
    cams = got.cameras()["vid.mp4"]
    assert cams[0]["res_w"] == 1920 and cams[0]["res_h"] == 1080
    assert got._pos_3d_min == -1.0 and got._pos_3d_max == 1.0
    _assert_tree_equal(got.cameras(), expected.cameras())
    assert got.skeleton().num_joints() == expected.skeleton().num_joints() == 17
    assert got.skeleton().parents().tolist() == expected.skeleton().parents().tolist()
    assert (got.skeleton().joints_left(), got.skeleton().joints_right()) == (
        expected.skeleton().joints_left(), expected.skeleton().joints_right())
    assert not got.supports_semi_supervised()


def test_humaneva_cli_on_the_cpu(tmp_path):
    """tests/test_cli.py::test_run_humaneva_train_eval on the port: one
    epoch on synthetic HumanEva, then the per-action report, finite."""
    errors = main(["--config", CONFIG, "--dataset", "humaneva15", "-c", str(tmp_path),
                   "-str", "Train/S1", "-ste", "Validate/S1"] + ARGS_COMMON, device="cpu")
    assert set(errors) == {"e1", "e2", "e3", "ev"}
    assert errors["e1"] and all(np.isfinite(v) for vals in errors.values() for v in vals)
    assert (tmp_path / "best_epoch").is_dir()


def test_custom_cli_reports_without_ground_truth(tmp_path, capsys):
    """A custom archive through cli.run.main --evaluate: the report prints
    its frames and speed, and NaN for every error (no 3D ground truth),
    where JAX's evaluation stops at the missing targets."""
    import torch

    from diff3dhpe_torch.models import MixSTEDenoiser

    _write_custom(tmp_path)
    torch.save(MixSTEDenoiser(num_frame=9, embed_dim=32, depth=1, num_heads=4, seed=1,
                              device="cpu").state_dict(), tmp_path / "w.bin")
    errors = main(["--config", CONFIG, "--dataset", "custom", "--keypoints", "myvideo",
                   "--data-root", str(tmp_path), "-c", str(tmp_path / "out"),
                   "-str", "vid.mp4", "-ste", "vid.mp4", "-frame", "9", "-s", "9",
                   "--embed_dim", "32", "--transformer_depth", "1", "--num-heads", "4",
                   "--timesteps", "20", "--sampling_timesteps", "3", "--batch-size-eval", "16",
                   "--evaluate", str(tmp_path / "w.bin")], device="cpu")
    assert all(len(v) == 1 and np.isnan(v[0]) for v in errors.values())
    out = capsys.readouterr().out
    assert "----custom----" in out and "eval_frame: 40" in out
    assert "Protocol #1   (MPJPE) action-wise average: nanmm" in out
