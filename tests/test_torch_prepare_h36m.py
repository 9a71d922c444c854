"""The port's H3.6M preparation (``diff3dhpe_torch.data.prepare_h36m``)
against the JAX package's on the miniature archive of
tests/test_prepare_h36m.py: ``from_archive``, ``from_source_mat`` and
``generate_gt_2d`` give JAX's arrays, ``from_source_cdf`` imports cdflib
only when called, and the prepared files go through the port's CLI (train
an epoch, then ``--evaluate best_epoch``), as
tests/test_real_data_chain.py drives JAX's."""
import os
import zipfile

import numpy as np
import pytest
import scipy.io

from diff3dhpe_torch.cli.run import main as run_main
from diff3dhpe_torch.data import prepare_h36m
from diff3dhpe_tpu.data import prepare_h36m as jax_prepare_h36m
from test_prepare_h36m import ACTIONS
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

h5py = pytest.importorskip("h5py")


def _make_fake_archive(path, n_frames):
    """tests/test_prepare_h36m.py::_make_fake_archive's archive (the same
    draws and names), its h5 files written beside ``path``."""
    rng = np.random.default_rng(0)
    scratch = os.path.dirname(path)
    with zipfile.ZipFile(path, "w") as zf:
        for subject in prepare_h36m.SUBJECTS:
            for action in ACTIONS:
                for suffix in ("", " 1"):
                    h5_path = os.path.join(scratch, f"_fake_{subject}_{action}{suffix}.h5")
                    with h5py.File(h5_path, "w") as hf:
                        hf["3D_positions"] = rng.standard_normal(
                            (96, n_frames)).astype("float32") * 1000
                    zf.write(h5_path, f"h36m/{subject}/MyPoses/3D_positions/{action}{suffix}.h5")
                    os.remove(h5_path)


def _assert_positions_equal(got, expected):
    assert list(got) == list(expected)
    for s in expected:
        assert sorted(got[s]) == sorted(expected[s])
        for a in expected[s]:
            assert got[s][a].dtype == expected[s][a].dtype
            np.testing.assert_array_equal(got[s][a], expected[s][a], err_msg=(s, a))


def test_constants_match_jax():
    assert (prepare_h36m.SUBJECTS, prepare_h36m.OUTPUT_3D, prepare_h36m.OUTPUT_2D) == (
        jax_prepare_h36m.SUBJECTS, jax_prepare_h36m.OUTPUT_3D, jax_prepare_h36m.OUTPUT_2D)


def test_from_archive_and_gt_2d_match_jax(tmp_path):
    archive = str(tmp_path / "h36m.zip")
    _make_fake_archive(archive, n_frames=8)
    got = prepare_h36m.from_archive(archive, str(tmp_path))
    expected = jax_prepare_h36m.from_archive(archive, str(tmp_path))
    _assert_positions_equal(got, expected)
    assert "Directions" not in got["S11"] and "Photo" in got["S1"]
    assert got["S1"]["Walking"].shape == (8, 32, 3)
    assert not os.path.exists(tmp_path / "_h36m_tmp")

    out_3d = str(tmp_path / "data_3d_h36m.npz")
    np.savez_compressed(out_3d, positions_3d=got)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    prepare_h36m.generate_gt_2d(out_3d, str(tmp_path / "port"))
    jax_prepare_h36m.generate_gt_2d(out_3d, str(tmp_path / "jax"))
    port_kp = np.load(tmp_path / "port" / "data_2d_h36m_gt.npz", allow_pickle=True)
    jax_kp = np.load(tmp_path / "jax" / "data_2d_h36m_gt.npz", allow_pickle=True)
    assert port_kp["metadata"].item() == jax_kp["metadata"].item()
    assert port_kp["metadata"].item()["num_joints"] == 17
    p2d, j2d = port_kp["positions_2d"].item(), jax_kp["positions_2d"].item()
    assert list(p2d) == list(j2d)
    for s in j2d:
        assert list(p2d[s]) == list(j2d[s])
        for a in j2d[s]:
            assert len(p2d[s][a]) == len(j2d[s][a]) == 4
            for cam_got, cam_expected in zip(p2d[s][a], j2d[s][a]):
                np.testing.assert_array_equal(cam_got, cam_expected)


def test_from_source_mat_matches_jax(tmp_path):
    """The .cdf.mat layout (a 1x1 cell holding [T, 96] millimetres)."""
    rng = np.random.default_rng(1)
    for subject in prepare_h36m.SUBJECTS:
        d = tmp_path / subject / "MyPoseFeatures" / "D3_Positions"
        d.mkdir(parents=True)
        for action in ACTIONS:
            for suffix in ("", " 1"):
                cell = np.empty((1, 1), dtype=object)
                cell[0, 0] = rng.standard_normal((6, 96)) * 1000
                scipy.io.savemat(str(d / f"{action}{suffix}.cdf.mat"), {"data": cell})
    got = prepare_h36m.from_source_mat(str(tmp_path))
    expected = jax_prepare_h36m.from_source_mat(str(tmp_path))
    _assert_positions_equal(got, expected)
    assert got["S1"]["Walking"].shape == (6, 32, 3)


def test_from_source_cdf_imports_cdflib_when_called(tmp_path):
    """cdflib stays a lazy import, as in JAX: the module loads without it,
    and the call needs it (the card's machine has neither it nor h5py)."""
    try:
        import cdflib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="cdflib"):
            prepare_h36m.from_source_cdf(str(tmp_path))
    else:  # with cdflib, an empty tree fails the 30-file check, as JAX's does
        with pytest.raises(AssertionError, match="Expected 30 files"):
            prepare_h36m.from_source_cdf(str(tmp_path))


def test_prepared_files_through_the_port_cli(tmp_path, capsys):
    """Archive -> the port's prepare_h36m.main -> Human36mDataset in
    cli/run.py -> an epoch of training -> --evaluate best_epoch, on the
    CPU; a second prepare into the same directory refuses to overwrite."""
    archive = str(tmp_path / "h36m.zip")
    _make_fake_archive(archive, n_frames=20)
    data_dir = str(tmp_path / "data")
    prepare_h36m.main(["--from-archive", archive, "--out-dir", data_dir])
    assert sorted(os.listdir(data_dir)) == ["data_2d_h36m_gt.npz", "data_3d_h36m.npz"]
    with pytest.raises(SystemExit) as exc:
        prepare_h36m.main(["--from-archive", archive, "--out-dir", data_dir])
    assert exc.value.code == 1 and "refusing to overwrite" in capsys.readouterr().out

    args = [
        "--config", "configs/h36m_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json",
        "--data-root", data_dir, "-c", str(tmp_path / "ckpt"),
        "-str", "S1", "-ste", "S9", "-a", "Walking", "-frame", "9", "-s", "9",
        "--embed_dim", "32", "--transformer_depth", "1", "--num-heads", "4",
        "--timesteps", "20", "--sampling_timesteps", "2", "-e", "1", "-b", "8",
        "--batch-size-eval", "16",
    ]
    errors = run_main(args, device="cpu")  # no --synthetic: the prepared npz files
    assert errors["e1"] and np.isfinite(errors["e1"][0])
    assert (tmp_path / "ckpt" / "best_epoch").is_dir()
    again = run_main(args + ["--evaluate", "best_epoch"], device="cpu")
    assert again == errors
