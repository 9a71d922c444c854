"""The port's MPI-INF-3DHP path against the JAX package's on the CPU: the
archive loader (``Base3DHPSplit``, ``MPIINF3DHPDataset``) on miniature
archives in both schemas, ``PoseDataset3DHP`` batches with the valid-frame
mask, ``make_synthetic_3dhp``, the per-sequence evaluation of
``cli/run_3dhp.py`` on the same weights and x_T (errors, PCK, AUC and the
``inference_data.mat`` arrays), and ``run_3dhp.main`` itself."""
import jax
import numpy as np
import pytest
import scipy.io
import torch

from diff3dhpe_torch.cli import run_3dhp
from diff3dhpe_torch.config import Config
from diff3dhpe_torch.data import MPIINF3DHPDataset, PoseDataset3DHP
from diff3dhpe_torch.data import mpiinf3dhp
from diff3dhpe_torch.data.synthetic import make_synthetic_3dhp
from diff3dhpe_torch.engine.runner import Runner
from diff3dhpe_tpu.cli import run_3dhp as jax_run_3dhp
from diff3dhpe_tpu.config import Config as JaxConfig
from diff3dhpe_tpu.data import MPIINF3DHPDataset as JaxMPIINF3DHPDataset
from diff3dhpe_tpu.data import mpiinf3dhp as jax_mpiinf3dhp
from diff3dhpe_tpu.data.dataset import PoseDataset3DHP as JaxPoseDataset3DHP
from diff3dhpe_tpu.data.synthetic import make_synthetic_3dhp as jax_make_synthetic_3dhp
from diff3dhpe_tpu.engine.runner import Runner as JaxRunner
from diff3dhpe_tpu.metrics import auc as jax_auc
from diff3dhpe_tpu.metrics import pck as jax_pck
from torch_port_helpers import jax_x_init, perturb
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

CONFIG = "configs/3dhp_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json"
ARGS_COMMON = [
    "--synthetic", "-frame", "9", "-s", "9", "--embed_dim", "32", "--transformer_depth", "1",
    "--timesteps", "20", "--sampling_timesteps", "3", "-e", "1", "-b", "8",
    "--batch-size-eval", "16",
]


def _write_archives(root):
    """data_train_3dhp.npz (two subjects, two cameras each) and
    data_test_3dhp.npz (TS1, TS2 at 2048x2048, TS5 at 1920x1080) in the
    P-STMO layouts, 2D in float64 as the loader normalises at source dtype."""
    rng = np.random.default_rng(0)

    def anim(n):
        return dict(data_3d=rng.normal(0.0, 300.0, (n, 17, 3)),
                    data_2d=rng.uniform(0.0, 2048.0, (n, 17, 2)))

    train = {f"{s} Seq{q}": [{cam: anim(30 + 3 * cam) for cam in (0, 8)}]
             for s in ("S1", "S2") for q in (1, 2)}
    test = {ts: dict(anim(40), valid=(rng.uniform(size=40) > 0.2).astype(np.float64))
            for ts in ("TS1", "TS2", "TS5")}
    np.savez(root / "data_train_3dhp.npz", data=train)
    np.savez(root / "data_test_3dhp.npz", data=test)


def _assert_split_equal(got, expected):
    assert list(got.poses_3d) == list(expected.poses_3d)
    assert list(got.poses_2d) == list(expected.poses_2d)
    for k in expected.poses_3d:
        np.testing.assert_array_equal(got.poses_3d[k], expected.poses_3d[k])
        np.testing.assert_array_equal(got.poses_2d[k], expected.poses_2d[k])
        assert got.poses_3d[k].dtype == expected.poses_3d[k].dtype
        assert got.poses_2d[k].dtype == expected.poses_2d[k].dtype
    if expected.valid_frame is None:
        assert got.valid_frame is None
    else:
        assert list(got.valid_frame) == list(expected.valid_frame)
        for k, v in expected.valid_frame.items():
            np.testing.assert_array_equal(got.valid_frame[k], v)
    assert (got.pos_3d_min, got.pos_3d_max) == (expected.pos_3d_min, expected.pos_3d_max)
    assert (got.kps_left, got.kps_right, got.joints_left, got.joints_right, got.num_joints) == (
        expected.kps_left, expected.kps_right, expected.joints_left, expected.joints_right,
        expected.num_joints)


@pytest.mark.parametrize("schema", ["train", "test"])
def test_split_matches_jax(tmp_path, schema):
    """Each archive schema: the selected subjects' root-centred 3D and
    screen-normalised 2D, the valid-frame vectors, and the extrema over every
    sequence, the unselected ones included."""
    _write_archives(tmp_path)
    train = schema == "train"
    path = str(tmp_path / f"data_{schema}_3dhp.npz")
    subjects = ["S1"] if train else ["TS1", "TS5"]
    got = mpiinf3dhp.Base3DHPSplit(path, subjects, train=train)
    expected = jax_mpiinf3dhp.Base3DHPSplit(path, subjects, train=train)
    _assert_split_equal(got, expected)
    assert len(got.poses_3d) == (4 if train else 2)
    # The extrema cover the unselected sequences too.
    everything = mpiinf3dhp.Base3DHPSplit(path, ["S1", "S2"] if train else ["TS1", "TS2", "TS5"],
                                          train=train)
    assert (got.pos_3d_min, got.pos_3d_max) == (everything.pos_3d_min, everything.pos_3d_max)


def test_dataset_matches_jax(tmp_path):
    _write_archives(tmp_path)
    got = MPIINF3DHPDataset("S1,S2", "TS1,TS2", root_path=str(tmp_path))
    expected = JaxMPIINF3DHPDataset("S1,S2", "TS1,TS2", root_path=str(tmp_path))
    _assert_split_equal(got._train, expected._train)
    _assert_split_equal(got._test, expected._test)
    assert (got._pos_3d_min, got._pos_3d_max) == (expected._pos_3d_min, expected._pos_3d_max)
    for name in ("KPS_LEFT", "KPS_RIGHT", "JOINTS_LEFT", "JOINTS_RIGHT", "NUM_JOINTS",
                 "ROOT_JOINT", "_TRAIN_RES", "_TEST_RES"):
        assert getattr(mpiinf3dhp, name) == getattr(jax_mpiinf3dhp, name), name


def _synthetic(n_frames=60):
    return (make_synthetic_3dhp(["S1"], ["TS1", "TS2"], n_frames=n_frames, seed=0),
            jax_make_synthetic_3dhp(["S1"], ["TS1", "TS2"], n_frames=n_frames, seed=0))


def test_make_synthetic_3dhp_matches_jax():
    got, expected = _synthetic()
    for split in ("_train", "_test"):
        _assert_split_equal(getattr(got, split), getattr(expected, split))
    assert (got._pos_3d_min, got._pos_3d_max) == (expected._pos_3d_min, expected._pos_3d_max)


CFG = dict(stride=9, number_of_frames=9, subjects_train="S1", subjects_test="TS1,TS2",
           dataset="3dhp", embed_dim=32, transformer_depth=1, num_heads=4, timesteps=20,
           sampling_timesteps=3, batch_size_eval=4)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_pose_dataset_3dhp_batches_match_jax(split):
    """Every batch array for array, the test split's valid-frame mask
    included; on the test split every valid frame is evaluated once (as
    tests/test_datasets.py:83 holds JAX's)."""
    got_data, jax_data = _synthetic()
    cfg, jcfg = Config(**CFG), JaxConfig(**CFG)
    got = PoseDataset3DHP(cfg, got_data._test if split == "test" else got_data._train,
                          got_data._pos_3d_min, got_data._pos_3d_max, split=split)
    expected = JaxPoseDataset3DHP(jcfg, jax_data._test if split == "test" else jax_data._train,
                                  jax_data._pos_3d_min, jax_data._pos_3d_max, split=split)
    assert (got.scale, len(got), got.joints_left, got.joints_right) == (
        expected.scale, len(expected), expected.joints_left, expected.joints_right)
    n = 0
    for b, e in zip(got.batches(5), expected.batches(5), strict=True):
        n += 1
        for field in ("gt_3d", "gt_3d_norm", "input_2d", "input_2d_flip", "target_mask",
                      "row_mask"):
            a, x = getattr(b, field), getattr(e, field)
            if x is None:
                assert a is None, field
            else:
                np.testing.assert_array_equal(a, x, err_msg=field)
        assert b.keys == e.keys
    assert n == -(-len(expected) // 5)
    if split == "test":
        masked = sum((b.target_mask & b.row_mask[:, None]).sum() for b in got.batches(16))
        assert masked == sum(v.sum() for v in got_data._test.valid_frame.values())
        one = PoseDataset3DHP(cfg, got_data._test, got_data._pos_3d_min, got_data._pos_3d_max,
                              split="test", seq_filter="TS2")
        assert {b.keys[0] for b in one.batches(4)} == {"TS2"}


@pytest.fixture(scope="module")
def jax_sequence_eval():
    """JAX's per-sequence evaluation of cli/run_3dhp.py (its Runner.evaluate
    with the default key, unit_scale 1.0) at embed 32, depth 1, 9 frames, on
    perturbed seed-0 weights: (params, {sequence: (metrics, masked gt,
    the batches' subkeys)})."""
    _, data = _synthetic()
    jcfg = JaxConfig(**CFG, matmul_precision="highest", mesh_shape="data:1")
    runner = JaxRunner(jcfg, 17, jax_mpiinf3dhp.JOINTS_LEFT, jax_mpiinf3dhp.JOINTS_RIGHT)
    x = np.zeros((1, 9, 17, 5), np.float32)
    params = jax.jit(runner.model.init)(jax.random.PRNGKey(0), x, np.zeros(1, np.float32))
    params = perturb(jax.tree.map(np.asarray, params["params"]), np.random.default_rng(3))
    runner.set_params(params)
    out = {}
    for seq in ("TS1", "TS2"):
        ds = JaxPoseDataset3DHP(jcfg, data._test, data._pos_3d_min, data._pos_3d_max,
                                split="test", seq_filter=seq)
        m = runner.evaluate(ds, action=seq, unit_scale=1.0)
        key, subkeys = jax.random.PRNGKey(jcfg.seed), []
        for _ in ds.batches(jcfg.batch_size_eval):
            key, sub = jax.random.split(key)
            subkeys.append(sub)
        out[seq] = (m, jax_run_3dhp._masked_gt(ds), subkeys)
    return params, out


def test_sequence_evaluation_matches_jax(jax_sequence_eval):
    """The port's per-sequence evaluation on JAX's weights and JAX's own x_T
    draws: every error within 1e-4 mm (and two float32 steps); PCK, AUC and the .mat arrays that the
    port builds from JAX's predictions equal JAX's (to float64 rounding), and
    those from its own predictions equal them too."""
    params, expected = jax_sequence_eval
    got_data, _ = _synthetic()
    cfg = Config(**CFG)
    runner = Runner(cfg, 17, mpiinf3dhp.JOINTS_LEFT, mpiinf3dhp.JOINTS_RIGHT, device="cpu")
    runner.set_params(params)
    rows = 2 * cfg.batch_size_eval
    per_seq, errors, speeds = run_3dhp.sequence_inference(
        runner, cfg, got_data,
        x_init=lambda seq, i: jax_x_init(expected[seq][2][i], rows, (9, 17, 3)))
    assert list(per_seq) == ["TS1", "TS2"] and len(speeds) == 2
    for i, seq in enumerate(per_seq):
        m, gt, subkeys = expected[seq]
        assert len(subkeys) == 2  # a full batch and a short one
        for k in ("e1", "e2", "e3", "ev"):
            assert np.isfinite(errors[k][i])
            # The errors are float32 means near 1,000 mm, where one float32
            # step is 1.2e-4 mm: 1e-4 mm plus two steps of the value.
            bar = 1e-4 + 2 * float(np.spacing(np.float32(m[k])))
            np.testing.assert_allclose(errors[k][i], m[k], rtol=0, atol=bar, err_msg=(seq, k))
        pred, got_gt = per_seq[seq]
        np.testing.assert_array_equal(got_gt, gt)
        np.testing.assert_allclose(pred, m["predictions"], rtol=0, atol=1e-3)
    jax_pred = np.concatenate([expected[s][0]["predictions"] for s in per_seq])
    jax_gt = np.concatenate([expected[s][1] for s in per_seq])
    jax_values = (float(jax_pck(jax_pred, jax_gt, threshold=150.0)),
                  float(jax_auc(jax_pred, jax_gt)))
    # Equal counts; the AUC's mean over 31 thresholds sums in another order
    # than numpy's, so equal to float64 rounding.
    assert run_3dhp.pck_auc(jax_pred, jax_gt) == pytest.approx(jax_values, rel=1e-12, abs=0)
    own = np.concatenate([p for p, _ in per_seq.values()])
    own_gt = np.concatenate([g for _, g in per_seq.values()])
    assert run_3dhp.pck_auc(own, own_gt) == pytest.approx(jax_values, rel=1e-12, abs=0)
    for seq, (pred, _) in per_seq.items():  # MATLAB layout [3, 17, N], as JAX writes it
        assert pred.transpose(2, 1, 0).shape == expected[seq][0]["predictions"].T.shape


def test_main_on_the_cpu(tmp_path):
    """tests/test_cli.py::test_run_3dhp's checks on the port: trains an
    epoch, then the report, PCK and AUC in [0, 100], native-mm errors and the
    [3, 17, N] .mat per sequence; then --evaluate best_epoch on the same
    checkpoint directory gives the same errors."""
    args = ["--config", CONFIG, "-c", str(tmp_path), "-str", "S1", "-ste", "TS1,TS2",
            "--with_time_emb", "False"] + ARGS_COMMON
    out = run_3dhp.main(args, device="cpu")
    assert 0.0 <= out["pck"] <= 100.0
    assert 0.0 <= out["auc"] <= 100.0
    for k, vals in out["errors"].items():
        assert len(vals) == 2 and all(0.0 < v < 5e4 for v in vals), (k, vals)
    mat = scipy.io.loadmat(str(tmp_path / "inference_data.mat"))
    n = {seq: mat[seq].shape[2] for seq in ("TS1", "TS2")}
    assert all(mat[seq].shape[:2] == (3, 17) and n[seq] > 0 for seq in n)
    assert (tmp_path / "best_epoch").is_dir()
    again = run_3dhp.main(args + ["--evaluate", "best_epoch"], device="cpu")
    assert again["errors"] == out["errors"]
    assert (again["pck"], again["auc"]) == (out["pck"], out["auc"])


def test_main_runs_on_the_card_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_3dhp.main(["--config", CONFIG, "-c", str(tmp_path), "-str", "S1", "-ste", "TS1"]
                      + ARGS_COMMON)

