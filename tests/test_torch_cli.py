"""The port's evaluate entry point end to end on the CPU:
``diff3dhpe_torch.cli.run.main([... --synthetic --evaluate x.bin ...])`` at
the shapes of tests/test_cli.py::test_run_h36m_evaluate_checkpoint, in the
four evaluate configurations, the report's lines, and the refusals."""
import json
import os

import numpy as np
import pytest
import torch

from diff3dhpe_torch.cli.run import main
from diff3dhpe_torch.config import load_config
from diff3dhpe_torch.data import PoseDataset, make_synthetic_h36m_like
from diff3dhpe_torch.engine.runner import Runner
from diff3dhpe_torch.models import MixSTEDenoiser
from torch_port_helpers import JOINTS_LEFT, JOINTS_RIGHT

CONFIG = "configs/h36m_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json"
ARGS_COMMON = [
    "--synthetic",
    "-frame", "9", "-s", "9",
    "--embed_dim", "32", "--transformer_depth", "1", "--num-heads", "4",
    "--timesteps", "20", "--sampling_timesteps", "3",
    "-e", "1", "-b", "8", "--batch-size-eval", "16",
    "-a", "Walking", "-str", "S1", "-ste", "S9",
]
MIXED = ["--fast-eval", "--compute-dtype", "bfloat16", "--eval-f32-final-steps", "1",
         "--eval-f32-head"]
REPORT_LINES = [
    "INFO: Receptive field: 9 frames", "INFO: Trainable parameter count:",
    "Params | FLOPs/forward", "Loaded checkpoint", "Evaluating...", "----Walking----",
    "eval_frame:", "inference_time:", "inference_speed:", "Protocol #1 Error (MPJPE):",
    "Protocol #2 Error (P-MPJPE):", "Protocol #3 Error (N-MPJPE):", "Velocity Error (MPJVE):",
    "Total eval_frame:", "Protocol #1   (MPJPE) action-wise average:",
    "Protocol #2 (P-MPJPE) action-wise average:", "Protocol #3 (N-MPJPE) action-wise average:",
    "Velocity      (MPJVE) action-wise average:",
]


def _write_checkpoint(path, wrapped=True):
    """A seed-3 state dict as the reference saves it: under
    ``model_diffusion``, with DataParallel's and the diffusion wrapper's
    prefixes, beside the wrapper's schedule buffers."""
    state = MixSTEDenoiser(num_frame=9, embed_dim=32, depth=1, num_heads=4, seed=3,
                           device="cpu").state_dict()
    if wrapped:
        state = {f"module.model.{k}": v for k, v in state.items()}
        state.update({"module.betas": torch.zeros(20), "module.alphas_cumprod": torch.ones(20),
                      "module.sqrt_one_minus_alphas_cumprod": torch.zeros(20)})
        state = {"model_diffusion": state, "epoch": 3}
    torch.save(state, path)


def _use_pallas_config(tmp_path):
    params = json.load(open(CONFIG))
    params["params"]["use_pallas_attention"] = True
    path = tmp_path / "use_pallas.json"
    path.write_text(json.dumps(params))
    return str(path)


@pytest.fixture(scope="module")
def default_errors(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("default")
    _write_checkpoint(tmp / "w.bin")
    return main(["--config", CONFIG, "-c", str(tmp), "--evaluate", "w.bin"] + ARGS_COMMON,
                device="cpu")


def test_main_evaluates_a_bin_checkpoint(tmp_path, capsys, default_errors):
    _write_checkpoint(tmp_path / "w.bin")
    argv = ["--config", CONFIG, "-c", str(tmp_path), "--evaluate", "w.bin"] + ARGS_COMMON
    errors = main(argv, device="cpu")
    out = capsys.readouterr().out
    for line in REPORT_LINES:
        assert line in out, line
    assert set(errors) == {"e1", "e2", "e3", "ev"}
    assert all(len(v) == 1 and np.isfinite(v[0]) and v[0] > 0 for v in errors.values())
    assert errors == default_errors  # the same seed draws the same x_T
    files = os.listdir(tmp_path)
    for prefix in ("config_", "log_", "results_"):
        assert any(f.startswith(prefix) for f in files), prefix
    results = open(os.path.join(tmp_path, next(f for f in files if f.startswith("results_")))).read()
    assert "----Walking----" in results and "action-wise average" in results

    # The report is that of the checkpoint's weights, not of the seeded init.
    cfg = load_config(CONFIG, dict(
        subjects_train="S1", subjects_test="S9", number_of_frames=9, stride=9, embed_dim=32,
        transformer_depth=1, num_heads=4, timesteps=20, sampling_timesteps=3, batch_size_eval=16))
    ds, kps = make_synthetic_h36m_like(subjects=("S1", "S9"), n_frames=100, seed=cfg.seed)
    action_ds = PoseDataset(cfg, ds, cfg.data_root, "test", action_filter=["Walking"],
                            keypoints_data=kps)
    runner = Runner(cfg, 17, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    seeded = runner.evaluate(action_ds)["e1"]
    runner.set_params(MixSTEDenoiser(num_frame=9, embed_dim=32, depth=1, num_heads=4, seed=3,
                                     device="cpu").state_dict())
    assert runner.evaluate(action_ds)["e1"] == errors["e1"][0] != seeded


def test_main_takes_a_bare_state_dict_by_path(tmp_path):
    _write_checkpoint(tmp_path / "bare.bin", wrapped=False)
    errors = main(["--config", CONFIG, "-c", str(tmp_path / "run"), "--evaluate",
                   str(tmp_path / "bare.bin")] + ARGS_COMMON, device="cpu")
    assert np.isfinite(errors["e1"][0])


@pytest.mark.parametrize("name,extra,tol_mm", [
    ("use_pallas_attention", [], 1e-3),
    ("fast_eval", ["--fast-eval"], 1e-3),
    ("mixed", MIXED, None),
])
def test_main_in_the_kernel_configurations(tmp_path, default_errors, name, extra, tol_mm):
    """The three configurations that run kernels on the card run their
    plain versions here: the f32 ones report the default run's errors to
    1e-3 mm, the mixed one's are finite and within 2% of them."""
    _write_checkpoint(tmp_path / "w.bin")
    config = _use_pallas_config(tmp_path) if name == "use_pallas_attention" else CONFIG
    errors = main(["--config", config, "-c", str(tmp_path), "--evaluate", "w.bin"]
                  + ARGS_COMMON + extra, device="cpu")
    for k, v in errors.items():
        assert np.isfinite(v[0])
        if tol_mm is None:
            assert abs(v[0] - default_errors[k][0]) <= 2e-2 * default_errors[k][0], k
        else:
            assert abs(v[0] - default_errors[k][0]) <= tol_mm, k


def test_main_without_evaluate_exits(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        main(["--config", CONFIG, "-c", str(tmp_path)] + ARGS_COMMON, device="cpu")
    assert exc.value.code not in (0, None)
    assert "Training through the CLI is not ported yet" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        main(["--config", CONFIG, "-c", str(tmp_path), "--evaluate", "w.bin", "--resume", "x"]
             + ARGS_COMMON, device="cpu")
    assert exc.value.code == 1


@pytest.mark.parametrize("field,extra", [
    ("mesh_shape", ["--mesh-shape", "data:8"]),
    ("eval_f32_tail_pairs", MIXED + ["--eval-f32-tail-pairs", "1"]),
    ("eval_final_prec", MIXED + ["--eval-final-prec", "default"]),
    ("compute_dtype", ["--compute-dtype", "bfloat16"]),
    ("remat", "json"),
    ("dataset", ["-d", "humaneva15"]),
    ("evaluate", ["--evaluate", "best_epoch"]),
])
def test_main_refuses_what_is_not_ported(tmp_path, field, extra):
    _write_checkpoint(tmp_path / "w.bin")
    config = CONFIG
    if extra == "json":
        params = json.load(open(CONFIG))
        params["params"]["remat"] = True
        config = str(tmp_path / "remat.json")
        open(config, "w").write(json.dumps(params))
        extra = []
    with pytest.raises(ValueError, match=f"^{field}="):
        main(["--config", config, "-c", str(tmp_path), "--evaluate", "w.bin"] + ARGS_COMMON
             + extra, device="cpu")


def test_main_runs_on_the_card_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
    _write_checkpoint(tmp_path / "w.bin")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--config", CONFIG, "-c", str(tmp_path), "--evaluate", "w.bin"] + ARGS_COMMON)
