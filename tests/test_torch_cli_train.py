"""The port's training entry point end to end on the CPU:
``diff3dhpe_torch.cli.run.main`` without ``--evaluate`` at the shapes of
tests/test_cli.py (the counterparts of its test_run_h36m_train_eval,
test_run_h36m_evaluate_checkpoint and test_resume_roundtrip), and what
``fit`` refuses, by field name."""
import json
import os
import shutil

import numpy as np
import pytest

from diff3dhpe_torch.cli.run import main
from diff3dhpe_tpu.io import checkpoint as jax_checkpoint
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

CONFIG = "configs/h36m_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json"
ARGS_COMMON = [
    "--synthetic",
    "-frame", "9", "-s", "9",
    "--embed_dim", "32", "--transformer_depth", "1", "--num-heads", "4",
    "--timesteps", "20", "--sampling_timesteps", "3",
    "-b", "8", "--batch-size-eval", "16",
    "-a", "Walking", "-str", "S1", "-ste", "S9",
]
TRAIN = ["--config", CONFIG, "--fast-train", "-e", "2", "--checkpoint-frequency", "1"] + ARGS_COMMON


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs through the CLI with fast_train, a checkpoint each epoch:
    (checkpoint dir, the final report's errors, stdout)."""
    path = str(tmp_path_factory.mktemp("train"))
    return path, main(TRAIN + ["-c", path], device="cpu")


def test_run_h36m_train_eval(trained, capsys):
    path, errors = trained
    assert set(errors) == {"e1", "e2", "e3", "ev"}
    assert all(len(v) == 1 and np.isfinite(v[0]) and v[0] > 0 for v in errors.values())
    files = os.listdir(path)
    for prefix in ("config_", "log_", "results_"):
        assert any(f.startswith(prefix) for f in files), prefix
    assert {"best_epoch", "epoch_0", "epoch_1"} <= set(files)
    log = "".join(open(os.path.join(path, f)).read() for f in files if f.startswith("log_"))
    for line in ("Epoch: 0, Time(mins):", "Train/_pose_loss:", "Valid/_mpjpe_mm:",
                 "Valid/_pose_loss:", "Epoch: 1,", "Saved checkpoint to", "save best checkpoint",
                 "Training finished! Total time:", "Loaded the best model from"):
        assert line in log, line
    meta = json.load(open(os.path.join(path, "best_epoch", "meta.json")))
    assert set(meta) == {"epoch", "best_epoch", "min_loss", "min_train_loss", "shuffle_rng_state"}


def test_run_h36m_evaluate_checkpoint(trained, capsys):
    """--evaluate best_epoch reloads the best checkpoint and reproduces the
    training run's final report (the same generator seed draws the same
    x_T)."""
    path, errors = trained
    again = main(["--config", CONFIG, "-c", path, "--evaluate", "best_epoch"] + ARGS_COMMON,
                 device="cpu")
    assert again == errors
    assert f"Loaded checkpoint {os.path.join(path, 'best_epoch')}" in capsys.readouterr().out


def test_resume_roundtrip(trained, tmp_path, capsys):
    """Resume from the periodic checkpoint epoch_0 (copied into a new
    directory) for the second epoch: the same epoch-1 line and the same
    final report as the unbroken run."""
    path, errors = trained
    copy = str(tmp_path / "copy")
    shutil.copytree(os.path.join(path, "epoch_0"), os.path.join(copy, "epoch_0"))
    capsys.readouterr()
    resumed = main(TRAIN + ["-c", copy, "--resume", "epoch_0"], device="cpu")
    out = capsys.readouterr().out
    assert f"Resumed from {os.path.join(copy, 'epoch_0')} at epoch 1" in out
    line = lambda text: next(l for l in text.splitlines() if l.startswith("Epoch: 1,")).split(
        ", Train/")[1]
    logs = "".join(open(os.path.join(path, f)).read() for f in os.listdir(path)
                   if f.startswith("log_"))  # the training run's, and any later run's
    assert line(out) == line(logs)
    assert resumed == errors


def test_pretrained_model_loads_a_port_checkpoint(trained, tmp_path, capsys):
    path, _ = trained
    errors = main(["--config", CONFIG, "-c", str(tmp_path), "-e", "1", "--pretrained_model",
                   os.path.join(path, "best_epoch")] + ARGS_COMMON, device="cpu")
    assert np.isfinite(errors["e1"][0])
    assert "parameters, 0 discarded" in capsys.readouterr().out


def _config_with(tmp_path, **fields):
    params = json.load(open(CONFIG))
    params["params"].update(fields)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(params))
    return str(path)


@pytest.mark.parametrize("field,fields,extra", [
    ("use_pallas_attention", dict(use_pallas_attention=True), []),
    ("mesh_shape", dict(mesh_shape="data:2"), []),
    ("eval_f32_tail_pairs", dict(eval_f32_tail_pairs=1), ["--fast-eval"]),
])
def test_fit_refuses_what_is_not_ported(tmp_path, field, fields, extra):
    with pytest.raises(ValueError, match=f"^{field}="):
        main(["--config", _config_with(tmp_path, **fields), "-c", str(tmp_path), "-e", "1"]
             + ARGS_COMMON + extra, device="cpu")


@pytest.mark.parametrize("fields,extra", [
    (dict(remat=True), []),                                           # the module, per block
    (dict(remat=True, remat_mode="whole"), []),
    ({}, ["--fast-train", "--compute-dtype", "bfloat16"]),            # bf16 fast_train
    (dict(remat=True), ["--compute-dtype", "bfloat16"]),              # the bf16 module
    (dict(fast_train_pair_vjp=False), ["--fast-train"]),              # the monolithic backward
    (dict(fast_train_pair_vjp=False, use_pallas_attention=True), ["--fast-train", "--fast-eval",
                                                                  "--compute-dtype", "bfloat16"]),
])
def test_fit_trains_what_was_refused_before(tmp_path, fields, extra):
    """bfloat16 training, ``remat`` in both modes and the monolithic
    backward train through the CLI: one epoch, finite losses, a report."""
    errors = main(["--config", _config_with(tmp_path, **fields), "-c", str(tmp_path), "-e", "1"]
                  + ARGS_COMMON + extra, device="cpu")
    assert all(np.isfinite(v[0]) for v in errors.values())
    log = "".join(open(os.path.join(tmp_path, f)).read() for f in os.listdir(tmp_path)
                  if f.startswith("log_"))
    assert "Epoch: 0, Time(mins):" in log and "Train/_pose_loss: nan" not in log


def test_evaluate_refuses_a_jax_orbax_directory(tmp_path):
    """A checkpoint directory the JAX package wrote (orbax state + meta)
    holds no port checkpoint: --evaluate names itself and the fields that
    take a port checkpoint."""
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax_ckpt"), {"w": np.zeros(3, np.float32)},
                                   {"epoch": 0})
    with pytest.raises(ValueError, match="^evaluate=.*evaluate, resume and pretrained_model"):
        main(["--config", CONFIG, "-c", str(tmp_path), "--evaluate", "jax_ckpt"] + ARGS_COMMON,
             device="cpu")


@pytest.mark.parametrize("fields,refused", [
    (dict(num_heads=16), "num_heads"),        # head_dim 32: the fast-train kernels take 64, 128
    (dict(embed_dim=4096, num_heads=32), "embed_dim"),  # wider than the f32 LayerNorm kernel
    (dict(num_heads=4), None),                # head_dim 128
])
def test_check_trainable_on_a_cuda_device(fields, refused):
    """What ``fit`` refuses by the card's kernels with ``fast_train``,
    decided from the device's type (no card needed); the CPU runs every
    width."""
    from diff3dhpe_torch.config import Config
    from diff3dhpe_torch.engine.runner import check_trainable

    cfg = Config(fast_train=True, **fields)
    check_trainable(cfg, "cpu")
    check_trainable(cfg.replace(fast_train=False), "cuda")
    if refused is None:
        check_trainable(cfg, "cuda")
    else:
        with pytest.raises(ValueError, match=f"^{refused}="):
            check_trainable(cfg, "cuda")
