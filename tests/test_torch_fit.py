"""``Runner.fit`` of the port against the JAX package's on the CPU (the
port's kernels through their plain versions, Pallas in interpret mode), on
the same synthetic dataset and weights. torch cannot draw JAX's bits, so
JAX's draws are replayed from its own key splits (engine/runner.py:272-276,
engine/steps.py:298, diffusion/gaussian_diffusion.py:147 and
models/fast_eval.py:679; x_T as ``torch_port_helpers.jax_x_init``) and
injected into the port through ``fit``'s ``draws``. Also: resume, the stop
rules, the loss curve, the rng JSON, ``load_matching_params`` and a port
checkpoint read by JAX."""
import functools
import json
import os
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from diff3dhpe_torch.config import Config
from diff3dhpe_torch.data import PoseDataset, make_synthetic_h36m_like
from diff3dhpe_torch.engine import runner as port_runner
from diff3dhpe_torch.engine.runner import Runner, RunLogger
from diff3dhpe_torch.io import (
    load_matching_params, restore_checkpoint, rng_state_from_json, rng_state_to_json,
)
from diff3dhpe_torch.io.checkpoint import STATE_FILE
from diff3dhpe_torch.models import MixSTEDenoiser
from diff3dhpe_tpu.config import Config as JaxConfig
from diff3dhpe_tpu.data import PoseDataset as JaxPoseDataset
from diff3dhpe_tpu.data import make_synthetic_h36m_like as jax_make_synthetic
from diff3dhpe_tpu.engine import runner as jax_runner_module
from diff3dhpe_tpu.engine import steps as jax_steps
from diff3dhpe_tpu.engine.runner import Runner as JaxRunner
from diff3dhpe_tpu.engine.steps import make_fast_train_denoise_fn as jax_make_fast_train_denoise_fn
from diff3dhpe_tpu.io import checkpoint as jax_checkpoint
from diff3dhpe_tpu.io.torch_convert import convert_torch_state_dict
from diff3dhpe_tpu.io.torch_convert import load_matching_params as jax_load_matching_params
from diff3dhpe_tpu.models.fast_eval import draw_drop_path_scales as jax_draw_drop_path_scales
from torch_port_helpers import JOINTS_LEFT, JOINTS_RIGHT, jax_x_init, perturb
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

J = 17
# 96 train windows (S1 Walking, 4 cameras, flip augmentation): 6 steps of 16
# an epoch; 48 val windows: 3 batches of 16. lr 1e-3 with decay 0.5 so the
# schedule shows in the curve.
BASE = dict(subjects_train="S1", subjects_test="S9", number_of_frames=9, stride=9, embed_dim=32,
            transformer_depth=1, num_heads=4, timesteps=50, sampling_timesteps=3, batch_size=16,
            batch_size_eval=16, actions="Walking", mesh_shape="data:1", seed=5, epochs=2,
            learning_rate=1e-3, lr_decay=0.5)
FAST = dict(fast_train=True, fast_train_attn_bwd=True, drop_path_rate=0.1)
PLAIN = dict(drop_path_rate=0.0, epochs=1)
EVAL_RTOL, EVAL_ATOL_MM = 1e-4, 1e-3  # the evaluate bar (tests/test_torch_runner.py)


def _datasets(cfg, jax_cfg):
    data_kw = dict(subjects=("S1", "S9"), n_frames=100, seed=1)
    ds, kps = make_synthetic_h36m_like(**data_kw)
    jds, jkps = jax_make_synthetic(**data_kw)
    port = {split: PoseDataset(cfg, ds, "data", split, keypoints_data=kps)
            for split in ("train", "val", "test")}
    jax_ds = {split: JaxPoseDataset(jax_cfg, jds, "data", split, keypoints_data=jkps)
              for split in ("train", "val", "test")}
    return port, jax_ds


def _params():
    """The flax tree of seed-0 weights of the port's init (converted by the
    JAX package, which needs no compile), perturbed."""
    model = MixSTEDenoiser(num_frame=9, embed_dim=32, depth=1, num_heads=4, device="cpu")
    return perturb(convert_torch_state_dict(model.state_dict(), depth=1),
                   np.random.default_rng(2))


def _state_on_mesh(mesh):
    """JAX's ``build_train_state`` with the whole state placed on the
    runner's mesh, the placement its train step returns. Without it JAX's
    ``fit`` traces and compiles its train step twice (``step`` and the
    optimizer's ``count`` start off the mesh); the values are the same."""
    def build(params, optimizer):
        return jax.device_put(jax_steps.build_train_state(params, optimizer),
                              NamedSharding(mesh, PartitionSpec()))
    return build


def _t_noise(key, rows, f, t_max):
    """p_losses's t and noise (diffusion/gaussian_diffusion.py:147-150)."""
    key_t, key_noise = jax.random.split(key)
    return (jax.random.randint(key_t, (rows,), 0, t_max),
            jax.random.normal(key_noise, (rows, f, J, 3), jnp.float32))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _train_draw(key, b, f, t_max, depth, rate):
    """One train step's draws (engine/runner.py:272-276, engine/steps.py:298,
    models/fast_eval.py:679); jitted: the same bits as JAX's eager calls,
    compiled once for the file."""
    key, sub = jax.random.split(key)
    diff_key, dropout_key = jax.random.split(sub)
    dp = jax_draw_drop_path_scales(dropout_key, b, depth, rate, num_frame=f, num_joints=J)
    return key, dict(zip(("t", "noise"), _t_noise(diff_key, b, f, t_max)), dp_scales=dp)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _val_draw(key, b_eval, f, t_max):
    """One validation batch's draws (engine/runner.py:369,
    engine/steps.py:458), x_T as ``jax_x_init`` draws it."""
    key, sub = jax.random.split(key)
    key_pred, key_l1, key_l2 = jax.random.split(sub, 3)
    key_init, _ = jax.random.split(key_pred)
    x_init = jax.vmap(lambda i: jax.random.normal(
        jax.random.fold_in(key_init, i), (f, J, 3), jnp.float32))(jnp.arange(2 * b_eval))
    return key, dict(x_init=x_init, losses=(_t_noise(key_l1, b_eval, f, t_max),
                                            _t_noise(key_l2, b_eval, f, t_max)))


def _jax_draws(cfg, n_train, n_val):
    """JAX's draws of an unbroken ``fit`` from PRNGKey(seed), keyed as
    the port's ``draws`` asks for them."""
    f, t_max, depth = cfg.number_of_frames, cfg.timesteps, cfg.transformer_depth
    # At depth 1 the one block pair's rate is linspace(0, rate, 1)[0] = 0
    # whatever the config's rate, so every rate draws the same bits: pass 0
    # and compile the draw once for the fits of both files.
    rate = cfg.drop_path_rate if depth > 1 else 0.0
    out = {}
    key = jax.random.PRNGKey(cfg.seed)
    for epoch in range(cfg.epochs):
        for i in range(n_train):
            key, out["train", epoch, i] = _train_draw(key, cfg.batch_size, f, t_max, depth, rate)
        val_key = key
        for i in range(n_val):
            val_key, out["val", epoch, i] = _val_draw(val_key, cfg.batch_size_eval, f, t_max)
    out = jax.tree.map(np.asarray, out)
    return lambda kind, epoch, i: out[kind, epoch, i]


@pytest.fixture(scope="module")
def jax_runner():
    """One JAX runner for the fits of this file, built on the plain config:
    its val and eval steps are jitted in its constructor, so each later fit
    reuses their compile. ``_fit_pair`` sets its config, logger and train
    denoiser for each fit."""
    return JaxRunner(JaxConfig(**{**BASE, **PLAIN}), J, JOINTS_LEFT, JOINTS_RIGHT)


def _fit_pair(tmp, overrides, jax_runner):
    """JAX's fit and the port's, with JAX's draws replayed, from the same
    weights. With ``fast_train`` the JAX runner trains through the denoiser
    its constructor builds for that config (engine/runner.py:166-181).
    Returns (port runner, port result, JAX result, port datasets, JAX
    datasets, JAX checkpoint dir, port checkpoint dir)."""
    kw = {**BASE, **overrides}
    port_dir, jax_dir = os.path.join(tmp, "port"), os.path.join(tmp, "jax")
    cfg, jax_cfg = Config(**kw, checkpoint=port_dir), JaxConfig(**kw, checkpoint=jax_dir)
    port_ds, jax_ds = _datasets(cfg, jax_cfg)
    jax_runner.cfg, jax_runner.logger = jax_cfg, jax_runner_module.RunLogger(jax_dir)
    jax_runner.train_diffusion = jax_runner.diffusion
    if cfg.fast_train:
        jax_runner.train_diffusion = jax_runner_module.dataclasses_replace_denoise(
            jax_runner.diffusion, jax_make_fast_train_denoise_fn(
                num_frame=cfg.number_of_frames, num_joints=J, depth=cfg.transformer_depth,
                num_heads=cfg.num_heads, dtype=jnp.float32, drop_path_rate=cfg.drop_path_rate,
                attn_bwd=cfg.fast_train_attn_bwd))
    params = _params()
    jax_runner.set_params(params)
    with mock.patch.object(jax_runner_module, "build_train_state",
                           _state_on_mesh(jax_runner.mesh)):
        expected = jax_runner.fit(jax_ds["train"], jax_ds["val"])

    runner = Runner(cfg, J, JOINTS_LEFT, JOINTS_RIGHT, logger=RunLogger(port_dir), device="cpu")
    runner.set_params(params)
    n_val = -(-len(port_ds["val"]) // cfg.batch_size_eval)
    draws = _jax_draws(cfg, len(port_ds["train"]) // cfg.batch_size, n_val)
    out = runner.fit(port_ds["train"], port_ds["val"], draws=draws)
    return runner, out, expected, port_ds, jax_ds, jax_dir, port_dir


@pytest.fixture(scope="module")
def fast_fit(tmp_path_factory, jax_runner):
    return _fit_pair(str(tmp_path_factory.mktemp("fast")), FAST, jax_runner)


def _meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def _logged_val_losses(checkpoint_dir):
    """The Valid/_pose_loss values of the run's log file."""
    name = next(f for f in os.listdir(checkpoint_dir) if f.startswith("log_"))
    with open(os.path.join(checkpoint_dir, name)) as f:
        return [float(v) for v in re.findall(r"Valid/_pose_loss: (\S+)", f.read())]


@pytest.mark.parametrize("case", ["fast_train", "plain"])
def test_fit_matches_jax(request, tmp_path, case):
    """The loss curve to 1e-5 relative per epoch, the validation MPJPE to
    the evaluate bar and the logged validation loss to its relative part
    (printed with 8 decimals), the best epoch and the best checkpoint's
    meta.json (min_loss to the bar, the shuffle state exactly): two
    epochs of the fast-train path (attn_bwd, drop-path 0.1), and one of
    the plain module at drop-path 0."""
    if case == "fast_train":
        _, out, expected, _, _, jax_dir, port_dir = request.getfixturevalue("fast_fit")
    else:
        _, out, expected, _, _, jax_dir, port_dir = _fit_pair(
            str(tmp_path), PLAIN, request.getfixturevalue("jax_runner"))
    n_epochs = 2 if case == "fast_train" else 1
    assert len(out["losses_train"]) == len(expected["losses_train"]) == n_epochs
    np.testing.assert_allclose(out["losses_train"], expected["losses_train"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(np.asarray(out["losses_valid"]) * 1000,
                               np.asarray(expected["losses_valid"]) * 1000,
                               rtol=EVAL_RTOL, atol=EVAL_ATOL_MM)
    np.testing.assert_allclose(_logged_val_losses(port_dir), _logged_val_losses(jax_dir),
                               rtol=EVAL_RTOL)
    assert out["best_epoch"] == expected["best_epoch"]
    np.testing.assert_allclose(out["min_loss"], expected["min_loss"], rtol=EVAL_RTOL,
                               atol=EVAL_ATOL_MM)
    assert out["best_path"] == os.path.join(port_dir, "best_epoch")
    meta, jax_meta = _meta(out["best_path"]), _meta(expected["best_path"])
    assert set(meta) == set(jax_meta)
    assert meta["epoch"] == jax_meta["epoch"] and meta["best_epoch"] == jax_meta["best_epoch"]
    np.testing.assert_allclose(meta["min_loss"], jax_meta["min_loss"], rtol=EVAL_RTOL,
                               atol=EVAL_ATOL_MM)
    np.testing.assert_allclose(meta["min_train_loss"], jax_meta["min_train_loss"], rtol=1e-5)
    assert meta["shuffle_rng_state"] == jax_meta["shuffle_rng_state"]


def test_port_checkpoint_evaluates_in_jax(fast_fit, jax_runner):
    """The best checkpoint the port wrote, loaded into JAX through
    ``load_torch_model_params``, evaluates to the port's numbers (the
    evaluate bar) with the same x_T."""
    runner, out, _, port_ds, jax_ds, _, _ = fast_fit
    cfg = runner.cfg
    params = jax_checkpoint.load_torch_model_params(
        os.path.join(out["best_path"], STATE_FILE), depth=cfg.transformer_depth)
    jax_runner.set_params(params)
    runner.set_params(restore_checkpoint(out["best_path"])[0]["model_diffusion"])
    key = jax.random.PRNGKey(11)
    expected = jax_runner.evaluate(jax_ds["test"], key=key)
    subkeys = []
    for _ in port_ds["test"].batches(cfg.batch_size_eval):
        key, sub = jax.random.split(key)
        subkeys.append(sub)
    got = runner.evaluate(port_ds["test"], x_init=lambda i: jax_x_init(
        subkeys[i], 2 * cfg.batch_size_eval, (cfg.number_of_frames, J, 3)))
    assert got["n_frames"] == expected["n_frames"] > 0
    for k in ("e1", "e2", "e3", "ev"):
        np.testing.assert_allclose(got[k], expected[k], rtol=EVAL_RTOL, atol=EVAL_ATOL_MM,
                                   err_msg=k)


def _port_runner(tmp, **overrides):
    cfg = Config(**{**BASE, **FAST, **overrides}, checkpoint=str(tmp))
    ds, kps = make_synthetic_h36m_like(subjects=("S1", "S9"), n_frames=100, seed=1)
    runner = Runner(cfg, J, JOINTS_LEFT, JOINTS_RIGHT, logger=RunLogger(str(tmp)), device="cpu")
    return runner, PoseDataset(cfg, ds, "data", "train", keypoints_data=kps), PoseDataset(
        cfg, ds, "data", "val", keypoints_data=kps)


def test_resume_equals_the_unbroken_run(tmp_path, monkeypatch):
    """Two epochs, then a fresh runner resumed from ``epoch_0`` for the
    second: its epoch-1 loss, parameters, AdamW moments and scheduler step
    equal the unbroken run's bit for bit, and its first step runs at the
    unbroken run's learning rate for epoch 1 (the generator is reseeded
    with seed + epoch, so no draw is injected)."""
    lrs = {}
    make_train_step = port_runner.make_train_step

    def recording(diffusion, optimizer, scheduler, **kwargs):
        step = make_train_step(diffusion, optimizer, scheduler, **kwargs)

        def train_step(*args, **kwargs):
            lrs.setdefault(id(optimizer), []).append(optimizer.param_groups[0]["lr"])
            return step(*args, **kwargs)

        return train_step

    monkeypatch.setattr(port_runner, "make_train_step", recording)
    unbroken, train_ds, val_ds = _port_runner(tmp_path / "a", checkpoint_frequency=1)
    out = unbroken.fit(train_ds, val_ds)
    resumed, train_ds2, val_ds2 = _port_runner(tmp_path / "b", checkpoint_frequency=1)
    out2 = resumed.fit(train_ds2, val_ds2, resume=str(tmp_path / "a" / "epoch_0"))

    assert out2["losses_train"] == out["losses_train"][1:]
    assert out2["losses_valid"] == out["losses_valid"][1:]
    assert out2["best_epoch"] == out["best_epoch"] and out2["min_loss"] == out["min_loss"]
    for name, p in unbroken.model.state_dict().items():
        assert torch.equal(p, resumed.model.state_dict()[name]), name
    a, _ = restore_checkpoint(str(tmp_path / "a" / "epoch_1"))
    b, meta_b = restore_checkpoint(str(tmp_path / "b" / "epoch_1"))
    assert a["step"] == b["step"] == 2 * (len(train_ds) // BASE["batch_size"])
    assert a["lr_scheduler"] == b["lr_scheduler"]
    moments_a, moments_b = a["optimizer"]["state"], b["optimizer"]["state"]
    assert moments_a.keys() == moments_b.keys()
    for i in moments_a:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(moments_a[i][k], moments_b[i][k]), (i, k)
    assert meta_b == _meta(str(tmp_path / "a" / "epoch_1"))
    first, second = lrs.values()
    steps = len(train_ds) // BASE["batch_size"]
    assert second == first[steps:]
    assert second[0] == BASE["learning_rate"] * BASE["lr_decay"] != first[0]


def _masked(lines, checkpoint_dir):
    """Log lines with their numbers and the checkpoint directory replaced,
    for comparing the rules."""
    return [re.sub(r"-?\d+(\.\d+)?(e-?\d+)?|nan|inf", "#", line.replace(checkpoint_dir, "<dir>"))
            for line in lines]


@pytest.mark.parametrize("stop", [
    dict(no_eval=True, patience=2, epochs=5),        # early stop after epoch 1
    dict(no_eval=True, max_time=0.0, epochs=3),      # max_time after epoch 0
    dict(patience=200, epochs=2, no_eval=True, checkpoint_frequency=2),
])
def test_stop_rules_and_log_lines_match_jax(tmp_path, capsys, monkeypatch, stop):
    """``patience``, ``max_time`` and ``no_eval`` stop where JAX's stop, with
    JAX's log lines (numbers masked). JAX's train step is replaced by a
    stand-in returning a constant loss: what is compared is the loop's
    rules, and JAX's compile of a real step is the cost of this test."""
    kw = {**BASE, **stop}
    monkeypatch.setattr(jax_runner_module, "make_train_step", lambda *a, **k: (
        lambda state, key, gt, x2d: (state, jnp.float32(0.5))))
    jax_cfg = JaxConfig(**kw, checkpoint=str(tmp_path / "jax"))
    cfg = Config(**kw, checkpoint=str(tmp_path / "port"))
    port_ds, jax_ds = _datasets(cfg, jax_cfg)
    jax_runner = JaxRunner(jax_cfg, J, JOINTS_LEFT, JOINTS_RIGHT)
    jax_runner.set_params(_params())
    capsys.readouterr()
    expected = jax_runner.fit(jax_ds["train"], jax_ds["val"])
    jax_lines = capsys.readouterr().out.splitlines()
    runner = Runner(cfg, J, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    out = runner.fit(port_ds["train"], port_ds["val"])
    lines = capsys.readouterr().out.splitlines()
    assert _masked(lines, cfg.checkpoint) == _masked(jax_lines, jax_cfg.checkpoint), (
        lines, jax_lines)
    assert len(out["losses_train"]) == len(expected["losses_train"])
    assert out["best_path"] is expected["best_path"] is None
    saved = lambda d: sorted(n for n in os.listdir(d) if n.startswith("epoch_")) if (
        os.path.isdir(d)) else []
    assert saved(cfg.checkpoint) == saved(jax_cfg.checkpoint)


def test_export_curves_writes_the_png(tmp_path):
    """More than 3 epochs with ``export_training_curves``: loss_3d.png."""
    runner, train_ds, val_ds = _port_runner(tmp_path, epochs=4, export_training_curves=True,
                                            no_eval=True)
    out = runner.fit(train_ds, val_ds)
    assert len(out["losses_train"]) == 4
    assert os.path.getsize(tmp_path / "loss_3d.png") > 0


def test_rng_json_round_trip_matches_jax():
    rng = np.random.default_rng(1234)
    rng.permutation(96)
    state = rng_state_to_json(rng)
    assert state == jax_checkpoint.rng_state_to_json(rng)
    json.dumps(state)  # plain JSON
    again = rng_state_from_json(json.loads(json.dumps(state)))
    assert rng_state_to_json(again) == state
    assert (again.permutation(96) == rng.permutation(96)).all()


def test_load_matching_params_matches_jax():
    """One renamed and one reshaped entry: the same matched and discarded
    names as JAX's on a flat tree of the same state dict."""
    rng = np.random.default_rng(3)
    target = {"a.weight": rng.standard_normal((4, 3)), "a.bias": rng.standard_normal(4),
              "b.weight": rng.standard_normal((2, 4)), "c": rng.standard_normal(5)}
    source = {k: v + 1.0 for k, v in target.items()}
    source["a.renamed"] = source.pop("a.bias")
    source["b.weight"] = rng.standard_normal((4, 2))
    as_torch = lambda d: {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in d.items()}
    merged, matched, discarded = load_matching_params(as_torch(target), as_torch(source))
    jax_merged, jax_matched, jax_discarded = jax_load_matching_params(target, source)
    names = lambda paths: sorted(p[0].key for p in paths)
    assert sorted(matched) == names(jax_matched) == ["a.weight", "c"]
    assert sorted(discarded) == names(jax_discarded) == ["a.renamed", "b.weight"]
    for k, v in merged.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jax_merged[k], np.float32), rtol=1e-7)
