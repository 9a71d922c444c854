"""``Runner.evaluate`` of the port against the JAX package's on the same
synthetic dataset and weights, on the CPU (the port's kernels through their
plain versions, Pallas in interpret mode). torch cannot reproduce JAX's
per-row x_T draw, so the port's evaluate is handed, batch by batch, the x_T
that JAX's evaluate draws from the keys it splits (runner.py:416-417)."""
import jax
import numpy as np
import pytest
import torch

from diff3dhpe_torch.config import Config
from diff3dhpe_torch.data import PoseDataset, make_synthetic_h36m_like
from diff3dhpe_torch.engine.runner import Runner, RunLogger, check_supported
from diff3dhpe_tpu.config import Config as JaxConfig
from diff3dhpe_tpu.data import PoseDataset as JaxPoseDataset
from diff3dhpe_tpu.data import make_synthetic_h36m_like as jax_make_synthetic
from diff3dhpe_tpu.engine.runner import Runner as JaxRunner
from torch_port_helpers import JOINTS_LEFT, JOINTS_RIGHT, jax_x_init, perturb

BASE = dict(subjects_train="S1", subjects_test="S9", number_of_frames=9, stride=9, embed_dim=32,
            transformer_depth=1, num_heads=4, timesteps=50, sampling_timesteps=3,
            batch_size_eval=4, actions="*", mesh_shape="data:1", seed=5)
MIXED = dict(fast_eval=True, compute_dtype="bfloat16", eval_f32_final_steps=1, eval_f32_head=True)
# The metrics are hundreds of mm on an untrained net. The f32 paths agree
# to rtol 1e-4 / atol 1e-3 mm. The mixed path's eight bf16 steps round in
# another order in the two packages (tests/test_torch_mixed_eval.py: the
# predictions differ by ~5e-3 of their range), so it is held to rtol 2e-3.
CASES = {
    "default": ({}, 1e-4),
    "use_pallas_attention": (dict(use_pallas_attention=True), 1e-4),
    "use_pallas_attention_81f": (dict(use_pallas_attention=True, number_of_frames=81, stride=81,
                                      batch_size_eval=2), 1e-4),
    "fast_eval": (dict(fast_eval=True), 1e-4),
    "mixed": (MIXED, 2e-3),
    "s2f_no_tta": (dict(model="ConditionalDiffusionMixSTES2FGRANDLinLift", out_all=False,
                       stride=1, batch_size_eval=128, test_time_augmentation=False), 1e-4),
}


def _pair(overrides):
    """(port runner, its dataset, JAX runner, its dataset) on the same
    synthetic subjects and the same perturbed flax weights."""
    kw = {**BASE, **overrides}
    cfg, jax_cfg = Config(**kw), JaxConfig(**kw)
    data_kw = dict(subjects=("S1", "S9"), n_frames=max(4 * cfg.number_of_frames, 100), seed=1)
    ds, kps = make_synthetic_h36m_like(**data_kw)
    jds, jkps = jax_make_synthetic(**data_kw)
    test_ds = PoseDataset(cfg, ds, "data", "test", keypoints_data=kps)
    jax_test_ds = JaxPoseDataset(jax_cfg, jds, "data", "test", keypoints_data=jkps)
    jax_runner = JaxRunner(jax_cfg, 17, JOINTS_LEFT, JOINTS_RIGHT)
    params = perturb(jax.tree.map(np.asarray, jax_runner.init_params()),
                     np.random.default_rng(2))
    jax_runner.set_params(params)
    runner = Runner(cfg, 17, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    runner.set_params(params)
    return runner, test_ds, jax_runner, jax_test_ds


@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_matches_jax(case):
    overrides, rtol = CASES[case]
    runner, test_ds, jax_runner, jax_test_ds = _pair(overrides)
    cfg = runner.cfg
    key = jax.random.PRNGKey(11)
    expected = jax_runner.evaluate(jax_test_ds, action="Walking", key=key)

    rows = cfg.batch_size_eval * (2 if cfg.test_time_augmentation else 1)
    f_out = cfg.number_of_frames if cfg.out_all else 1
    subkeys = []
    for _ in test_ds.batches(cfg.batch_size_eval):
        key, sub = jax.random.split(key)
        subkeys.append(sub)
    assert len(subkeys) > 1
    out = runner.evaluate(test_ds, action="Walking",
                          x_init=lambda i: jax_x_init(subkeys[i], rows, (f_out, 17, 3)))

    assert out["n_frames"] == expected["n_frames"] > 0
    assert out["predictions"].shape == expected["predictions"].shape
    for k in ("e1", "e2", "e3", "ev"):
        assert np.isfinite(out[k])
        np.testing.assert_allclose(out[k], expected[k], rtol=rtol, atol=1e-3, err_msg=k)
    assert out["model_time"] > 0 and out["frames_per_sec"] > 0


def test_evaluate_draws_x_t_from_the_generator():
    """Without x_init the draws come from ``generator`` (default: seeded
    with cfg.seed): the same seed gives the same report, another seed
    another one; the warm-up batch does not consume the caller's draws."""
    cfg = Config(**BASE)
    ds, kps = make_synthetic_h36m_like(subjects=("S1", "S9"), n_frames=100, seed=1)
    test_ds = PoseDataset(cfg, ds, "data", "test", keypoints_data=kps)
    runner = Runner(cfg, 17, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    gen = lambda seed: torch.Generator().manual_seed(seed)
    a, b, c = (runner.evaluate(test_ds, generator=g) for g in (gen(cfg.seed), None, gen(6)))
    np.testing.assert_array_equal(a["predictions"], b["predictions"])
    assert np.abs(a["predictions"] - c["predictions"]).max() > 0
    # The first timed batch sees the generator's first draws.
    first = next(iter(test_ds.batches(cfg.batch_size_eval)))
    pred = runner.eval_step(first.input_2d, first.input_2d_flip, generator=gen(cfg.seed))
    pred = test_ds.reverse_norm_3d_pose(pred.numpy()).reshape(-1, 17, 3)
    mask = (first.target_mask & first.row_mask[:, None]).reshape(-1)
    np.testing.assert_array_equal(a["predictions"][:mask.sum()], pred[mask])


def test_set_params_and_init_params(tmp_path):
    cfg = Config(**BASE, checkpoint=str(tmp_path))
    runner = Runner(cfg, 17, JOINTS_LEFT, JOINTS_RIGHT, logger=RunLogger(str(tmp_path)),
                    device="cpu")
    same, other = runner.init_params(), runner.init_params(seed=6)
    assert same.keys() == other.keys() == runner.model.state_dict().keys()
    assert all(torch.equal(v, runner.model.state_dict()[k]) for k, v in same.items())
    assert any(not torch.equal(v, same[k]) for k, v in other.items())
    runner.set_params(other)
    assert torch.equal(runner.model.head[1].weight, other["head.1.weight"])
    assert runner.param_count() == sum(v.numel() for v in other.values())
    with pytest.raises(RuntimeError, match="head"):
        runner.set_params({k: v for k, v in other.items() if not k.startswith("head")})
    files = sorted(p.name.split("_")[0] for p in tmp_path.iterdir())
    assert files == []  # the logger writes on first use only
    runner.logger.result("x\n")
    assert [p.name.split("_")[0] for p in tmp_path.iterdir()] == ["results"]


def test_mixed_runner_rebuilds_its_bf16_snapshot():
    """The bf16 denoise_fn holds a snapshot of the weights: ``set_params``
    must rebuild it, or the evaluation would run the old weights."""
    cfg = Config(**{**BASE, **MIXED})
    ds, kps = make_synthetic_h36m_like(subjects=("S1", "S9"), n_frames=100, seed=1)
    test_ds = PoseDataset(cfg, ds, "data", "test", keypoints_data=kps)
    runner = Runner(cfg, 17, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    before = runner.evaluate(test_ds)["predictions"]
    runner.set_params(runner.init_params(seed=6))
    after = runner.evaluate(test_ds)["predictions"]
    fresh = Runner(Config(**{**BASE, **MIXED, "seed": 6}), 17, JOINTS_LEFT, JOINTS_RIGHT,
                   device="cpu")
    gen = torch.Generator().manual_seed(cfg.seed)
    assert np.abs(after - before).max() > 0
    np.testing.assert_array_equal(after, fresh.evaluate(test_ds, generator=gen)["predictions"])


@pytest.mark.parametrize("field,overrides", [
    ("mesh_shape", dict(mesh_shape="data:8")),
    ("mesh_shape", dict(mesh_shape="data:4,model:2")),
    ("eval_f32_tail_pairs", dict(eval_f32_tail_pairs=2, **MIXED)),
    ("eval_final_prec", dict(eval_final_prec="default", **MIXED)),
    ("remat", dict(remat=True)),
    ("compute_dtype", dict(compute_dtype="bfloat16")),
    ("compute_dtype", dict(compute_dtype="float16")),
    ("use_pallas_attention", dict(use_pallas_attention=True, **MIXED)),
])
def test_runner_refuses_what_is_not_ported(field, overrides):
    cfg = Config(**{**BASE, "mesh_shape": None, **overrides})
    with pytest.raises(ValueError, match=f"^{field}="):
        check_supported(cfg)
    with pytest.raises(ValueError, match=f"^{field}="):
        Runner(cfg, 17, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")


def test_runner_accepts_what_means_one_device_and_exact_f32():
    for overrides in (dict(mesh_shape=None), dict(mesh_shape="data:1"),
                      dict(eval_final_prec="highest", **MIXED), dict(eval_final_prec="high3")):
        check_supported(Config(**{**BASE, **overrides}))


def test_runner_needs_a_gpu_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Runner(Config(**BASE), 17, JOINTS_LEFT, JOINTS_RIGHT)
