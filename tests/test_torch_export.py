"""The serving export (io/export.py, cli/export.py) on the CPU, where the
``diff3dhpe::`` operators run their kernels' plain versions: the ports of
JAX's tests/test_export.py cases that apply (the round trip equals the
live step bit for bit, :29; the artifact is weight-agnostic, :53; the CLI
end to end, :106), in every eval mode; the restored artifact against JAX's
eval step on the same x_T; ``torch.library.opcheck`` on each operator; and
the refusals (the sharded export outside a data-parallel run, whose cases
are in tests/test_torch_parallel.py; the platform list, since an artifact
runs on the device it was exported on)."""
import os

import jax
import numpy as np
import pytest
import torch

from diff3dhpe_torch.cli.export import main as export_main
from diff3dhpe_torch.config import Config
from diff3dhpe_torch.engine.runner import Runner
from diff3dhpe_torch.io.export import export_eval_step, live_eval_step, restore_eval_step
from diff3dhpe_torch.models import MixSTEDenoiser
from diff3dhpe_tpu.config import Config as JaxConfig
from diff3dhpe_tpu.engine.runner import Runner as JaxRunner
from torch_port_helpers import JOINTS_LEFT, JOINTS_RIGHT, jax_x_init, perturb
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

F = 9
BASE = dict(stride=F, number_of_frames=F, embed_dim=32, transformer_depth=2, num_heads=4,
            timesteps=20, sampling_timesteps=2, batch_size=4, batch_size_eval=4, seed=3,
            mesh_shape="data:1")
MIXED = dict(fast_eval=True, compute_dtype="bfloat16", eval_f32_final_steps=1, eval_f32_head=True)
# Every eval mode the runner builds, and the mixed mode in the cols layout.
MODES = {
    "plain": ({}, "rows"),
    "use_pallas": (dict(use_pallas_attention=True), "rows"),
    "fast_f32": (dict(fast_eval=True), "rows"),
    "mixed": (MIXED, "rows"),
    "mixed_cols": (MIXED, "cols"),
    "mixed_tail": (dict(MIXED, eval_f32_tail_pairs=1), "rows"),
    "bf16": (dict(fast_eval=True, compute_dtype="bfloat16"), "rows"),
    "ddim_eta": (dict(ddim_sampling_eta=0.5), "rows"),
}
CONFIG = "configs/h36m_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json"


def _inputs(rng, cfg, batch=2):
    x = rng.standard_normal((batch, F, 17, 2)).astype(np.float32)
    xf = rng.standard_normal((batch, F, 17, 2)).astype(np.float32)
    x_init = rng.standard_normal((2 * batch, F, 17, 3)).astype(np.float32)
    noises = (rng.standard_normal((cfg.sampling_timesteps,) + x_init.shape).astype(np.float32)
              if cfg.ddim_sampling_eta else None)
    return x, xf, x_init, noises


@pytest.mark.parametrize("mode", list(MODES))
def test_export_roundtrip_matches_live_step(mode, tmp_path):
    overrides, tmode = MODES[mode]
    runner = Runner(Config(**BASE, **overrides), 17, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    path = str(tmp_path / "eval.pt2")
    data = export_eval_step(runner, batch_size=2, path=path, temporal_mode=tmode)
    assert isinstance(data, bytes) and len(data) == os.path.getsize(path) > 0
    x, xf, x_init, noises = _inputs(np.random.default_rng(0), runner.cfg)
    live = live_eval_step(runner, tmode)(x, xf, x_init=x_init, noises=noises)
    if tmode == "rows":
        torch.testing.assert_close(runner.eval_step(x, xf, x_init=x_init, noises=noises), live,
                                   rtol=0, atol=0)
    for artifact in (data, path):
        step = restore_eval_step(artifact)
        served = step(runner.model.state_dict(), x, xf, x_init, noises)
        assert served.shape == (2, F, 17, 3)
        torch.testing.assert_close(served, live, rtol=0, atol=0)


def test_export_artifact_is_weight_agnostic():
    """Weights are runtime inputs: one artifact (the mixed mode, whose bf16
    copies are made inside the graph) serves any checkpoint of its shape,
    each bit for bit as the live step on those weights; the state dict is
    taken as load_state_dict(strict=True) takes it."""
    runner = Runner(Config(**BASE, **MIXED), 17, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    step = restore_eval_step(export_eval_step(runner, batch_size=1))
    x, xf, x_init, _ = _inputs(np.random.default_rng(1), runner.cfg, batch=1)
    outs = []
    for seed in (None, 123):
        if seed is not None:
            runner.set_params(runner.init_params(seed=seed))
        state = {k: v.clone() for k, v in runner.model.state_dict().items()}
        out = step(state, x, xf, x_init)
        torch.testing.assert_close(out, runner.eval_step(x, xf, x_init=x_init), rtol=0, atol=0)
        outs.append(out)
    assert not torch.equal(*outs)
    state.pop("head.1.bias")
    with pytest.raises(KeyError, match="head.1.bias"):
        step(state, x, xf, x_init)
    with pytest.raises(KeyError, match="extra"):
        step(dict(runner.model.state_dict(), extra=torch.zeros(1)), x, xf, x_init)


@pytest.mark.parametrize("mode", ["fast_f32"])
def test_restored_artifact_matches_jax_eval_step(mode):
    """The artifact on the CPU against JAX's eval step (``Runner.eval_step``,
    Pallas interpreted) on the same perturbed weights, x_T from JAX's key
    (``jax_x_init``), within 1e-4. (Every other mode's artifact equals its
    live step bit for bit, above, whose agreement with JAX
    tests/test_torch_runner.py and test_torch_tail.py hold.)"""
    overrides, _ = MODES[mode]
    kw = {**BASE, **overrides}
    jax_runner = JaxRunner(JaxConfig(**kw), 17, JOINTS_LEFT, JOINTS_RIGHT)
    params = jax.tree.map(np.asarray, jax_runner.init_params())
    params = perturb(params, np.random.default_rng(2))
    jax_runner.set_params(params)
    runner = Runner(Config(**kw), 17, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    runner.set_params(params)
    step = restore_eval_step(export_eval_step(runner, batch_size=2))
    rng = np.random.default_rng(4)
    x, xf = (rng.standard_normal((2, F, 17, 2)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(7)
    expected = np.asarray(jax_runner.eval_step(jax_runner.state.params, key, x, xf))
    served = step(runner.model.state_dict(), x, xf, jax_x_init(key, 4, (F, 17, 3))).numpy()
    np.testing.assert_allclose(served, expected, rtol=0, atol=1e-4)


def _block_args(seed=0):
    """A block's operator arguments at a small shape: B1 on 3 groups of 17
    rows with the time add, drop-path and the out-LN."""
    from diff3dhpe_torch.ops.fused_block import _block_operands

    g = torch.Generator().manual_seed(seed)
    model = MixSTEDenoiser(num_frame=F, embed_dim=32, depth=1, num_heads=4, device="cpu")
    block = model.STEblocks[0]
    ops = tuple(t.detach() if isinstance(t, torch.Tensor) else t
                for t in _block_operands(block, model.Spatial_norm))
    x = torch.randn(3 * 17, 32, generator=g)
    t_rows = torch.randn(3, 32, generator=g)
    dp = (torch.rand(3 * 17, 2, generator=g) < 0.7).float() / 0.7
    return x, t_rows, dp, ops


def _op_cases():
    x, t_rows, dp, ops = _block_args()
    qkv = torch.randn(2, 17, 3, 4, 8, generator=torch.Generator().manual_seed(1))
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    cols = torch.randn(2 * F, 17 * 32, generator=torch.Generator().manual_seed(2))
    return {
        "fused_transformer_block": (x, t_rows, dp, *ops, 17, 4, 17, 17, 0),
        "fused_transformer_block_high3": (x, t_rows, dp, *ops, 17, 4, 17, 17, 1),
        "fused_transformer_block_bf16": (x.bfloat16(), t_rows, None, *ops, 17, 4, 17, 17, 0),
        "fused_temporal_block_cols": (cols, torch.randn(2, 32), None, *ops, F, 17, 4, 0),
        "fused_temporal_block_cols_default": (cols, torch.randn(2, 32), None, *ops, F, 17, 4, 2),
        "fused_grand_attention": (q, k, v, None),
        "fused_grand_attention_bf16": (q.bfloat16(), k.bfloat16(), v.bfloat16(), 0.35),
        "fused_grand_attention_long": tuple(torch.randn(6, 81, 8) for _ in range(3)) + (None,),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_operators_pass_opcheck(case):
    """``torch.library.opcheck`` on each ``diff3dhpe::`` operator: its
    schema, its fake implementation against the CPU one (shape, dtype,
    strides), and its tracing by AOT autograd."""
    import diff3dhpe_torch.ops  # noqa: F401

    name = case.replace("_bf16", "").replace("_long", "").replace("_high3", "").replace(
        "_default", "")
    op = getattr(torch.ops.diff3dhpe, name).default
    torch.library.opcheck(op, _op_cases()[case])


def _tiny_cli_args(tmp_path):
    return ["--config", CONFIG, "-c", str(tmp_path), "-a", "Walking", "-str", "S1", "-ste", "S9",
            "--synthetic", "-frame", "9", "-s", "9", "--embed_dim", "32",
            "--transformer_depth", "1", "--timesteps", "20", "--sampling_timesteps", "3",
            "-e", "1", "-b", "8", "--batch-size-eval", "16"]


def test_export_cli_end_to_end(tmp_path, capsys):
    """Train one tiny synthetic epoch, export its best checkpoint through
    the CLI, replay the artifact with the checkpoint's weights and equal the
    live step on them; then export from a reference .bin."""
    from diff3dhpe_torch.cli.run import main as run_main
    from diff3dhpe_torch.io.checkpoint import restore_checkpoint

    args = _tiny_cli_args(tmp_path)
    run_main(args, device="cpu")
    out = str(tmp_path / "eval.pt2")
    data = export_main(args + ["--evaluate", "best_epoch", "--output", out,
                               "--export-batch-size", "2"], device="cpu")
    assert os.path.getsize(out) == len(data) > 0
    assert "Exported eval step ->" in capsys.readouterr().out
    state = restore_checkpoint(str(tmp_path / "best_epoch"), field="evaluate")[0][
        "model_diffusion"]
    x = np.zeros((2, F, 17, 2), np.float32)
    x_init = np.random.default_rng(0).standard_normal((4, F, 17, 3)).astype(np.float32)
    served = restore_eval_step(out)(state, x, x, x_init)
    assert served.shape == (2, F, 17, 3) and torch.isfinite(served).all()
    runner = Runner(Config(stride=F, number_of_frames=F, embed_dim=32, transformer_depth=1,
                           timesteps=20, sampling_timesteps=3), 17, JOINTS_LEFT, JOINTS_RIGHT,
                    device="cpu")
    runner.set_params(state)
    torch.testing.assert_close(served, runner.eval_step(x, x, x_init=x_init), rtol=0, atol=0)

    weights = str(tmp_path / "w.bin")
    torch.save(runner.init_params(seed=8), weights)
    out_bin = str(tmp_path / "bin.pt2")
    export_main(args + ["--evaluate", weights, "--output", out_bin, "--fast-eval"], device="cpu")
    step = restore_eval_step(out_bin)
    assert step.meta["batch_size"] == 16 and step.meta["temporal_mode"] == "rows"


@pytest.mark.parametrize("extra,field", [
    (["--export-sharded"], "export_sharded"),
    (["--export-platforms", "cpu,tpu"], "export_platforms"),  # tpu: not a torch platform
])
def test_export_cli_refuses_what_is_not_taken(tmp_path, extra, field):
    with pytest.raises(ValueError, match=f"^{field}="):
        export_main(_tiny_cli_args(tmp_path) + ["--output", str(tmp_path / "x.pt2")] + extra,
                    device="cpu")
    assert not os.path.exists(tmp_path / "x.pt2")


def test_export_refuses_sharded_and_needs_the_card_by_default(tmp_path, monkeypatch):
    runner = Runner(Config(**BASE), 17, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    with pytest.raises(ValueError, match="data-parallel run"):
        export_eval_step(runner, batch_size=2, sharded=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        export_main(_tiny_cli_args(tmp_path) + ["--output", str(tmp_path / "x.pt2")])
