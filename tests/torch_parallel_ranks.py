"""The rank side of tests/test_torch_parallel.py: the port's data-parallel
steps, ``Runner.fit``, the CLI and the sharded export, run by each of N
processes of one gloo group on the CPU. It imports no JAX, so a spawned
rank starts in seconds; the test process imports it too, for the
one-process references of the same cases.

``run_rank(rank, world_size, init_file, spec_path, out_dir)`` starts the
rank (a ``file://`` rendezvous, so that parallel test workers cannot
collide on a port), runs every case of the spec, and saves its results to
``out_dir/rank{rank}.pt``.
"""
import contextlib
import io
import os
import traceback

import torch

from diff3dhpe_torch.config import Config
from diff3dhpe_torch.data import PoseDataset, make_synthetic_h36m_like
from diff3dhpe_torch.diffusion import GaussianDiffusion
from diff3dhpe_torch.engine import (
    make_denoise_fn, make_eval_step, make_fast_denoise_fn, make_fast_train_denoise_fn,
    make_optimizer, make_train_denoise_fn, make_train_step,
)
from diff3dhpe_torch.engine import runner as runner_module
from diff3dhpe_torch.engine.runner import Runner, RunLogger
from diff3dhpe_torch.models import MixSTEDenoiser

F, J, EMBED, DEPTH, HEADS = 9, 17, 32, 1, 4
JOINTS_LEFT, JOINTS_RIGHT = [4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]
MODEL_KW = dict(num_frame=F, num_joints=J, in_chans=2, embed_dim=EMBED, depth=DEPTH,
                num_heads=HEADS, mlp_ratio=2.0, qkv_bias=True, with_time_emb=True, mode="s2s")
EVAL_KW = dict(timesteps=20, sampling_timesteps=3, clip_denoised=True)
TRAIN_KW = dict(timesteps=1000, sampling_timesteps=3, clip_loss=True)
DROP_PATH, LR = 0.5, 1e-3
# 96 train windows (S1 Walking, 4 cameras, flip augmentation): 6 steps of 16
# an epoch; 48 val windows: 3 batches of 16 (tests/test_torch_fit.py's BASE).
FIT = dict(subjects_train="S1", subjects_test="S9", number_of_frames=F, stride=F,
           embed_dim=EMBED, transformer_depth=DEPTH, num_heads=HEADS, timesteps=50,
           sampling_timesteps=3, batch_size=16, batch_size_eval=16, actions="Walking", seed=5,
           epochs=2, learning_rate=1e-3, lr_decay=0.5, fast_train=True, drop_path_rate=0.1,
           checkpoint_frequency=1)


def model(weights):
    port = MixSTEDenoiser(**MODEL_KW, device="cpu")
    port.load_state_dict(weights, strict=True)
    return port.eval()


def eval_step(port, fused, repeat_n, mesh=None, eta=0.0):
    """The flip-TTA eval step on the module (``fused``: the f32 fused
    forward) at EVAL_KW."""
    denoise = make_fast_denoise_fn(port) if fused else make_denoise_fn(port)
    diffusion = GaussianDiffusion.create(denoise, ddim_sampling_eta=eta, **EVAL_KW)
    return make_eval_step(diffusion, JOINTS_LEFT, JOINTS_RIGHT, repeat_n=repeat_n,
                          device="cpu", mesh=mesh)


def train_step(port, fast, mesh=None, dtype=torch.float32, attn_bwd=False):
    """One AdamW step of ``port`` at TRAIN_KW: the fast-train path with
    drop-path (``fast``, in ``dtype``, with the attention backward kernels
    under ``attn_bwd``) or the plain module without."""
    fn = (make_fast_train_denoise_fn(port, DROP_PATH, attn_bwd=attn_bwd, dtype=dtype) if fast
          else make_train_denoise_fn(port, 0.0))
    optimizer, scheduler = make_optimizer(port.parameters(), LR, 0.99, steps_per_epoch=10)
    return make_train_step(GaussianDiffusion.create(fn, **TRAIN_KW), optimizer, scheduler,
                           mesh=mesh)


def run_train(weights, fast, batch, mesh=None, dtype=torch.float32, attn_bwd=False, **draws):
    """(loss, {name: grad}, {name: param after the step}) of one step on
    ``batch`` (gt, x2d) with the injected ``draws`` or, with ``seed``, the
    generator's."""
    port = model(weights).train()
    seed = draws.pop("seed", None)
    generator = None if seed is None else torch.Generator().manual_seed(seed)
    loss = train_step(port, fast, mesh, dtype, attn_bwd)(*batch, generator=generator, **draws)
    return (loss, {n: p.grad.clone() for n, p in port.named_parameters()},
            {n: p.detach().clone() for n, p in port.named_parameters()})


def fit_runner(checkpoint, mesh=None, logger=None):
    cfg = Config(**FIT, checkpoint=str(checkpoint))
    runner = Runner(cfg, J, JOINTS_LEFT, JOINTS_RIGHT, logger=logger, device="cpu", mesh=mesh)
    ds, kps = make_synthetic_h36m_like(subjects=("S1", "S9"), n_frames=100, seed=1)
    return runner, PoseDataset(cfg, ds, "data", "train", keypoints_data=kps), PoseDataset(
        cfg, ds, "data", "val", keypoints_data=kps)


def fit_summary(out):
    return dict(losses_train=list(out["losses_train"]), losses_valid=list(out["losses_valid"]),
                best_epoch=out["best_epoch"], min_loss=float(out["min_loss"]))


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cli_argv(weights_path, checkpoint, extra=()):
    config = "configs/h36m_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json"
    return ["--config", os.path.join(ROOT, config),
            "--synthetic", "-frame", str(F), "-s", str(F), "--embed_dim", str(EMBED),
            "--transformer_depth", str(DEPTH), "--num-heads", str(HEADS), "--timesteps", "20",
            "--sampling_timesteps", "3", "--batch-size-eval", "16", "-a", "Walking", "-str",
            "S1", "-ste", "S9", "-c", str(checkpoint), "--evaluate", str(weights_path),
            *extra]


def cli_main_one(argv):
    """``cli.run.main`` in this process alone, on the CPU, its output
    swallowed; returns its errors."""
    from diff3dhpe_torch.cli.run import main

    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv, device="cpu")


def _raises_does_not_divide(fn):
    try:
        fn()
    except ValueError as e:
        return "does not divide" in str(e)
    return False


def run_cases(spec, mesh, out_dir):
    """Every case of ``spec`` on this rank; returns {case: result}."""
    from diff3dhpe_torch.cli.run import main as cli_main
    from diff3dhpe_torch.io.export import export_eval_step, restore_eval_step

    res = {}
    w = spec["weights"]
    x2d, x2d_flip = spec["x2d"], spec["x2d_flip"]
    # Eval against JAX's data:2 mesh: JAX's x_T injected as the global x_init.
    for key, x_init in spec["jax_x_init"].items():
        fused, repeat_n = key.split("/")
        res[f"eval_jax/{key}"] = eval_step(model(w), fused == "fused", int(repeat_n), mesh)(
            x2d, x2d_flip, x_init=x_init)
    # Eval against the one-process port, both drawing from the generator.
    for key in spec["self_eval"]:
        fused, repeat_n, eta = key.split("/")
        step = eval_step(model(w), fused == "fused", int(repeat_n), mesh, float(eta))
        res[f"eval_self/{key}"] = step(x2d, x2d_flip, generator=torch.Generator().manual_seed(3))
    # One train step against JAX's (its draws injected), and against itself.
    batch = (spec["gt"], spec["x2d"])
    for key, draws in spec["jax_train_draws"].items():
        res[f"train_jax/{key}"] = run_train(w, key == "fast", batch, mesh, **draws)
    res["train_self"] = run_train(w, True, batch, mesh, seed=4)
    # A batch that does not divide the ranks.
    odd = spec["x2d"][:3]
    res["indivisible"] = dict(
        eval=_raises_does_not_divide(lambda: eval_step(model(w), False, 1, mesh)(
            odd, odd, generator=torch.Generator().manual_seed(0))),
        train=_raises_does_not_divide(lambda: train_step(model(w).train(), True, mesh)(
            spec["gt"][:3], odd, generator=torch.Generator().manual_seed(0))))

    # Weights that differ on one rank.
    port = model(w)
    mesh.check_replicated(port.parameters())
    if mesh.rank == 1:
        with torch.no_grad():
            next(port.parameters()).add_(1.0)
    try:
        mesh.check_replicated(port.parameters())
        raised = False
    except RuntimeError:
        raised = True
    res["replicated"] = dict(same=True, differing_raised=raised)

    # fit: 2 epochs, a checkpoint each; rank 0 alone writes (its saves
    # counted), the other ranks' logger neither writes nor prints.
    saves = []
    save = runner_module.save_checkpoint
    runner_module.save_checkpoint = lambda *a, **k: (saves.append(a[0]), save(*a, **k))[1]
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            logger = RunLogger(spec["fit_dir"], enabled=mesh.is_main, echo=mesh.is_main)
            runner, train_ds, val_ds = fit_runner(spec["fit_dir"], mesh, logger)
            res["fit"] = dict(fit_summary(runner.fit(train_ds, val_ds)), saves=list(saves))
    finally:
        runner_module.save_checkpoint = save
    res["fit"]["stdout"] = text.getvalue()

    # The CLI's evaluate entry point in this process group.
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        errors = cli_main(cli_argv(spec["weights_path"], os.path.join(out_dir, "cli"),
                                   ["--mesh-shape", f"data:{mesh.size}"]), device="cpu")
    res["cli"] = dict(errors={k: [float(e) for e in v] for k, v in errors.items()},
                      stdout=text.getvalue())

    # The sharded export: written by rank 0, restored by every rank, held
    # against the live data-parallel step.
    runner = Runner(Config(**{**FIT, "batch_size_eval": 4, "fast_eval": True}), J, JOINTS_LEFT,
                    JOINTS_RIGHT, device="cpu", mesh=mesh)
    runner.set_params(w)
    path = spec["artifact"]
    data = export_eval_step(runner, batch_size=4, path=path, sharded=True)
    step = restore_eval_step(path, mesh)
    x_init = spec["jax_x_init"]["fused/1"]
    res["export"] = dict(
        bytes=None if data is None else len(data), meta=dict(step.meta["sharded"]),
        served=step(w, x2d, x2d_flip, x_init),
        live=runner.eval_step(x2d, x2d_flip, x_init=x_init))
    return res


def run_bf16_cases(spec, mesh, out_dir):
    """The bf16 fast-train step with the attention backward kernels
    (ROADMAP C.10; tests/test_torch_parallel_bf16.py) on ``spec["batch"]``
    with ``spec["draws"]``, the global draws, injected."""
    return dict(train_bf16=run_train(spec["weights"], True, spec["batch"], mesh,
                                     dtype=torch.bfloat16, attn_bwd=True, **spec["draws"]))


def run_rank(rank, world_size, init_file, spec_path, out_dir, cases="run_cases"):
    """Starts the rank and runs the spec's cases through ``cases``, a
    function of this module by name (``run_cases``, ``run_bf16_cases``)."""
    from diff3dhpe_torch.parallel import start_ranks

    torch.set_num_threads(1)
    mesh = start_ranks("cpu", init_method=f"file://{init_file}", rank=rank,
                       world_size=world_size, timeout=120)
    try:
        spec = torch.load(spec_path, weights_only=False)
        res = dict(mesh=repr(mesh), cases=globals()[cases](spec, mesh, out_dir))
    except Exception:  # the rank's failure, reported to the test as its result
        res = dict(error=traceback.format_exc())
        raise
    finally:
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        torch.distributed.destroy_process_group()

