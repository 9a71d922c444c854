"""The rank side of tests/test_torch_tensor_parallel.py: the port's tensor
parallelism (``mesh_shape`` "data:2,model:2", and "data:1,model:2" on two
groups of two side by side: the plain module, the fused training on whole
weights, the sharded export) run by each of four processes of one gloo
group on the CPU; and the rank side of tests/test_torch_dropout.py, the
plain module's dropout at "data:1,model:2" on two ranks
(``run_dropout_cases``). It imports no JAX; the test processes import it
too, for the one-process references of the same cases.

``run_rank`` follows tests/torch_parallel_ranks.py's protocol (a
``file://`` rendezvous, the results saved to ``out_dir/rank{rank}.pt``).
"""
import contextlib
import io
import os

import torch
import torch.distributed as dist

from diff3dhpe_torch.config import Config
from diff3dhpe_torch.data import PoseDataset, make_synthetic_h36m_like
from diff3dhpe_torch.diffusion import GaussianDiffusion
from diff3dhpe_torch.engine import (
    make_denoise_fn, make_eval_step, make_fast_train_denoise_fn, make_optimizer,
    make_train_denoise_fn, make_train_step,
)
from diff3dhpe_torch.engine import runner as runner_module
from diff3dhpe_torch.engine.runner import Runner, RunLogger
from diff3dhpe_torch.models import MixSTEDenoiser
from diff3dhpe_torch.parallel import DataMesh
from diff3dhpe_torch.parallel.tensor import (
    WholeWeights, check_params_replicated, gather_params, shard_model, shard_params,
)

F, J, EMBED, DEPTH, HEADS = 9, 17, 32, 1, 8
MESH = "data:2,model:2"
JOINTS_LEFT, JOINTS_RIGHT = [4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]
MODEL_KW = dict(num_frame=F, num_joints=J, in_chans=2, embed_dim=EMBED, depth=DEPTH,
                num_heads=HEADS, mlp_ratio=2.0, qkv_bias=True, with_time_emb=True, mode="s2s")
EVAL_KW = dict(timesteps=20, sampling_timesteps=3, clip_denoised=True)
TRAIN_KW = dict(timesteps=1000, sampling_timesteps=3, clip_loss=True)
DROP_PATH, LR = 0.5, 1e-3
# tests/torch_parallel_ranks.py's fit (96 train windows: 6 steps of 16 an
# epoch; 48 val windows), on the plain module; FAST_FIT trains the fused path
# at "data:1,model:2" (JAX refuses it beside a data axis > 1).
FIT = dict(subjects_train="S1", subjects_test="S9", number_of_frames=F, stride=F,
           embed_dim=EMBED, transformer_depth=DEPTH, num_heads=HEADS, timesteps=50,
           sampling_timesteps=3, batch_size=16, batch_size_eval=16, actions="Walking", seed=5,
           epochs=2, learning_rate=1e-3, lr_decay=0.5, drop_path_rate=0.1,
           checkpoint_frequency=1)
FAST_FIT = dict(fast_train=True, fast_train_attn_bwd=True, no_eval=True)
MIXED = dict(fast_eval=True, compute_dtype="bfloat16", eval_f32_final_steps=1,
             eval_f32_head=True)
FUSED = {"f32": dict(fast_eval=True), "mixed": MIXED}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def model(weights, mesh=None, dtype=torch.float32, use_pallas=False, module=None):
    """The module on ``weights`` (a whole state dict), sharded over
    ``mesh``'s model axis where it has one; ``module``: more of its
    constructor's arguments (the dropout rates)."""
    port = MixSTEDenoiser(**MODEL_KW, **(module or {}), dtype=dtype, use_pallas=use_pallas,
                          device="cpu")
    port.load_state_dict(weights, strict=True)
    if mesh is not None:
        shard_model(port, mesh)
    return port.eval()


def whole(tensors, mesh):
    """{name: tensor} gathered whole over ``mesh``'s model axis."""
    return tensors if mesh is None else gather_params(tensors, mesh)


def run_train(weights, batch, mesh=None, dtype=torch.float32, drop_path=0.0, fast=False,
              module=None, **draws):
    """(loss, {name: whole grad}, {name: whole param after the step}) of one
    AdamW step of the plain module on ``batch`` (gt, x2d) with the injected
    ``draws`` or, with ``seed``, the generator's. ``fast``: the fused
    training path (``attn_bwd``) at ``dtype``, under ``mesh``'s model axis
    on a whole replica loaded from the shards (``WholeWeights``).
    ``module``: as ``model``'s."""
    port = model(weights, mesh, dtype, module=module).train()
    seed = draws.pop("seed", None)
    generator = None if seed is None else torch.Generator().manual_seed(seed)
    replica = None
    if fast and mesh is not None:
        replica = WholeWeights(model(weights, dtype=dtype), port, mesh)
    if fast:
        fn = make_fast_train_denoise_fn(port if replica is None else replica.replica, drop_path,
                                        attn_bwd=True, dtype=dtype)
    else:
        fn = make_train_denoise_fn(port, drop_path)
    optimizer, scheduler = make_optimizer(port.parameters(), LR, 0.99, steps_per_epoch=10)
    step = make_train_step(GaussianDiffusion.create(fn, **TRAIN_KW), optimizer, scheduler,
                           mesh=mesh, whole=replica)
    loss = step(*batch, generator=generator, **draws)
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    params = {n: p.detach().clone() for n, p in port.named_parameters()}
    if mesh is not None:
        check_params_replicated(port, mesh)  # raises where the ranks part
    return loss, whole(grads, mesh), whole(params, mesh)


def eval_step(port, repeat_n, mesh=None, eta=0.0):
    """The flip-TTA eval step on the plain (or use_pallas) module at EVAL_KW."""
    diffusion = GaussianDiffusion.create(make_denoise_fn(port), ddim_sampling_eta=eta, **EVAL_KW)
    return make_eval_step(diffusion, JOINTS_LEFT, JOINTS_RIGHT, repeat_n=repeat_n,
                          device="cpu", mesh=mesh)


def fused_eval(weights, mode, mesh=None, mesh_shape=None, **inputs):
    """The Runner's fused eval step ("f32" or "mixed") on ``weights``."""
    cfg = Config(**{**FIT, "batch_size_eval": 4, **FUSED[mode], "mesh_shape": mesh_shape})
    runner = Runner(cfg, J, JOINTS_LEFT, JOINTS_RIGHT, device="cpu", mesh=mesh)
    runner.set_params(weights)
    return runner.eval_step(inputs["x2d"], inputs["x2d_flip"], x_init=inputs["x_init"])


def fit_runner(checkpoint, mesh=None, logger=None, mesh_shape=None, **fields):
    cfg = Config(**{**FIT, **fields}, checkpoint=str(checkpoint), mesh_shape=mesh_shape)
    runner = Runner(cfg, J, JOINTS_LEFT, JOINTS_RIGHT, logger=logger, device="cpu", mesh=mesh)
    ds, kps = make_synthetic_h36m_like(subjects=("S1", "S9"), n_frames=100, seed=1)
    return runner, PoseDataset(cfg, ds, "data", "train", keypoints_data=kps), PoseDataset(
        cfg, ds, "data", "val", keypoints_data=kps)


def fit_summary(out):
    return dict(losses_train=list(out["losses_train"]), losses_valid=list(out["losses_valid"]),
                best_epoch=out["best_epoch"], min_loss=float(out["min_loss"]))


def fast_fit(checkpoint, mesh=None, mesh_shape=None):
    """``Runner.fit`` of FAST_FIT (2 epochs, a checkpoint each), then the
    run resumed from its epoch_0 for epoch 1: dict(losses, resumed (the
    resumed run's losses), state (the whole weights after the 2 epochs))."""
    runner, train_ds, val_ds = fit_runner(checkpoint, mesh, None, mesh_shape, **FAST_FIT)
    out = dict(losses=runner.fit(train_ds, val_ds)["losses_train"])
    out["state"] = {k: v.clone() for k, v in runner.full_state_dict().items()}
    runner, train_ds, val_ds = fit_runner(os.path.join(checkpoint, "resumed"), mesh, None,
                                          mesh_shape, **FAST_FIT)
    out["resumed"] = runner.fit(train_ds, val_ds, resume=os.path.join(checkpoint, "epoch_0"))[
        "losses_train"]
    return out


def served_and_live(runner, path, inputs, mesh=None):
    """The artifact at ``path`` restored under ``mesh`` and run on the
    runner's whole weights, and the runner's live eval step, on ``inputs``."""
    from diff3dhpe_torch.io.export import restore_eval_step

    step = restore_eval_step(path, mesh)
    served = step(runner.full_state_dict(), inputs["x2d"], inputs["x2d_flip"], inputs["x_init"])
    live = runner.eval_step(inputs["x2d"], inputs["x2d_flip"], x_init=inputs["x_init"])
    return dict(served=served, live=live, meta=step.meta)


def cli_argv(weights_path, checkpoint, extra=()):
    config = "configs/h36m_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json"
    return ["--config", os.path.join(ROOT, config),
            "--synthetic", "-frame", str(F), "-s", str(F), "--embed_dim", str(EMBED),
            "--transformer_depth", str(DEPTH), "--num-heads", str(HEADS), "--timesteps", "20",
            "--sampling_timesteps", "3", "--batch-size-eval", "16", "-a", "Walking", "-str",
            "S1", "-ste", "S9", "-c", str(checkpoint), "--evaluate", str(weights_path),
            *extra]


def _wait_for(path, seconds=120):
    """Waits for ``path`` (a checkpoint's meta.json, written after its state
    file) to exist; raises after ``seconds``."""
    import time

    deadline = time.time() + seconds
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"{path} did not appear in {seconds} s")
        time.sleep(0.1)


def run_tp_cases(spec, world, out_dir):
    """Every case of ``spec`` on this rank of four; returns {case: result}."""
    from diff3dhpe_torch.cli.run import main as cli_main
    from diff3dhpe_torch.io.export import export_eval_step, restore_eval_step

    res = {}
    w = spec["weights"]
    # Two groups of two, made on every rank (in one order), each the
    # model axis of its own "data:1,model:2" mesh.
    pair, _ = dist.new_subgroups_by_enumeration([[0, 1], [2, 3]])
    meshes = {MESH: world.with_model_axis(2),
              "data:1,model:2": DataMesh(world.device, pair, model=2)}
    mesh = meshes[MESH]
    res["mesh"] = repr(mesh)

    local = shard_params(w, mesh)
    back = gather_params(local, mesh)
    res["round_trip"] = dict(shapes={k: tuple(v.shape) for k, v in local.items()},
                             equal=list(back) == list(w) and all(
                                 torch.equal(a, w[k]) for k, a in back.items()))

    batch = (spec["gt"], spec["x2d"])
    res["train_jax"] = run_train(w, batch, mesh, **spec["jax_draws"])
    res["train_bf16"] = run_train(w, batch, mesh, dtype=torch.bfloat16, **spec["jax_draws"])
    for shape, m in meshes.items():
        res[f"train_self/{shape}"] = run_train(w, batch, m, drop_path=DROP_PATH, seed=4)

    x2d, x2d_flip = spec["x2d"], spec["x2d_flip"]
    for r, x_init in spec["jax_x_init"].items():
        res[f"eval_jax/{r}"] = eval_step(model(w, mesh), r, mesh)(x2d, x2d_flip, x_init=x_init)
    for key in spec["self_eval"]:
        kind, r, eta = key.split("/")
        port = model(w, mesh, use_pallas=kind == "pallas")
        res[f"eval_self/{key}"] = eval_step(port, int(r), mesh, float(eta))(
            x2d, x2d_flip, generator=torch.Generator().manual_seed(3))
    inputs = dict(x2d=x2d, x2d_flip=x2d_flip, x_init=spec["jax_x_init"][1])
    for shape, m in meshes.items():
        for mode in FUSED:
            res[f"fused/{mode}/{shape}"] = fused_eval(w, mode, m, shape, **inputs)

    # fit: 2 epochs, a checkpoint each; rank 0 alone writes (its saves
    # counted); then the one-process run's epoch_0 resumed under the mesh.
    saves = []
    save = runner_module.save_checkpoint
    runner_module.save_checkpoint = lambda *a, **k: (saves.append(a[0]), save(*a, **k))[1]
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            logger = RunLogger(spec["fit_dir"], enabled=mesh.is_main, echo=mesh.is_main)
            runner, train_ds, val_ds = fit_runner(spec["fit_dir"], world, logger, MESH)
            res["fit"] = dict(fit_summary(runner.fit(train_ds, val_ds)), saves=list(saves))
            _wait_for(os.path.join(spec["one_epoch_0"], "meta.json"))  # the test process's
            runner, train_ds, val_ds = fit_runner(spec["resume_dir"], world, None, MESH)
            res["resumed"] = fit_summary(runner.fit(train_ds, val_ds,
                                                    resume=spec["one_epoch_0"]))
    finally:
        runner_module.save_checkpoint = save
    res["fit"]["stdout"] = text.getvalue()

    # The CLI's evaluate entry point in this process group.
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        errors = cli_main(cli_argv(spec["weights_path"], os.path.join(out_dir, "cli"),
                                   ["--mesh-shape", MESH]), device="cpu")
    res["cli"] = dict(errors={k: [float(e) for e in v] for k, v in errors.items()},
                      stdout=text.getvalue())

    # The fused training at data:1,model:2, on whole weights gathered from
    # the shards: one step at f32 and at bf16 with JAX's draws, then fit.
    pair_mesh = meshes["data:1,model:2"]
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        res[f"fast_train/{name}"] = run_train(w, batch, pair_mesh, dtype, DROP_PATH, fast=True,
                                              **spec["jax_fast_draws"])
    res["fast_fit"] = fast_fit(f"{spec['fit_dir']}_pair{world.rank // 2}", pair_mesh,
                               "data:1,model:2")

    # The sharded export at data:2,model:2: rank 0 traces, every rank
    # restores; then the same artifact under data:4, and the CLI's.
    for mode in FUSED:
        runner = Runner(Config(**{**FIT, "batch_size_eval": 4, **FUSED[mode], "mesh_shape": MESH}),
                        J, JOINTS_LEFT, JOINTS_RIGHT, device="cpu", mesh=world)
        runner.set_params(w)
        path = os.path.join(out_dir, f"sharded_{mode}.pt2")
        data = export_eval_step(runner, batch_size=4, path=path, sharded=True)
        res[f"export/{mode}"] = dict(served_and_live(runner, path, inputs, runner.mesh),
                                     bytes=None if data is None else len(data))
    try:
        served_and_live(runner, path, inputs, world)
        res["export/data:4"] = None
    except ValueError as e:
        res["export/data:4"] = str(e)
    from diff3dhpe_torch.cli.export import main as export_main

    path = os.path.join(out_dir, "sharded_cli.pt2")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        export_main(cli_argv(spec["weights_path"], os.path.join(out_dir, "cli_export"), [
            "--mesh-shape", MESH, "--export-sharded", "--output", path,
            "--export-batch-size", "4"]), device="cpu")
    step = restore_eval_step(path, mesh)
    res["export/cli"] = dict(stdout=text.getvalue(), meta=step.meta, served=step(
        w, x2d, x2d_flip, spec["jax_x_init"][1]))
    return res


def run_dropout_cases(spec, world, out_dir):
    """The plain module's f32 train step with dropout and drop-path, the
    draws from one seed, at "data:1,model:2" on this rank of two."""
    mesh = world.with_model_axis(2)
    return {"train": run_train(spec["weights"], (spec["gt"], spec["x2d"]), mesh,
                               drop_path=DROP_PATH, module=spec["module"], seed=4)}


def run_rank(rank, world_size, init_file, spec_path, out_dir, cases="run_tp_cases"):
    """Starts the rank, runs ``cases`` (``run_tp_cases`` or
    ``run_dropout_cases``) and saves its results to ``out_dir/rank{rank}.pt``
    (tests/torch_parallel_ranks.py's protocol)."""
    import traceback

    from diff3dhpe_torch.parallel import start_ranks

    torch.set_num_threads(1)
    world = start_ranks("cpu", init_method=f"file://{init_file}", rank=rank,
                        world_size=world_size, timeout=120)
    try:
        spec = torch.load(spec_path, weights_only=False)
        res = dict(cases=globals()[cases](spec, world, out_dir))
    except Exception:  # the rank's failure, reported to the test as its result
        res = dict(error=traceback.format_exc())
        raise
    finally:
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
