"""The rank side of tests/test_torch_tensor_parallel.py: the port's tensor
parallelism (``mesh_shape`` "data:2,model:2", and "data:1,model:2" on two
groups of two side by side) run by each of four processes of one gloo
group on the CPU. It imports no JAX; the test process imports it too, for
the one-process references of the same cases.

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
    make_denoise_fn, make_eval_step, make_optimizer, make_train_denoise_fn, make_train_step,
)
from diff3dhpe_torch.engine import runner as runner_module
from diff3dhpe_torch.engine.runner import Runner, RunLogger
from diff3dhpe_torch.models import MixSTEDenoiser
from diff3dhpe_torch.parallel import DataMesh
from diff3dhpe_torch.parallel.tensor import (
    check_params_replicated, gather_params, shard_model, shard_params,
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
# epoch; 48 val windows), on the plain module: fast_train takes no model axis.
FIT = dict(subjects_train="S1", subjects_test="S9", number_of_frames=F, stride=F,
           embed_dim=EMBED, transformer_depth=DEPTH, num_heads=HEADS, timesteps=50,
           sampling_timesteps=3, batch_size=16, batch_size_eval=16, actions="Walking", seed=5,
           epochs=2, learning_rate=1e-3, lr_decay=0.5, drop_path_rate=0.1,
           checkpoint_frequency=1)
MIXED = dict(fast_eval=True, compute_dtype="bfloat16", eval_f32_final_steps=1,
             eval_f32_head=True)
FUSED = {"f32": dict(fast_eval=True), "mixed": MIXED}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def model(weights, mesh=None, dtype=torch.float32, use_pallas=False):
    """The module on ``weights`` (a whole state dict), sharded over
    ``mesh``'s model axis where it has one."""
    port = MixSTEDenoiser(**MODEL_KW, dtype=dtype, use_pallas=use_pallas, device="cpu")
    port.load_state_dict(weights, strict=True)
    if mesh is not None:
        shard_model(port, mesh)
    return port.eval()


def whole(tensors, mesh):
    """{name: tensor} gathered whole over ``mesh``'s model axis."""
    return tensors if mesh is None else gather_params(tensors, mesh)


def run_train(weights, batch, mesh=None, dtype=torch.float32, drop_path=0.0, **draws):
    """(loss, {name: whole grad}, {name: whole param after the step}) of one
    AdamW step of the plain module on ``batch`` (gt, x2d) with the injected
    ``draws`` or, with ``seed``, the generator's."""
    port = model(weights, mesh, dtype).train()
    seed = draws.pop("seed", None)
    generator = None if seed is None else torch.Generator().manual_seed(seed)
    optimizer, scheduler = make_optimizer(port.parameters(), LR, 0.99, steps_per_epoch=10)
    step = make_train_step(GaussianDiffusion.create(make_train_denoise_fn(port, drop_path),
                                                    **TRAIN_KW), optimizer, scheduler, mesh=mesh)
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


def fit_runner(checkpoint, mesh=None, logger=None, mesh_shape=None):
    cfg = Config(**FIT, checkpoint=str(checkpoint), mesh_shape=mesh_shape)
    runner = Runner(cfg, J, JOINTS_LEFT, JOINTS_RIGHT, logger=logger, device="cpu", mesh=mesh)
    ds, kps = make_synthetic_h36m_like(subjects=("S1", "S9"), n_frames=100, seed=1)
    return runner, PoseDataset(cfg, ds, "data", "train", keypoints_data=kps), PoseDataset(
        cfg, ds, "data", "val", keypoints_data=kps)


def fit_summary(out):
    return dict(losses_train=list(out["losses_train"]), losses_valid=list(out["losses_valid"]),
                best_epoch=out["best_epoch"], min_loss=float(out["min_loss"]))


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
    from diff3dhpe_torch.io.export import export_eval_step

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

    # The sharded export refuses a model axis.
    runner = Runner(Config(**{**FIT, "batch_size_eval": 4, "mesh_shape": MESH}), J,
                    JOINTS_LEFT, JOINTS_RIGHT, device="cpu", mesh=world)
    try:
        export_eval_step(runner, batch_size=4, sharded=True)
        res["export_sharded"] = None
    except ValueError as e:
        res["export_sharded"] = str(e)
    return res


def run_rank(rank, world_size, init_file, spec_path, out_dir):
    """Starts the rank, runs ``run_tp_cases`` and saves its results to
    ``out_dir/rank{rank}.pt`` (tests/torch_parallel_ranks.py's protocol)."""
    import traceback

    from diff3dhpe_torch.parallel import start_ranks

    torch.set_num_threads(1)
    world = start_ranks("cpu", init_method=f"file://{init_file}", rank=rank,
                        world_size=world_size, timeout=120)
    try:
        spec = torch.load(spec_path, weights_only=False)
        res = dict(cases=run_tp_cases(spec, world, out_dir))
    except Exception:  # the rank's failure, reported to the test as its result
        res = dict(error=traceback.format_exc())
        raise
    finally:
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
