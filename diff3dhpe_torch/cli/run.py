"""H3.6M / HumanEva / custom train + eval entry point.

Port of ``diff3dhpe_tpu/cli/run.py`` (itself the equivalent of the
reference's run_conditionalDiffusionDDIM3dhpeNormalDirectPredictVariableLoss.py):
config merge, dataset/model/diffusion construction, training with
per-epoch flip-TTA validation and checkpoints (``Runner.fit``), weight
loading, and the final per-action evaluation protocol with its report.

Usage (reference command lines work with the module path swapped):
    python -m diff3dhpe_torch.cli.run --config configs/h36m_gt_s2s_....json \\
        [--evaluate <ckpt>] [--resume <ckpt>] [overrides...]
    python -m diff3dhpe_torch.cli.run --synthetic ...   # no dataset needed

A checkpoint is a reference ``.bin`` file or a checkpoint directory the
port wrote (``epoch_{n}/``, ``best_epoch/`` under ``--checkpoint``; a name
that does not exist as given is looked up there). ``--pretrained_model``
loads every parameter whose name and shape match (the reference's
``load_pretrained_weights``) before training.

Runs on the CUDA device; ``main(argv, device="cpu")`` runs the plain
PyTorch path on the CPU. Data parallel across N processes (``--mesh-shape
data:N``; the batch sizes are global, split over the data ranks), and with
a ``model`` axis of M tensor parallel too, on N·M processes (``--mesh-shape
data:N,model:M``; the plain module's blocks split over each model group's
M ranks, ``parallel.tensor``; ``--fast-train`` at N = 1 trains the fused
path on whole weights gathered from the shards before every step, and is
refused beside N > 1, as in JAX):

    torchrun --nproc-per-node N -m diff3dhpe_torch.cli.run --mesh-shape data:N ...
    torchrun --nproc-per-node N*M -m diff3dhpe_torch.cli.run --mesh-shape data:N,model:M ...
    torchrun --nproc-per-node M -m diff3dhpe_torch.cli.run --mesh-shape data:1,model:M \
        --fast-train ...

(``python -m torch.distributed.run`` is the same launcher); each rank runs
on ``cuda:LOCAL_RANK`` over ``nccl`` (on the CPU, ``device="cpu"``, over
``gloo``; several ranks on one card take ``gloo`` too, as NCCL refuses
them), and only rank 0 writes the run's files and prints its report. A
process that already belongs to a process group runs as its rank
(``parallel.entry_ranks``). The ``Params | FLOPs/forward`` line counts FLOPs
by formula (``utils.profiling.denoiser_matmul_flops``) where JAX asks XLA's
cost analysis. A custom archive holds 2D detections only: its report
prints the frames and their speed, and NaN for every error, where JAX's
evaluation stops at the missing ground truth. A dataset name other than
h36m, humaneva* or custom* raises a ValueError naming it (JAX: KeyError,
or with ``--synthetic`` the H3.6M-like set whatever the name).
"""
from __future__ import annotations

import os
import sys

import numpy as np


def resolve_checkpoint(cfg, name):
    """``name`` as given where it exists, else under ``cfg.checkpoint``."""
    return os.path.join(cfg.checkpoint, name) if not os.path.exists(name) else name


def load_weights(path, field):
    """The denoiser's state dict of a reference ``.bin`` file or a checkpoint
    directory the port wrote; ``field`` names the flag in a refusal."""
    from diff3dhpe_torch.io.checkpoint import load_torch_state_dict, restore_checkpoint

    if path.endswith(".bin"):
        return load_torch_state_dict(path)
    return restore_checkpoint(path, field=field)[0]["model_diffusion"]


def load_evaluated_weights(cfg, runner):
    """Loads ``cfg.evaluate`` (else ``cfg.pretrained_model``) into ``runner``
    as the export and visualisation entry points do (JAX cli/export.py:
    93-110, cli/viz.py:102-113); returns the path, or None where neither is
    set."""
    name = cfg.evaluate or cfg.pretrained_model
    if not name:
        return None
    path = resolve_checkpoint(cfg, name)
    runner.set_params(load_weights(path, "evaluate" if cfg.evaluate else "pretrained_model"))
    print(f"Loaded checkpoint {path}")
    return path


def rank_print(mesh):
    """``print`` on rank 0 (or in one process), else a function that prints
    nothing."""
    return print if mesh is None or mesh.is_main else (lambda *args, **kwargs: None)


def describe_ranks(mesh, device):
    """The INFO line naming the device, and in a run across processes the
    world size, the backend and this rank; under a model axis > 1 both
    axes and this rank's place on each."""
    if mesh is None:
        return f"INFO: device: {device}"
    if mesh.model_size > 1:
        return (f"INFO: mesh data:{mesh.data_size},model:{mesh.model_size} (data parallel x "
                f"tensor parallel): world size {mesh.size}, backend {mesh.backend}, rank "
                f"{mesh.rank} (data {mesh.data_rank}, model {mesh.model_rank}) on device {device}")
    return (f"INFO: data parallel: world size {mesh.size}, backend {mesh.backend}, rank "
            f"{mesh.rank} on device {device}")


def main(argv=None, device="cuda"):
    from diff3dhpe_torch.parallel import entry_ranks

    with entry_ranks(device) as mesh:
        return _main(argv, device, mesh)


def _main(argv, device, mesh):
    from diff3dhpe_torch.cli.args import args_to_overrides, build_parser
    from diff3dhpe_torch.config import load_config

    args = build_parser().parse_args(argv)
    cfg = load_config(args.config, args_to_overrides(args))
    if args.resume and args.evaluate:
        print("Invalid flags: --resume and --evaluate cannot be set at the same time")
        sys.exit(1)

    from diff3dhpe_torch.data import Human36mDataset, PoseDataset, make_synthetic_h36m_like
    from diff3dhpe_torch.engine.runner import Runner, RunLogger
    from diff3dhpe_torch.io.convert import load_matching_params
    from diff3dhpe_torch.utils.profiling import clever_format, denoiser_matmul_flops

    say = rank_print(mesh)
    main_rank = mesh is None or mesh.is_main
    if main_rank:
        os.makedirs(cfg.checkpoint, exist_ok=True)
    logger = RunLogger(cfg.checkpoint, enabled=main_rank, echo=main_rank)

    # ------------------------------------------------------------------
    # Dataset
    # ------------------------------------------------------------------
    keypoints_data = None
    all_subjects = tuple(
        dict.fromkeys(cfg.subjects_train.split(",") + cfg.subjects_test.split(","))
    )
    if not (cfg.dataset == "h36m" or cfg.dataset.startswith(("humaneva", "custom"))):
        raise ValueError(f"dataset={cfg.dataset!r} is not a dataset of this entry point: "
                         "h36m, humaneva* or custom* (3dhp: cli/run_3dhp.py)")
    if args.synthetic and cfg.dataset.startswith("humaneva"):
        from diff3dhpe_torch.data.synthetic import make_synthetic_humaneva

        dataset, keypoints_data = make_synthetic_humaneva(
            subjects=all_subjects,
            n_frames=max(4 * cfg.number_of_frames, 100),
            seed=cfg.seed,
        )
    elif args.synthetic:
        dataset, keypoints_data = make_synthetic_h36m_like(
            subjects=all_subjects,
            n_frames=max(4 * cfg.number_of_frames, 100),
            seed=cfg.seed,
            motion=getattr(args, "synthetic_motion", "walk"),
        )
    elif cfg.dataset == "h36m":
        dataset = Human36mDataset(f"{cfg.data_root}/data_3d_{cfg.dataset}.npz")
    elif cfg.dataset.startswith("humaneva"):
        from diff3dhpe_torch.data.humaneva import HumanEvaDataset

        dataset = HumanEvaDataset(f"{cfg.data_root}/data_3d_{cfg.dataset}.npz")
    else:
        from diff3dhpe_torch.data.custom import CustomDataset

        dataset = CustomDataset(f"{cfg.data_root}/data_2d_{cfg.dataset}_{cfg.keypoints}.npz")

    say(f"INFO: Receptive field: {cfg.number_of_frames} frames")
    logger.log(f"INFO: Receptive field: {cfg.number_of_frames} frames\n")

    test_ds = PoseDataset(
        cfg, dataset, cfg.data_root, "test",
        noise_std=cfg.test_extra_noise_std, joint_drop_rate=cfg.test_joint_drop,
        keypoints_data=keypoints_data,
    )
    num_joints = test_ds.num_joints
    joints_left = list(dataset.skeleton().joints_left())
    joints_right = list(dataset.skeleton().joints_right())

    runner = Runner(cfg, num_joints, joints_left, joints_right, logger=logger, device=device,
                    mesh=mesh)
    n_params = runner.param_count()
    say(f"INFO: Trainable parameter count: {n_params}")

    # Params | FLOPs printout (reference run.py:195-200, thop-equivalent).
    flops = denoiser_matmul_flops(cfg.number_of_frames, num_joints, cfg.embed_dim,
                                  cfg.transformer_depth, cfg.mlp_ratio)
    say("Params | FLOPs/forward")
    say("---|---")
    say(f"{clever_format(n_params)} | {clever_format(flops)}")
    logger.config(
        f"Dataset: {cfg.dataset},\nModel: {cfg.model}\n\nparams={cfg}\n\n\n"
        f"Total Parameters: {n_params}\n\n"
    )
    print(describe_ranks(runner.mesh, runner.device))

    # ------------------------------------------------------------------
    # Optional weight loading (reference .bin or the port's checkpoint dir)
    # ------------------------------------------------------------------
    def resolve(name):
        return resolve_checkpoint(cfg, name)

    if cfg.evaluate:
        path = resolve(cfg.evaluate)
        runner.set_params(load_weights(path, "evaluate"))
        say(f"Loaded checkpoint {path}")
    elif cfg.pretrained_model:
        merged, matched, discarded = load_matching_params(
            runner.full_state_dict(), load_weights(cfg.pretrained_model, "pretrained_model"))
        runner.set_params(merged)
        say(f"Loaded checkpoint {cfg.pretrained_model}: {len(matched)} parameters, "
              f"{len(discarded)} discarded {discarded}")

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    if not cfg.evaluate:
        train_ds = PoseDataset(
            cfg, dataset, cfg.data_root, "train",
            noise_std=cfg.train_extra_noise_std, joint_drop_rate=cfg.train_joint_drop,
            keypoints_data=keypoints_data,
        )
        # Per-epoch validation split: train subjects, no augmentation, its
        # own corruption knobs (reference run.py:278-284).
        val_ds = PoseDataset(
            cfg, dataset, cfg.data_root, "val",
            noise_std=cfg.train_val_extra_noise_std,
            joint_drop_rate=cfg.train_val_joint_drop,
            keypoints_data=keypoints_data,
        )
        say(
            f"INFO: Training on {len(train_ds)} windows, validating on "
            f"{len(val_ds)}, testing on {len(test_ds)}"
        )
        result = runner.fit(train_ds, val_ds, resume=resolve(cfg.resume) if cfg.resume else None)
        if result["best_path"]:
            runner.set_params(load_weights(result["best_path"], "evaluate"))
            logger.log(f"Loaded the best model from {result['best_path']}\n")

    # ------------------------------------------------------------------
    # Final per-action evaluation (reference run_evaluation:712-766)
    # ------------------------------------------------------------------
    logger.result(
        f"Dataset: {cfg.dataset},\nModel: {cfg.model}\n\nargs={cfg}\n\n\n"
        f"Total Parameters: {n_params}\n\n"
    )
    say("Evaluating...")

    subjects_test = cfg.subjects_test.split(",")
    all_actions = {}
    for subject in subjects_test:
        for action in dataset[subject].keys():
            all_actions.setdefault(action.split(" ")[0], []).append((subject, action))

    action_filter = None if cfg.actions == "*" else cfg.actions.split(",")

    frames, times = [], []
    errors = {k: [] for k in ("e1", "e2", "e3", "ev")}
    for action_key in all_actions:
        if action_filter is not None and not any(
            action_key.startswith(a) for a in action_filter
        ):
            continue
        action_ds = PoseDataset(
            cfg, dataset, cfg.data_root, "test", action_filter=[action_key],
            noise_std=cfg.test_extra_noise_std, joint_drop_rate=cfg.test_joint_drop,
            keypoints_data=keypoints_data,
        )
        m = runner.evaluate(action_ds, action=action_key)
        frames.append(m["n_frames"])
        times.append(m["model_time"])
        for k in errors:
            errors[k].append(m[k])

    total_frames, total_time = np.sum(frames), np.sum(times)
    summary = (
        f"Total eval_frame: {total_frames}\n"
        f"Total inference_time: {total_time / 60}min\n"
        f"inference_speed: {total_frames / total_time if total_time else float('inf')}frame/s\n"
        f"Protocol #1   (MPJPE) action-wise average: {round(np.mean(errors['e1']), 1)}mm\n"
        f"Protocol #2 (P-MPJPE) action-wise average: {round(np.mean(errors['e2']), 1)}mm\n"
        f"Protocol #3 (N-MPJPE) action-wise average: {round(np.mean(errors['e3']), 1)}mm\n"
        f"Velocity      (MPJVE) action-wise average: {round(np.mean(errors['ev']), 2)}mm\n"
    )
    logger.result(summary)
    return errors


if __name__ == "__main__":
    main()
