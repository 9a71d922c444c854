"""H3.6M evaluation entry point.

Port of the evaluate path of ``diff3dhpe_tpu/cli/run.py`` (itself the
equivalent of the reference's run_conditionalDiffusionDDIM3dhpe
NormalDirectPredictVariableLoss.py): config merge, dataset/model/diffusion
construction, weight loading from a reference ``.bin`` checkpoint, and the
final per-action evaluation protocol with its report.

Usage (reference command lines work with the module path swapped):
    python -m diff3dhpe_torch.cli.run --config configs/h36m_gt_s2s_....json \\
        --evaluate <ckpt.bin> [overrides...]
    python -m diff3dhpe_torch.cli.run --synthetic --evaluate <ckpt.bin> ...

Runs on the CUDA device; ``main(argv, device="cpu")`` runs the plain
PyTorch path on the CPU. Training through the CLI (no ``--evaluate``) is
not ported yet and exits with a message. The ``Params | FLOPs/forward``
line counts FLOPs by formula (``utils.profiling.denoiser_matmul_flops``)
where JAX asks XLA's cost analysis.
"""
from __future__ import annotations

import os
import sys

import numpy as np


def main(argv=None, device="cuda"):
    from diff3dhpe_torch.cli.args import args_to_overrides, build_parser
    from diff3dhpe_torch.config import load_config

    args = build_parser().parse_args(argv)
    cfg = load_config(args.config, args_to_overrides(args))
    if args.resume and args.evaluate:
        print("Invalid flags: --resume and --evaluate cannot be set at the same time")
        sys.exit(1)
    if not cfg.evaluate:
        print("Training through the CLI is not ported yet: pass --evaluate <checkpoint.bin>")
        sys.exit(2)

    from diff3dhpe_torch.data import Human36mDataset, PoseDataset, make_synthetic_h36m_like
    from diff3dhpe_torch.engine.runner import Runner, RunLogger
    from diff3dhpe_torch.io.checkpoint import load_torch_state_dict
    from diff3dhpe_torch.utils.profiling import clever_format, denoiser_matmul_flops

    os.makedirs(cfg.checkpoint, exist_ok=True)
    logger = RunLogger(cfg.checkpoint, enabled=True)

    # ------------------------------------------------------------------
    # Dataset
    # ------------------------------------------------------------------
    keypoints_data = None
    all_subjects = tuple(
        dict.fromkeys(cfg.subjects_train.split(",") + cfg.subjects_test.split(","))
    )
    if cfg.dataset.startswith(("humaneva", "custom")):
        raise ValueError(f"dataset={cfg.dataset!r} is not ported: only h36m (and its "
                         "synthetic stand-in) so far")
    if args.synthetic:
        dataset, keypoints_data = make_synthetic_h36m_like(
            subjects=all_subjects,
            n_frames=max(4 * cfg.number_of_frames, 100),
            seed=cfg.seed,
            motion=getattr(args, "synthetic_motion", "walk"),
        )
    elif cfg.dataset == "h36m":
        dataset = Human36mDataset(f"{cfg.data_root}/data_3d_{cfg.dataset}.npz")
    else:
        raise KeyError("Invalid dataset")

    print(f"INFO: Receptive field: {cfg.number_of_frames} frames")
    logger.log(f"INFO: Receptive field: {cfg.number_of_frames} frames\n")

    test_ds = PoseDataset(
        cfg, dataset, cfg.data_root, "test",
        noise_std=cfg.test_extra_noise_std, joint_drop_rate=cfg.test_joint_drop,
        keypoints_data=keypoints_data,
    )
    num_joints = test_ds.num_joints
    joints_left = list(dataset.skeleton().joints_left())
    joints_right = list(dataset.skeleton().joints_right())

    runner = Runner(cfg, num_joints, joints_left, joints_right, logger=logger, device=device)
    n_params = runner.param_count()
    print(f"INFO: Trainable parameter count: {n_params}")

    # Params | FLOPs printout (reference run.py:195-200, thop-equivalent).
    flops = denoiser_matmul_flops(cfg.number_of_frames, num_joints, cfg.embed_dim,
                                  cfg.transformer_depth, cfg.mlp_ratio)
    print("Params | FLOPs/forward")
    print("---|---")
    print(f"{clever_format(n_params)} | {clever_format(flops)}")
    logger.config(
        f"Dataset: {cfg.dataset},\nModel: {cfg.model}\n\nparams={cfg}\n\n\n"
        f"Total Parameters: {n_params}\n\n"
    )
    print(f"INFO: device: {runner.device}")

    # ------------------------------------------------------------------
    # Weight loading (reference .bin)
    # ------------------------------------------------------------------
    path = (os.path.join(cfg.checkpoint, cfg.evaluate)
            if not os.path.exists(cfg.evaluate) else cfg.evaluate)
    if not path.endswith(".bin"):
        raise ValueError(f"evaluate={cfg.evaluate!r} is not ported: only reference .bin "
                         "checkpoints load so far")
    runner.set_params(load_torch_state_dict(path))
    print(f"Loaded checkpoint {path}")

    # ------------------------------------------------------------------
    # Final per-action evaluation (reference run_evaluation:712-766)
    # ------------------------------------------------------------------
    logger.result(
        f"Dataset: {cfg.dataset},\nModel: {cfg.model}\n\nargs={cfg}\n\n\n"
        f"Total Parameters: {n_params}\n\n"
    )
    print("Evaluating...")

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
