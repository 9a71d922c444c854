"""MPI-INF-3DHP train + eval entry point.

Port of ``diff3dhpe_tpu/cli/run_3dhp.py`` (the equivalent of the
reference's run_*_3dhp.py): per-test-sequence (TS1-TS6) evaluation with
valid-frame masking, raw-prediction export to
checkpoint/inference_data.mat (the layout the reference feeds the external
MATLAB evaluator, run_3dhp.py:542-547,631-632), plus in-framework PCK@150mm
and AUC so no MATLAB is needed (thresholds per the standard
mpii_test_predictions protocol).

Usage:
    python -m diff3dhpe_torch.cli.run_3dhp --config configs/3dhp_gt_s2s_....json \\
        [--evaluate <ckpt>] [--resume <ckpt>] [--synthetic] [overrides...]

Checkpoints as ``cli/run.py`` takes them: a reference ``.bin`` file or a
checkpoint directory the port wrote (a name that does not exist as given
is looked up under ``--checkpoint``). Runs on the CUDA device;
``main(argv, device="cpu")`` runs the plain PyTorch path on the CPU. Data
parallel across N processes, and tensor parallel on N·M, as ``cli/run.py``
is (``torchrun --nproc-per-node N -m diff3dhpe_torch.cli.run_3dhp
--mesh-shape data:N ...``, or ``--nproc-per-node N*M ... --mesh-shape
data:N,model:M``; ``--fast-train`` under a model axis at N = 1 only):
only rank 0 writes the run's files and ``inference_data.mat`` and prints
the report.

Note on units: the 3DHP arrays are in millimetres (the reference's 3DHP
MPJPE prints are mm without the x1000 used for H3.6M, run_3dhp.py:561-568).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch


def main(argv=None, device="cuda"):
    from diff3dhpe_torch.parallel import entry_ranks

    with entry_ranks(device) as mesh:
        return _main(argv, device, mesh)


def _main(argv, device, mesh):
    from diff3dhpe_torch.cli.args import args_to_overrides, build_parser
    from diff3dhpe_torch.cli.run import describe_ranks, rank_print
    from diff3dhpe_torch.config import load_config

    args = build_parser().parse_args(argv)
    overrides = args_to_overrides(args)
    overrides.setdefault("dataset", None)
    cfg = load_config(args.config, overrides)
    if cfg.dataset != "3dhp":
        cfg = cfg.replace(dataset="3dhp")
    if args.resume and args.evaluate:
        print("Invalid flags: --resume and --evaluate cannot be set at the same time")
        sys.exit(1)

    from diff3dhpe_torch.data import MPIINF3DHPDataset
    from diff3dhpe_torch.data.dataset import PoseDataset3DHP
    from diff3dhpe_torch.data.mpiinf3dhp import JOINTS_LEFT, JOINTS_RIGHT, NUM_JOINTS
    from diff3dhpe_torch.engine.runner import Runner, RunLogger
    from diff3dhpe_torch.io.checkpoint import load_torch_state_dict, restore_checkpoint
    from diff3dhpe_torch.io.convert import load_matching_params

    say = rank_print(mesh)
    main_rank = mesh is None or mesh.is_main
    if main_rank:
        os.makedirs(cfg.checkpoint, exist_ok=True)
    logger = RunLogger(cfg.checkpoint, enabled=main_rank, echo=main_rank)

    if args.synthetic:
        from diff3dhpe_torch.data.synthetic import make_synthetic_3dhp

        dataset = make_synthetic_3dhp(
            subjects_train=cfg.subjects_train.split(","),
            subjects_test=cfg.subjects_test.split(","),
            n_frames=max(4 * cfg.number_of_frames, 100),
            seed=cfg.seed,
        )
    else:
        dataset = MPIINF3DHPDataset(
            cfg.subjects_train, cfg.subjects_test, root_path=cfg.data_root
        )

    say(f"INFO: Receptive field: {cfg.number_of_frames} frames")
    runner = Runner(cfg, NUM_JOINTS, JOINTS_LEFT, JOINTS_RIGHT, logger=logger, device=device,
                    mesh=mesh)
    n_params = runner.param_count()
    logger.config(
        f"Dataset: 3dhp,\nModel: {cfg.model}\n\nparams={cfg}\n\n\n"
        f"Total Parameters: {n_params}\n\n"
    )
    say(f"INFO: Trainable parameter count: {n_params}")
    print(describe_ranks(runner.mesh, runner.device))

    def resolve(name):
        return os.path.join(cfg.checkpoint, name) if not os.path.exists(name) else name

    def load_weights(path, field):
        """The denoiser's state dict of the .bin file or checkpoint directory."""
        if path.endswith(".bin"):
            return load_torch_state_dict(path)
        return restore_checkpoint(path, field=field)[0]["model_diffusion"]

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

    test_all_ds = PoseDataset3DHP(
        cfg, dataset._test, dataset._pos_3d_min, dataset._pos_3d_max, split="test",
        noise_std=cfg.test_extra_noise_std, joint_drop_rate=cfg.test_joint_drop,
    )

    if not cfg.evaluate:
        train_ds = PoseDataset3DHP(
            cfg, dataset._train, dataset._pos_3d_min, dataset._pos_3d_max,
            split="train", noise_std=cfg.train_extra_noise_std,
            joint_drop_rate=cfg.train_joint_drop,
        )
        # Per-epoch validation on the train sequences without augmentation
        # (reference run_3dhp.py:234-236; the reference passes
        # train_extra_noise_std, not train_val_*, for this dataset).
        val_ds = PoseDataset3DHP(
            cfg, dataset._train, dataset._pos_3d_min, dataset._pos_3d_max,
            split="val", noise_std=cfg.train_extra_noise_std,
            joint_drop_rate=cfg.train_joint_drop,
        )
        say(
            f"INFO: Training on {len(train_ds)} windows, validating on "
            f"{len(val_ds)}, testing on {len(test_all_ds)}"
        )
        result = runner.fit(train_ds, val_ds, resume=resolve(cfg.resume) if cfg.resume else None)
        if result["best_path"]:
            runner.set_params(load_weights(result["best_path"], "evaluate"))
            logger.log(f"Loaded the best model from {result['best_path']}\n")

    # ------------------------------------------------------------------
    # Per-sequence evaluation (reference run_evaluation:593-627)
    # ------------------------------------------------------------------
    logger.result(
        f"Dataset: 3dhp,\nModel: {cfg.model}\n\nargs={cfg}\n\n\nTotal Parameters: {n_params}\n\n"
    )
    say("Evaluating...")
    per_seq, errors, frames_per_sec = sequence_inference(runner, cfg, dataset)
    pred_cat = np.concatenate([p for p, _ in per_seq.values()])
    gt_cat = np.concatenate([g for _, g in per_seq.values()])
    data_inference = {k: p.transpose(2, 1, 0) for k, (p, _) in per_seq.items()}  # MATLAB layout

    for k in errors:
        avg = round(float(np.mean(errors[k])), 2)
        logger.result(f"{k} sequence-wise average: {avg}mm\n")

    # In-framework PCK/AUC over all test sequences (mm thresholds).
    pck_v, auc_v = pck_auc(pred_cat, gt_cat)
    logger.result(f"PCK@150mm: {pck_v:.2f}%\nAUC: {auc_v:.2f}%\n")

    import scipy.io as scio

    mat_path = os.path.join(cfg.checkpoint, "inference_data.mat")
    if main_rank:
        scio.savemat(mat_path, data_inference)
    say(f"Saved raw predictions to {mat_path}")
    return dict(errors=errors, pck=pck_v, auc=auc_v, frames_per_sec=frames_per_sec)


def sequence_inference(runner, cfg, dataset, x_init=None):
    """Evaluates each test sequence of ``cfg.subjects_test`` that the data
    holds, in order, with ``unit_scale=1.0`` (3DHP poses are natively mm).
    Returns ({sequence: (predictions [N, 17, 3] mm, masked ground
    truth)}, {e1, e2, e3, ev: one value a sequence}, frames/s a sequence).
    ``x_init``: (sequence, batch index) -> x_T, for tests that inject
    another sampler's draws."""
    from diff3dhpe_torch.data.dataset import PoseDataset3DHP

    out = {}
    errors = {k: [] for k in ("e1", "e2", "e3", "ev")}
    speeds = []
    for seq_name in cfg.subjects_test.split(","):
        if seq_name not in dataset._test.poses_3d:
            continue
        seq_ds = PoseDataset3DHP(
            cfg, dataset._test, dataset._pos_3d_min, dataset._pos_3d_max,
            split="test", noise_std=cfg.test_extra_noise_std,
            joint_drop_rate=cfg.test_joint_drop, seq_filter=seq_name,
        )
        draws = None if x_init is None else (lambda i, s=seq_name: x_init(s, i))
        m = runner.evaluate(seq_ds, action=seq_name, unit_scale=1.0, x_init=draws)
        for k in errors:
            errors[k].append(m[k])
        speeds.append(m["frames_per_sec"])
        out[seq_name] = (m["predictions"], _masked_gt(seq_ds))
    return out, errors, speeds


def pck_auc(pred, gt):
    """PCK@150 mm and AUC (%) of [N, J, 3] mm predictions, as floats."""
    from diff3dhpe_torch.metrics import auc, pck

    pred, gt = torch.as_tensor(pred), torch.as_tensor(gt)
    return float(pck(pred, gt, threshold=150.0)), float(auc(pred, gt))


def _masked_gt(seq_ds):
    """Ground truth frames in the same order/mask the runner's predictions
    use (batches of windows, target-mask filtered)."""
    gts = []
    for b in seq_ds.batches(batch_size=512):
        mask = (b.target_mask & b.row_mask[:, None]).reshape(-1)
        gts.append(b.gt_3d.reshape(-1, b.gt_3d.shape[-2], 3)[mask])
    return np.concatenate(gts)


if __name__ == "__main__":
    main()
