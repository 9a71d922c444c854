"""Serving-export entry point: serialize the flip-TTA DDIM eval step.

Port of ``diff3dhpe_tpu/cli/export.py``. One command turns a config and a
checkpoint into a ``torch.export`` artifact that a serving process replays
with ``io.export.restore_eval_step`` (see ``io/export.py``):

    python -m diff3dhpe_torch.cli.export \\
        --config configs/h36m_gt_s2s_...json \\
        --evaluate checkpoint/best_epoch \\
        --output serve/eval.pt2 --export-batch-size 16

Any config-override flag of ``cli.run`` works here too (e.g.
``--number-of-frames``, ``--fast-eval``). For datasets whose joint layout
is not derivable without the data archive (humaneva*, custom*), pass
``--export-num-joints/--export-joints-left/--export-joints-right``.

The artifact runs on the device it was exported on (the card, or the CPU
with ``main(argv, device="cpu")``) and on the other device types that
``--export-platforms cpu,cuda`` names (``restore_eval_step(path,
device=...)``); the list must name the export's own device type and holds
only "cpu" and "cuda" (a ValueError names the flag otherwise).
``--export-sharded`` exports the per-rank step of a run across processes
(``io.export``): run the command under ``torchrun --nproc-per-node N·M ...
--mesh-shape data:N,model:M`` (or ``data:N``), with
``--export-batch-size`` the global batch, which N must divide; rank 0
writes the file, which restores in a run of the same mesh shape. Under a
model axis M > 1 every rank gathers the whole weights first, and the step
runs the whole module on its data rank's B / N rows. Without
``--export-sharded`` a run of any mesh shape exports the one-process step.
"""
from __future__ import annotations

import sys


def _dataset_joints(dataset: str):
    """(num_joints, joints_left, joints_right) for archive-free datasets."""
    if dataset == "h36m":
        import copy

        from diff3dhpe_torch.data.h36m import h36m_skeleton

        sk = copy.deepcopy(h36m_skeleton)
        # Same 32->17 reduction as Human36mDataset (data/h36m.py:224); the
        # shoulder rewiring only edits parents, not the symmetry lists.
        sk.remove_joints([4, 5, 9, 10, 11, 16, 20, 21, 22, 23, 24, 28, 29, 30, 31])
        return sk.num_joints(), list(sk.joints_left()), list(sk.joints_right())
    if dataset == "3dhp":
        from diff3dhpe_torch.data.mpiinf3dhp import JOINTS_LEFT, JOINTS_RIGHT, NUM_JOINTS

        return NUM_JOINTS, list(JOINTS_LEFT), list(JOINTS_RIGHT)
    return None


def build_export_parser():
    from diff3dhpe_torch.cli.args import build_parser

    parser = build_parser()
    parser.add_argument("--output", required=True, metavar="PATH",
                        help="where to write the serialized artifact")
    parser.add_argument("--export-batch-size", type=int, default=None, metavar="N",
                        help="fixed batch shape baked into the artifact "
                             "(default: batch_size_eval)")
    parser.add_argument("--export-platforms", type=str, default=None, metavar="LIST",
                        help="comma-separated device types the artifact may be restored on, "
                             "'cpu' and 'cuda' (default: the export's device)")
    parser.add_argument("--export-sharded", action="store_true",
                        help="export the per-rank step of a run across processes (under "
                             "torchrun with --mesh-shape data:N or data:N,model:M) at the "
                             "global batch / N")
    parser.add_argument("--export-num-joints", type=int, default=None)
    parser.add_argument("--export-joints-left", type=str, default=None,
                        help="comma-separated joint indices")
    parser.add_argument("--export-joints-right", type=str, default=None)
    return parser


def main(argv=None, device="cuda"):
    """Exports the eval step of the config's eval mode on ``device``;
    returns the artifact's bytes (in a data-parallel run: rank 0's; the
    other ranks return None)."""
    from diff3dhpe_torch.parallel import entry_ranks

    with entry_ranks(device) as mesh:
        return _main(argv, device, mesh)


def _main(argv, device, mesh):
    from diff3dhpe_torch.cli.args import args_to_overrides
    from diff3dhpe_torch.config import load_config
    from diff3dhpe_torch.io.export import check_platforms

    args = build_export_parser().parse_args(argv)
    platforms = None
    if args.export_platforms is not None:
        platforms = check_platforms([p.strip() for p in args.export_platforms.split(",")
                                     if p.strip()], device, field="export_platforms")
    if args.export_sharded and mesh is None:
        raise ValueError("export_sharded=True exports the per-rank step of a run across "
                         "processes: run this command under torchrun --nproc-per-node N*M with "
                         "--mesh-shape data:N,model:M (or data:N)")
    cfg = load_config(args.config, args_to_overrides(args))

    from diff3dhpe_torch.cli.run import load_evaluated_weights
    from diff3dhpe_torch.engine.runner import Runner
    from diff3dhpe_torch.io.export import export_eval_step

    if args.export_num_joints is not None:
        meta = (
            args.export_num_joints,
            [int(s) for s in (args.export_joints_left or "").split(",") if s],
            [int(s) for s in (args.export_joints_right or "").split(",") if s],
        )
    else:
        meta = _dataset_joints(cfg.dataset)
        if meta is None:
            print(
                f"Dataset '{cfg.dataset}' needs its archive for the joint "
                "layout; pass --export-num-joints/--export-joints-left/"
                "--export-joints-right explicitly."
            )
            sys.exit(1)
    num_joints, joints_left, joints_right = meta

    runner = Runner(cfg, num_joints, joints_left, joints_right, device=device, mesh=mesh)
    if load_evaluated_weights(cfg, runner) is None:
        print("WARNING: exporting freshly-initialised weights "
              "(no --evaluate/--pretrained_model given)")

    batch = args.export_batch_size or cfg.batch_size_eval
    data = export_eval_step(runner, batch_size=batch, path=args.output,
                            sharded=args.export_sharded, platforms=platforms)
    if data is None:  # a data-parallel run's rank other than 0
        return None
    rows = batch * cfg.repeat_n * (2 if cfg.test_time_augmentation else 1)
    f_out = cfg.number_of_frames if cfg.out_all else 1
    sharded = (f", per rank {batch // runner.mesh.data_size} rows of {runner.world_size} ranks "
               f"({runner.mesh.shape})" if args.export_sharded else "")
    print(
        f"Exported eval step -> {args.output} ({len(data)} bytes): "
        f"eval(state_dict, x2d, x2d_flip, x_init{', noises' if cfg.ddim_sampling_eta else ''}) "
        f"with x2d [{batch}, {cfg.number_of_frames}, {num_joints}, 2] and x_init "
        f"[{rows}, {f_out}, {num_joints}, 3], device={runner.device}{sharded}"
    )
    return data


if __name__ == "__main__":
    main()
