"""Visualisation entry point. Port of ``diff3dhpe_tpu/cli/viz.py``.

Equivalent of the reference's visualization_ani.py / visualization_fig.py
drivers: for one (subject, action, camera), run the model with diffusion
introspection and render
- the input 2D keypoint animation,
- GT vs reconstruction 3D animation (world space, trajectory re-anchored,
  per-frame MPJPE in the title),
- the forward-diffusion chain (``get_noisy_pose``) animation,
- the reverse-diffusion chain (DDIM ``collect_chain``) animation,
- static snapshots of the reverse chain at start/middle/end steps,
- with ``repeat_n`` > 1 the hypotheses, and with ``--viz-video`` the
  poses over the footage.

JAX's entry point is split in two: ``compute`` does the model work on the
device (the card unless the caller asks for the CPU) and needs no
matplotlib; ``main`` renders its arrays on the host with ``viz.render``
(matplotlib, Pillow; GIF/PNG). Supports ``--synthetic``.
"""
from __future__ import annotations

import os

import numpy as np


def build_viz_parser():
    from diff3dhpe_torch.cli.args import build_parser

    parser = build_parser()
    parser.add_argument("--viz-subject", type=str, default=None)
    parser.add_argument("--viz-action", type=str, default=None)
    parser.add_argument("--viz-camera", type=int, default=0)
    parser.add_argument("--viz-output", type=str, default="viz_out")
    parser.add_argument("--viz-limit", type=int, default=60, help="frames to render")
    parser.add_argument("--viz-chain-samples", type=int, default=20,
                        help="forward-diffusion snapshots")
    parser.add_argument("--viz-video", type=str, default=None,
                        help="footage to overlay poses on: a frame directory, "
                             "GIF, or imageio-readable file")
    parser.add_argument("--viz-video-skip", type=int, default=0,
                        help="frames to skip at the start of the footage")
    return parser


def compute(cfg, args, device="cuda", draws=None) -> dict:
    """The model work of the visualisation, on ``device``: the sequence's
    predictions (``Runner.evaluate``), the forward chain of its first
    window's normalised ground truth (``get_noisy_pose``), the reverse DDIM
    chain of that window on the runner's module (``ddim_sample_loop(
    collect_chain=True)`` on ``runner.diffusion``, as JAX's :161-165) and,
    with ``repeat_n`` > 1, its hypotheses (``estimate_pose(reduce=False)``
    on ``runner.eval_diffusion``). ``args`` carries the ``--viz-*`` and
    ``--synthetic`` flags.

    The draws come from a ``torch.Generator`` seeded with ``cfg.seed`` on
    the device (the evaluation's from its own, as ``Runner.evaluate``
    draws them), in the order forward noise, reverse x_T, hypotheses' x_T,
    unless ``draws`` gives them: "forward_noise" [1, F, J, 3],
    "reverse_x_init" [1, F_out, J, 3], "hypotheses_x_init" [repeat_n,
    F_out, J, 3], "evaluate" (``Runner.evaluate``'s ``x_init``).

    Returns a dict of numpy arrays and what rendering needs: "runner",
    "window_2d" (the first window's 2D input on the device), "windows",
    "metrics", "predictions" [N, J, 3], "forward_chain" [F, J, 3, S] and
    "reverse_states", "reverse_x0" [F_out, J, 3, steps] (normalised),
    "hypotheses" [repeat_n, F_out, J, 3] (normalised) or None, "t_list",
    and the sequence: "scale", "gt_3d", "poses_2d", "positions_world",
    "camera", "parents", "joints_right"."""
    import torch

    from diff3dhpe_torch.cli.run import load_evaluated_weights
    from diff3dhpe_torch.data import Human36mDataset, PoseDataset, make_synthetic_h36m_like
    from diff3dhpe_torch.data.dataset import _WindowedPoseData
    from diff3dhpe_torch.engine.runner import Runner

    draws = draws or {}
    keypoints_data = None
    if args.synthetic:
        dataset, keypoints_data = make_synthetic_h36m_like(
            subjects=tuple(dict.fromkeys(
                cfg.subjects_train.split(",") + cfg.subjects_test.split(","))),
            n_frames=max(4 * cfg.number_of_frames, 100), seed=cfg.seed,
        )
    else:
        dataset = Human36mDataset(f"{cfg.data_root}/data_3d_{cfg.dataset}.npz")

    subject = args.viz_subject or cfg.subjects_test.split(",")[0]
    action = args.viz_action or next(iter(dataset[subject].keys()))
    cam_idx = args.viz_camera

    base = PoseDataset(
        cfg, dataset, cfg.data_root, "test", action_filter=[action.split(" ")[0]],
        keypoints_data=keypoints_data,
    )
    seq_key = (subject, action, cam_idx)
    if seq_key not in base.poses_2d:
        raise ValueError(f"{seq_key} is not in the test split")
    seq_ds = _WindowedPoseData(
        poses_2d={seq_key: base.poses_2d[seq_key]},
        poses_3d={seq_key: base.poses_3d[seq_key]},
        cameras={seq_key: base.cameras[seq_key]} if base.cameras else None,
        valid_frame=None,
        scale=base.scale,
        chunk_length=base.chunk_length,
        pad=base.pad,
        out_all=base.out_all,
        kps_left=base.kps_left, kps_right=base.kps_right,
        joints_left=base.joints_left, joints_right=base.joints_right,
        augment=False, test_aug=cfg.test_time_augmentation, train=False,
    )
    seq_ds.num_joints = base.num_joints

    runner = Runner(cfg, base.num_joints, base.joints_left, base.joints_right, device=device)
    load_evaluated_weights(cfg, runner)
    dev = runner.device
    as_dev = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.float32, device=dev)

    m = runner.evaluate(seq_ds, action=f"{subject}/{action}/cam{cam_idx}",
                        x_init=draws.get("evaluate"))

    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    item = seq_ds.get_item(0)
    x0 = as_dev(item["gt_3d_norm"])[None]
    fwd, t_list = runner.diffusion.get_noisy_pose(
        x0, num_sample=args.viz_chain_samples, noise=as_dev(draws.get("forward_noise")),
        generator=gen)
    x2d = as_dev(item["input_2d"])[None]
    x_rev = draws.get("reverse_x_init")
    if x_rev is None:
        x_rev = torch.randn(x0.shape, generator=gen, device=dev)
    _, states, x0_ests = runner.diffusion.ddim_sample_loop(
        x2d, tuple(x0.shape), x_init=as_dev(x_rev), collect_chain=True)
    hyps = None
    if cfg.repeat_n > 1:
        x_hyp = draws.get("hypotheses_x_init")
        if x_hyp is None:
            x_hyp = torch.randn((cfg.repeat_n,) + tuple(x0.shape[1:]), generator=gen, device=dev)
        hyps = runner.eval_diffusion.estimate_pose(
            x2d, tuple(x0.shape), repeat_n=cfg.repeat_n, x_init=as_dev(x_hyp), reduce=False,
        )[:, 0]
    host = lambda t: None if t is None else t.float().cpu().numpy()
    return dict(
        runner=runner, window_2d=x2d, windows=len(seq_ds.pairs), metrics=m,
        predictions=m["predictions"], forward_chain=host(fwd)[0], t_list=t_list,
        reverse_states=host(states)[0], reverse_x0=host(x0_ests)[0], hypotheses=host(hyps),
        scale=seq_ds.scale, gt_3d=base.poses_3d[seq_key], poses_2d=base.poses_2d[seq_key],
        positions_world=dataset[subject][action]["positions"],
        camera=dataset.cameras()[subject][cam_idx], parents=dataset.skeleton().parents(),
        joints_right=dataset.skeleton().joints_right(),
    )


def world_views(out, limit):
    """What the figures show, from ``compute``'s arrays, in JAX's order of
    steps: the first ``n`` frames (``limit`` at most) of the 2D input in
    pixels, of the ground truth and of the prediction in world space (the
    camera-space poses re-anchored on the sequence's root trajectory), and
    the hypotheses likewise (or None). Returns (n, kps_pix, gt_world,
    pred_world, hyps_world)."""
    from diff3dhpe_torch.geometry.camera import camera_to_world, image_coordinates, world_to_camera

    cam, pred = out["camera"], out["predictions"]
    rot, tr = cam["orientation"], cam["translation"]
    traj = world_to_camera(out["positions_world"], R=rot, t=tr)[:, :1]
    n = min(len(pred), len(traj), limit)
    gt_world = camera_to_world(out["gt_3d"][:n] + traj[:n], R=rot, t=tr)
    pred_world = camera_to_world(pred[:n] + traj[:n], R=rot, t=tr)
    kps_pix = image_coordinates(out["poses_2d"][:n].copy(), w=cam["res_w"], h=cam["res_h"])
    hyps_world = None
    if out["hypotheses"] is not None:
        hyps_cam = out["hypotheses"] * out["scale"]
        n_h = min(hyps_cam.shape[1], len(traj), limit)
        hyps_world = np.stack([camera_to_world(h[:n_h] + traj[:n_h], R=rot, t=tr)
                               for h in hyps_cam])
    return n, kps_pix, gt_world, pred_world, hyps_world


def render(out, args) -> list:
    """Writes JAX's files from ``compute``'s arrays into ``args.viz_output``
    (matplotlib; ``ImportError`` without it); returns their paths."""
    from diff3dhpe_torch.viz import (
        read_video,
        render_2d_animation,
        render_2d_figs,
        render_3d_animation,
        render_3d_figs,
        render_chain_animation,
        render_hypotheses_animation,
        render_video_overlay,
    )
    from diff3dhpe_torch.viz.render import _import_mpl

    _import_mpl()  # fail before any file is written
    os.makedirs(args.viz_output, exist_ok=True)
    path = lambda name: os.path.join(args.viz_output, name)
    parents, joints_right, scale = out["parents"], out["joints_right"], out["scale"]
    azim = out["camera"].get("azimuth", 70.0)
    n, kps_pix, gt_world, pred_world, hyps_world = world_views(out, args.viz_limit)
    outputs = [
        render_2d_animation(kps_pix, parents, joints_right, path("input_2d.gif")),
        render_3d_animation(gt_world, pred_world, parents, joints_right,
                            path("reconstruction_3d.gif"), azim=azim),
        render_2d_figs(kps_pix, parents, joints_right, path("input_2d_frames.png"),
                       frame_indices=[0, n // 2, n - 1]),
        render_chain_animation(out["forward_chain"] * scale, parents, joints_right,
                               path("forward_diffusion.gif"),
                               titles=[f"t={t}" for t in out["t_list"]]),
    ]
    rev = out["reverse_states"] * scale
    s = rev.shape[-1]
    outputs += [
        render_chain_animation(rev, parents, joints_right, path("reverse_diffusion.gif")),
        render_3d_figs(rev, parents, joints_right, path("reverse_diffusion_steps.png"),
                       step_indices=[0, s // 2, s - 1]),
    ]
    if hyps_world is not None:
        outputs.append(render_hypotheses_animation(
            gt_world[:hyps_world.shape[1]], hyps_world, parents, joints_right,
            path("hypotheses_3d.gif"), azim=azim))
    if args.viz_video:
        frames = read_video(args.viz_video, limit=n, skip=args.viz_video_skip)
        k = frames.shape[0]
        outputs.append(render_video_overlay(
            frames, kps_pix[:k], parents, joints_right, path("video_overlay.gif"),
            prediction=pred_world[:k], gt=gt_world[:k], azim=azim))
    return outputs


def main(argv=None, device="cuda"):
    """``compute`` on ``device``, then ``render``; returns the metrics."""
    from diff3dhpe_torch.cli.args import args_to_overrides
    from diff3dhpe_torch.config import load_config
    from diff3dhpe_torch.viz.render import _import_mpl

    args = build_viz_parser().parse_args(argv)
    cfg = load_config(args.config, args_to_overrides(args))
    _import_mpl()  # the model work is wasted where nothing can render it
    out = compute(cfg, args, device)
    print("Wrote:", ", ".join(render(out, args)))
    return out["metrics"]


if __name__ == "__main__":
    main()
