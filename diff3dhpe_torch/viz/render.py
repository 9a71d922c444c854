"""Host-side matplotlib rendering of poses, predictions, and diffusion chains.

Re-implementation of the reference's visualisation capabilities
(visualization_ani.py:71-338 animations; visualization_fig.py:35-125 static
figures): 2D keypoint animations, side-by-side GT vs reconstruction 3D
animations with per-frame MPJPE titles, forward/reverse diffusion chain
animations, and static snapshots of the reverse chain.

Animations are written with the Pillow GIF writer (this image has no
ffmpeg); pass ``writer='ffmpeg'`` for mp4 where available. All functions
take plain numpy arrays so the render layer has no model dependencies.

A copy of ``diff3dhpe_tpu/viz/render.py``, which imports no JAX: the port
imports nothing of the JAX package. matplotlib (and PIL or imageio for
``read_video``) is imported inside each function, so the package imports
where it is absent.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _import_mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _skeleton_lines(ax, pose, parents, joints_right, lw=2, dim=3, colors=("black", "red")):
    """Draw one pose (J, 2|3) as parent->child line segments."""
    artists = []
    for j, parent in enumerate(parents):
        if parent == -1:
            continue
        col = colors[1] if j in joints_right else colors[0]
        xs = [pose[j, 0], pose[parent, 0]]
        ys = [pose[j, 1], pose[parent, 1]]
        if dim == 3:
            zs = [pose[j, 2], pose[parent, 2]]
            (ln,) = ax.plot(xs, ys, zs, zdir="z", c=col, lw=lw)
        else:
            (ln,) = ax.plot(xs, ys, c=col, lw=lw)
        artists.append(ln)
    return artists


def _setup_3d_axis(ax, radius, title=None):
    ax.set_xlim3d([-radius / 2, radius / 2])
    ax.set_zlim3d([0, radius])
    ax.set_ylim3d([-radius / 2, radius / 2])
    try:
        ax.set_aspect("equal")
    except NotImplementedError:
        ax.set_aspect("auto")
    ax.view_init(elev=15.0, azim=70)
    ax.set_xticklabels([])
    ax.set_yticklabels([])
    ax.set_zticklabels([])
    ax.dist = 7.5
    if title:
        ax.set_title(title)


def render_2d_animation(
    keypoints: np.ndarray,
    parents: Sequence[int],
    joints_right: Sequence[int],
    out_path: str,
    fps: int = 25,
    limit: Optional[int] = None,
):
    """Animate 2D keypoints [F, J, 2] (pixel coordinates)."""
    plt = _import_mpl()
    from matplotlib.animation import FuncAnimation

    frames = keypoints.shape[0] if limit is None else min(limit, keypoints.shape[0])
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(1, 1, 1)
    ax.set_xlim(keypoints[..., 0].min(), keypoints[..., 0].max())
    ax.set_ylim(keypoints[..., 1].max(), keypoints[..., 1].min())  # image coords: y down
    ax.axis("off")

    state = {"artists": []}

    def update(i):
        for a in state["artists"]:
            a.remove()
        state["artists"] = _skeleton_lines(ax, keypoints[i], parents, joints_right, dim=2)
        return state["artists"]

    anim = FuncAnimation(fig, update, frames=frames, interval=1000 / fps, blit=False)
    anim.save(out_path, writer="pillow", fps=fps)
    plt.close(fig)
    return out_path


def render_3d_animation(
    gt: Optional[np.ndarray],
    prediction: np.ndarray,
    parents: Sequence[int],
    joints_right: Sequence[int],
    out_path: str,
    fps: int = 25,
    limit: Optional[int] = None,
    radius: float = 1.7,
    azim: float = 70.0,
):
    """Side-by-side GT vs reconstruction animation ([F, J, 3] world space)
    with per-frame MPJPE in the prediction panel title when GT is given."""
    plt = _import_mpl()
    from matplotlib.animation import FuncAnimation

    frames = prediction.shape[0] if limit is None else min(limit, prediction.shape[0])
    panels = [("Reconstruction", prediction)]
    if gt is not None:
        panels.insert(0, ("Ground truth", gt))

    fig = plt.figure(figsize=(4 * len(panels), 4))
    axes = []
    for i, (title, _) in enumerate(panels):
        ax = fig.add_subplot(1, len(panels), i + 1, projection="3d")
        _setup_3d_axis(ax, radius, title)
        ax.view_init(elev=15.0, azim=azim)
        axes.append(ax)

    state = {"artists": []}

    def update(i):
        for a in state["artists"]:
            a.remove()
        state["artists"] = []
        for ax, (title, data) in zip(axes, panels):
            pose = data[i] - data[i, :1] + np.array([0, 0, radius / 2])
            state["artists"] += _skeleton_lines(ax, pose, parents, joints_right, dim=3)
        if gt is not None:
            err = np.mean(np.linalg.norm(prediction[i] - gt[i], axis=-1)) * 1000
            axes[-1].set_title(f"Reconstruction ({err:.1f} mm)")
        return state["artists"]

    anim = FuncAnimation(fig, update, frames=frames, interval=1000 / fps, blit=False)
    anim.save(out_path, writer="pillow", fps=fps)
    plt.close(fig)
    return out_path


def render_chain_animation(
    chain: np.ndarray,
    parents: Sequence[int],
    joints_right: Sequence[int],
    out_path: str,
    frame_index: int = 0,
    fps: int = 4,
    radius: float = 1.7,
    titles: Optional[Sequence[str]] = None,
):
    """Animate a diffusion chain [F, J, 3, num_steps] for one frame index:
    each animation step is one diffusion step (forward chain from
    get_noisy_pose or reverse chain from ddim collect_chain)."""
    plt = _import_mpl()
    from matplotlib.animation import FuncAnimation

    steps = chain.shape[-1]
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(1, 1, 1, projection="3d")
    _setup_3d_axis(ax, radius)

    state = {"artists": []}

    def update(s):
        for a in state["artists"]:
            a.remove()
        pose = chain[frame_index, :, :, s]
        pose = pose - pose[:1] + np.array([0, 0, radius / 2])
        state["artists"] = _skeleton_lines(ax, pose, parents, joints_right, dim=3)
        ax.set_title(titles[s] if titles else f"step {s}")
        return state["artists"]

    anim = FuncAnimation(fig, update, frames=steps, interval=1000 / fps, blit=False)
    anim.save(out_path, writer="pillow", fps=fps)
    plt.close(fig)
    return out_path


def render_2d_figs(
    keypoints: np.ndarray,
    parents: Sequence[int],
    joints_right: Sequence[int],
    out_path: str,
    frame_indices: Sequence[int],
):
    """Static multi-panel 2D keypoint snapshots (reference render_2d_figs)."""
    plt = _import_mpl()

    n = len(frame_indices)
    fig, axes = plt.subplots(1, n, figsize=(3 * n, 3))
    axes = np.atleast_1d(axes)
    for ax, i in zip(axes, frame_indices):
        ax.set_xlim(keypoints[..., 0].min(), keypoints[..., 0].max())
        ax.set_ylim(keypoints[..., 1].max(), keypoints[..., 1].min())
        ax.axis("off")
        _skeleton_lines(ax, keypoints[i], parents, joints_right, dim=2)
        ax.set_title(f"frame {i}")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def render_3d_figs(
    poses: np.ndarray,
    parents: Sequence[int],
    joints_right: Sequence[int],
    out_path: str,
    step_indices: Sequence[int],
    frame_index: int = 0,
    radius: float = 1.7,
    titles: Optional[Sequence[str]] = None,
):
    """Static snapshots of a diffusion chain [F, J, 3, S] at chosen steps
    (reference render_3d_figs: start/middle/end of the reverse chain)."""
    plt = _import_mpl()

    n = len(step_indices)
    fig = plt.figure(figsize=(3 * n, 3))
    for k, s in enumerate(step_indices):
        ax = fig.add_subplot(1, n, k + 1, projection="3d")
        _setup_3d_axis(ax, radius, titles[k] if titles else f"step {s}")
        pose = poses[frame_index, :, :, s]
        pose = pose - pose[:1] + np.array([0, 0, radius / 2])
        _skeleton_lines(ax, pose, parents, joints_right, dim=3)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def read_video(path: str, limit: Optional[int] = None, skip: int = 0) -> np.ndarray:
    """Decode video frames to [T, H, W, 3] uint8.

    Equivalent of the reference's ffmpeg-pipe reader (visualization_ani.py
    read_video:44-63) for an image without ffmpeg: accepts a directory of
    image frames (sorted by name), an animated GIF (Pillow), or — when an
    imageio plugin that can handle the container is installed — any
    imageio-readable file.
    """
    import os

    frames = []

    def push(img) -> bool:
        frames.append(np.asarray(img, dtype=np.uint8))
        return limit is not None and len(frames) >= limit

    if os.path.isdir(path):
        from PIL import Image

        names = sorted(
            f for f in os.listdir(path)
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
        )
        for name in names[skip:]:
            with Image.open(os.path.join(path, name)) as im:
                if push(im.convert("RGB")):
                    break
    elif path.lower().endswith(".gif"):
        from PIL import Image, ImageSequence

        with Image.open(path) as im:
            for i, frame in enumerate(ImageSequence.Iterator(im)):
                if i < skip:
                    continue
                if push(frame.convert("RGB")):
                    break
    else:
        import imageio.v3 as iio  # may lack an ffmpeg plugin for mp4

        for i, frame in enumerate(iio.imiter(path)):
            if i < skip:
                continue
            if push(frame[..., :3]):
                break
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def render_video_overlay(
    frames: np.ndarray,
    keypoints: np.ndarray,
    parents: Sequence[int],
    joints_right: Sequence[int],
    out_path: str,
    prediction: Optional[np.ndarray] = None,
    gt: Optional[np.ndarray] = None,
    fps: int = 25,
    radius: float = 1.7,
    azim: float = 70.0,
):
    """Pose-over-footage animation (reference render_animation:71-228).

    Left panel: the video frame with the 2D skeleton drawn over it
    (``keypoints`` [F, J, 2] in pixel coordinates). Optional 3D panels for
    the ground truth and for the reconstruction; ``prediction`` may be
    [F, J, 3] (one panel) or [H, F, J, 3] (one panel per hypothesis — the
    reference's `-b 4` multi-hypothesis flow, README:79).
    """
    plt = _import_mpl()
    from matplotlib.animation import FuncAnimation

    n_frames = min(frames.shape[0], keypoints.shape[0])
    preds = None
    if prediction is not None:
        preds = prediction if prediction.ndim == 4 else prediction[None]
        n_frames = min(n_frames, preds.shape[1])
    if gt is not None:
        n_frames = min(n_frames, gt.shape[0])

    panels_3d = ([] if gt is None else [("Ground truth", gt)]) + (
        []
        if preds is None
        else [
            (f"Hypothesis {h + 1}" if preds.shape[0] > 1 else "Reconstruction", preds[h])
            for h in range(preds.shape[0])
        ]
    )
    n_panels = 1 + len(panels_3d)

    fig = plt.figure(figsize=(4 * n_panels, 4))
    ax_vid = fig.add_subplot(1, n_panels, 1)
    ax_vid.axis("off")
    ax_vid.set_title("Input")
    im = ax_vid.imshow(frames[0])
    axes_3d = []
    for i, (title, _) in enumerate(panels_3d):
        ax = fig.add_subplot(1, n_panels, i + 2, projection="3d")
        _setup_3d_axis(ax, radius, title)
        ax.view_init(elev=15.0, azim=azim)
        axes_3d.append(ax)

    state = {"artists": []}

    def update(i):
        for a in state["artists"]:
            a.remove()
        state["artists"] = []
        im.set_data(frames[i])
        state["artists"] += _skeleton_lines(
            ax_vid, keypoints[i], parents, joints_right, dim=2, colors=("yellow", "red")
        )
        for ax, (title, data) in zip(axes_3d, panels_3d):
            pose = data[i] - data[i, :1] + np.array([0, 0, radius / 2])
            state["artists"] += _skeleton_lines(ax, pose, parents, joints_right, dim=3)
            if gt is not None and title != "Ground truth":
                err = np.mean(np.linalg.norm(data[i] - gt[i], axis=-1)) * 1000
                ax.set_title(f"{title} ({err:.1f} mm)")
        return state["artists"]

    anim = FuncAnimation(fig, update, frames=n_frames, interval=1000 / fps, blit=False)
    anim.save(out_path, writer="pillow", fps=fps)
    plt.close(fig)
    return out_path


def render_hypotheses_animation(
    gt: Optional[np.ndarray],
    hypotheses: np.ndarray,
    parents: Sequence[int],
    joints_right: Sequence[int],
    out_path: str,
    fps: int = 25,
    limit: Optional[int] = None,
    radius: float = 1.7,
    azim: float = 70.0,
):
    """Multi-hypothesis 3D animation: one panel per hypothesis [H, F, J, 3]
    plus their mean, each with per-frame MPJPE vs GT when given."""
    plt = _import_mpl()
    from matplotlib.animation import FuncAnimation

    h, f = hypotheses.shape[:2]
    frames = f if limit is None else min(limit, f)
    panels = [(f"Hypothesis {i + 1}", hypotheses[i]) for i in range(h)]
    panels.append(("Mean", hypotheses.mean(axis=0)))
    if gt is not None:
        panels.insert(0, ("Ground truth", gt))

    fig = plt.figure(figsize=(3 * len(panels), 3))
    axes = []
    for i, (title, _) in enumerate(panels):
        ax = fig.add_subplot(1, len(panels), i + 1, projection="3d")
        _setup_3d_axis(ax, radius, title)
        ax.view_init(elev=15.0, azim=azim)
        axes.append(ax)

    state = {"artists": []}

    def update(i):
        for a in state["artists"]:
            a.remove()
        state["artists"] = []
        for ax, (title, data) in zip(axes, panels):
            pose = data[i] - data[i, :1] + np.array([0, 0, radius / 2])
            state["artists"] += _skeleton_lines(ax, pose, parents, joints_right, dim=3)
            if gt is not None and title != "Ground truth":
                err = np.mean(np.linalg.norm(data[i] - gt[i], axis=-1)) * 1000
                ax.set_title(f"{title} ({err:.1f} mm)")
        return state["artists"]

    anim = FuncAnimation(fig, update, frames=frames, interval=1000 / fps, blit=False)
    anim.save(out_path, writer="pillow", fps=fps)
    plt.close(fig)
    return out_path
