"""Synthetic pose data for tests and benchmarks.

Generates smooth random-walk 3D joint trajectories in world space with
plausible scale, projects them through real H3.6M camera models to GT 2D
keypoints, and packages everything in the same npz-dict layout the real
loaders consume — so the full pipeline (camera transforms, chunking,
normalisation, training, eval) runs end-to-end without the (licensed,
non-redistributable) H3.6M data.
"""
from __future__ import annotations

import copy

import numpy as np

from diff3dhpe_torch.data.h36m import build_h36m_cameras, h36m_skeleton
from diff3dhpe_torch.data.mocap import MocapDataset
from diff3dhpe_torch.geometry.camera import (
    image_coordinates,
    project_to_2d,
    world_to_camera,
)


def _random_walk_poses(rng, n_frames, n_joints=17):
    """Smooth world-space poses around the S1 capture volume (~m units).

    NOTE: per-joint walks are UNLEARNABLE as a 2D->3D lifting task — depth
    has no pose prior to be inferred from, so a converged model stalls near
    the ~1 m depth spread. Use them
    for pipeline/shape coverage; use motion="latent" where the evidence
    needs a model that actually learns (accuracy gating, convergence
    studies)."""
    base = rng.normal(0.0, 0.4, (n_joints, 3)).astype(np.float64)
    base[:, 2] += 1.0  # above ground
    steps = rng.normal(0.0, 0.01, (n_frames, n_joints, 3))
    walk = np.cumsum(steps, axis=0)
    drift = rng.normal(0.0, 0.002, (n_frames, 1, 3)).cumsum(axis=0)
    return (base[None] + walk + drift).astype(np.float32)


def _make_pose_manifold(rng, n_joints=17, latent_dim=8):
    """Fixed low-dimensional pose manifold: a global mean pose plus a
    latent->pose linear decoder, shared by every sequence in the dataset —
    the synthetic analogue of the anthropometric prior that makes monocular
    depth inferable on real mocap. Each basis direction is unit-Frobenius."""
    mean = rng.normal(0.0, 0.25, (n_joints, 3))
    mean[:, 2] += 1.0  # above ground
    w = rng.normal(0.0, 1.0, (latent_dim, n_joints, 3))
    w /= np.linalg.norm(w.reshape(latent_dim, -1), axis=1).reshape(-1, 1, 1)
    return mean, w


def _latent_motion_poses(rng, n_frames, mean, w, amp=0.3):
    """LEARNABLE smooth motion: a bounded sinusoid-mixture latent trajectory
    decoded through the fixed manifold. The 2D projection of 17 joints
    overdetermines the ~8 latent coordinates, so the 3D pose (including
    depth) is exactly recoverable from one camera's 2D — a converged lifter
    lands at tens of mm, giving an accuracy gate a meaningful operating
    point."""
    latent_dim = w.shape[0]
    t = np.arange(n_frames, dtype=np.float64)[:, None]
    # 2-3 sinusoids per latent dim with random freq/phase/amplitude.
    z = np.zeros((n_frames, latent_dim))
    for _ in range(3):
        freqs = rng.uniform(0.004, 0.06, (1, latent_dim)) * 2 * np.pi
        phases = rng.uniform(0.0, 2 * np.pi, (1, latent_dim))
        amps = rng.uniform(0.2, 1.0, (1, latent_dim))
        z += np.sin(freqs * t + phases) * amps
    z *= amp / np.sqrt(3.0)
    poses = mean[None] + np.einsum("tk,kjc->tjc", z, w)
    return poses.astype(np.float32)


class SyntheticH36MDataset(MocapDataset):
    """Drop-in Human36mDataset substitute backed by synthetic motion."""

    def __init__(self, subjects=("S1", "S5", "S9"), actions=("Walking 1", "Posing 1"),
                 n_frames=150, seed=0, n_joints=17, motion="walk"):
        # 17-joint skeleton = reference skeleton after static-joint removal.
        skel = copy.deepcopy(h36m_skeleton)
        skel.remove_joints([4, 5, 9, 10, 11, 16, 20, 21, 22, 23, 24, 28, 29, 30, 31])
        skel._parents[11] = 8
        skel._parents[14] = 8
        super().__init__(fps=50, skeleton=skel)

        rng = np.random.default_rng(seed)
        self._cameras = build_h36m_cameras()
        self._data = {}
        all_pos_3d = []
        # motion="latent": every sequence rides ONE fixed low-dim manifold
        # (drawn once here), so 2D->3D lifting is learnable; "walk" keeps the
        # unstructured per-joint walks for pipeline/shape coverage.
        manifold = _make_pose_manifold(rng, n_joints) if motion == "latent" else None
        if motion == "latent":
            # Share ONE camera set across subjects: per-subject extrinsic
            # differences make the camera-space manifold differ between the
            # train and test subjects, which bounds ANY model at ~100 mm on
            # this linear-manifold task (measured with a quadratic-feature
            # regression probe). With shared cameras the held-out floor is
            # exactly 0 mm, so a converged model's MPJPE measures the model,
            # not a synthetic-geometry artefact.
            shared = self._cameras[subjects[0] if subjects[0] in self._cameras else "S1"]
            self._cameras = {s: shared for s in self._cameras}
        for subject in subjects:
            self._data[subject] = {}
            for action in actions:
                if motion == "latent":
                    positions = _latent_motion_poses(rng, n_frames, *manifold)
                else:
                    positions = _random_walk_poses(rng, n_frames, n_joints)
                self._data[subject][action] = {
                    "positions": positions,
                    "cameras": self._cameras[subject],
                }
                for cam in self._cameras[subject]:
                    pos_3d = world_to_camera(positions, R=cam["orientation"], t=cam["translation"])
                    all_pos_3d.append(pos_3d)

        all_pos_3d = np.concatenate(all_pos_3d, axis=0)
        centred = all_pos_3d - all_pos_3d[:, :1]
        self._pos_3d_min = centred.min()
        self._pos_3d_max = centred.max()
        self._w_mpjpe = None


def make_synthetic_h36m_like(subjects=("S1", "S5", "S9"), actions=("Walking 1", "Posing 1"),
                             n_frames=150, seed=0, motion="walk"):
    """Returns (dataset, keypoints_data) where keypoints_data mimics the
    data_2d_*.npz archive (projected GT 2D in pixel coordinates + metadata).
    ``motion="latent"`` generates LEARNABLE manifold motion (converged MPJPE
    lands at tens of mm) for accuracy gating and convergence studies."""
    dataset = SyntheticH36MDataset(subjects, actions, n_frames, seed, motion=motion)

    positions_2d = {}
    for subject in subjects:
        positions_2d[subject] = {}
        for action in dataset[subject].keys():
            anim = dataset[subject][action]
            kps_all = []
            for cam in anim["cameras"]:
                pos_3d = world_to_camera(
                    anim["positions"], R=cam["orientation"], t=cam["translation"]
                )
                pos_2d = project_to_2d(pos_3d[None], cam["intrinsic"][None])[0]
                # Store pixel coordinates — the same contract as the real
                # data_2d_*.npz archive (prepare_data_h36m.py:122-147 writes
                # image_coordinates output); PoseDataset screen-normalises.
                pos_2d_pixel = image_coordinates(pos_2d, w=cam["res_w"], h=cam["res_h"])
                kps_all.append(pos_2d_pixel.astype(np.float32))
            positions_2d[subject][action] = kps_all

    keypoints_data = {
        "positions_2d": positions_2d,
        "metadata": {
            "num_joints": 17,
            "keypoints_symmetry": [
                list(dataset.skeleton().joints_left()),
                list(dataset.skeleton().joints_right()),
            ],
        },
    }
    return dataset, keypoints_data


def make_synthetic_humaneva(subjects=("Train/S1", "Validate/S1"),
                            actions=("Walking 1", "Jog 1"),
                            n_frames=120, seed=0):
    """Synthetic HumanEva-shaped dataset: world-space 15-joint walks plus
    GT 2D keypoints projected through the real HumanEva cameras. Returns
    (dataset, keypoints_data) like make_synthetic_h36m_like."""
    from diff3dhpe_torch.data.humaneva import HumanEvaDataset

    rng = np.random.default_rng(seed)
    positions_3d = {}
    for subject in subjects:
        positions_3d[subject] = {
            action: _random_walk_poses(rng, n_frames, n_joints=15)
            for action in actions
        }
    dataset = HumanEvaDataset(data=positions_3d)

    positions_2d = {}
    for subject in subjects:
        positions_2d[subject] = {}
        for action in dataset[subject].keys():
            anim = dataset[subject][action]
            kps_all = []
            for cam in anim["cameras"]:
                pos_3d = world_to_camera(
                    anim["positions"], R=cam["orientation"], t=cam["translation"]
                )
                pos_2d = project_to_2d(pos_3d[None], cam["intrinsic"][None])[0]
                pos_2d_pixel = image_coordinates(pos_2d, w=cam["res_w"], h=cam["res_h"])
                kps_all.append(pos_2d_pixel.astype(np.float32))
            positions_2d[subject][action] = kps_all

    keypoints_data = {
        "positions_2d": positions_2d,
        "metadata": {
            "num_joints": 15,
            "keypoints_symmetry": [
                list(dataset.skeleton().joints_left()),
                list(dataset.skeleton().joints_right()),
            ],
        },
    }
    return dataset, keypoints_data


class _SynthSplit:
    """Duck-typed Base3DHPSplit carrying synthetic sequences."""

    def __init__(self, poses_3d, poses_2d, valid_frame=None):
        from diff3dhpe_torch.data.mpiinf3dhp import (
            JOINTS_LEFT,
            JOINTS_RIGHT,
            KPS_LEFT,
            KPS_RIGHT,
            NUM_JOINTS,
        )

        self.poses_3d = poses_3d
        self.poses_2d = poses_2d
        self.valid_frame = valid_frame
        self.kps_left, self.kps_right = KPS_LEFT, KPS_RIGHT
        self.joints_left, self.joints_right = JOINTS_LEFT, JOINTS_RIGHT
        self.num_joints = NUM_JOINTS
        cat = np.concatenate(list(poses_3d.values()))
        self.pos_3d_min = cat.min()
        self.pos_3d_max = cat.max()


class _Synth3DHP:
    def __init__(self, train, test):
        self._train = train
        self._test = test
        self._pos_3d_min = min(train.pos_3d_min, test.pos_3d_min)
        self._pos_3d_max = max(train.pos_3d_max, test.pos_3d_max)


def make_synthetic_3dhp(subjects_train=("S1",), subjects_test=("TS1", "TS2"),
                        n_frames=100, seed=0):
    """Synthetic MPI-INF-3DHP-shaped dataset (mm units, root joint 14)."""
    rng = np.random.default_rng(seed)

    def gen(n):
        pose = _random_walk_poses(rng, n) * 1000.0  # metres -> mm
        pose = pose - pose[:, 14:15]
        pose2d = pose[..., :2] / 2048.0  # already-normalised-looking 2D
        return pose.astype(np.float32), pose2d.astype(np.float32)

    train_3d, train_2d = {}, {}
    for s in subjects_train:
        for cam in (0, 1):
            p3, p2 = gen(n_frames)
            train_3d[(s, "Seq1", cam)] = p3
            train_2d[(s, "Seq1", cam)] = p2

    test_3d, test_2d, valid = {}, {}, {}
    for ts in subjects_test:
        p3, p2 = gen(n_frames)
        test_3d[ts] = p3
        test_2d[ts] = p2
        v = np.ones((n_frames, 1))
        v[: n_frames // 10] = 0  # some invalid frames, like the real TS files
        valid[ts] = v

    return _Synth3DHP(
        _SynthSplit(train_3d, train_2d),
        _SynthSplit(test_3d, test_2d, valid_frame=valid),
    )
