"""MPI-INF-3DHP dataset (reference: common/mpiinf3dhp_dataset.py, which
descends from P-STMO's load_data_3dhp_mae.py, MIT licence).

Consumes the P-STMO preprocessed ``data_train_3dhp.npz`` /
``data_test_3dhp.npz`` archives. The numeric contract is fixed by parity:
root-centre on joint 14, screen-normalise 2D at 2048x2048 (train and
TS1-TS4) or 1920x1080 (TS5/TS6), and take the global 3D min/max over EVERY
sequence in both archives — selected subjects or not — for the scalar
normalisation (reference mpiinf3dhp_dataset.py:45-92,105-108).

Structure here is record-stream based: each archive is flattened to
(key, anim, resolution, valid) records by a per-schema iterator, and one
consumer builds the split from the stream.
"""
from __future__ import annotations

import os

import numpy as np

from diff3dhpe_torch.geometry.camera import normalize_screen_coordinates

KPS_LEFT = [5, 6, 7, 11, 12, 13]
KPS_RIGHT = [2, 3, 4, 8, 9, 10]
JOINTS_LEFT = KPS_LEFT
JOINTS_RIGHT = KPS_RIGHT
NUM_JOINTS = 17
ROOT_JOINT = 14

_TRAIN_RES = (2048, 2048)
_TEST_RES = {"TS5": (1920, 1080), "TS6": (1920, 1080)}


def _records(archive: dict, train: bool):
    """Flatten an archive to (key, subject, anim, (w, h), valid) records.

    Train schema: {"<subject> <seq>": [{cam: anim}]}, keyed by
    (subject, seq, cam). Test schema: {"TSn": anim}, keyed by the TS name,
    with a per-frame validity vector.
    """
    if train:
        for seq, recs in archive.items():
            subject, seq_name = seq.split(" ")
            for cam, anim in recs[0].items():
                yield (subject, seq_name, cam), subject, anim, _TRAIN_RES, None
    else:
        for seq, anim in archive.items():
            yield seq, seq, anim, _TEST_RES.get(seq, _TRAIN_RES), anim["valid"]


def _root_centred(data_3d: np.ndarray) -> np.ndarray:
    return (data_3d - data_3d[:, ROOT_JOINT : ROOT_JOINT + 1]).astype("float32")


class Base3DHPSplit:
    """One archive split: pose dicts keyed as the chunker expects, plus the
    archive-wide 3D extrema for the global scale."""

    kps_left, kps_right = KPS_LEFT, KPS_RIGHT
    joints_left, joints_right = JOINTS_LEFT, JOINTS_RIGHT
    num_joints = NUM_JOINTS

    def __init__(self, path: str, subjects_list, train: bool = True):
        archive = np.load(path, allow_pickle=True)["data"].item()
        self.subjects_list = list(subjects_list)

        self.poses_3d = {}
        self.poses_2d = {}
        self.valid_frame = None if train else {}
        lo, hi = np.inf, -np.inf

        for key, subject, anim, (w, h), valid in _records(archive, train):
            pose_3d = _root_centred(anim["data_3d"])
            lo = min(lo, float(pose_3d.min()))
            hi = max(hi, float(pose_3d.max()))
            if subject not in self.subjects_list:
                continue
            pose_2d = np.array(anim["data_2d"])  # normalise at source dtype,
            pose_2d[..., :2] = normalize_screen_coordinates(pose_2d[..., :2], w=w, h=h)
            self.poses_3d[key] = pose_3d
            self.poses_2d[key] = pose_2d.astype("float32")  # then cast (parity)
            if valid is not None:
                self.valid_frame[key] = valid

        self.pos_3d_min = lo
        self.pos_3d_max = hi


class MPIINF3DHPDataset:
    def __init__(self, subjects_train, subjects_test, root_path: str = "data"):
        if isinstance(subjects_train, str):
            subjects_train = subjects_train.split(",")
        if isinstance(subjects_test, str):
            subjects_test = subjects_test.split(",")
        self._train = Base3DHPSplit(
            os.path.join(root_path, "data_train_3dhp.npz"), subjects_train, train=True
        )
        self._test = Base3DHPSplit(
            os.path.join(root_path, "data_test_3dhp.npz"), subjects_test, train=False
        )
        self._pos_3d_min = min(self._train.pos_3d_min, self._test.pos_3d_min)
        self._pos_3d_max = max(self._train.pos_3d_max, self._test.pos_3d_max)
        self.kps_left, self.kps_right = KPS_LEFT, KPS_RIGHT
        self.joints_left, self.joints_right = JOINTS_LEFT, JOINTS_RIGHT
        self.num_joints = NUM_JOINTS
