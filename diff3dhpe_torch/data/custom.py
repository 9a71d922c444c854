"""Custom-video dataset: 2D-detections-only path for arbitrary footage
(reference: common/custom_dataset.py). Uses a dummy H3.6M-style camera and
no 3D ground truth; predictions are only qualitatively meaningful (for the
visualisation pipeline).
"""
from __future__ import annotations

import copy

import numpy as np

from diff3dhpe_torch.data.h36m import h36m_skeleton
from diff3dhpe_torch.data.mocap import MocapDataset

custom_camera_params = {
    "id": None,
    "res_w": None,
    "res_h": None,
    "azimuth": 70,
    "orientation": np.array(
        [0.1407056450843811, -0.1500701755285263, -0.755240797996521, 0.6223280429840088],
        dtype="float32",
    ),
    "translation": np.array([1.841107, 4.95528467, 1.56344543], dtype="float32"),
}


class CustomDataset(MocapDataset):
    def __init__(self, detections_path, remove_static_joints=True):
        skel = copy.deepcopy(h36m_skeleton)
        super().__init__(fps=None, skeleton=skel)

        data = np.load(detections_path, allow_pickle=True)
        resolutions = data["metadata"].item()["video_metadata"]

        self._cameras = {}
        self._data = {}
        for video_name, res in resolutions.items():
            cam = dict(custom_camera_params)
            cam["orientation"] = cam["orientation"].copy()
            cam["translation"] = cam["translation"].copy()
            cam["id"] = video_name
            cam["res_w"] = res["w"]
            cam["res_h"] = res["h"]
            self._cameras[video_name] = [cam]
            self._data[video_name] = {"custom": {"cameras": cam}}

        if remove_static_joints:
            self.remove_joints([4, 5, 9, 10, 11, 16, 20, 21, 22, 23, 24, 28, 29, 30, 31])
            self._skeleton._parents[11] = 8
            self._skeleton._parents[14] = 8

        # No 3D ground truth: a unit scale keeps the normalisation a no-op
        # (the reference leaves these unset and would crash; SURVEY.md 2.1 #15).
        self._pos_3d_min, self._pos_3d_max = -1.0, 1.0
        self._w_mpjpe = None

    def remove_joints(self, joints_to_remove):
        self._skeleton.remove_joints(joints_to_remove)

    def supports_semi_supervised(self):
        return False
