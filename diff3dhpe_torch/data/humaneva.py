"""HumanEva-I dataset (reference: common/humaneva_dataset.py).

15-joint skeleton and the public HumanEva camera calibration (constants are
public calibration data, same values as the VideoPose3D lineage). Two fixes
over the reference, which ships a HumanEva path that cannot run:

- the reference never computes _pos_3d_min/_pos_3d_max, so its load_Dataset
  crashes (SURVEY.md 2.1 #14); we compute them like the H3.6M loader does;
- we also carry the intrinsic center/focal/distortion parameters so GT-2D
  projection works for synthetic/prepared archives.

Per-subject extrinsics (orientation quaternion + translation, mm -> m) are
attached to every camera dict, keyed under each of the archive's subject
prefixes (reference humaneva_dataset.py:42-110).
"""
from __future__ import annotations

import copy

import numpy as np

from diff3dhpe_torch.data.mocap import MocapDataset
from diff3dhpe_torch.geometry.camera import normalize_screen_coordinates, world_to_camera
from diff3dhpe_torch.geometry.skeleton import Skeleton

humaneva_skeleton = Skeleton(
    parents=[-1, 0, 1, 2, 3, 1, 5, 6, 0, 8, 9, 0, 11, 12, 1],
    joints_left=[2, 3, 4, 8, 9, 10],
    joints_right=[5, 6, 7, 11, 12, 13],
)

_CAMERAS_INTRINSIC = [
    {"id": "C1", "res_w": 640, "res_h": 480, "azimuth": 0,
     "center": [299.264884, 224.011557], "focal_length": [765.788214, 765.527418],
     "radial_distortion": [-0.288198, 0.099026, 0.0], "tangential_distortion": [0.001253, -0.000425]},
    {"id": "C2", "res_w": 640, "res_h": 480, "azimuth": -90,
     "center": [341.650227, 234.103088], "focal_length": [767.617322, 767.142609],
     "radial_distortion": [-0.282131, 0.082447, 0.0], "tangential_distortion": [-0.000483, -0.000695]},
    {"id": "C3", "res_w": 640, "res_h": 480, "azimuth": 90,
     "center": [320.217920, 244.382774], "focal_length": [764.727122, 764.045019],
     "radial_distortion": [-0.270482, 0.063358, 0.0], "tangential_distortion": [-0.001497, -0.000394]},
]

# Per-subject extrinsics (reference humaneva_dataset.py:42-91): world->camera
# orientation quaternion (w, x, y, z) and translation in millimetres.
_CAMERAS_EXTRINSIC = {
    "S1": [
        {"orientation": [0.424207, -0.4983646, -0.5802981, 0.4847012],
         "translation": [4062.227, 663.2477, 1528.397]},
        {"orientation": [0.6503354, -0.7481602, -0.0919284, 0.0941766],
         "translation": [844.8131, -3805.2092, 1504.9929]},
        {"orientation": [0.0664734, -0.0690535, 0.7416416, -0.6639132],
         "translation": [-797.67377, 3916.3174, 1433.6602]},
    ],
    "S2": [
        {"orientation": [0.4214752, -0.4961493, -0.5838273, 0.4851187],
         "translation": [4112.9121, 626.4929, 1545.2988]},
        {"orientation": [0.6501393, -0.7476588, -0.0954617, 0.0959808],
         "translation": [923.5740, -3877.9243, 1504.5518]},
        {"orientation": [0.0699353, -0.0712403, 0.7421637, -0.662742],
         "translation": [-781.4915, 3838.8853, 1444.9929]},
    ],
    "S3": [
        {"orientation": [0.424207, -0.4983646, -0.5802981, 0.4847012],
         "translation": [4062.2271, 663.2477, 1528.3970]},
        {"orientation": [0.6503354, -0.7481602, -0.0919284, 0.0941766],
         "translation": [844.8131, -3805.2092, 1504.9929]},
        {"orientation": [0.0664734, -0.0690535, 0.7416416, -0.6639132],
         "translation": [-797.6738, 3916.3174, 1433.6602]},
    ],
    "S4": [{}, {}, {}],
}

# The serialized archive keys subjects by split prefix (reference :105-110).
_SUBJECT_PREFIXES = ("Train/", "Validate/", "Unlabeled/Train/",
                     "Unlabeled/Validate/", "Unlabeled/")


def _build_subject_cameras():
    """Merged intrinsic+extrinsic camera dicts for every prefixed subject."""
    out = {}
    for subject, extrinsics in _CAMERAS_EXTRINSIC.items():
        cams = []
        for intr, extr in zip(copy.deepcopy(_CAMERAS_INTRINSIC), extrinsics):
            cam = dict(intr)
            for k, v in cam.items():
                if k not in ("id", "res_w", "res_h"):
                    cam[k] = np.array(v, dtype="float32")
            cam["center"] = normalize_screen_coordinates(
                cam["center"], w=cam["res_w"], h=cam["res_h"]
            ).astype("float32")
            cam["focal_length"] = cam["focal_length"] / cam["res_w"] * 2
            cam["intrinsic"] = np.concatenate(
                (cam["focal_length"], cam["center"],
                 cam["radial_distortion"], cam["tangential_distortion"])
            )
            if extr:
                cam["orientation"] = np.array(extr["orientation"], dtype="float32")
                cam["translation"] = (
                    np.array(extr["translation"], dtype="float32") / 1000.0  # mm -> m
                )
            cams.append(cam)
        for prefix in _SUBJECT_PREFIXES:
            out[prefix + subject] = cams
        out[subject] = cams  # bare subject names (synthetic archives)
    return out


class HumanEvaDataset(MocapDataset):
    def __init__(self, path=None, data=None):
        """``path``: a data_3d_humaneva*.npz archive with a positions_3d
        dict; or pass the dict directly via ``data`` (synthetic pipelines).
        """
        super().__init__(fps=60, skeleton=copy.deepcopy(humaneva_skeleton))

        subject_cameras = _build_subject_cameras()

        if data is None:
            data = np.load(path, allow_pickle=True)["positions_3d"].item()

        self._cameras = {}
        self._data = {}
        all_pos_3d = []
        for subject, actions in data.items():
            cameras = subject_cameras.get(subject)
            if cameras is None:
                raise KeyError(
                    f"Unknown HumanEva subject {subject!r}; expected one of "
                    f"{sorted(subject_cameras)}"
                )
            self._cameras[subject] = cameras
            self._data[subject] = {}
            for action_name, positions in actions.items():
                entry = {"cameras": cameras}
                if isinstance(positions, dict):
                    # Archive with precomputed per-camera positions.
                    entry.update(positions)
                else:
                    entry["positions"] = positions
                self._data[subject][action_name] = entry
                pos = entry.get("positions")
                if pos is not None:
                    for cam in cameras:
                        if "orientation" in cam:
                            pos_3d = world_to_camera(
                                pos, R=cam["orientation"], t=cam["translation"]
                            )
                        else:
                            pos_3d = pos
                        all_pos_3d.append(pos_3d)

        # Global scale extrema — the reference forgets these (its HumanEva
        # path would crash in load_Dataset); computed like H3.6M.
        if all_pos_3d:
            cat = np.concatenate(all_pos_3d, axis=0)
            centred = cat - cat[:, :1]
            self._pos_3d_min = centred.min()
            self._pos_3d_max = centred.max()
        else:
            self._pos_3d_min, self._pos_3d_max = -1.0, 1.0
        self._w_mpjpe = None
