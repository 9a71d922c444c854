"""Mocap dataset base container (reference: common/mocap_dataset.py:11-44;
that file descends from VideoPose3D, CC-BY-4.0, (c) Facebook, Inc.).

A dataset is a skeleton + frame rate + a ``{subject: {action: seq}}`` tree
where each ``seq`` dict carries at least ``positions`` ([T, J, 3] world
coordinates) and ``cameras``; concrete loaders (h36m.py, synthetic.py) populate the tree in their constructors.
"""
from __future__ import annotations

from typing import Dict, Optional


class MocapDataset:
    def __init__(self, fps: float, skeleton):
        self._fps = fps
        self._skeleton = skeleton
        self._data: Optional[Dict] = None  # {subject: {action: seq-dict}}
        self._cameras: Optional[Dict] = None  # {subject: [camera-dict, ...]}

    # Subclasses read/write _data and _cameras directly; the public surface
    # below is what the data pipeline consumes.
    def __getitem__(self, subject):
        return self._data[subject]

    def __contains__(self, subject):
        return subject in self._data

    def subjects(self):
        return self._data.keys()

    def fps(self) -> float:
        return self._fps

    def skeleton(self):
        return self._skeleton

    def cameras(self):
        return self._cameras

    def supports_semi_supervised(self) -> bool:
        return False

    def remove_joints(self, joints_to_remove) -> None:
        """Reduce the skeleton and slice every sequence's ``positions`` to
        the kept joints (original-index order preserved)."""
        kept = self._skeleton.remove_joints(joints_to_remove)
        for actions in self._data.values():
            for seq in actions.values():
                if "positions" in seq:
                    seq["positions"] = seq["positions"][:, kept]
