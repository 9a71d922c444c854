"""Joint-tree topology metadata (reference: common/skeleton.py:12-90).

Host-side metadata only — drives left/right flips and rendering; never
on the device. The joint-removal semantics (rewire every parent pointer
past removed ancestors, then renumber densely) follow the VideoPose3D
lineage the reference inherits (CC-BY-4.0, (c) Facebook, Inc.), but are
implemented here as vectorised numpy fix-point/cumsum passes rather than
the original per-joint Python loops.
"""
from __future__ import annotations

import numpy as np


class Skeleton:
    """Parent-pointer tree over joints plus left/right symmetry lists."""

    def __init__(self, parents, joints_left, joints_right):
        assert len(joints_left) == len(joints_right)
        self._parents = np.asarray(parents, dtype=int).copy()
        self._joints_left = joints_left
        self._joints_right = joints_right
        self._refresh_children()

    # -- accessors -----------------------------------------------------
    def num_joints(self) -> int:
        return self._parents.size

    def parents(self) -> np.ndarray:
        return self._parents

    def has_children(self) -> np.ndarray:
        return self._has_children

    def children(self):
        return self._children

    def joints_left(self):
        return self._joints_left

    def joints_right(self):
        return self._joints_right

    # -- topology edit ---------------------------------------------------
    def remove_joints(self, joints_to_remove):
        """Drop joints, rewiring children to the nearest kept ancestor and
        renumbering the remainder densely.

        Returns the kept joint indices (original numbering) so callers can
        slice their per-joint arrays the same way.
        """
        removed = np.zeros(self.num_joints(), dtype=bool)
        removed[list(joints_to_remove)] = True

        # Fix-point: hop every parent pointer past removed ancestors until
        # all pointers land on kept joints (or the root sentinel -1).
        parents = self._parents.copy()
        pending = (parents >= 0) & removed[np.maximum(parents, 0)]
        while pending.any():
            parents[pending] = parents[parents[pending]]
            pending = (parents >= 0) & removed[np.maximum(parents, 0)]

        # Dense renumbering: old index i maps to i - (#removed <= i).
        shift = np.cumsum(removed)
        kept = np.flatnonzero(~removed)
        kept_parents = parents[kept]
        self._parents = np.where(
            kept_parents < 0,
            kept_parents,
            kept_parents - shift[np.maximum(kept_parents, 0)],
        ).astype(int)

        def renumber(joints):
            if joints is None:
                return None
            return [int(j - shift[j]) for j in joints if not removed[j]]

        self._joints_left = renumber(self._joints_left)
        self._joints_right = renumber(self._joints_right)
        self._refresh_children()
        return kept.tolist()

    def _refresh_children(self):
        p = self._parents
        self._has_children = np.zeros(p.size, dtype=bool)
        self._has_children[p[p >= 0]] = True
        self._children = [np.flatnonzero(p == i).tolist() for i in range(p.size)]
