"""Dataset wrappers: windowed pose datasets + fixed-shape batch iteration.

Functional re-design of the reference's load_Dataset
(reference: data/load_noisy_data.py:20-291) on top of the immutable chunk
index in chunking.py. Differences by design:

- No torch DataLoader: windows are cheap numpy gathers; an in-process
  iterator assembles fixed-shape batches (the last eval batch is padded and
  row-masked instead of ragged, so every eval step sees one shape).
- Corruption noise (ablations) uses an explicit seeded np.random.Generator
  rather than the process-global RNG.
- The shuffle RNG state is exposed for checkpoint/resume (the reference
  pickles the generator's RandomState into its checkpoints, run.py:457).

- Sequence preparation is a PURE record stream (_sequence_records): one
  immutable SequenceRecord per (subject, action, camera), computed on
  copies. The reference's two-phase prepare/fetch (load_noisy_data.py:
  115-230, derived from VideoPose3D's fetch loops, MIT licence) mutates the
  dataset and keypoint dicts in place; a direct port of that
  double-normalised the val split's 2D inputs when splits shared one
  injected archive. The per-sequence operation ORDER (truncate-then-
  normalise, subset/downsample arithmetic, deterministic_random offsets)
  stays parity-pinned and is tested bit-exactly via tests/test_chunking.py
  + tests/test_datasets.py.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np

from diff3dhpe_torch.data.chunking import (
    ChunkSpec,
    build_seq2frame_chunks,
    build_seq2seq_chunks,
    materialize_window,
)
from diff3dhpe_torch.geometry.camera import normalize_screen_coordinates, world_to_camera
from diff3dhpe_torch.utils.misc import deterministic_random


@dataclasses.dataclass
class Batch:
    """One fixed-shape batch. row_mask marks real (non-padding) rows."""

    gt_3d: np.ndarray  # [B, F_out, J, 3] unnormalised (metres / mm)
    gt_3d_norm: np.ndarray  # [B, F_out, J, 3] divided by the global scale
    input_2d: np.ndarray  # [B, F_in, J, 2]
    input_2d_flip: Optional[np.ndarray]  # test-time-augmentation copy
    target_mask: np.ndarray  # [B, F_out] bool
    row_mask: np.ndarray  # [B] bool
    cam: Optional[np.ndarray]  # [B, 9]
    keys: List  # per-row sequence keys

    @property
    def size(self) -> int:
        return self.gt_3d.shape[0]


class _WindowedPoseData:
    """Shared core: chunk index + window materialisation + batching."""

    def __init__(
        self,
        *,
        poses_2d: Dict,
        poses_3d: Dict,
        cameras: Optional[Dict],
        valid_frame: Optional[Dict],
        scale: float,
        chunk_length: int,
        pad: int,
        out_all: bool,
        kps_left: Sequence[int],
        kps_right: Sequence[int],
        joints_left: Sequence[int],
        joints_right: Sequence[int],
        augment: bool,
        reverse_aug: bool = False,
        test_aug: bool = False,
        train: bool = True,
        noise_std: float = 0.0,
        joint_drop_rate: float = 0.0,
        corruption_seed: int = 0,
    ):
        self.poses_2d = poses_2d
        self.poses_3d = poses_3d
        self.cameras = cameras
        self.valid_frame = valid_frame
        self.scale = scale
        self.chunk_length = chunk_length
        self.pad = pad
        self.out_all = out_all
        self.kps_left, self.kps_right = list(kps_left), list(kps_right)
        self.joints_left, self.joints_right = list(joints_left), list(joints_right)
        self.test_aug = test_aug
        self.train = train
        self.noise_std = noise_std
        self.joint_drop_rate = joint_drop_rate
        self._corrupt_rng = np.random.default_rng(corruption_seed)

        seq_lengths = {k: v.shape[0] for k, v in poses_2d.items()}
        build_chunks = build_seq2seq_chunks if out_all else build_seq2frame_chunks
        self.pairs: List[ChunkSpec] = build_chunks(
            seq_lengths, chunk_length, augment=augment, reverse_aug=reverse_aug
        )
        self.shuffle_rng = np.random.default_rng(1234)

    # -- single-window access ------------------------------------------------
    def __len__(self):
        return len(self.pairs)

    def num_frames(self):
        return len(self.pairs)

    def norm_3d_pose(self, gt_3d):
        return gt_3d / self.scale

    def reverse_norm_3d_pose(self, predicted):
        return predicted * self.scale

    def _window(self, spec: ChunkSpec, flip_override: Optional[bool] = None):
        if flip_override is not None:
            spec = dataclasses.replace(spec, flip=flip_override, reverse=False)
        return materialize_window(
            spec,
            self.poses_2d[spec.key],
            self.poses_3d[spec.key] if self.poses_3d is not None else None,
            pad=self.pad,
            chunk_length=self.chunk_length,
            out_all=self.out_all,
            kps_left=self.kps_left,
            kps_right=self.kps_right,
            joints_left=self.joints_left,
            joints_right=self.joints_right,
            camera=self.cameras.get(spec.key) if self.cameras else None,
            valid_frame=self.valid_frame.get(spec.key) if self.valid_frame else None,
        )

    def _corrupt(self, input_2d: np.ndarray) -> np.ndarray:
        if self.noise_std > 0:
            input_2d = input_2d + self._corrupt_rng.normal(
                0.0, self.noise_std, input_2d.shape
            ).astype("float32")
        if self.joint_drop_rate > 0:
            keep = self._corrupt_rng.binomial(
                1, 1 - self.joint_drop_rate, input_2d.shape[:-1] + (1,)
            ).astype("float32")
            input_2d = input_2d * keep
        return input_2d

    def get_item(self, index: int) -> dict:
        spec = self.pairs[index]
        w = self._window(spec)
        gt_3d = w["gt_3d"]
        target_mask = w["target_mask"]
        if target_mask is None:
            target_mask = np.full(gt_3d.shape[0], True, dtype=bool)
        input_2d = self._corrupt(w["input_2d"].astype("float32"))
        item = {
            "cam": w["cam"],
            "gt_3d": gt_3d.astype("float32"),
            "gt_3d_norm": self.norm_3d_pose(gt_3d).astype("float32"),
            "input_2d": input_2d,
            "target_mask": target_mask,
            "key": spec.key,
        }
        if (not self.train) and self.test_aug:
            flip_w = self._window(spec, flip_override=True)
            item["input_2d_flip"] = self._corrupt(flip_w["input_2d"].astype("float32"))
        return item

    # -- batching -------------------------------------------------------------
    def batches(self, batch_size: int, shuffle: bool = False, drop_last: bool = False):
        """Yield fixed-shape Batch objects; the final partial batch is padded
        with repeated rows and row-masked (unless drop_last)."""
        order = np.arange(len(self.pairs))
        if shuffle:
            order = self.shuffle_rng.permutation(order)
        n = len(order)
        for start in range(0, n, batch_size):
            idx = order[start : start + batch_size]
            if len(idx) < batch_size:
                if drop_last:
                    return
                pad_n = batch_size - len(idx)
                idx = np.concatenate([idx, np.repeat(idx[-1:], pad_n)])
                row_mask = np.concatenate(
                    [np.ones(batch_size - pad_n, bool), np.zeros(pad_n, bool)]
                )
            else:
                row_mask = np.ones(batch_size, bool)

            items = [self.get_item(int(i)) for i in idx]
            has_flip = "input_2d_flip" in items[0]
            yield Batch(
                gt_3d=np.stack([it["gt_3d"] for it in items]),
                gt_3d_norm=np.stack([it["gt_3d_norm"] for it in items]),
                input_2d=np.stack([it["input_2d"] for it in items]),
                input_2d_flip=(
                    np.stack([it["input_2d_flip"] for it in items]) if has_flip else None
                ),
                target_mask=np.stack([it["target_mask"] for it in items]),
                row_mask=row_mask,
                cam=(
                    np.stack([it["cam"] for it in items])
                    if items[0]["cam"] is not None
                    else None
                ),
                keys=[it["key"] for it in items],
            )


@dataclasses.dataclass(frozen=True)
class SequenceRecord:
    """One processed (subject, action, camera) sequence, ready for the chunk
    index: screen-normalised 2D, camera-space root-centred 3D (None for
    2D-only footage), and the camera intrinsic vector (None if absent)."""

    key: tuple  # (subject, action, cam_idx)
    pose_2d: np.ndarray
    pose_3d: Optional[np.ndarray]
    camera: Optional[np.ndarray]


# Derived-data memo: world->camera conversion per (dataset, subject,
# action), weakly keyed on the dataset object so it dies with it. The
# removed prepare/fetch port cached this by WRITING anim["positions_3d"]
# into the input dataset; the memo keeps construction of the train/val/test
# split trio O(1 conversion) per sequence without mutating any input.
_CAM_SPACE_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _camera_space_poses(dataset, subject, action):
    """Root-centred camera-space 3D for each camera of one animation
    (reference prepare_data semantics), or None when the animation carries
    no mocap (2D-only custom footage). Precomputed per-camera lists
    (``positions_3d``) pass through so callers can inject viz-space poses."""
    anim = dataset[subject][action]
    if "positions_3d" in anim:
        return anim["positions_3d"]
    if "positions" not in anim:
        return None
    per_ds = _CAM_SPACE_CACHE.setdefault(dataset, {})
    key = (subject, action)
    if key not in per_ds:
        out = []
        for cam in anim["cameras"]:
            pos_3d = world_to_camera(
                anim["positions"], R=cam["orientation"], t=cam["translation"]
            )
            pos_3d = pos_3d - pos_3d[:, :1]
            # The memo is handed UNCOPIED to every split built over this
            # dataset (train/val/test share it); freezing it turns any
            # future in-place transform — the bug class the record-stream
            # rewrite removed for 2D — into an immediate error instead of
            # silent cross-split corruption.
            pos_3d.setflags(write=False)
            out.append(pos_3d)
        per_ds[key] = out
    return per_ds[key]


def _sequence_records(dataset, subjects, keypoints, action_filter):
    """Stream of SequenceRecords for the requested subjects.

    PURE over its inputs: `dataset` and `keypoints` are never written; the
    2D arrays are fresh copies and the memoized camera-space 3D arrays are
    shared read-only (frozen in _camera_space_poses). (A direct port of the
    reference's prepare/fetch phases screen-normalised the shared keypoint
    arrays in place, so constructing a second split over the same injected
    archive — exactly what the train/val pair does — silently normalised the
    val inputs twice, collapsing them to ~-1.) The per-sequence operation
    ORDER is parity-pinned to load_noisy_data.py:115-230: truncate the 2D
    track to the mocap length, then screen-normalise with that camera's
    resolution; camera-count/length asserts match the reference's.
    """
    for subject in subjects:
        assert subject in keypoints, f"Subject {subject} missing from 2D detections"
        missing = [a for a in dataset[subject] if a not in keypoints[subject]]
        assert not missing, (
            f"Actions {missing} of subject {subject} missing from 2D detections"
        )
        for action in keypoints[subject].keys():
            if action_filter is not None and not any(
                action.startswith(a) for a in action_filter
            ):
                continue
            kp_cams = keypoints[subject][action]
            poses_3d = _camera_space_poses(dataset, subject, action)
            if poses_3d is not None:
                assert len(poses_3d) == len(kp_cams), "Camera count mismatch"
            cams = dataset.cameras()[subject]
            assert len(cams) == len(kp_cams), "Camera count mismatch"
            for cam_idx, kp in enumerate(kp_cams):
                cam = cams[cam_idx]
                pose_3d = None
                if poses_3d is not None:
                    pose_3d = poses_3d[cam_idx]
                    assert kp.shape[0] >= pose_3d.shape[0], (
                        f"2D track shorter than mocap for {subject}/{action}"
                    )
                    kp = kp[: pose_3d.shape[0]]
                pose_2d = kp.copy()
                pose_2d[..., :2] = normalize_screen_coordinates(
                    pose_2d[..., :2], w=cam["res_w"], h=cam["res_h"]
                )
                yield SequenceRecord(
                    key=(subject, action, cam_idx),
                    pose_2d=pose_2d,
                    pose_3d=pose_3d,
                    camera=cam["intrinsic"] if "intrinsic" in cam else None,
                )


class PoseDataset(_WindowedPoseData):
    """H3.6M-style dataset wrapper (reference load_Dataset:20-291).

    Performs world->camera + root-centering, 2D screen normalisation, the
    global scalar 3D scale, and chunk-index construction for one split.
    """

    def __init__(
        self,
        opt,
        dataset,
        root_path: str,
        split: str = "train",
        action_filter: Optional[List[str]] = None,
        noise_std: float = 0.0,
        joint_drop_rate: float = 0.0,
        keypoints_data: Optional[dict] = None,
    ):
        self.split = split
        self.dataset_name = opt.dataset
        self.keypoints_name = opt.keypoints
        self.root_path = root_path

        train_list = opt.subjects_train.split(",")
        test_list = opt.subjects_test.split(",")
        if action_filter is None:
            self.action_filter = None if opt.actions == "*" else opt.actions.split(",")
        else:
            assert isinstance(action_filter, list)
            self.action_filter = action_filter

        self.downsample = opt.downsample
        self.subset = opt.subset
        receptive_field = opt.number_of_frames

        # Global scalar 3D normalisation (reference :44-53).
        scale = max(abs(float(dataset._pos_3d_max)), abs(float(dataset._pos_3d_min)))

        pad = 0 if opt.out_all else (receptive_field - 1) // 2
        subjects = train_list if split in ("train", "val") else test_list

        keypoints = self._load_keypoints(keypoints_data)
        self.joints_left = list(dataset.skeleton().joints_left())
        self.joints_right = list(dataset.skeleton().joints_right())
        poses_2d, poses_3d, cameras = {}, {}, {}
        for rec in _sequence_records(dataset, subjects, keypoints, self.action_filter):
            poses_2d[rec.key] = rec.pose_2d
            if rec.pose_3d is not None:
                poses_3d[rec.key] = rec.pose_3d
            if rec.camera is not None:
                cameras[rec.key] = rec.camera
        self._select_frames(poses_2d, poses_3d)

        super().__init__(
            poses_2d=poses_2d,
            poses_3d=poses_3d or None,
            cameras=cameras or None,
            valid_frame=None,
            scale=scale,
            chunk_length=opt.stride,
            pad=pad,
            out_all=opt.out_all,
            kps_left=self.kps_left,
            kps_right=self.kps_right,
            joints_left=self.joints_left,
            joints_right=self.joints_right,
            augment=(split == "train") and opt.data_augmentation,
            test_aug=opt.test_time_augmentation,
            # The 'val' split (train subjects, no augmentation — reference
            # load_noisy_data.py:95-107) is iterated with flip-TTA per epoch,
            # so it needs the flip copies that train batches don't carry.
            train=(split == "train"),
            noise_std=noise_std,
            joint_drop_rate=joint_drop_rate,
        )

    def _load_keypoints(self, keypoints_data):
        """2D-detection archive access: loads fresh from disk unless an
        archive dict was injected, reads the joint metadata, and returns the
        positions_2d mapping UNTOUCHED — every per-sequence transform happens
        on copies inside _sequence_records."""
        if keypoints_data is None:
            keypoints_data = dict(
                np.load(
                    f"{self.root_path}/data_2d_{self.dataset_name}_{self.keypoints_name}.npz",
                    allow_pickle=True,
                )
            )
        metadata = keypoints_data["metadata"]
        if hasattr(metadata, "item"):
            metadata = metadata.item()
        keypoints_symmetry = metadata["keypoints_symmetry"]
        self.num_joints = metadata["num_joints"]
        self.kps_left, self.kps_right = list(keypoints_symmetry[0]), list(keypoints_symmetry[1])
        keypoints = keypoints_data["positions_2d"]
        if hasattr(keypoints, "item"):
            keypoints = keypoints.item()
        return keypoints

    def _select_frames(self, poses_2d, poses_3d):
        """In-place subset/downsample selection over the collected record
        dicts. The arithmetic is parity-pinned to the reference
        (load_noisy_data.py:208-227): ``subset<1`` keeps one contiguous slice
        per sequence whose length is a stride multiple, offset by
        deterministic_random seeded on the sequence length."""
        stride = self.downsample
        if self.subset < 1:
            for key in poses_2d:
                n_frames = int(round(len(poses_2d[key]) // stride * self.subset) * stride)
                start = deterministic_random(
                    0, len(poses_2d[key]) - n_frames + 1, str(len(poses_2d[key]))
                )
                poses_2d[key] = poses_2d[key][start : start + n_frames : stride]
                if key in poses_3d:
                    poses_3d[key] = poses_3d[key][start : start + n_frames : stride]
        elif stride > 1:
            for key in poses_2d:
                poses_2d[key] = poses_2d[key][::stride]
                if key in poses_3d:
                    poses_3d[key] = poses_3d[key][::stride]
