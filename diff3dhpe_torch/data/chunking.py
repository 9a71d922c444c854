"""Chunked-window index construction and window materialisation.

Functional re-design of the reference's mutable ChunkedGenerator family
(reference: common/nosiy_generators.py:14-338 for the H3.6M generator,
:341-679 for the 3DHP variant with valid-frame masking): the chunk index is
built once as a list of immutable ChunkSpec rows, and each window is
materialised on demand into fresh numpy arrays — no shared scratch buffers,
so the pipeline is trivially safe under any parallel prefetching.

Semantics preserved exactly:
- seq2seq (out_all=True): non-overlapping chunks of ``chunk_length``; the
  last chunk is shifted left to end-align with the sequence, and its
  ``target_mask`` marks the frames that overlap the previous chunk False so
  every frame is evaluated exactly once (reference :27-48, :267-271).
  Sequences shorter than ``chunk_length`` are edge-padded on the right (mask
  stays all-True, matching the reference's None -> all-True fallback in
  load_noisy_data.py:270-271).
- seq2frame (out_all=False): centered receptive field with ``pad`` frames of
  2D context each side, edge-padded at the boundaries (reference :81-111,
  :162-245).
- flip augmentation negates x and swaps left/right keypoint/joint lists;
  camera intrinsics flip cx (index 2) and the tangential p2 (index 7)
  (reference :183-185, :212-215, :222-224).
- reverse augmentation reverses time (and the target mask with it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChunkSpec:
    key: Hashable
    start: int
    end: int
    target_start: int
    target_end: int
    flip: bool
    reverse: bool


def build_seq2seq_chunks(
    seq_lengths: Dict[Hashable, int],
    chunk_length: int,
    augment: bool = False,
    reverse_aug: bool = False,
) -> List[ChunkSpec]:
    """Non-overlapping seq2seq chunk index (reference :27-64)."""
    pairs: List[ChunkSpec] = []
    for key, n in seq_lengths.items():
        n_chunks = (n + chunk_length - 1) // chunk_length
        bounds = np.arange(n_chunks) * chunk_length
        start_last = n - chunk_length
        # The last chunk end-aligns; its target window records how far it was
        # shifted so the overlap with the previous chunk can be masked out.
        target_offset = start_last - bounds[-1]
        starts = np.append(bounds[:-1], start_last)
        ends = np.append(bounds[1:], n)
        t_starts = np.append(bounds[:-1], start_last + target_offset)
        t_ends = np.append(bounds[1:], n)

        def rows(flip, reverse):
            return [
                ChunkSpec(key, int(s), int(e), int(ts), int(te), flip, reverse)
                for s, e, ts, te in zip(starts, ends, t_starts, t_ends)
            ]

        pairs += rows(False, False)
        if reverse_aug:
            pairs += rows(False, True)
        if augment:
            pairs += rows(True, True) if reverse_aug else rows(True, False)
    return pairs


def build_seq2frame_chunks(
    seq_lengths: Dict[Hashable, int],
    chunk_length: int,
    augment: bool = False,
    reverse_aug: bool = False,
) -> List[ChunkSpec]:
    """Centered seq2frame chunk index (reference :82-97)."""
    pairs: List[ChunkSpec] = []
    for key, n in seq_lengths.items():
        n_chunks = (n + chunk_length - 1) // chunk_length
        offset = (n_chunks * chunk_length - n) // 2
        bounds = np.arange(n_chunks + 1) * chunk_length - offset

        def rows(flip, reverse):
            return [
                ChunkSpec(key, int(s), int(e), int(s), int(e), flip, reverse)
                for s, e in zip(bounds[:-1], bounds[1:])
            ]

        pairs += rows(False, False)
        if reverse_aug:
            pairs += rows(False, True)
        if augment:
            pairs += rows(True, True) if reverse_aug else rows(True, False)
    return pairs


def _edge_pad_slice(seq: np.ndarray, start: int, end: int) -> np.ndarray:
    """seq[start:end] with edge replication outside [0, len)."""
    low = max(start, 0)
    high = min(end, seq.shape[0])
    pad_left = low - start
    pad_right = end - high
    window = seq[low:high]
    if pad_left or pad_right:
        pad_width = ((pad_left, pad_right),) + ((0, 0),) * (seq.ndim - 1)
        window = np.pad(window, pad_width, "edge")
    else:
        window = window.copy()
    return window


def _flip_pose(x: np.ndarray, left: Sequence[int], right: Sequence[int]) -> np.ndarray:
    x = x.copy()
    x[..., 0] *= -1
    x[:, list(left) + list(right)] = x[:, list(right) + list(left)]
    return x


def materialize_window(
    spec: ChunkSpec,
    poses_2d: np.ndarray,
    poses_3d: Optional[np.ndarray],
    *,
    pad: int = 0,
    chunk_length: int,
    out_all: bool,
    kps_left: Sequence[int],
    kps_right: Sequence[int],
    joints_left: Sequence[int],
    joints_right: Sequence[int],
    camera: Optional[np.ndarray] = None,
    valid_frame: Optional[np.ndarray] = None,
    frame_ids: Optional[np.ndarray] = None,
) -> dict:
    """Materialise one training/eval window.

    Returns dict with: input_2d [F2, J, 2], gt_3d (seq2seq [F, J, 3] /
    seq2frame [chunk, J, 3] or None), target_mask (bool [F] or None),
    cam (9,) or None, frame ids when requested.
    """
    start_2d = spec.start - pad
    end_2d = spec.end + pad

    had_padding = start_2d < 0 or end_2d > poses_2d.shape[0]
    input_2d = _edge_pad_slice(poses_2d, start_2d, end_2d)
    ids_2d = (
        _edge_pad_slice(frame_ids, start_2d, end_2d) if frame_ids is not None else None
    )

    target_mask = None
    if out_all and not had_padding:
        # Last-chunk overlap masking (reference :267-271).
        target_mask = np.full(chunk_length, True, dtype=bool)
        n_unused = spec.start - spec.target_start
        assert n_unused >= 0
        if n_unused > 0:
            target_mask[:n_unused] = False

    if spec.flip:
        input_2d = _flip_pose(input_2d, kps_left, kps_right)
    if spec.reverse:
        input_2d = input_2d[::-1].copy()
        if ids_2d is not None:
            ids_2d = ids_2d[::-1].copy()

    gt_3d = None
    ids_3d = None
    batch_valid = None
    if poses_3d is not None:
        if out_all:
            lo, hi = start_2d, end_2d
        else:
            lo, hi = spec.start, spec.end
        gt_3d = _edge_pad_slice(poses_3d, lo, hi)
        if frame_ids is not None:
            ids_3d = _edge_pad_slice(frame_ids, lo, hi)
        if valid_frame is not None:
            # valid-frame only flows through the unpadded seq2seq path, as in
            # the reference 3DHP generator (:640-643).
            if not (lo < 0 or hi > poses_3d.shape[0]):
                batch_valid = valid_frame[lo:hi].copy()
        if spec.flip:
            gt_3d = _flip_pose(gt_3d, joints_left, joints_right)
        if spec.reverse:
            gt_3d = gt_3d[::-1].copy()
            if ids_3d is not None:
                ids_3d = ids_3d[::-1].copy()
            if target_mask is not None:
                target_mask = target_mask[::-1].copy()
            if batch_valid is not None:
                batch_valid = batch_valid[::-1].copy()

    if valid_frame is not None and batch_valid is not None:
        flat_valid = batch_valid.reshape(batch_valid.shape[0], -1)[:, 0].astype(bool)
        if target_mask is not None:
            target_mask = target_mask & flat_valid
        elif not out_all:
            # seq2frame: the valid-frame flags ARE the mask (reference :560-561).
            target_mask = flat_valid

    cam = None
    if camera is not None:
        cam = camera.copy()
        if spec.flip:
            cam[2] *= -1  # principal point cx
            cam[7] *= -1  # tangential distortion p2
    return {
        "cam": cam,
        "gt_3d": gt_3d,
        "input_2d": input_2d,
        "target_mask": target_mask,
        "ids_3d": ids_3d,
        "ids_2d": ids_2d,
    }
