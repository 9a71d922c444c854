"""Human3.6M preprocessing: produce data_3d_h36m.npz + data_2d_h36m_gt.npz.

Equivalent of the reference's data/prepare_data_h36m.py: converts the
official H3.6M release (h5 archive, or .cdf/.mat source files) into the
32-joint metre-unit 3D archive, then projects ground-truth 2D keypoints
through the full distortion camera model with the symmetry metadata the
loaders require.

Usage:
    python -m diff3dhpe_torch.data.prepare_h36m --from-archive h36m.zip
    python -m diff3dhpe_torch.data.prepare_h36m --from-source-cdf <dir>
    python -m diff3dhpe_torch.data.prepare_h36m --from-source-mat <dir>
"""
from __future__ import annotations

import argparse
import os
import sys
import zipfile
from glob import glob
from shutil import rmtree

import numpy as np

SUBJECTS = ["S1", "S5", "S6", "S7", "S8", "S9", "S11"]
OUTPUT_3D = "data_3d_h36m"
OUTPUT_2D = "data_2d_h36m_gt"


def from_archive(archive_path: str, out_dir: str) -> dict:
    import h5py

    output = {}
    tmp = os.path.join(out_dir, "_h36m_tmp")
    with zipfile.ZipFile(archive_path, "r") as archive:
        archive.extractall(tmp)
    try:
        for subject in SUBJECTS:
            output[subject] = {}
            file_list = glob(os.path.join(tmp, "h36m", subject, "MyPoses", "3D_positions", "*.h5"))
            assert len(file_list) == 30, f"Expected 30 files for subject {subject}, got {len(file_list)}"
            for f in file_list:
                action = os.path.splitext(os.path.basename(f))[0]
                if subject == "S11" and action == "Directions":
                    continue  # corrupt video in the official release
                canonical = action.replace("TakingPhoto", "Photo").replace("WalkingDog", "WalkDog")
                with h5py.File(f) as hf:
                    positions = hf["3D_positions"][:].reshape(32, 3, -1).transpose(2, 0, 1)
                    output[subject][canonical] = (positions / 1000.0).astype("float32")
    finally:
        rmtree(tmp)
    return output


def from_source_mat(root: str) -> dict:
    from scipy.io import loadmat

    output = {}
    for subject in SUBJECTS:
        output[subject] = {}
        file_list = glob(os.path.join(root, subject, "MyPoseFeatures", "D3_Positions", "*.cdf.mat"))
        assert len(file_list) == 30, f"Expected 30 files for subject {subject}, got {len(file_list)}"
        for f in file_list:
            action = os.path.splitext(os.path.splitext(os.path.basename(f))[0])[0]
            if subject == "S11" and action == "Directions":
                continue
            canonical = action.replace("TakingPhoto", "Photo").replace("WalkingDog", "WalkDog")
            hf = loadmat(f)
            positions = hf["data"][0, 0].reshape(-1, 32, 3)
            output[subject][canonical] = (positions / 1000.0).astype("float32")
    return output


def from_source_cdf(root: str) -> dict:
    import cdflib  # optional dependency; not bundled in every image

    output = {}
    for subject in SUBJECTS:
        output[subject] = {}
        file_list = glob(os.path.join(root, subject, "MyPoseFeatures", "D3_Positions", "*.cdf"))
        assert len(file_list) == 30, f"Expected 30 files for subject {subject}, got {len(file_list)}"
        for f in file_list:
            action = os.path.splitext(os.path.basename(f))[0]
            if subject == "S11" and action == "Directions":
                continue
            canonical = action.replace("TakingPhoto", "Photo").replace("WalkingDog", "WalkDog")
            hf = cdflib.CDF(f)
            positions = hf["Pose"].reshape(-1, 32, 3)
            output[subject][canonical] = (positions / 1000.0).astype("float32")
    return output


def generate_gt_2d(dataset_path: str, out_dir: str) -> None:
    """Project the 3D archive to GT 2D pixels with the distortion model."""
    from diff3dhpe_torch.data.h36m import Human36mDataset
    from diff3dhpe_torch.geometry.camera import (
        image_coordinates,
        project_to_2d,
        world_to_camera,
    )

    dataset = Human36mDataset(dataset_path)
    output_2d_poses = {}
    for subject in dataset.subjects():
        output_2d_poses[subject] = {}
        for action in dataset[subject].keys():
            anim = dataset[subject][action]
            positions_2d = []
            for cam in anim["cameras"]:
                pos_3d = world_to_camera(
                    anim["positions"], R=cam["orientation"], t=cam["translation"]
                )
                pos_2d = project_to_2d(pos_3d[None], cam["intrinsic"][None])[0]
                pos_2d_pixel_space = image_coordinates(
                    pos_2d, w=cam["res_w"], h=cam["res_h"]
                )
                positions_2d.append(pos_2d_pixel_space.astype("float32"))
            output_2d_poses[subject][action] = positions_2d

    metadata = {
        "num_joints": dataset.skeleton().num_joints(),
        "keypoints_symmetry": [
            dataset.skeleton().joints_left(),
            dataset.skeleton().joints_right(),
        ],
    }
    np.savez_compressed(
        os.path.join(out_dir, OUTPUT_2D),
        positions_2d=output_2d_poses,
        metadata=metadata,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="Human3.6M dataset preparation")
    parser.add_argument("--from-archive", type=str, help="official h36m.zip archive")
    parser.add_argument("--from-source-cdf", type=str, help="root of .cdf source files")
    parser.add_argument("--from-source-mat", type=str, help="root of converted .cdf.mat files")
    parser.add_argument("--out-dir", type=str, default="data")
    args = parser.parse_args(argv)

    modes = [args.from_archive, args.from_source_cdf, args.from_source_mat]
    if sum(x is not None for x in modes) != 1:
        print("Specify exactly one of --from-archive / --from-source-cdf / --from-source-mat")
        sys.exit(1)

    os.makedirs(args.out_dir, exist_ok=True)
    out_3d = os.path.join(args.out_dir, OUTPUT_3D + ".npz")
    if os.path.exists(out_3d):
        print(f"{out_3d} already exists — refusing to overwrite")
        sys.exit(1)

    print("Converting original Human3.6M dataset from", [m for m in modes if m][0])
    if args.from_archive:
        data = from_archive(args.from_archive, args.out_dir)
    elif args.from_source_mat:
        data = from_source_mat(args.from_source_mat)
    else:
        data = from_source_cdf(args.from_source_cdf)

    np.savez_compressed(out_3d, positions_3d=data)
    print("Saved", out_3d)

    print("Generating ground-truth 2D projections...")
    generate_gt_2d(out_3d, args.out_dir)
    print("Saved", os.path.join(args.out_dir, OUTPUT_2D + ".npz"))
    print("Done.")


if __name__ == "__main__":
    main()
