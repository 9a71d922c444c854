"""The port's host-side copies (config, CLI arguments, geometry, synthetic
data, chunking, PoseDataset, metrics) against the JAX package's: both are
numpy, so the same inputs must give bit-equal results."""
import dataclasses

import numpy as np
import pytest

from diff3dhpe_torch.cli.args import args_to_overrides, build_parser
from diff3dhpe_torch.config import Config, load_config
from diff3dhpe_torch.data import PoseDataset, make_synthetic_h36m_like
from diff3dhpe_torch.data import chunking, h36m
from diff3dhpe_torch.geometry import camera, quaternion
from diff3dhpe_torch.geometry.skeleton import Skeleton
from diff3dhpe_torch.metrics import mean_velocity_error, mpjpe, n_mpjpe, p_mpjpe
from diff3dhpe_torch.utils import deterministic_random
from diff3dhpe_tpu import metrics as jax_metrics
from diff3dhpe_tpu.cli.args import args_to_overrides as jax_args_to_overrides
from diff3dhpe_tpu.cli.args import build_parser as jax_build_parser
from diff3dhpe_tpu.config import Config as JaxConfig
from diff3dhpe_tpu.config import load_config as jax_load_config
from diff3dhpe_tpu.data import PoseDataset as JaxPoseDataset
from diff3dhpe_tpu.data import chunking as jax_chunking
from diff3dhpe_tpu.data import h36m as jax_h36m
from diff3dhpe_tpu.data import make_synthetic_h36m_like as jax_make_synthetic
from diff3dhpe_tpu.geometry import camera as jax_camera
from diff3dhpe_tpu.geometry import quaternion as jax_quaternion
from diff3dhpe_tpu.geometry.skeleton import Skeleton as JaxSkeleton
from diff3dhpe_tpu.utils import deterministic_random as jax_deterministic_random
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

CONFIGS = ["configs/h36m_gt_s2s_243f.json",
           "configs/h36m_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json",
           "configs/3dhp_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json"]
ARGV = ["--synthetic", "-frame", "27", "-s", "27", "--embed_dim", "64", "--out_all", "True",
        "--fast-eval", "--compute-dtype", "bfloat16", "--eval-f32-final-steps", "1",
        "--eval-f32-head", "--batch-size-eval", "4", "-a", "Walking", "--gpu_id", "0",
        "--evaluate", "x.bin", "--num-heads", "4", "--eval-final-prec", "highest"]


def test_config_has_every_field_of_the_jax_config():
    ours = {f.name: (f.type, f.default) for f in dataclasses.fields(Config)}
    theirs = {f.name: (f.type, f.default) for f in dataclasses.fields(JaxConfig)}
    assert ours == theirs
    assert Config().pad == JaxConfig().pad == 0
    assert Config(out_all=False, number_of_frames=27).pad == 13


@pytest.mark.parametrize("path", CONFIGS)
@pytest.mark.parametrize("argv", [[], ARGV])
def test_load_config_and_overrides_match_jax(path, argv):
    args, jax_args = build_parser().parse_args(argv), jax_build_parser().parse_args(argv)
    assert vars(args) == vars(jax_args)
    overrides = args_to_overrides(args)
    assert overrides == jax_args_to_overrides(jax_args)
    cfg, jax_cfg = load_config(path, overrides), jax_load_config(path, overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    if argv:
        assert (cfg.fast_eval, cfg.compute_dtype, cfg.eval_f32_final_steps, cfg.eval_f32_head,
                cfg.number_of_frames, cfg.out_all) == (True, "bfloat16", 1, True, 27, True)


def test_use_pallas_attention_comes_from_the_config_json(tmp_path):
    import json

    path = tmp_path / "c.json"
    path.write_text(json.dumps({"params": {"use_pallas_attention": True, "clip_denoised": "False",
                                           "not_a_field": 1}}))
    cfg = load_config(str(path), {"seed": None, "stride": 9})
    assert cfg.use_pallas_attention and cfg.clip_denoised is False
    assert (cfg.seed, cfg.stride) == (42, 9)
    assert "use_pallas_attention" not in " ".join(
        a.dest for a in build_parser()._actions)  # no flag that the JAX CLI lacks


def test_geometry_matches_jax(rng):
    q = rng.standard_normal((5, 7, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.standard_normal((5, 7, 3))
    np.testing.assert_array_equal(quaternion.qrot(q, v), jax_quaternion.qrot(q, v))
    np.testing.assert_array_equal(quaternion.qinverse(q), jax_quaternion.qinverse(q))
    x = rng.standard_normal((11, 17, 3)).astype(np.float32) + np.float32([0, 0, 4])
    r, t = q[0, 0].astype(np.float32), rng.standard_normal(3).astype(np.float32)
    np.testing.assert_array_equal(camera.world_to_camera(x, r, t),
                                  jax_camera.world_to_camera(x, r, t))
    np.testing.assert_array_equal(camera.camera_to_world(x, r, t),
                                  jax_camera.camera_to_world(x, r, t))
    cam = np.tile(rng.uniform(0.1, 1.0, (1, 9)).astype(np.float32), (11, 1))
    for name in ("project_to_2d", "project_to_2d_linear"):
        np.testing.assert_array_equal(getattr(camera, name)(x, cam),
                                      getattr(jax_camera, name)(x, cam))
    px = rng.uniform(0, 1000, (4, 17, 2)).astype(np.float32)
    norm = camera.normalize_screen_coordinates(px, w=1000, h=1002)
    np.testing.assert_array_equal(norm, jax_camera.normalize_screen_coordinates(px, w=1000, h=1002))
    np.testing.assert_array_equal(camera.image_coordinates(norm, w=1000, h=1002),
                                  jax_camera.image_coordinates(norm, w=1000, h=1002))


def test_skeleton_and_cameras_match_jax():
    for ours, theirs in ((h36m.h36m_skeleton, jax_h36m.h36m_skeleton),):
        for cls, skel in ((Skeleton, ours), (JaxSkeleton, theirs)):
            assert isinstance(skel, cls)
        np.testing.assert_array_equal(ours.parents(), theirs.parents())
        assert list(ours.joints_left()) == list(theirs.joints_left())
        assert list(ours.joints_right()) == list(theirs.joints_right())
    cams, jax_cams = h36m.build_h36m_cameras(), jax_h36m.build_h36m_cameras()
    assert cams.keys() == jax_cams.keys()
    for subject in cams:
        for a, b in zip(cams[subject], jax_cams[subject]):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    assert [deterministic_random(0, 50, s) for s in ("7", "1383")] == [
        jax_deterministic_random(0, 50, s) for s in ("7", "1383")]


@pytest.mark.parametrize("motion", ["walk", "latent"])
def test_synthetic_dataset_matches_jax(motion):
    kw = dict(subjects=("S1", "S9"), n_frames=60, seed=3, motion=motion)
    (ds, kps), (jds, jkps) = make_synthetic_h36m_like(**kw), jax_make_synthetic(**kw)
    assert (ds._pos_3d_min, ds._pos_3d_max) == (jds._pos_3d_min, jds._pos_3d_max)
    assert kps["metadata"] == jkps["metadata"]
    assert list(ds.skeleton().joints_left()) == list(jds.skeleton().joints_left())
    for subject in kw["subjects"]:
        assert list(ds[subject].keys()) == list(jds[subject].keys())
        for action in ds[subject].keys():
            np.testing.assert_array_equal(ds[subject][action]["positions"],
                                          jds[subject][action]["positions"])
            for a, b in zip(kps["positions_2d"][subject][action],
                            jkps["positions_2d"][subject][action]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunker", ["build_seq2seq_chunks", "build_seq2frame_chunks"])
@pytest.mark.parametrize("augment,reverse_aug", [(False, False), (True, True)])
def test_chunk_index_matches_jax(chunker, augment, reverse_aug):
    lengths = {("S1", "a", 0): 31, ("S1", "b", 1): 9, ("S9", "a", 0): 4}
    ours = getattr(chunking, chunker)(lengths, 9, augment=augment, reverse_aug=reverse_aug)
    theirs = getattr(jax_chunking, chunker)(lengths, 9, augment=augment, reverse_aug=reverse_aug)
    assert [dataclasses.astuple(c) for c in ours] == [dataclasses.astuple(c) for c in theirs]
    assert len(ours) > 0


@pytest.mark.parametrize("out_all,split,noise", [(True, "test", 0.0), (False, "test", 0.0),
                                                 (True, "train", 0.0), (True, "val", 0.05)])
def test_pose_dataset_batches_match_jax(out_all, split, noise):
    cfg_kw = dict(subjects_train="S1", subjects_test="S9", number_of_frames=9, stride=9,
                  out_all=out_all, actions="*")
    kw = dict(subjects=("S1", "S9"), n_frames=50, seed=1)
    ds, kps = make_synthetic_h36m_like(**kw)
    jds, jkps = jax_make_synthetic(**kw)
    ours = PoseDataset(Config(**cfg_kw), ds, "data", split, keypoints_data=kps, noise_std=noise,
                       joint_drop_rate=noise)
    theirs = JaxPoseDataset(JaxConfig(**cfg_kw), jds, "data", split, keypoints_data=jkps,
                            noise_std=noise, joint_drop_rate=noise)
    assert len(ours) == len(theirs) > 0 and ours.scale == theirs.scale
    assert (ours.num_joints, ours.joints_left, ours.kps_right) == (
        theirs.num_joints, theirs.joints_left, theirs.kps_right)
    pose = np.random.default_rng(0).standard_normal((3, 17, 3)).astype(np.float32)
    np.testing.assert_array_equal(ours.reverse_norm_3d_pose(ours.norm_3d_pose(pose)),
                                  theirs.reverse_norm_3d_pose(theirs.norm_3d_pose(pose)))
    shuffle = split == "train"
    batches = list(ours.batches(7, shuffle=shuffle))
    jax_batches = list(theirs.batches(7, shuffle=shuffle))
    assert len(batches) == len(jax_batches) > 1
    assert not batches[-1].row_mask.all()  # the last batch is padded and row-masked
    for a, b in zip(batches, jax_batches):
        assert a.keys == b.keys and a.size == b.size == 7
        for field in ("gt_3d", "gt_3d_norm", "input_2d", "input_2d_flip", "target_mask",
                      "row_mask", "cam"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None), field
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=field)
    assert (batches[0].input_2d_flip is None) == (split == "train")
    assert len(list(ours.batches(7, drop_last=True))) == len(batches) - 1


def test_metrics_match_jax(rng):
    pred = rng.standard_normal((40, 17, 3)).astype(np.float32)
    gt = (pred + 0.1 * rng.standard_normal((40, 17, 3))).astype(np.float32)
    assert mpjpe(pred[:, None], gt[:, None]) == jax_metrics.mpjpe(pred[:, None], gt[:, None])
    np.testing.assert_array_equal(mpjpe(pred, gt, reduce="none"),
                                  jax_metrics.mpjpe(pred, gt, reduce="none"))
    assert n_mpjpe(pred[:, None], gt[:, None]) == jax_metrics.n_mpjpe(pred[:, None], gt[:, None])
    assert p_mpjpe(pred, gt) == jax_metrics.p_mpjpe(pred, gt)
    assert mean_velocity_error(pred, gt) == jax_metrics.mean_velocity_error(pred, gt)
    # A rotated, scaled and shifted copy is a perfect Procrustes match.
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    assert p_mpjpe((2.0 * gt @ rot + 1.0).astype(np.float32), gt) < 1e-5
    assert n_mpjpe(3.0 * gt[:, None], gt[:, None]) < 1e-6
    with pytest.raises(ValueError, match="reduce"):
        mpjpe(pred, gt, reduce="sum")
