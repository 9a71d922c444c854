"""The visualisation path on the CPU: the diffusion functions only it uses
(``get_noisy_pose``, ``ddim_sample_loop(collect_chain=True)``,
``p_sample_loop``, ``estimate_pose(reduce=False)``) against JAX's on the
same draws, at the module bar (1e-4 absolute); ``cli/viz.py::compute``'s
arrays against JAX's cli/viz.py on the same weights and draws; and the
ports of JAX's tests/test_cli.py::test_viz_cli (:73) and
::test_viz_video_overlay_and_hypotheses (:117): the same files written on
``--synthetic``. ``compute`` needs no matplotlib; ``main`` refuses to start
without it."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch import GaussianDiffusion, make_denoise_fn
from diff3dhpe_torch.cli.viz import build_viz_parser, compute, world_views
from diff3dhpe_torch.cli.viz import main as viz_main
from diff3dhpe_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diff3dhpe_tpu.engine import make_denoise_fn as jax_make_denoise_fn
from torch_port_helpers import build_pair, jax_x_init
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

F, T = 9, 20
BAR = 1e-4
CONFIG = "configs/h36m_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json"
VIZ_ARGS = ["--config", CONFIG, "-str", "S1", "-ste", "S9", "--viz-limit", "6",
            "--viz-chain-samples", "4", "--synthetic", "-frame", "9", "-s", "9", "--embed_dim",
            "32", "--transformer_depth", "1", "--timesteps", "20", "--sampling_timesteps", "3",
            "--batch-size-eval", "16"]
FILES = {"input_2d.gif", "reconstruction_3d.gif", "forward_diffusion.gif",
         "reverse_diffusion.gif", "reverse_diffusion_steps.png", "input_2d_frames.png"}


@pytest.fixture(scope="module")
def sampler():
    """(JAX diffusion, port diffusion, numpy params, x_cond) on one perturbed
    flax denoiser at F = 9, embed 32, depth 1, T = 20 (cosine), DDIM-3."""
    model, params, port = build_pair(np.random.default_rng(7), num_frame=F, embed_dim=32,
                                     depth=1, num_heads=4)
    kw = dict(timesteps=T, sampling_timesteps=3, clip_denoised=True, beta_schedule="cosine")
    jd = JaxDiffusion.create(jax_make_denoise_fn(model), **kw)
    pd = GaussianDiffusion.create(make_denoise_fn(port), **kw)
    x_cond = np.random.default_rng(8).standard_normal((2, F, 17, 2)).astype(np.float32)
    return jd, pd, params, x_cond


def test_get_noisy_pose_matches_jax(sampler):
    jd, pd, _, _ = sampler
    x0 = np.random.default_rng(1).standard_normal((2, F, 17, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    expected, t_jax = jd.get_noisy_pose(jnp.asarray(x0), 6, key=key)
    noise = np.array(jax.random.normal(key, x0.shape, jnp.float32))
    got, t_list = pd.get_noisy_pose(torch.from_numpy(x0), 6, noise=torch.from_numpy(noise))
    assert t_list == list(t_jax) == [0, 3, 6, 9, 12, 15, 18]
    assert got.shape == (2, F, 17, 3, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=BAR)
    # Without noise, one draw of x0's shape from the generator.
    drawn, _ = pd.get_noisy_pose(torch.from_numpy(x0), 6,
                                 generator=torch.Generator().manual_seed(0))
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(drawn, pd.get_noisy_pose(torch.from_numpy(x0), 6, noise=noise)[0],
                               rtol=0, atol=0)


def _jax_step_noises(key, steps, rows, row_shape):
    """The per-step noise of JAX's stochastic DDIM: step i, row r from
    fold_in(fold_in(key_steps, i), r) (gaussian_diffusion.py:252-262)."""
    _, key_steps = jax.random.split(key)
    return np.stack([np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.fold_in(key_steps, i), r), row_shape, jnp.float32))
        for r in range(rows)]) for i in range(steps)])


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_chain_matches_jax(sampler, eta):
    """collect_chain: the final sample, the per-step states and x0
    estimates on the last axis; at eta > 0 with JAX's per-step noise
    injected (``noises``)."""
    import dataclasses

    jd, pd, params, x_cond = sampler
    jd, pd = (dataclasses.replace(d, ddim_sampling_eta=eta) for d in (jd, pd))
    shape = (2, F, 17, 3)
    key = jax.random.PRNGKey(5)
    x_j, states_j, x0_j = jax.jit(lambda p: jd.ddim_sample_loop(
        p, key, jnp.asarray(x_cond), shape, collect_chain=True))(params)
    noises = torch.from_numpy(_jax_step_noises(key, 3, 2, shape[1:])) if eta else None
    x, states, x0s = pd.ddim_sample_loop(
        torch.from_numpy(x_cond), shape, x_init=torch.from_numpy(jax_x_init(key, 2, shape[1:])),
        collect_chain=True, noises=noises)
    assert states.shape == x0s.shape == shape + (3,)
    for mine, theirs in ((x, x_j), (states, states_j), (x0s, x0_j)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=0, atol=BAR)
    torch.testing.assert_close(states[..., -1], x, rtol=0, atol=0)
    # The chain's sample is the plain loop's.
    plain = pd.ddim_sample_loop(torch.from_numpy(x_cond), shape,
                                x_init=torch.from_numpy(jax_x_init(key, 2, shape[1:])),
                                noises=noises)
    torch.testing.assert_close(plain, x, rtol=0, atol=0)


def test_p_sample_loop_matches_jax(sampler):
    """Ancestral DDPM over all T = 20 steps, JAX's x_T and per-step draws
    injected (gaussian_diffusion.py:305-345)."""
    jd, pd, params, x_cond = sampler
    shape = (2, F, 17, 3)
    key = jax.random.PRNGKey(9)
    expected = np.asarray(jax.jit(lambda p: jd.p_sample_loop(p, key, jnp.asarray(x_cond),
                                                             shape))(params))
    key_init, key_steps = jax.random.split(key)
    x_init = np.asarray(jax.random.normal(key_init, shape, jnp.float32))
    noises = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                       for k in jax.random.split(key_steps, T)])
    got = pd.p_sample_loop(torch.from_numpy(x_cond), shape, x_init=torch.from_numpy(x_init),
                           noises=torch.from_numpy(noises)).numpy()
    assert np.isfinite(got).all()
    # The untrained net's output read as noise grows the sample; the bar is
    # relative to its size where that exceeds 1.
    np.testing.assert_allclose(got, expected, rtol=0, atol=BAR * max(1.0, np.abs(expected).max()))
    with pytest.raises(ValueError, match="Generator"):
        pd.p_sample_loop(torch.from_numpy(x_cond), shape)


@pytest.mark.parametrize("repeat_n", [1, 3])
def test_estimate_pose_unreduced_matches_jax(sampler, repeat_n):
    jd, pd, params, x_cond = sampler
    shape = (2, F, 17, 3)
    key = jax.random.PRNGKey(4)
    expected = np.asarray(jax.jit(lambda p: jd.estimate_pose(
        p, key, jnp.asarray(x_cond), shape, repeat_n=repeat_n, reduce=False))(params))
    x_init = torch.from_numpy(jax_x_init(key, 2 * repeat_n, shape[1:]))
    got = pd.estimate_pose(torch.from_numpy(x_cond), shape, repeat_n=repeat_n, x_init=x_init,
                           reduce=False)
    assert got.shape == (repeat_n,) + shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=BAR)
    mean = pd.estimate_pose(torch.from_numpy(x_cond), shape, repeat_n=repeat_n, x_init=x_init)
    torch.testing.assert_close(mean, got.mean(dim=0), rtol=0, atol=0)


def test_compute_matches_jax_viz(tmp_path, monkeypatch):
    """``compute`` on a reference .bin against JAX's cli/viz.py main on the
    same file, flags and draws (JAX's from PRNGKey(seed), replayed into the
    port): the predictions, the forward and reverse chains and the
    hypotheses in world space, as JAX hands them to its renderers."""
    import diff3dhpe_tpu.viz as jax_viz
    from diff3dhpe_torch.config import load_config
    from diff3dhpe_torch.cli.args import args_to_overrides
    from diff3dhpe_torch.models import MixSTEDenoiser
    from diff3dhpe_tpu.cli.viz import main as jax_viz_main

    weights = str(tmp_path / "w.bin")
    torch.save(MixSTEDenoiser(num_frame=F, embed_dim=32, depth=1, seed=3, device="cpu")
               .state_dict(), weights)
    argv = VIZ_ARGS + ["--viz-output", str(tmp_path / "jax"), "--repeat_n", "2",
                       "--evaluate", weights, "--mesh-shape", "data:1"]
    captured = {}
    for name in ("render_2d_animation", "render_3d_animation", "render_2d_figs",
                 "render_chain_animation", "render_3d_figs", "render_hypotheses_animation"):
        def fake(*a, _name=name, **kw):
            captured.setdefault(_name, []).append(a)
            return _name
        monkeypatch.setattr(jax_viz, name, fake)
    m_jax = jax_viz_main(argv)

    args = build_viz_parser().parse_args(argv)
    cfg = load_config(args.config, args_to_overrides(args))
    key = jax.random.PRNGKey(cfg.seed)
    rows = 2 * cfg.batch_size_eval * cfg.repeat_n
    subkeys, k = [], key
    for _ in range(4):
        k, sub = jax.random.split(k)
        subkeys.append(sub)
    shape = (F, 17, 3)
    draws = dict(forward_noise=np.asarray(jax.random.normal(key, (1,) + shape, jnp.float32)),
                 reverse_x_init=jax_x_init(key, 1, shape),
                 hypotheses_x_init=jax_x_init(key, cfg.repeat_n, shape),
                 evaluate=lambda i: jax_x_init(subkeys[i], rows, shape))
    out = compute(cfg, args, "cpu", draws)
    np.testing.assert_allclose(out["predictions"], m_jax["predictions"], rtol=0, atol=BAR)
    fwd, rev = captured["render_chain_animation"]
    np.testing.assert_allclose(out["forward_chain"] * out["scale"], fwd[0], rtol=0, atol=BAR)
    np.testing.assert_allclose(out["reverse_states"] * out["scale"], rev[0], rtol=0, atol=BAR)
    n, kps_pix, gt_world, pred_world, hyps_world = world_views(out, args.viz_limit)
    (gt_j, pred_j), = [a[:2] for a in captured["render_3d_animation"]]
    (gt_h, hyps_j), = [a[:2] for a in captured["render_hypotheses_animation"]]
    np.testing.assert_allclose(pred_world, pred_j, rtol=0, atol=BAR)
    np.testing.assert_allclose(gt_world, gt_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(hyps_world, hyps_j, rtol=0, atol=BAR)
    np.testing.assert_allclose(kps_pix, captured["render_2d_animation"][0][0], rtol=0, atol=1e-4)
    assert out["t_list"] == [0, 5, 10, 15] and out["reverse_x0"].shape == rev[0].shape


def test_viz_cli(tmp_path):
    out_dir = str(tmp_path / "viz")
    viz_main(VIZ_ARGS + ["--viz-output", out_dir], device="cpu")
    assert FILES <= set(os.listdir(out_dir))


def test_viz_video_overlay_and_hypotheses(tmp_path):
    """--viz-video overlays poses on footage frames; repeat_n > 1 renders
    the hypotheses."""
    from PIL import Image

    rng = np.random.default_rng(0)
    frames = [Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
              for _ in range(8)]
    video = tmp_path / "footage.gif"
    frames[0].save(video, save_all=True, append_images=frames[1:], duration=40)
    out_dir = str(tmp_path / "viz")
    viz_main(VIZ_ARGS + ["--viz-output", out_dir, "--viz-video", str(video), "--repeat_n", "2"],
             device="cpu")
    assert FILES | {"video_overlay.gif", "hypotheses_3d.gif"} <= set(os.listdir(out_dir))


def test_compute_needs_no_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is absent, ``compute`` runs and ``main`` raises an
    ImportError before any model work or file."""
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    args = build_viz_parser().parse_args(VIZ_ARGS + ["--viz-output", str(tmp_path / "v")])
    from diff3dhpe_torch.cli.args import args_to_overrides
    from diff3dhpe_torch.config import load_config

    out = compute(load_config(args.config, args_to_overrides(args)), args, "cpu")
    assert out["reverse_states"].shape == (F, 17, 3, 3) and out["hypotheses"] is None
    assert np.isfinite(out["forward_chain"]).all()
    with pytest.raises(ImportError):
        viz_main(VIZ_ARGS + ["--viz-output", str(tmp_path / "v")], device="cpu")
    assert not os.path.exists(tmp_path / "v")
