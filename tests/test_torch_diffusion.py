"""The port's schedules and DDIM sampler against the JAX package: exact
equality for the host-side tables, and the sampler on the same x_T."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.diffusion import GaussianDiffusion, ddim_time_pairs, make_diffusion_constants
from diff3dhpe_torch.engine import make_denoise_fn, make_fast_denoise_fn
from diff3dhpe_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diff3dhpe_tpu.diffusion.gaussian_diffusion import ddim_time_pairs as jax_time_pairs
from diff3dhpe_tpu.diffusion.schedules import make_diffusion_constants as jax_constants
from diff3dhpe_tpu.engine import make_denoise_fn as jax_make_denoise_fn
from make_golden import DIFF_KW, GOLDEN, MODEL_KW, build
from torch_port_helpers import build_pair, jax_x_init, port_model
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("schedule", ["linear", "cosine", "logcosine", "quadratic", "sigmoid"])
def test_schedules_equal_jax(schedule):
    ours, ref = make_diffusion_constants(schedule, 1000), jax_constants(schedule, 1000)
    for field in ref.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field), err_msg=field)


@pytest.mark.parametrize("total,sampling", [(1000, 9), (1000, 20), (50, 5), (100, 100), (7, 3)])
def test_ddim_time_pairs_and_tables_equal_jax(total, sampling):
    np.testing.assert_array_equal(ddim_time_pairs(total, sampling), jax_time_pairs(total, sampling))
    for eta in (0.0, 0.5):
        ours = GaussianDiffusion.create(None, total, sampling, ddim_sampling_eta=eta)
        ref = JaxDiffusion.create(None, total, sampling, ddim_sampling_eta=eta)
        ta, tb = ours._ddim_step_tables(), ref._ddim_step_tables()
        assert set(ta) == set(tb)
        for k in tb:
            np.testing.assert_array_equal(ta[k], np.asarray(tb[k]), err_msg=k)


def test_q_sample_matches_jax(rng):
    ours = GaussianDiffusion.create(None, 100, 10)
    ref = JaxDiffusion.create(None, 100, 10)
    x0 = rng.standard_normal((4, 9, 17, 3)).astype(np.float32)
    noise = rng.standard_normal((4, 9, 17, 3)).astype(np.float32)
    t = np.array([0, 5, 50, 99])
    expected = np.asarray(ref.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    out = ours.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode,fast,final_split", [
    ("s2s", False, False), ("s2f", False, False), ("s2s", True, False), ("s2s", True, True),
])
def test_ddim_sample_loop_matches_jax(rng, mode, fast, final_split):
    f, depth = 9, 1
    model, params, port = build_pair(rng, num_frame=f, depth=depth, mode=mode)
    kw = dict(timesteps=50, sampling_timesteps=5, clip_denoised=True, mode=mode)
    ref = JaxDiffusion.create(jax_make_denoise_fn(model), **kw)
    denoise = (make_fast_denoise_fn if fast else make_denoise_fn)(port)
    if final_split:  # the last 2 steps through the other path: same result
        ours = GaussianDiffusion.create(make_denoise_fn(port), **kw, final_denoise_fn=denoise,
                                        final_denoise_steps=2)
    else:
        ours = GaussianDiffusion.create(denoise, **kw)
    f_out = f if mode == "s2s" else 1
    cond = rng.uniform(-1, 1, (2, f, 17, 2)).astype(np.float32)
    x_init = rng.standard_normal((2, f_out, 17, 3)).astype(np.float32)
    expected = np.asarray(ref.ddim_sample_loop(
        params, jax.random.PRNGKey(0), jnp.asarray(cond), (2, f_out, 17, 3),
        x_init=jnp.asarray(x_init),
    ))
    out = ours.ddim_sample_loop(torch.from_numpy(cond), (2, f_out, 17, 3),
                                x_init=torch.from_numpy(x_init))
    # The module bar (<= 1e-4) per forward; the DDIM update gains are < 1.
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-4, atol=1e-4)


@pytest.mark.skipif(
    not os.path.isfile(os.path.join(GOLDEN, "tiny_model_v1.npz")),
    reason="golden fixtures not generated",
)
def test_golden_ddim_sample_with_jax_x_init():
    golden = np.load(os.path.join(GOLDEN, "tiny_model_v1.npz"))
    _, _, params, x, _ = build()
    kw = {k: MODEL_KW[k] for k in ("num_frame", "num_joints", "in_chans", "embed_dim",
                                   "depth", "num_heads", "mlp_ratio", "qkv_bias",
                                   "with_time_emb", "mode")}
    port = port_model(params, **kw)
    ours = GaussianDiffusion.create(
        make_denoise_fn(port), timesteps=DIFF_KW["timesteps"],
        sampling_timesteps=DIFF_KW["sampling_timesteps"],
        clip_denoised=DIFF_KW["clip_denoised"], beta_schedule=DIFF_KW["beta_schedule"],
        mode=DIFF_KW["mode"],
    )
    x_init = jax_x_init(jax.random.PRNGKey(2), 2, (9, 17, 3))
    cond = torch.from_numpy(np.array(x)[..., :2])
    out = ours.ddim_sample_loop(cond, (2, 9, 17, 3), x_init=torch.from_numpy(x_init))
    np.testing.assert_allclose(out.numpy(), golden["ddim_sample"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_sampler_draws_noise_only_from_the_callers_generator(eta):
    ours = GaussianDiffusion.create(lambda x, t: x[..., 2:], 10, 2, ddim_sampling_eta=eta)
    cond = torch.zeros(1, 3, 17, 2)
    x_init = torch.ones(1, 3, 17, 3)
    with pytest.raises(ValueError):
        ours.ddim_sample_loop(cond, (1, 3, 17, 3))
    if eta:  # the per-step noise needs a generator even with x_init
        with pytest.raises(ValueError):
            ours.ddim_sample_loop(cond, (1, 3, 17, 3), x_init=x_init)
    draw = lambda seed: ours.ddim_sample_loop(
        cond, (1, 3, 17, 3), x_init=x_init, generator=torch.Generator().manual_seed(seed))
    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert torch.equal(a, c) != bool(eta)  # eta > 0 adds noise; eta = 0 is deterministic
