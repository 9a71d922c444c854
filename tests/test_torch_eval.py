"""The port's flip-TTA eval step against the JAX make_eval_step on the same
weights, with x_T rebuilt through JAX's per-row draw and injected."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.diffusion import GaussianDiffusion
from diff3dhpe_torch.engine import flip_pose, make_eval_step, make_fast_denoise_fn
from diff3dhpe_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diff3dhpe_tpu.engine import make_denoise_fn as jax_make_denoise_fn
from diff3dhpe_tpu.engine import make_eval_step as jax_make_eval_step
from diff3dhpe_tpu.engine.steps import flip_pose_jnp
from torch_port_helpers import JOINTS_LEFT, JOINTS_RIGHT, build_pair, jax_x_init
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def test_flip_pose_matches_jax(rng):
    pose = rng.standard_normal((2, 5, 17, 3)).astype(np.float32)
    expected = np.asarray(flip_pose_jnp(jnp.asarray(pose), JOINTS_LEFT, JOINTS_RIGHT))
    out = flip_pose(torch.from_numpy(pose), JOINTS_LEFT, JOINTS_RIGHT).numpy()
    np.testing.assert_array_equal(out, expected)


@pytest.fixture(scope="module")
def pair():
    """(flax model, numpy params, port model), shared by the cases."""
    return build_pair(np.random.default_rng(1), num_frame=9, depth=1)


@pytest.mark.parametrize("tta,repeat_n", [(True, 1), (False, 1), (True, 2)])
def test_eval_step_matches_jax(rng, pair, tta, repeat_n):
    f, b = 9, 2
    model, params, port = pair
    kw = dict(timesteps=50, sampling_timesteps=5, clip_denoised=True)
    ref = jax_make_eval_step(JaxDiffusion.create(jax_make_denoise_fn(model), **kw),
                             JOINTS_LEFT, JOINTS_RIGHT, repeat_n=repeat_n, tta=tta)
    ours = make_eval_step(GaussianDiffusion.create(make_fast_denoise_fn(port), **kw),
                          JOINTS_LEFT, JOINTS_RIGHT, repeat_n=repeat_n, tta=tta, device="cpu")
    x2d = rng.uniform(-1, 1, (b, f, 17, 2)).astype(np.float32)
    x2d_flip = np.asarray(flip_pose_jnp(jnp.asarray(x2d), JOINTS_LEFT, JOINTS_RIGHT))
    key = jax.random.PRNGKey(7)
    expected = np.asarray(ref(params, key, jnp.asarray(x2d), jnp.asarray(x2d_flip)))
    rows = b * repeat_n * (2 if tta else 1)
    out = ours(x2d, x2d_flip, x_init=jax_x_init(key, rows, (f, 17, 3)))
    assert out.shape == expected.shape == (b, f, 17, 3)
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-4, atol=1e-4)
