"""Shared set-up for the tests that hold the PyTorch port against the JAX
package: one flax MixSTEDenoiser's params, perturbed so that every
parameter matters, loaded into the port's module by reference names."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.io import state_dict_from_flax
from diff3dhpe_torch.models import MixSTEDenoiser as TorchMixSTE
from diff3dhpe_tpu.models import MixSTEDenoiser

# Left/right joints of the 17-joint Human3.6M skeleton.
JOINTS_LEFT = [4, 5, 6, 11, 12, 13]
JOINTS_RIGHT = [1, 2, 3, 14, 15, 16]


def perturb(params, rng):
    """Non-trivial LayerNorm scales/biases and position embeddings (flax
    initialises them to ones/zeros, which would hide a wrong wiring)."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and set(v) == {"scale", "bias"}:
                out[k] = {
                    "scale": (1.0 + 0.2 * rng.standard_normal(v["scale"].shape)).astype(np.float32),
                    "bias": (0.2 * rng.standard_normal(v["bias"].shape)).astype(np.float32),
                }
            elif isinstance(v, dict):
                out[k] = walk(v)
            elif k.endswith("pos_embed"):
                out[k] = (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
            else:
                out[k] = v
        return out
    return walk(params)


def build_pair(rng, *, num_frame=9, num_joints=17, embed_dim=32, depth=2, num_heads=4,
               with_time_emb=True, mode="s2s", qkv_bias=True, perturbed=True):
    """(flax model, numpy params, port model on the CPU with those params)."""
    kw = dict(num_frame=num_frame, num_joints=num_joints, in_chans=2, embed_dim=embed_dim,
              depth=depth, num_heads=num_heads, mlp_ratio=2.0, qkv_bias=qkv_bias,
              with_time_emb=with_time_emb, mode=mode)
    model = MixSTEDenoiser(drop_path_rate=0.0, **kw)
    x = np.zeros((1, num_frame, num_joints, 5), np.float32)
    # jit: eager flax init compiles op by op, several seconds per new shape.
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x, np.zeros(1, np.float32))["params"]
    params = jax.tree.map(np.asarray, params)
    if perturbed:
        params = perturb(params, rng)
    return model, params, port_model(params, **kw)


def port_model(params, **kw):
    port = TorchMixSTE(**kw, device="cpu")
    port.load_state_dict(
        state_dict_from_flax(params, kw["depth"], kw["with_time_emb"], kw["mode"]), strict=True
    )
    return port.eval()


def jax_x_init(key, rows, row_shape):
    """x_T exactly as JAX's ddim_sample_loop draws it: one fold_in per row
    (diffusion/gaussian_diffusion.py:238-247)."""
    key_init, _ = jax.random.split(key)
    return np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key_init, i), row_shape, jnp.float32))
        for i in range(rows)
    ])


def assert_bf16_bars(out, expected):
    """The bf16 bars, in float32: max |out - expected| <= 1e-2 max|expected|
    and mean |out - expected| <= 1e-3 max|expected|. Two bf16 paths that
    round at the same points differ where float32 sums taken in another
    order flip single bf16 roundings, each worth 2^-8 relative."""
    out, expected = np.asarray(out, np.float32), np.asarray(expected, np.float32)
    assert out.shape == expected.shape, (out.shape, expected.shape)
    diff, scale = np.abs(out - expected), np.abs(expected).max()
    assert diff.max() <= 1e-2 * scale, (diff.max(), scale)
    assert diff.mean() <= 1e-3 * scale, (diff.mean(), scale)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Runs a test module's torch ops on one thread (imported by the port's
    test files, so autouse there): the tier-1 run puts several pytest
    workers on the machine's cores, and torch's OpenMP threads then spin
    against each other and against XLA's (test_torch_runner.py took over
    ten times longer in that run than alone at the default thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
