"""The port's plain PyTorch MixSTEDenoiser against the flax module on the
same numpy params (the tests/test_model.py bar: <= 1e-4 abs), and against
the golden forward of tests/golden/tiny_model_v1.npz."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.io import state_dict_from_flax
from diff3dhpe_tpu.io.torch_convert import convert_params_to_torch_state_dict
from make_golden import GOLDEN, MODEL_KW, build
from torch_port_helpers import build_pair, port_model
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _inputs(rng, num_frame, num_joints=17):
    x = rng.standard_normal((2, num_frame, num_joints, 5)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    return x, t


@pytest.mark.parametrize(
    "mode,with_time_emb,qkv_bias,num_frame",
    [("s2s", True, True, 9), ("s2s", False, True, 9), ("s2f", True, True, 9),
     ("s2s", True, False, 9), ("s2s", True, True, 27)],
)
def test_module_matches_flax(rng, mode, with_time_emb, qkv_bias, num_frame):
    model, params, port = build_pair(
        rng, num_frame=num_frame, with_time_emb=with_time_emb, mode=mode, qkv_bias=qkv_bias,
    )
    x, t = _inputs(rng, num_frame)
    expected = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert out.shape == expected.shape
    np.testing.assert_allclose(out, expected, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode,qkv_bias", [("s2s", True), ("s2f", True), ("s2s", False)])
def test_state_dict_names_match_reference_converter(rng, mode, qkv_bias):
    """The port's converter emits the JAX package's reference names and
    values, and they are exactly the port module's own state_dict keys."""
    _, params, port = build_pair(rng, mode=mode, qkv_bias=qkv_bias)
    ours = state_dict_from_flax(params, 2, True, mode)
    ref = convert_params_to_torch_state_dict(params, 2, True, mode)
    assert set(ours) == set(ref) == set(port.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


@pytest.mark.skipif(
    not os.path.isfile(os.path.join(GOLDEN, "tiny_model_v1.npz")),
    reason="golden fixtures not generated",
)
def test_module_matches_golden_forward():
    golden = np.load(os.path.join(GOLDEN, "tiny_model_v1.npz"))
    _, _, params, x, t = build()
    kw = {k: MODEL_KW[k] for k in ("num_frame", "num_joints", "in_chans", "embed_dim",
                                   "depth", "num_heads", "mlp_ratio", "qkv_bias",
                                   "with_time_emb", "mode")}
    port = port_model(params, **kw)
    with torch.no_grad():
        out = port(torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(t))).numpy()
    np.testing.assert_allclose(out, golden["forward"], rtol=0, atol=1e-4)


def test_seeded_init_is_deterministic_and_uses_torch_bounds():
    from diff3dhpe_torch.models import MixSTEDenoiser

    a = MixSTEDenoiser(embed_dim=32, depth=1, num_heads=4, seed=3, device="cpu")
    b = MixSTEDenoiser(embed_dim=32, depth=1, num_heads=4, seed=3, device="cpu")
    c = MixSTEDenoiser(embed_dim=32, depth=1, num_heads=4, seed=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["fusion_layer.weight"], sc["fusion_layer.weight"])
    w = sa["STEblocks.0.mlp.fc2.weight"]  # fan_in = hidden = 64
    assert w.abs().max() <= 64 ** -0.5 and w.abs().max() > 0.9 * 64 ** -0.5
