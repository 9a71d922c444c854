"""The port's fast_forward_denoise (fused-block path; the plain version of
the kernel on the CPU) against the JAX fast_forward_denoise at f32 with the
Pallas kernels in interpret mode, at the tests/test_fast_eval.py bar
(rtol 2e-4, atol 2e-5). F=27 makes the temporal group size no multiple of
8: JAX pads it to 32, the port does not. Only the first case runs two
block pairs (the second without position embeddings): the interpreted
Pallas kernels cost about a second per block call."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.models import fast_forward_denoise
from diff3dhpe_tpu.models.fast_eval import fast_forward_denoise as jax_fast_forward
from torch_port_helpers import build_pair
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

C, HEADS = 32, 4


@pytest.mark.parametrize(
    "mode,with_time_emb,qkv_bias,num_frame,depth",
    [("s2s", True, True, 9, 2), ("s2s", False, True, 9, 1), ("s2f", True, True, 9, 1),
     ("s2s", True, False, 9, 1), ("s2s", True, True, 27, 1)],
)
def test_fast_forward_matches_jax(rng, mode, with_time_emb, qkv_bias, num_frame, depth):
    _, params, port = build_pair(
        rng, num_frame=num_frame, embed_dim=C, depth=depth, num_heads=HEADS,
        with_time_emb=with_time_emb, mode=mode, qkv_bias=qkv_bias,
    )
    x = rng.standard_normal((2, num_frame, 17, 5)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    expected = np.asarray(jax_fast_forward(
        params, jnp.asarray(x), jnp.asarray(t), num_frame=num_frame, num_joints=17,
        depth=depth, num_heads=HEADS, with_time_emb=with_time_emb, mode=mode,
        dtype=jnp.float32, interpret=True,
    ))
    out = fast_forward_denoise(port, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert out.shape == expected.shape
    np.testing.assert_allclose(out, expected, rtol=2e-4, atol=2e-5)
    with torch.no_grad():
        plain = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, plain, rtol=2e-4, atol=2e-5)
