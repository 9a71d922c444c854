"""The port's fused_transformer_block against the JAX Pallas kernel in
interpret mode (the tests/test_fast_eval.py bar: rtol 2e-4, atol 2e-5).

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel is
held against that version by tests/test_torch_cuda_kernels.py, which runs
only where there is a GPU, and by chip_smoke.py at the flagship shapes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.ops import fused_transformer_block, fused_transformer_block_ref
from diff3dhpe_tpu.ops.fused_block import fused_transformer_block as jax_fused_block
from torch_port_helpers import build_pair
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

C, HEADS = 32, 4


@pytest.fixture(scope="module")
def pair():
    """(numpy params, port model) of one depth-1 denoiser, shared by the
    cases: building the flax params costs more than a case."""
    _, params, port = build_pair(np.random.default_rng(1), embed_dim=C, depth=1, num_heads=HEADS)
    return params, port


@pytest.mark.parametrize("with_t,with_out_ln", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("n,n_pad", [(17, None), (27, 32)])
def test_ref_matches_jax_kernel(rng, pair, n, n_pad, with_t, with_out_ln):
    groups, items = 6, 2
    params, port = pair
    x = rng.standard_normal((groups * (n_pad or n), C)).astype(np.float32)
    t = rng.standard_normal((items, C)).astype(np.float32) if with_t else None
    rows_per_item = groups * (n_pad or n) // items
    expected = np.asarray(jax_fused_block(
        jnp.asarray(x), params["ste_block_0"], n=n, heads=HEADS, interpret=True,
        out_ln_params=params["spatial_norm"] if with_out_ln else None,
        t_rows=None if t is None else jnp.asarray(t),
        rows_per_item=rows_per_item if with_t else None, pre_padded_n8=n_pad,
    ))
    kw = dict(n_pad=n_pad, t_rows=None if t is None else torch.from_numpy(t),
              rows_per_item=rows_per_item if with_t else None,
              out_ln=port.Spatial_norm if with_out_ln else None)
    with torch.no_grad():
        ref = fused_transformer_block_ref(torch.from_numpy(x), port.STEblocks[0], n, HEADS, **kw)
        out = fused_transformer_block(torch.from_numpy(x), port.STEblocks[0], n, HEADS, **kw)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)  # a CPU tensor takes the plain version
    # Pad rows (n..n_pad-1 of each group) carry garbage in both; compare real rows.
    real = lambda a: np.asarray(a).reshape(groups, n_pad or n, C)[:, :n]
    np.testing.assert_allclose(real(ref.numpy()), real(expected), rtol=2e-4, atol=2e-5)


def test_wrapper_rejects_bad_arguments(pair):
    block = pair[1].STEblocks[0]
    x = torch.zeros(34, C)
    with pytest.raises(ValueError):
        fused_transformer_block(x, block, n=17, heads=HEADS, n_pad=16)   # n > n_pad
    with pytest.raises(ValueError):
        fused_transformer_block(torch.zeros(30, C), block, n=17, heads=HEADS)  # R % n
    with pytest.raises(ValueError):
        fused_transformer_block(x, block, n=17, heads=HEADS, t_rows=torch.zeros(1, C),
                                rows_per_item=17)  # t_rows too short
    with pytest.raises(ValueError):
        fused_transformer_block(x.to("meta"), block, n=17, heads=HEADS)
