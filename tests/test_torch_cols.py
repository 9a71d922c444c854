"""B2, the port of ``fused_temporal_block_cols``, and the cols layout of the
fused forward, against the JAX package on the CPU (Pallas in interpret
mode) and against the port's own rows layout.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel is
held against that version by tests/test_torch_cuda_kernels.py on a GPU
and by chip_smoke.py at the flagship shapes. The port does not pad frames
(F8 = F); JAX is run both unpadded and padded to F8 = 16, and compared on
the real frames. At bf16 JAX's B2 rounds the out-LN parameters to bf16
(fused_block.py:846) where its B1 does not; the port keeps them float32 in
both layouts, which the bf16 bars allow (a 2^-9 relative change of the LN
scale flips single output roundings)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch import (
    draw_drop_path_scales, fast_forward_denoise, fast_forward_denoise_train_pairs,
    fused_temporal_block_cols, fused_temporal_block_cols_ref,
)
from diff3dhpe_tpu.models.fast_eval import fast_forward_denoise as jax_fast_forward
from diff3dhpe_tpu.ops.fused_block import fused_temporal_block_cols as jax_cols
from torch_port_helpers import assert_bf16_bars, build_pair
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

C, HEADS, B, F, J = 32, 4, 2, 9, 5


@pytest.fixture(scope="module")
def pair():
    """(numpy params, port model) of one depth-1 denoiser at F = 9."""
    _, params, port = build_pair(np.random.default_rng(1), num_frame=F, embed_dim=C, depth=1,
                                 num_heads=HEADS)
    return params, port


@pytest.mark.parametrize("dtype,f8,extras", [
    ("float32", F, True), ("float32", 16, True), ("bfloat16", F, True), ("bfloat16", 16, True),
    ("bfloat16", F, False),
])
def test_cols_ref_matches_jax(rng, pair, dtype, f8, extras):
    """With ``extras``: the time rows, the out-LN and per-group drop-path."""
    params, port = pair
    x = rng.standard_normal((B * F, J * C)).astype(np.float32)
    t = rng.standard_normal((B, C)).astype(np.float32)
    dp = ((rng.random((B * J, 2)) < 0.6) / 0.6).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    x_pad = jnp.pad(xj.reshape(B, F, J * C), ((0, 0), (0, f8 - F), (0, 0))).reshape(B * f8, J * C)
    # jit: the interpreted kernel runs op by op otherwise, several times slower.
    expected = jax.jit(lambda a: jax_cols(
        a, params["tte_block_0"], n=F, f8=f8, j_groups=J, heads=HEADS, interpret=True,
        t_rows=jnp.asarray(t) if extras else None,
        out_ln_params=params["temporal_norm"] if extras else None,
        dp_scales=jnp.asarray(dp) if extras else None))(x_pad)
    expected = np.asarray(expected.astype(jnp.float32)).reshape(B, f8, J * C)[:, :F]
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    kw = dict(t_rows=torch.from_numpy(t) if extras else None,
              out_ln=port.Temporal_norm if extras else None,
              dp_scales=torch.from_numpy(dp) if extras else None)
    with torch.no_grad():
        ref = fused_temporal_block_cols_ref(xt, port.TTEblocks[0], F, J, HEADS, **kw)
        out = fused_temporal_block_cols(xt, port.TTEblocks[0], F, J, HEADS, **kw)
    assert out.dtype == tdt and out.shape == (B * F, J * C)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)  # a CPU tensor takes the plain version
    got = ref.float().numpy().reshape(B, F, J * C)
    if dtype == "float32":
        np.testing.assert_allclose(got, expected, rtol=2e-4, atol=2e-5)
    else:
        assert_bf16_bars(got, expected)


def test_cols_wrapper_rejects_bad_arguments(pair):
    block = pair[1].TTEblocks[0]
    x = torch.zeros(B * F, J * C)
    with pytest.raises(ValueError):
        fused_temporal_block_cols(torch.zeros(B * F + 1, J * C), block, F, J, HEADS)  # rows % F
    with pytest.raises(ValueError):
        fused_temporal_block_cols(x, block, F, J, HEADS, t_rows=torch.zeros(B + 1, C))
    with pytest.raises(ValueError):
        fused_temporal_block_cols(x, block, F, J, HEADS, dp_scales=torch.ones(B * F, 2))
    with pytest.raises(ValueError):
        fused_temporal_block_cols(x.half(), block, F, J, HEADS)  # neither float32 nor bfloat16


@pytest.fixture(scope="module")
def pair2():
    """(numpy params, port model) at depth 2, F = 9."""
    _, params, port = build_pair(np.random.default_rng(2), num_frame=F, embed_dim=C, depth=2,
                                 num_heads=HEADS)
    return params, port


def test_cols_fast_forward_matches_jax_and_rows(rng, pair2):
    """The f32 forward in the cols layout against JAX's cols forward (the
    tests/test_fast_eval.py bar) and against the port's rows layout (1e-6;
    at bf16 equal)."""
    params, port = pair2
    x = rng.standard_normal((2, F, 17, 5)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    expected = np.asarray(jax.jit(lambda p: jax_fast_forward(
        p, jnp.asarray(x), jnp.asarray(t), num_frame=F, num_joints=17, depth=2, num_heads=HEADS,
        dtype=jnp.float32, interpret=True, temporal_mode="cols"))(params))
    cols = fast_forward_denoise(port, torch.from_numpy(x), torch.from_numpy(t), temporal_mode="cols")
    rows = fast_forward_denoise(port, torch.from_numpy(x), torch.from_numpy(t), temporal_mode="rows")
    np.testing.assert_allclose(cols.numpy(), expected, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(cols.numpy(), rows.numpy(), rtol=0, atol=1e-6)
    # At bf16 the layouts round at the same points on the same values.
    kw = dict(dtype=torch.bfloat16, f32_head=True)
    torch.testing.assert_close(
        fast_forward_denoise(port, torch.from_numpy(x), torch.from_numpy(t), temporal_mode="cols", **kw),
        fast_forward_denoise(port, torch.from_numpy(x), torch.from_numpy(t), temporal_mode="rows", **kw),
        rtol=0, atol=0)
    with pytest.raises(ValueError):
        fast_forward_denoise(port, torch.from_numpy(x), torch.from_numpy(t), temporal_mode="legacy")


def test_cols_train_pairs_match_rows(pair2):
    """The fused train forward in the cols layout: the output and every
    parameter gradient of sum(out²), with drop-path, against the rows
    layout (the recompute backward is the same in both)."""
    _, port = pair2
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(3, F, 17, 5, generator=gen)
    t = torch.tensor([3.0, 70.0, 700.0])
    dp = draw_drop_path_scales(gen, 3, 2, 0.5, F, 17)
    grads, outs = {}, {}
    for mode in ("rows", "cols"):
        port.zero_grad(set_to_none=True)
        out = fast_forward_denoise_train_pairs(port, x, t, dp, attn_bwd=True, temporal_mode=mode)
        (out ** 2).sum().backward()
        outs[mode] = out.detach()
        grads[mode] = {n: p.grad.clone() for n, p in port.named_parameters()}
    torch.testing.assert_close(outs["cols"], outs["rows"], rtol=0, atol=1e-6)
    for name, g in grads["rows"].items():
        assert (grads["cols"][name] - g).abs().max() <= 1e-5 * g.abs().max(), name
