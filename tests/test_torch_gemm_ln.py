"""The block kernels' exact-f32 GEMM and their LayerNorm as ops, through
their plain versions on the CPU, against the JAX package:

- ``_gemm_f32_ref`` (``F.linear`` in float32 and the epilogue) against
  ``jnp.dot(..., precision=HIGHEST)`` with the same epilogue, for each
  epilogue: 1e-5 of max|jax| (float32 sums in another order);
- ``layer_norm_rows_ref`` against JAX's ``_layernorm_rows`` on the time-added
  rows as JAX's block kernel forms them (``xs = (x + t).astype(x.dtype)``),
  at float32 (1e-5 absolute) and bf16 (the bf16 bars; xs equal);
- on a CPU tensor each op is its plain version, and both refuse bad
  arguments.

The CUDA kernels are held against these plain versions by
tests/test_torch_cuda_kernels.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.ops.fused_block import (
    _gemm_f32, _gemm_f32_ref, layer_norm_rows, layer_norm_rows_ref,
)
from diff3dhpe_tpu.ops.fused_block import _layernorm_rows
from torch_port_helpers import assert_bf16_bars
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("epilogue,with_rscale", [("bias", False), ("gelu", False),
                                                  ("residual", False), ("residual", True)])
def test_gemm_f32_ref_matches_jnp_highest(rng, epilogue, with_rscale):
    """A ragged M (no multiple of the kernel's 128-row tile) and N = 4 x 19."""
    m, n, k = 170, 76, 96
    a, w, bias = _f32(rng, m, k), _f32(rng, n, k, scale=k ** -0.5), _f32(rng, n)
    res = _f32(rng, m, n) if epilogue == "residual" else None
    rscale = ((rng.random((m, 2)) < 0.7) / 0.7).astype(np.float32) if with_rscale else None
    acc = jnp.dot(jnp.asarray(a), jnp.asarray(w).T,
                  precision=jax.lax.Precision.HIGHEST) + jnp.asarray(bias)
    if epilogue == "gelu":
        acc = jax.nn.gelu(acc, approximate=False)
    elif epilogue == "residual":
        acc = jnp.asarray(res) + (1.0 if rscale is None else jnp.asarray(rscale)[:, 0:1]) * acc
    expected = np.asarray(acc)
    t = lambda x: None if x is None else torch.from_numpy(x)
    ref = _gemm_f32_ref(t(a), t(w), t(bias), epilogue, t(res), t(rscale))
    out = _gemm_f32(t(a), t(w), t(bias), epilogue, t(res), t(rscale))
    assert ref.dtype == torch.float32 and ref.shape == (m, n)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)  # a CPU tensor takes the plain version
    assert np.abs(ref.numpy() - expected).max() <= 1e-5 * np.abs(expected).max()


def test_gemm_f32_rejects_bad_arguments(rng):
    a, w = torch.from_numpy(_f32(rng, 8, 32)), torch.from_numpy(_f32(rng, 16, 32))
    with pytest.raises(ValueError, match="epilogue"):
        _gemm_f32(a, w, epilogue="relu")
    with pytest.raises(ValueError, match="epilogue"):
        _gemm_f32(a, w, epilogue="residual")
    with pytest.raises(ValueError, match=r"w \[N, K\]"):
        _gemm_f32(a, torch.from_numpy(_f32(rng, 16, 64)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_t", [False, True])
def test_layer_norm_rows_ref_matches_jax(rng, dtype, with_t):
    r, c, items, eps = 51, 96, 3, 1e-6
    x = jnp.asarray(_f32(rng, r, c, scale=2.0) + 0.5).astype(dtype)
    w, b = 1.0 + _f32(rng, c, scale=0.2), _f32(rng, c, scale=0.2)
    t = _f32(rng, items, c)
    xs = x
    if with_t:
        rows = np.arange(r) // (r // items)
        t_rows = jnp.asarray(t).astype(dtype).astype(jnp.float32)[rows]
        xs = (x.astype(jnp.float32) + t_rows).astype(dtype)
    expected = _layernorm_rows(xs, jnp.asarray(w), jnp.asarray(b), eps).astype(dtype)

    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
    kw = dict(t_rows=torch.from_numpy(t), rows_per_item=r // items) if with_t else {}
    y, xs_port = layer_norm_rows_ref(xt, torch.from_numpy(w), torch.from_numpy(b), eps, **kw)
    y_op, xs_op = layer_norm_rows(xt, torch.from_numpy(w), torch.from_numpy(b), eps, **kw)
    torch.testing.assert_close(y_op, y, rtol=0, atol=0)  # a CPU tensor takes the plain version
    torch.testing.assert_close(xs_op, xs_port, rtol=0, atol=0)
    assert y.dtype == xs_port.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(xs_port.float().numpy(), np.asarray(xs.astype(jnp.float32)))
    expected = np.asarray(expected.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), expected, rtol=0, atol=1e-5)
    else:
        assert_bf16_bars(y.float().numpy(), expected)


def test_layer_norm_rows_rejects_bad_arguments(rng):
    x = torch.from_numpy(_f32(rng, 6, 8))
    w, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="weight and bias"):
        layer_norm_rows(x, torch.ones(7), b)
    with pytest.raises(ValueError, match="t_rows"):
        layer_norm_rows(x, w, b, t_rows=torch.zeros(1, 8), rows_per_item=3)
    with pytest.raises(ValueError, match=r"\[R, C\]"):
        layer_norm_rows(x.double(), w, b)
