"""The port's GRAND attention ops of the training path against the JAX
package on the CPU: B3 (``grand_attention_fullseq``) and B4
(``grand_attention_bwd``), whose wrappers run their plain versions for CPU
tensors, against the Pallas kernels in interpret mode, and the gradients of
``grand_attention_trainable`` against JAX's custom VJP. The bar is rtol and
atol 1e-5, as in tests/test_pallas_attention.py. The CUDA kernels are held
against the same plain versions by tests/test_torch_cuda_kernels.py and
chip_smoke.py, on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.ops import (
    grand_attention_bwd,
    grand_attention_bwd_ref,
    grand_attention_fullseq,
    grand_attention_fullseq_ref,
    grand_attention_trainable,
)
from diff3dhpe_tpu.ops import attention as jax_attention
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _operands(rng, *shape, count=3):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("n", [96, 243])
def test_fullseq_matches_pallas(rng, n):
    q, k, v = _operands(rng, 3, n, 32)
    with jax.default_matmul_precision("highest"):
        expected = np.asarray(jax_attention.grand_attention_pallas_3d(
            *(jnp.asarray(a) for a in (q, k, v)), interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = grand_attention_fullseq(tq, tk, tv)
    torch.testing.assert_close(out, grand_attention_fullseq_ref(tq, tk, tv), rtol=0, atol=0)
    np.testing.assert_allclose(out.numpy(), expected, **TOL)


@pytest.mark.parametrize("n", [43, 243])
def test_bwd_matches_pallas(rng, n):
    q, k, v, do = _operands(rng, 3, n, 32, count=4)
    with jax.default_matmul_precision("highest"):
        expected = jax_attention.grand_attention_bwd_pallas(
            *(jnp.asarray(a) for a in (q, k, v, do)), interpret=True)
    tensors = [torch.from_numpy(a) for a in (q, k, v, do)]
    got = grand_attention_bwd(*tensors)
    for a, b, c in zip(got, grand_attention_bwd_ref(*tensors), expected):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **TOL)


@pytest.mark.parametrize("n", [17, 96, 243])
def test_trainable_grads_match_jax(rng, n):
    """n = 17 takes the plain formulas in both packages, n > 64 the kernels'
    dispatch (B3 forward, B4 backward)."""
    q, k, v, do = _operands(rng, 2, 2, n, 32, count=4)

    def loss(q_, k_, v_):
        return jnp.sum(jax_attention.grand_attention_trainable(q_, k_, v_) * jnp.asarray(do))

    with jax.default_matmul_precision("highest"):
        expected = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = grand_attention_trainable(tq, tk, tv)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for a, b in zip(got, expected):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_wrappers_reject_what_the_kernels_do_not_take():
    meta = torch.zeros(2, 243, 64, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        grand_attention_fullseq(meta, meta, meta)
    with pytest.raises(ValueError, match="cuda"):
        grand_attention_bwd(meta, meta, meta, meta)
    with pytest.raises(ValueError, match="G, N, D"):
        grand_attention_fullseq(*(torch.zeros(2, 3)[None].to("meta")[0] for _ in range(3)))
