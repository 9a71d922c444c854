"""The port's small-group GRAND attention (B6) and its dispatcher against
the JAX package: ``packed_grand_attention`` in interpret mode and the plain
``grand_attention``, atol 1e-5 (float32 sums in another order).

On the CPU the wrappers run their plain versions; the CUDA kernel is held
against them by tests/test_torch_cuda_kernels.py and by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.ops import attention as port
from diff3dhpe_tpu.ops.attention import grand_attention as jax_grand_attention
from diff3dhpe_tpu.ops.attention import packed_grand_attention as jax_packed

D = 64


def _qkv(rng, *shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("g,n", [(10, 17), (7, 27), (5, 64), (23, 17)])  # 10, 5, 23: no multiples of 7
def test_packed_ref_matches_jax_kernel(rng, g, n):
    q, k, v = _qkv(rng, g, n, D)
    expected = np.asarray(jax_packed(*map(jnp.asarray, (q, k, v)), interpret=True,
                                     tiles_per_step=2))
    plain = np.asarray(jax_grand_attention(*map(jnp.asarray, (q, k, v))))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ref = port.packed_grand_attention_ref(tq, tk, tv)
    out = port.packed_grand_attention(tq, tk, tv)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)  # a CPU tensor takes the plain version
    np.testing.assert_allclose(ref.numpy(), expected, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ref.numpy(), plain, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [17, 64, 65, 81])
def test_dispatcher_matches_jax(rng, n, monkeypatch):
    """[B, H, N, D] through the dispatcher, given as views of one qkv
    projection; N <= 64 goes to B6's wrapper, larger N to B3's."""
    b, h = 3, 2
    qkv = rng.standard_normal((b, n, 3, h, D)).astype(np.float32)
    q, k, v = torch.from_numpy(qkv).permute(2, 0, 3, 1, 4)
    expected = np.asarray(jax_grand_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v))))
    calls = []
    for name in ("packed_grand_attention", "grand_attention_fullseq"):
        fn = getattr(port, name)
        monkeypatch.setattr(port, name, lambda *a, _fn=fn, _name=name: (calls.append(_name),
                                                                         _fn(*a))[1])
    out = port.fused_grand_attention(q, k, v)
    assert calls == ["packed_grand_attention" if n <= 64 else "grand_attention_fullseq"]
    np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=1e-5)


def test_trainable_forward_goes_through_the_dispatcher(rng, monkeypatch):
    """JAX ``_gat_fwd``: the forward is the dispatcher's; the small-N
    backward stays on the plain formulas and equals autograd's."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(rng, 2, 2, 17, D))
    calls = []
    fn = port.fused_grand_attention
    monkeypatch.setattr(port, "fused_grand_attention", lambda *a: (calls.append(1), fn(*a))[1])
    do = torch.from_numpy(rng.standard_normal((2, 2, 17, D)).astype(np.float32))
    got = torch.autograd.grad(port.grand_attention_trainable(q, k, v), (q, k, v), do)
    assert calls == [1]
    ref = torch.autograd.grad(port.grand_attention(q, k, v), (q, k, v), do)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_packed_rejects_long_groups():
    x = torch.zeros(2, 65, D)
    with pytest.raises(ValueError, match="n <= 64"):
        port.packed_grand_attention(x, x, x)
    with pytest.raises(ValueError, match="n <= 64"):
        port.packed_grand_attention(x.to("meta"), x.to("meta"), x.to("meta"))
