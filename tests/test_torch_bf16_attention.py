"""The port's bf16 GRAND attention (B3 at bf16, the kernel behind the
attention step of B1, B2 and B5) and the block kernels' bf16 GEMM against
the JAX package, through their plain versions on the CPU:

- ``grand_attention_fullseq`` at bf16 against JAX's
  ``grand_attention_pallas_3d`` in interpret mode, under the bf16 bars of
  ``torch_port_helpers.assert_bf16_bars`` (both normalise first, round P to
  bf16 and round the output once; float32 sums taken in another order flip
  single bf16 roundings);
- the same plain function against the attention step inside the block
  kernels' plain version, exactly (one code path);
- the dispatcher's routing at bf16 and its dtype checks;
- the GEMM helper's plain version against ``jnp``'s bf16 product with
  float32 accumulation and the three epilogues.

The CUDA kernels are held against these plain versions by
tests/test_torch_cuda_kernels.py and by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from diff3dhpe_torch.models.mixste import Block
from diff3dhpe_torch.ops import attention as port
from diff3dhpe_torch.ops.fused_block import _attn_branch_ref, _gemm_bf16, _gemm_bf16_ref
from diff3dhpe_tpu.ops.attention import grand_attention_pallas_3d
from torch_port_helpers import assert_bf16_bars
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

D = 64


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).bfloat16()


def _to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("g,n", [(4, 243), (6, 81)])
def test_fullseq_bf16_matches_jax_kernel(rng, g, n):
    q, k, v = (_bf16(rng, g, n, D) for _ in range(3))
    expected = jax.jit(lambda a, b, c: grand_attention_pallas_3d(a, b, c, interpret=True))(
        *map(_to_jax, (q, k, v)))
    assert expected.dtype == jnp.bfloat16
    out = port.grand_attention_fullseq(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    # a CPU tensor takes the plain version
    torch.testing.assert_close(out, port.grand_attention_fullseq_ref(q, k, v), rtol=0, atol=0)
    assert_bf16_bars(out.float().numpy(), np.asarray(expected.astype(jnp.float32)))


@pytest.mark.parametrize("n,n_pad,groups", [(17, 17, 6), (81, 81, 2), (27, 32, 3)])
def test_fullseq_bf16_is_the_blocks_attention_step(rng, n, n_pad, groups):
    """``_attn_branch_ref`` = proj(attention(qkv(LN1(x)))) with the attention
    step of ``grand_attention_fullseq_ref``: rebuilt around the public
    function it gives the same bits. With n_pad > n the pad query rows
    attend to the real keys and subtract their own v."""
    c, heads, bf = 128, 2, torch.bfloat16
    block = Block(c, heads, 2.0, qkv_bias=True)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                    * (0.1 if p.ndim == 2 else 0.3))
    x = _bf16(rng, groups * n_pad, c).float()
    rnd = lambda a: a.to(bf).float()
    with torch.no_grad():
        want = _attn_branch_ref(x, block, n, heads, n_pad, bf)
        xn = rnd(F.layer_norm(x, (c,), block.norm1.weight, block.norm1.bias, block.norm1.eps))
        qkv = F.linear(xn, rnd(block.attn.qkv.weight), block.attn.qkv.bias).to(bf)
        q, k, v = qkv.view(groups, n_pad, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        if n_pad == n:
            attn = port.grand_attention_fullseq(q, k, v)
        else:
            attn = port.grand_attention_stored(q.float(), k[:, :, :n].float(), v[:, :, :n].float(),
                                               (c // heads) ** -0.5, rnd, v_self=v.float()).to(bf)
            real = port.grand_attention_fullseq(q[:, :, :n], k[:, :, :n], v[:, :, :n])
            torch.testing.assert_close(attn[:, :, :n], real, rtol=0, atol=0)
        got = F.linear(attn.float().permute(0, 2, 1, 3).reshape(groups * n_pad, c),
                       rnd(block.attn.proj.weight), block.attn.proj.bias)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n", [17, 243])
def test_dispatcher_sends_bf16_to_fullseq(rng, n, monkeypatch):
    """At bf16 as at float32, n <= 64 goes to B6's wrapper and larger n to
    B3's (B6 at bf16 is B3's tensor-core kernel)."""
    qkv = _bf16(rng, 2, n, 3, 2, D)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    calls = []
    for name in ("packed_grand_attention", "grand_attention_fullseq"):
        fn = getattr(port, name)
        monkeypatch.setattr(port, name, lambda *a, _fn=fn, _name=name: (calls.append(_name),
                                                                         _fn(*a))[1])
    out = port.fused_grand_attention(q, k, v)
    want = "packed_grand_attention" if n <= port.SMALL_N else "grand_attention_fullseq"
    assert calls == [want] and out.dtype == torch.bfloat16
    expected = jax.jit(lambda a, b, c: grand_attention_pallas_3d(a, b, c, interpret=True))(
        *(_to_jax(t.reshape(4, n, D)) for t in (q, k, v)))
    assert_bf16_bars(out.reshape(4, n, D).float().numpy(),
                     np.asarray(expected.astype(jnp.float32)))


@pytest.mark.parametrize("fn", ["fused_grand_attention", "grand_attention_fullseq"])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_mixed_dtypes_raise(rng, fn, which):
    qkv = [_bf16(rng, 2, 2, 17, D) for _ in range(3)]
    qkv[which] = qkv[which].float()
    with pytest.raises(ValueError, match="all be float32 or all bfloat16"):
        getattr(port, fn)(*qkv)
    with pytest.raises(ValueError, match="all be float32 or all bfloat16"):
        getattr(port, fn)(*(t.double() for t in qkv))


@pytest.mark.parametrize("epilogue,with_rscale", [("bias", False), ("gelu", False),
                                                  ("residual", False), ("residual", True)])
def test_gemm_ref_matches_jnp(rng, epilogue, with_rscale):
    """A ragged M (no multiple of the kernel's 128-row tile) and K = 96."""
    m, n, k = 170, 72, 96
    a, w = _bf16(rng, m, k), _bf16(rng, n, k, scale=k ** -0.5)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    res = _bf16(rng, m, n) if epilogue == "residual" else None
    rscale = None
    if with_rscale:
        rscale = torch.from_numpy(((rng.random((m, 2)) < 0.7) / 0.7).astype(np.float32))
    acc = jax.lax.dot_general(_to_jax(a), _to_jax(w), (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32) + jnp.asarray(bias.numpy())
    if epilogue == "gelu":
        acc = jax.nn.gelu(acc, approximate=False)
    elif epilogue == "residual":
        s = 1.0 if rscale is None else jnp.asarray(rscale.numpy())[:, 0:1]
        acc = _to_jax(res).astype(jnp.float32) + s * acc
    expected = np.asarray(acc.astype(jnp.bfloat16).astype(jnp.float32))
    ref = _gemm_bf16_ref(a, w, bias, epilogue, res, rscale)
    out = _gemm_bf16(a, w, bias, epilogue, res, rscale)
    assert ref.dtype == torch.bfloat16 and ref.shape == (m, n)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)  # a CPU tensor takes the plain version
    assert_bf16_bars(ref.float().numpy(), expected)


def test_gemm_rejects_bad_arguments(rng):
    a, w = _bf16(rng, 8, 32), _bf16(rng, 16, 32)
    with pytest.raises(ValueError, match="epilogue"):
        _gemm_bf16(a, w, epilogue="relu")
    with pytest.raises(ValueError, match="epilogue"):
        _gemm_bf16(a, w, epilogue="residual")
    with pytest.raises(ValueError, match="epilogue"):
        _gemm_bf16(a, w, epilogue="gelu", res=_bf16(rng, 8, 16))
    with pytest.raises(ValueError, match=r"w \[N, K\]"):
        _gemm_bf16(a, _bf16(rng, 16, 64))
