"""The port's attention half-block (B5, ``fused_attention_block``) against
the JAX Pallas kernel in interpret mode, at the shapes of
tests/test_fused_block.py: rtol 2e-4 / atol 2e-5 at float32, the bf16 bars
of ``torch_port_helpers.assert_bf16_bars`` at bfloat16 (both round the LN
output, qkv, the head outputs and the result).

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernels are
held against it by tests/test_torch_cuda_kernels.py and by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.models.mixste import Block
from diff3dhpe_torch.ops import fused_attention_block, fused_attention_block_ref
from diff3dhpe_tpu.ops.fused_block import fused_attention_block as jax_attention_block
from torch_port_helpers import assert_bf16_bars
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

C, HEADS = 64, 8


def _weights(rng):
    """(JAX arguments, the port's Block holding the same numbers)."""
    w = dict(
        ln_s=rng.standard_normal(C) * 0.1 + 1.0, ln_b=rng.standard_normal(C) * 0.1,
        w_qkv=rng.standard_normal((C, 3 * C)) * 0.05, b_qkv=rng.standard_normal(3 * C) * 0.05,
        w_proj=rng.standard_normal((C, C)) * 0.05, b_proj=rng.standard_normal(C) * 0.05,
    )
    w = {k: v.astype(np.float32) for k, v in w.items()}
    block = Block(C, HEADS, 2.0, qkv_bias=True)
    with torch.no_grad():
        block.norm1.weight.copy_(torch.from_numpy(w["ln_s"]))
        block.norm1.bias.copy_(torch.from_numpy(w["ln_b"]))
        block.attn.qkv.weight.copy_(torch.from_numpy(w["w_qkv"].T))
        block.attn.qkv.bias.copy_(torch.from_numpy(w["b_qkv"]))
        block.attn.proj.weight.copy_(torch.from_numpy(w["w_proj"].T))
        block.attn.proj.bias.copy_(torch.from_numpy(w["b_proj"]))
    return w, block


@pytest.mark.parametrize("n,groups", [(17, 21), (17, 8), (243, 3), (81, 5), (27, 9)])
def test_ref_matches_jax_kernel(rng, n, groups):
    w, block = _weights(rng)
    x = rng.standard_normal((n * groups, C)).astype(np.float32)
    expected = np.asarray(jax.jit(lambda a: jax_attention_block(
        a, *(jnp.asarray(w[k]) for k in ("ln_s", "ln_b", "w_qkv", "b_qkv", "w_proj", "b_proj")),
        n=n, heads=HEADS, interpret=True))(jnp.asarray(x)))
    with torch.no_grad():
        ref = fused_attention_block_ref(torch.from_numpy(x), block, n, HEADS)
        out = fused_attention_block(torch.from_numpy(x), block, n, HEADS)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)  # a CPU tensor takes the plain version
    np.testing.assert_allclose(ref.numpy(), expected, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n,groups", [(17, 21), (81, 5)])
def test_bf16_ref_matches_jax_kernel(rng, n, groups):
    """JAX takes every operand in bf16; the port keeps LN parameters and
    biases float32, so the block holds their bf16-rounded values."""
    w, _ = _weights(rng)
    bf = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in w.items()}
    x = jnp.asarray(rng.standard_normal((n * groups, C)).astype(np.float32)).astype(jnp.bfloat16)
    expected = jax.jit(lambda a: jax_attention_block(
        a, *(bf[k] for k in ("ln_s", "ln_b", "w_qkv", "b_qkv", "w_proj", "b_proj")),
        n=n, heads=HEADS, interpret=True))(x)
    assert expected.dtype == jnp.bfloat16
    block = Block(C, HEADS, 2.0, qkv_bias=True)
    rounded = {k: torch.from_numpy(np.array(v.astype(jnp.float32))) for k, v in bf.items()}
    with torch.no_grad():
        block.norm1.weight.copy_(rounded["ln_s"])
        block.norm1.bias.copy_(rounded["ln_b"])
        block.attn.qkv.weight.copy_(rounded["w_qkv"].T)
        block.attn.qkv.bias.copy_(rounded["b_qkv"])
        block.attn.proj.weight.copy_(rounded["w_proj"].T)
        block.attn.proj.bias.copy_(rounded["b_proj"])
        xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
        ref = fused_attention_block_ref(xt, block, n, HEADS)
        f32 = fused_attention_block_ref(xt.float(), block, n, HEADS)
    assert ref.dtype == torch.bfloat16
    assert_bf16_bars(ref.float().numpy(), np.asarray(expected.astype(jnp.float32)))
    assert not torch.equal(ref, f32.bfloat16())  # the bf16 path does round in between


def test_is_the_first_half_of_the_whole_block(rng):
    """B5 equals B1 with the MLP branch scaled to zero by drop-path."""
    from diff3dhpe_torch.ops import fused_transformer_block_ref

    _, block = _weights(rng)
    x = torch.from_numpy(rng.standard_normal((17 * 4, C)).astype(np.float32))
    dp = torch.tensor([[1.0, 0.0]]).expand(x.shape[0], 2).contiguous()
    with torch.no_grad():
        half = fused_attention_block_ref(x, block, 17, HEADS)
        whole = fused_transformer_block_ref(x, block, 17, HEADS, dp_scales=dp)
    torch.testing.assert_close(half, whole, rtol=0, atol=0)


def test_wrapper_rejects_bad_arguments(rng):
    _, block = _weights(rng)
    with pytest.raises(ValueError, match="multiple of n"):
        fused_attention_block(torch.zeros(30, C), block, 17, HEADS)
    with pytest.raises(ValueError, match="heads"):
        fused_attention_block(torch.zeros(34, C), block, 17, 7)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_attention_block(torch.zeros(34, C, dtype=torch.float16), block, 17, HEADS)
    with pytest.raises(ValueError, match="expected"):
        fused_attention_block(torch.zeros(34, 32), block, 17, 4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_attention_block(torch.zeros(34, C, device="meta"), block, 17, HEADS)
