"""Head width 128 (embed 256 with 2 heads, the width of the configs with
``num_heads`` 4 at embed 512) through the port's f32 attention ops on the
CPU, against the JAX package: B3 (``grand_attention_fullseq``) against
``grand_attention_pallas_3d`` and B4 (``grand_attention_bwd``) against
``grand_attention_bwd_pallas``, both in interpret mode, B6's plain version
against ``packed_grand_attention``, and the ``use_pallas`` denoiser at
depth 1 and 9 frames against the flax one. On the CPU the wrappers run
their plain versions; the CUDA kernels are held against the same plain
versions at head_dim 128 by tests/test_torch_cuda_kernels.py and
chip_smoke.py. Also: which head widths ``check_supported`` accepts and
refuses on a CUDA device (every multiple of 8 from 8 to 128, so 16 heads
at embed 512 too; tests/test_torch_head_widths.py holds those widths).

Bars: the forward 1e-5 absolute (float32 sums in another order, outputs of
order 1); the backward 2e-4 of max|g| (gradients sum n products of order
sqrt(128))."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.config import Config
from diff3dhpe_torch.engine.runner import check_supported
from diff3dhpe_torch.ops import attention as port
from diff3dhpe_tpu.ops import attention as jax_attention
from torch_port_helpers import build_pair, port_model
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

EMBED, HEADS, D = 256, 2, 128
FWD_ABS = 1e-5
BWD_REL = 2e-4


def _operands(rng, *shape, count=3):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("n", [9, 27])
def test_fullseq_matches_pallas_at_head_dim_128(rng, n):
    q, k, v = _operands(rng, 3, n, D)
    with jax.default_matmul_precision("highest"):
        expected = np.asarray(jax_attention.grand_attention_pallas_3d(
            *(jnp.asarray(a) for a in (q, k, v)), interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = port.grand_attention_fullseq(tq, tk, tv)
    torch.testing.assert_close(out, port.grand_attention_fullseq_ref(tq, tk, tv), rtol=0, atol=0)
    np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=FWD_ABS)


@pytest.mark.parametrize("n", [9, 27])
def test_bwd_matches_pallas_at_head_dim_128(rng, n):
    q, k, v, do = _operands(rng, 3, n, D, count=4)
    with jax.default_matmul_precision("highest"):
        expected = jax_attention.grand_attention_bwd_pallas(
            *(jnp.asarray(a) for a in (q, k, v, do)), interpret=True)
    tensors = [torch.from_numpy(a) for a in (q, k, v, do)]
    got = port.grand_attention_bwd(*tensors)
    for a, b, c in zip(got, port.grand_attention_bwd_ref(*tensors), expected):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        c = np.asarray(c)
        assert np.abs(a.numpy() - c).max() <= BWD_REL * np.abs(c).max()


@pytest.mark.parametrize("g,n", [(10, 9), (7, 27)])
def test_packed_ref_matches_jax_at_head_dim_128(rng, g, n):
    q, k, v = _operands(rng, g, n, D)
    expected = np.asarray(jax_attention.packed_grand_attention(
        *map(jnp.asarray, (q, k, v)), interpret=True, tiles_per_step=2))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = port.packed_grand_attention(tq, tk, tv)
    torch.testing.assert_close(out, port.packed_grand_attention_ref(tq, tk, tv), rtol=0, atol=0)
    np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=FWD_ABS)


def test_use_pallas_model_matches_flax_at_head_dim_128(rng):
    from diff3dhpe_tpu.models import MixSTEDenoiser as FlaxMixSTE

    kw = dict(num_frame=9, num_joints=17, in_chans=2, embed_dim=EMBED, depth=1,
              num_heads=HEADS, mlp_ratio=2.0, qkv_bias=True, with_time_emb=True, mode="s2s")
    _, params, _ = build_pair(rng, num_frame=9, embed_dim=EMBED, depth=1, num_heads=HEADS)
    fused = port_model(params, use_pallas=True, **kw)
    flax = FlaxMixSTE(drop_path_rate=0.0, use_pallas=True, **kw)
    x = rng.standard_normal((2, 9, 17, 5)).astype(np.float32)
    t = np.array([3.0, 41.0], np.float32)
    expected = np.asarray(jax.jit(lambda p, a, b: flax.apply({"params": p}, a, b))(
        params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = fused(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=1e-4)


HEADS4 = dict(subjects_train="S1", subjects_test="S9", number_of_frames=9, stride=9,
              embed_dim=512, transformer_depth=1, num_heads=4, timesteps=50,
              sampling_timesteps=3, batch_size_eval=4, actions="*", seed=5)
MIXED = dict(fast_eval=True, compute_dtype="bfloat16", eval_f32_final_steps=1, eval_f32_head=True)


@pytest.mark.parametrize("overrides", [
    dict(num_heads=2, fast_eval=True),               # head_dim 256: past K1's shared memory
    dict(embed_dim=480, num_heads=24, use_pallas_attention=True),  # 20: no multiple of 8
])
def test_check_supported_refuses_head_widths_the_kernels_do_not_take(overrides):
    cfg = Config(**{**HEADS4, **overrides})
    with pytest.raises(ValueError, match="^num_heads="):
        check_supported(cfg, torch.device("cuda"))
    check_supported(cfg, torch.device("cpu"))  # the plain versions take every width
    check_supported(cfg)


@pytest.mark.parametrize("overrides", [
    dict(embed_dim=4096, num_heads=32, fast_eval=True),             # f32 rows of 4096
    dict(embed_dim=4096, num_heads=32, **MIXED),                    # its final step is f32
    dict(embed_dim=8192, num_heads=64, fast_eval=True, compute_dtype="bfloat16"),
])
def test_check_supported_refuses_rows_wider_than_the_layer_norm_takes(overrides):
    cfg = Config(**{**HEADS4, **overrides})
    with pytest.raises(ValueError, match="^embed_dim="):
        check_supported(cfg, torch.device("cuda"))
    check_supported(cfg, torch.device("cpu"))  # the plain LayerNorm takes every width


@pytest.mark.parametrize("overrides", [
    dict(fast_eval=True), dict(use_pallas_attention=True), dict(),  # head_dim 128 at f32
    dict(embed_dim=2048, num_heads=16, fast_eval=True),              # the widest f32 LN rows
    dict(embed_dim=4096, num_heads=32, fast_eval=True, compute_dtype="bfloat16"),  # bf16's
    dict(num_heads=8, **MIXED),                                      # head_dim 64 at bf16
    dict(fast_eval=True, compute_dtype="bfloat16"),  # pure bf16 at 128: the bf16 block (K1, wgmma)
    MIXED,                                           # the mixed mode's bf16 steps at 128
    dict(num_heads=16, fast_eval=True),              # head_dim 32 on the 64 instance
    dict(num_heads=16, use_pallas_attention=True),
])
def test_check_supported_accepts_what_the_kernels_take(overrides):
    check_supported(Config(**{**HEADS4, **overrides}), torch.device("cuda"))
