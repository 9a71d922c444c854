"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small widths. Every test here needs an NVIDIA GPU and skips
without one. The file imports neither JAX nor the JAX package, so it also
runs where JAX is not installed:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from diff3dhpe_torch import (
    GaussianDiffusion, MixSTEDenoiser, draw_drop_path_scales, fast_forward_denoise,
    fast_forward_denoise_train_pairs, fused_attention_block, fused_attention_block_ref,
    fused_grand_attention, fused_temporal_block_cols, fused_temporal_block_cols_ref,
    fused_transformer_block, fused_transformer_block_ref, grand_attention_bwd,
    grand_attention_bwd_ref, grand_attention_fullseq, grand_attention_fullseq_ref,
    grand_attention_trainable, make_denoise_fn, make_eval_step, make_fast_denoise_fn,
    make_mixed_diffusion, packed_grand_attention, packed_grand_attention_ref,
)
from diff3dhpe_torch.ops._build import load_library
from diff3dhpe_torch.ops.fused_block import (
    LN_MAX_C, _gemm_bf16, _gemm_bf16_ref, _gemm_f32, _gemm_f32_ref, _gemm_wgmma_f32,
    _gemm_wgmma_f32_ref, block_attention, block_attention_ref, layer_norm_rows,
    layer_norm_rows_ref, split_bf16, split_bf16_ref,
)

C = 128  # heads = C // 64: head width 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(device, num_frame=27, embed_dim=C, head_dim=64, **kw):
    model = MixSTEDenoiser(num_frame=num_frame, embed_dim=embed_dim, depth=1,
                           num_heads=embed_dim // head_dim, device="cpu", **kw)
    g = np.random.default_rng(0)
    with torch.no_grad():  # non-trivial LayerNorms and position embeddings
        for name, p in model.named_parameters():
            if "norm" in name or "pos_embed" in name or name.startswith("head.0"):
                p.add_(torch.from_numpy(0.2 * g.standard_normal(p.shape).astype(np.float32)))
    return model.to(device).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_pad,groups,with_t,with_out_ln,c", [
    (17, 17, 40, True, True, C), (243, 243, 4, True, True, C), (27, 32, 12, True, True, C),
    (17, 17, 8, False, False, C), (200, 256, 2, False, True, C), (256, 256, 2, True, True, C),
    (17, 17, 10, True, True, 192),  # 3C = 576 and M = 170: partial GEMM tiles both ways
    # The 3DHP config's 27 frames and HumanEva's 15 joints with 8 heads of 64.
    (27, 27, 24, True, True, 512), (15, 15, 40, True, True, 512),
])
def test_block_kernel_matches_ref(cuda_device, n, n_pad, groups, with_t, with_out_ln, c):
    model = _model(cuda_device, embed_dim=c)
    heads = c // 64
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(groups * n_pad, c, generator=gen, device=cuda_device)
    t = torch.randn(2, c, generator=gen, device=cuda_device)
    kw = dict(n_pad=n_pad, t_rows=t if with_t else None,
              rows_per_item=groups * n_pad // 2 if with_t else None,
              out_ln=model.Spatial_norm if with_out_ln else None)
    counts = lambda: [getattr(fused_transformer_block, f"launches{k}")
                      for k in ("", "_ln", "_gemm_f32", "_bf16")]
    before = counts()
    with torch.no_grad():
        out = fused_transformer_block(x, model.STEblocks[0], n, heads, **kw)
        ref = fused_transformer_block_ref(x, model.STEblocks[0], n, heads, **kw)
    torch.cuda.synchronize()
    # Every kernel, the LayerNorms, the f32 GEMMs, those at bf16.
    assert [a - b for a, b in zip(counts(), before)] == (
        [8, 3, 4, 0] if with_out_ln else [7, 2, 4, 0])
    real = lambda a: a.reshape(groups, n_pad, c)[:, :n]
    torch.testing.assert_close(real(out), real(ref), rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_pad,groups", [(17, 17, 40), (243, 243, 4), (27, 32, 12),
                                            (200, 256, 2)])
def test_block_kernel_at_head_dim_128_matches_ref(cuda_device, n, n_pad, groups):
    """B1 with head_dim 128 (C = 256, 2 heads) at f32, and at bf16 (the
    tensor-core attention's d = 128 instance) under the bf16 bars; with 8
    heads (head_dim 32, run on the 64 instance) at bf16 under the same bars;
    a head width the kernels lack (256, 1 head) is refused by the wrapper."""
    c = 256
    model = _model(cuda_device, embed_dim=c, head_dim=128)
    gen = torch.Generator(device=cuda_device).manual_seed(n + 3)
    x = torch.randn(groups * n_pad, c, generator=gen, device=cuda_device)
    dp = (torch.rand(groups * n_pad, 2, generator=gen, device=cuda_device) < 0.7) / 0.7
    kw = dict(n_pad=n_pad, t_rows=torch.randn(2, c, generator=gen, device=cuda_device),
              rows_per_item=groups * n_pad // 2, out_ln=model.Spatial_norm, dp_scales=dp.float())
    with torch.no_grad():
        out = fused_transformer_block(x, model.STEblocks[0], n, 2, **kw)
        ref = fused_transformer_block_ref(x, model.STEblocks[0], n, 2, **kw)
        real = lambda a: a.reshape(groups, n_pad, c)[:, :n]
        torch.testing.assert_close(real(out), real(ref), rtol=2e-4, atol=2e-5)
        xb = x.bfloat16()
        assert_bf16_close(real(fused_transformer_block(xb, model.STEblocks[0], n, 2, **kw)),
                          real(fused_transformer_block_ref(xb, model.STEblocks[0], n, 2, **kw)))
        assert_bf16_close(real(fused_transformer_block(xb, model.STEblocks[0], n, 8, **kw)),
                          real(fused_transformer_block_ref(xb, model.STEblocks[0], n, 8, **kw)))
        with pytest.raises(ValueError, match="head_dim"):
            fused_transformer_block(xb, model.STEblocks[0], n, 1, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n,groups", [(17, 40), (243, 4)])
def test_block_kernel_drop_path_matches_ref(cuda_device, n, groups):
    model = _model(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(groups * n, C, generator=gen, device=cuda_device)
    dp = (torch.rand(groups * n, 2, generator=gen, device=cuda_device) < 0.7) / 0.7
    kw = dict(t_rows=torch.randn(2, C, generator=gen, device=cuda_device),
              rows_per_item=groups * n // 2, out_ln=model.Spatial_norm, dp_scales=dp.float())
    with torch.no_grad():
        out = fused_transformer_block(x, model.STEblocks[0], n, C // 64, **kw)
        ref = fused_transformer_block_ref(x, model.STEblocks[0], n, C // 64, **kw)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)


def assert_bf16_close(out, ref):
    """The bf16 bars: kernel and plain version round at the same points, and
    float32 sums taken in another order flip single bf16 roundings (2^-8
    relative each): max |diff| <= 1e-2 max|ref|, mean |diff| <= 1e-3 max|ref|."""
    diff, scale = (out.float() - ref.float()).abs(), ref.float().abs().max()
    assert out.dtype == ref.dtype == torch.bfloat16
    assert diff.max() <= 1e-2 * scale and diff.mean() <= 1e-3 * scale, (diff.max(), diff.mean(), scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_pad,groups,with_t,with_out_ln,c", [
    (17, 17, 40, True, True, C), (243, 243, 4, True, True, C), (27, 32, 12, True, True, C),
    (17, 17, 8, False, False, C), (256, 256, 2, True, True, C),
    (17, 17, 10, True, True, 192),  # 3C = 576 and M = 170: partial GEMM tiles both ways
    (27, 27, 24, True, True, 512), (15, 15, 40, True, True, 512),  # 3DHP, HumanEva
])
def test_block_kernel_bf16_matches_ref(cuda_device, n, n_pad, groups, with_t, with_out_ln, c):
    model = _model(cuda_device, embed_dim=c)
    gen = torch.Generator(device=cuda_device).manual_seed(n + 1)
    x = torch.randn(groups * n_pad, c, generator=gen, device=cuda_device).bfloat16()
    t = torch.randn(2, c, generator=gen, device=cuda_device)
    dp = (torch.rand(groups * n_pad, 2, generator=gen, device=cuda_device) < 0.7) / 0.7
    kw = dict(n_pad=n_pad, t_rows=t if with_t else None,
              rows_per_item=groups * n_pad // 2 if with_t else None,
              out_ln=model.Spatial_norm if with_out_ln else None, dp_scales=dp.float())
    counts = lambda: [getattr(fused_transformer_block, f"launches{k}")
                      for k in ("_bf16", "_ln", "_gemm_f32")]
    before = counts()
    with torch.no_grad():
        out = fused_transformer_block(x, model.STEblocks[0], n, c // 64, **kw)
        ref = fused_transformer_block_ref(x, model.STEblocks[0], n, c // 64, **kw)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == (
        [8, 3, 0] if with_out_ln else [7, 2, 0])
    real = lambda a: a.reshape(groups, n_pad, c)[:, :n]
    assert_bf16_close(real(out), real(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,j", [(2, 27, 17), (1, 243, 5), (3, 9, 4), (2, 243, 15)])
def test_cols_kernel_matches_ref(cuda_device, dtype, b, f, j):
    model = _model(cuda_device, num_frame=f)
    gen = torch.Generator(device=cuda_device).manual_seed(f)
    x = torch.randn(b * f, j * C, generator=gen, device=cuda_device).to(dtype)
    kw = dict(t_rows=torch.randn(b, C, generator=gen, device=cuda_device),
              out_ln=model.Temporal_norm,
              dp_scales=((torch.rand(b * j, 2, generator=gen, device=cuda_device) < 0.7) / 0.7).float())
    counts = lambda: [getattr(fused_temporal_block_cols, f"launches{k}")
                      for k in ("", "_ln", "_gemm_f32")]
    before = counts()
    with torch.no_grad():
        out = fused_temporal_block_cols(x, model.TTEblocks[0], f, j, C // 64, **kw)
        ref = fused_temporal_block_cols_ref(x, model.TTEblocks[0], f, j, C // 64, **kw)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [8, 3, 4 if dtype == torch.float32 else 0]
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
    else:
        assert_bf16_close(out, ref)


def _qkv_views(device, b, h, n, seed, dtype=torch.float32, d=64):
    """q, k, v [b, h, n, d] as strided views of one [b, n, 3, h, d]
    projection, the layout the trainable attention hands to the kernels."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=gen, device=device).to(dtype)
    return qkv.permute(2, 0, 3, 1, 4), gen


@pytest.mark.cuda
@pytest.mark.parametrize("n", [243, 43, 256, 65])
def test_fullseq_attention_matches_ref(cuda_device, n):
    (q, k, v), gen = _qkv_views(cuda_device, 3, 2, n, n)
    before = grand_attention_fullseq.launches
    out = grand_attention_fullseq(q, k, v)
    torch.testing.assert_close(out, grand_attention_fullseq_ref(q, k, v), rtol=1e-5, atol=1e-5)
    g = torch.randn(5, n, 64, generator=gen, device=cuda_device)
    q3, k3, v3 = g, g.flip(0), g * 0.5
    torch.testing.assert_close(grand_attention_fullseq(q3, k3, v3),
                               grand_attention_fullseq_ref(q3, k3, v3), rtol=1e-5, atol=1e-5)
    assert grand_attention_fullseq.launches - before == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [243, 43, 256, 65])
def test_attention_bwd_matches_ref(cuda_device, n):
    (q, k, v), gen = _qkv_views(cuda_device, 3, 2, n, n + 1)
    do = torch.randn(3, n, 2, 64, generator=gen, device=cuda_device).transpose(1, 2)
    before = grand_attention_bwd.launches
    got = grand_attention_bwd(q, k, v, do)
    assert grand_attention_bwd.launches - before == 2
    for a, b in zip(got, grand_attention_bwd_ref(q, k, v, do)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [17, 31, 64, 200, 243, 256])
def test_f32_attention_kernels_at_both_head_widths(cuda_device, d, n):
    """B3, B4 and (n <= 64) B6 at head_dim 64 and 128 on strided qkv views
    (dO and the outputs laid out [B, N, H, d]) against their plain versions."""
    (q, k, v), gen = _qkv_views(cuda_device, 3, 2, n, n + d, d=d)
    do = torch.randn(3, n, 2, d, generator=gen, device=cuda_device).transpose(1, 2)
    counters = (grand_attention_fullseq, grand_attention_bwd, packed_grand_attention)
    before = [c.launches for c in counters]
    out = grand_attention_fullseq(q, k, v)
    torch.testing.assert_close(out, grand_attention_fullseq_ref(q, k, v), rtol=1e-5, atol=1e-5)
    for a, b in zip(grand_attention_bwd(q, k, v, do), grand_attention_bwd_ref(q, k, v, do)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    if n <= 64:
        torch.testing.assert_close(packed_grand_attention(q, k, v),
                                   packed_grand_attention_ref(q, k, v), rtol=1e-5, atol=1e-5)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 2, int(n <= 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_attention_bwd_is_deterministic(cuda_device, d):
    """B4 writes every gradient element from one thread, with no atomics:
    two calls on the same inputs give the same bits."""
    (q, k, v), gen = _qkv_views(cuda_device, 4, 3, 243, d, d=d)
    do = torch.randn(4, 243, 3, d, generator=gen, device=cuda_device).transpose(1, 2)
    first = grand_attention_bwd(q, k, v, do)
    for a, b in zip(first, grand_attention_bwd(q, k, v, do)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 1, 27, 32, 33, 64])
def test_packed_attention_matches_ref(cuda_device, n):
    """B6 on strided qkv views (13 groups x 3 heads: the last block is
    partly empty) and on contiguous [G, n, 64] operands."""
    (q, k, v), gen = _qkv_views(cuda_device, 13, 3, n, n)
    before = packed_grand_attention.launches
    out = packed_grand_attention(q, k, v)
    torch.testing.assert_close(out, packed_grand_attention_ref(q, k, v), rtol=1e-5, atol=1e-5)
    assert out.permute(0, 2, 1, 3).is_contiguous()  # laid out [B, N, H, 64]
    g = torch.randn(5, n, 64, generator=gen, device=cuda_device)
    q3, k3, v3 = g, g.flip(0), g * 0.5
    torch.testing.assert_close(packed_grand_attention(q3, k3, v3),
                               packed_grand_attention_ref(q3, k3, v3), rtol=1e-5, atol=1e-5)
    assert packed_grand_attention.launches - before == 2


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["views", "contiguous"])
@pytest.mark.parametrize("n", [15, 17, 27, 33, 64])
@pytest.mark.parametrize("d", [64, 128])
def test_small_kernel_matches_ref(cuda_device, d, n, layout):
    """The small-group kernel (B6 at f32) on qkv views and on contiguous
    [G, n, d] operands, with more pairs than the persistent grid holds, so
    every block walks several: within 1e-5 of the plain version (outputs of
    order 1), and the same bits in a second call."""
    pairs = 2000 if d == 64 else 1000
    if layout == "views":
        (q, k, v), _ = _qkv_views(cuda_device, pairs // 4, 4, n, n + d, d=d)
    else:
        gen = torch.Generator(device=cuda_device).manual_seed(n + d)
        q, k, v = (torch.randn(pairs, n, d, generator=gen, device=cuda_device) for _ in range(3))
    before = packed_grand_attention.launches
    out = packed_grand_attention(q, k, v)
    assert packed_grand_attention.launches - before == 1
    assert (out - packed_grand_attention_ref(q, k, v)).abs().max() <= 1e-5
    assert torch.equal(out, packed_grand_attention(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [15, 17, 27, 64])
@pytest.mark.parametrize("d", [64, 128])
def test_packed_attention_bf16_matches_ref(cuda_device, d, n):
    """B6 at bf16 (B3's tensor-core kernel) on qkv views and contiguous
    operands under the bf16 bars, counted on packed_grand_attention at
    bf16; n above 64 is refused by name."""
    (q, k, v), gen = _qkv_views(cuda_device, 13, 3, n, n + 5, torch.bfloat16, d=d)
    before = (packed_grand_attention.launches, packed_grand_attention.launches_bf16,
              grand_attention_fullseq.launches)
    out = packed_grand_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.permute(0, 2, 1, 3).is_contiguous()
    assert_bf16_close(out, packed_grand_attention_ref(q, k, v))
    g = torch.randn(7, n, d, generator=gen, device=cuda_device).bfloat16()
    assert_bf16_close(packed_grand_attention(g, g.flip(0), g * 0.5),
                      packed_grand_attention_ref(g, g.flip(0), g * 0.5))
    assert (packed_grand_attention.launches, packed_grand_attention.launches_bf16,
            grand_attention_fullseq.launches) == (before[0] + 2, before[1] + 2, before[2])
    x = torch.zeros(2, 65, d, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="n <= 64"):
        packed_grand_attention(x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [27, 17])
def test_f32_cols_block_equals_rows(cuda_device, f):
    """B2 equals B1 bit for bit at f32: the temporal groups (b, j) of f <= 32
    frames read in place from the spatial-major rows (B2, the small-group
    kernel with the outer index) and the same groups transposed to
    consecutive rows (B1, the same kernel without it), with the time add,
    drop-path and the out-LN."""
    b, j = 3, 17
    model = _model(cuda_device, num_frame=f)
    gen = torch.Generator(device=cuda_device).manual_seed(f + 1)
    x = torch.randn(b * f, j * C, generator=gen, device=cuda_device)
    t = torch.randn(b, C, generator=gen, device=cuda_device)
    dp = ((torch.rand(b * j, 2, generator=gen, device=cuda_device) < 0.7) / 0.7).float()
    block, out_ln = model.TTEblocks[0], model.Temporal_norm
    with torch.no_grad():
        cols = fused_temporal_block_cols(x, block, f, j, C // 64, t_rows=t, out_ln=out_ln,
                                         dp_scales=dp)
        x_rows = x.view(b, f, j, C).transpose(1, 2).reshape(b * j * f, C)
        rows = fused_transformer_block(x_rows, block, f, C // 64, t_rows=t, rows_per_item=j * f,
                                       out_ln=out_ln, dp_scales=dp.repeat_interleave(f, dim=0))
    torch.testing.assert_close(cols.view(b, f, j, C).transpose(1, 2).reshape(b * j * f, C),
                               rows, rtol=0, atol=0)


@pytest.mark.cuda
def test_dispatcher_picks_the_kernel_by_n(cuda_device):
    counters = (packed_grand_attention, grand_attention_fullseq)
    for n, want in ((17, (1, 0)), (64, (1, 0)), (65, (0, 1)), (243, (0, 1))):
        (q, k, v), _ = _qkv_views(cuda_device, 2, 2, n, n)
        before = [c.launches for c in counters]
        out = fused_grand_attention(q, k, v)
        assert tuple(c.launches - b for c, b in zip(counters, before)) == want
        torch.testing.assert_close(out, grand_attention_fullseq_ref(q, k, v), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="n <= 64"):
        packed_grand_attention(q, k, v)  # n = 243
    narrow = [t[:, :, :17, :32] for t in (q, k, v)]  # head_dim 32, rows 3·2·64 floats apart
    torch.testing.assert_close(packed_grand_attention(*narrow),
                               packed_grand_attention_ref(*narrow), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="head_dim"):
        packed_grand_attention(*_qkv_views(cuda_device, 2, 1, 17, 0, d=256)[0])
    with pytest.raises(ValueError, match="all be float32 or all bfloat16"):
        packed_grand_attention(*(t[:, :, :17].double() for t in (q, k, v)))
    with pytest.raises(ValueError, match="all be float32 or all bfloat16"):
        fused_grand_attention(q.bfloat16(), k, v)
    (q, k, v), _ = _qkv_views(cuda_device, 2, 2, 243, 0, torch.bfloat16, d=32)
    assert_bf16_close(grand_attention_fullseq(q, k, v), grand_attention_fullseq_ref(q, k, v))
    (q, k, v), _ = _qkv_views(cuda_device, 2, 1, 243, 0, torch.bfloat16, d=256)
    with pytest.raises(ValueError, match="head_dim"):  # past 128: K and V would not fit K1
        grand_attention_fullseq(q, k, v)


@pytest.mark.cuda
def test_kernel_ops_refuse_autograd_on_cuda(cuda_device):
    """A kernel writes into a buffer autograd does not see: on CUDA tensors
    that require grad, under grad mode, every kernel-launching wrapper
    raises before it launches; under no_grad the same call launches."""
    (q, k, v), _ = _qkv_views(cuda_device, 2, 2, 243, 5)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    model = _model(cuda_device)  # its parameters require grad
    x = torch.randn(2 * 27 * 17, C, device=cuda_device)
    block, heads = model.STEblocks[0], C // 64
    calls = {
        "fused_grand_attention": lambda: fused_grand_attention(q, k, v),
        "grand_attention_fullseq": lambda: grand_attention_fullseq(q, k, v),
        "packed_grand_attention": lambda: packed_grand_attention(q[:, :, :17], k[:, :, :17],
                                                                 v[:, :, :17]),
        "fused_transformer_block": lambda: fused_transformer_block(x, block, 17, heads),
        "fused_temporal_block_cols": lambda: fused_temporal_block_cols(
            x.view(2 * 27, 17 * C), model.TTEblocks[0], 27, 17, heads),
        "fused_attention_block": lambda: fused_attention_block(x, block, 17, heads),
    }
    wrappers = (fused_grand_attention, grand_attention_fullseq, packed_grand_attention,
                fused_transformer_block, fused_temporal_block_cols, fused_attention_block)
    for name, call in calls.items():
        before = sum(getattr(w, "launches", 0) for w in wrappers)
        with pytest.raises(RuntimeError, match=f"^{name} has no backward"):
            call()
        assert sum(getattr(w, "launches", 0) for w in wrappers) == before, name
        with torch.no_grad():
            assert torch.isfinite(call()).all(), name
        assert sum(getattr(w, "launches", 0) for w in wrappers) > before, name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 16, 17, 27, 64, 65, 243, 248, 256])
def test_fullseq_attention_bf16_matches_ref(cuda_device, n):
    """B3 at bf16 (the tensor-core kernel) on strided qkv views (13 groups x
    3 heads: at small n the last block is partly empty) and on contiguous
    [G, n, 64] operands, under the bf16 bars; the dispatcher sends n <= 64
    to B6's wrapper, which runs the same kernel at bf16."""
    (q, k, v), gen = _qkv_views(cuda_device, 13, 3, n, n, torch.bfloat16)
    counters = (grand_attention_fullseq, packed_grand_attention)
    before = [c.launches for c in counters]
    out = fused_grand_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.permute(0, 2, 1, 3).is_contiguous()
    assert_bf16_close(out, grand_attention_fullseq_ref(q, k, v))
    g = torch.randn(5, n, 64, generator=gen, device=cuda_device).bfloat16()
    q3, k3, v3 = g, g.flip(0), g * 0.5
    assert_bf16_close(grand_attention_fullseq(q3, k3, v3), grand_attention_fullseq_ref(q3, k3, v3))
    assert [c.launches - b for c, b in zip(counters, before)] == ([1, 1] if n <= 64 else [2, 0])


@pytest.mark.cuda
def test_fullseq_attention_bf16_limits(cuda_device):
    x = torch.zeros(2, 257, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="n <= 256"):
        grand_attention_fullseq(x, x, x)
    with pytest.raises(ValueError, match="all be float32 or all bfloat16"):
        grand_attention_fullseq(x, x.float(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 81, 243])
def test_fullseq_attention_bf16_at_head_dim_128(cuda_device, n):
    """The tensor-core attention's d = 128 instance (B3 at bf16) on strided
    qkv views, 13 groups x 3 heads, under the bf16 bars."""
    (q, k, v), _ = _qkv_views(cuda_device, 13, 3, n, n + 128, torch.bfloat16, d=128)
    before = grand_attention_fullseq.launches
    out = grand_attention_fullseq(q, k, v)
    assert grand_attention_fullseq.launches - before == 1
    assert out.dtype == torch.bfloat16 and out.permute(0, 2, 1, 3).is_contiguous()
    assert_bf16_close(out, grand_attention_fullseq_ref(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rows", "cols"])
@pytest.mark.parametrize("n", [17, 81, 243])
def test_bf16_block_at_head_dim_128(cuda_device, layout, n):
    """B1 (rows) and B2 (cols) at bf16 with head_dim 128 (C = 256, 2 heads)
    against their plain versions under the bf16 bars, with the time add,
    the out-LN and drop-path."""
    c, j = 256, 5
    model = _model(cuda_device, num_frame=n, embed_dim=c, head_dim=128)
    gen = torch.Generator(device=cuda_device).manual_seed(n + 11)
    block = model.STEblocks[0] if layout == "rows" else model.TTEblocks[0]
    if layout == "rows":
        groups = max(2, 1024 // n)
        x = torch.randn(groups * n, c, generator=gen, device=cuda_device).bfloat16()
        dp = (torch.rand(groups * n, 2, generator=gen, device=cuda_device) < 0.7) / 0.7
        kw = dict(t_rows=torch.randn(2, c, generator=gen, device=cuda_device),
                  rows_per_item=groups * n // 2, out_ln=model.Spatial_norm, dp_scales=dp.float())
        run = lambda f: f(x, block, n, 2, **kw)
        fns = (fused_transformer_block, fused_transformer_block_ref)
    else:
        x = torch.randn(2 * n, j * c, generator=gen, device=cuda_device).bfloat16()
        dp = (torch.rand(2 * j, 2, generator=gen, device=cuda_device) < 0.7) / 0.7
        kw = dict(t_rows=torch.randn(2, c, generator=gen, device=cuda_device),
                  out_ln=model.Temporal_norm, dp_scales=dp.float())
        run = lambda f: f(x, block, n, j, 2, **kw)
        fns = (fused_temporal_block_cols, fused_temporal_block_cols_ref)
    with torch.no_grad():
        out, ref = run(fns[0]), run(fns[1])
    assert_bf16_close(out, ref)


@pytest.mark.cuda
def test_bf16_cols_forward_equals_rows_at_head_dim_128(cuda_device):
    """The bf16 forward at head_dim 128 gives the same bits in both
    temporal layouts, through the small-group (27 frames) instance."""
    model = _model(cuda_device, num_frame=27, embed_dim=256, head_dim=128)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(2, 27, 17, 5, generator=gen, device=cuda_device)
    t = torch.tensor([3.0, 700.0], device=cuda_device)
    rows, cols = (fast_forward_denoise(model, x, t, dtype=torch.bfloat16, temporal_mode=m)
                  for m in ("rows", "cols"))
    torch.testing.assert_close(cols, rows, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue,with_rscale", [("bias", False), ("gelu", False),
                                                  ("residual", False), ("residual", True)])
@pytest.mark.parametrize("m,n,k", [(170, 576, 192), (301, 36, 64), (1000, 1028, 512),
                                   (16524, 1536, 512), (16524, 512, 512), (16524, 1024, 512),
                                   (16524, 512, 1024)])
def test_gemm_f32_matches_ref(cuda_device, m, n, k, epilogue, with_rscale):
    """The block kernels' exact-f32 GEMM (gemm_nt_kernel) alone, at ragged
    M (no multiple of 128) and N (4 x odd), and at the four products of a
    block at the eval rows, against F.linear in f32 (no TF32) and the same
    epilogue: the two sum k in other orders, so 1e-5 of max|ref|."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + n + k)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=cuda_device)
    a, w, bias = randn(m, k), randn(n, k) * k ** -0.5, randn(n)
    res = randn(m, n) if epilogue == "residual" else None
    rscale = ((torch.rand(m, 2, generator=gen, device=cuda_device) < 0.7) / 0.7).float() \
        if with_rscale else None
    before = _gemm_f32.launches
    out = _gemm_f32(a, w, bias, epilogue, res, rscale)
    torch.cuda.synchronize()
    assert _gemm_f32.launches - before == 1
    ref = _gemm_f32_ref(a, w, bias, epilogue, res, rscale)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(36, 64), (12, 64), (64, 30)])
def test_gemm_f32_refuses_shapes(cuda_device, k, n):
    """gemm_nt_kernel reads K in 8-column tiles and stores 4 columns at a
    time: K % 8 or N % 4 is refused by name before a launch."""
    a, w = torch.ones(16, k, device=cuda_device), torch.ones(n, k, device=cuda_device)
    before = _gemm_f32.launches
    with pytest.raises(ValueError, match=r"K % 8 == 0 and N % 4 == 0"):
        _gemm_f32(a, w)
    assert _gemm_f32.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_t", [False, True])
@pytest.mark.parametrize("r,c", [(1001, 512), (17, 192), (33, 64), (7, 1024), (65, 2048)])
def test_layer_norm_rows_matches_ref(cuda_device, dtype, with_t, r, c):
    """The block kernels' LayerNorm alone at odd R, with and without the
    time add (whose sum xs it also returns): f32 to 1e-5 of max|ref|, bf16
    under the bf16 bars (xs equal: one rounding of the same f32 sum). The
    widths reach every instance: 1 to 16 pieces a lane at f32, to 8 at
    bf16 (16 in the test below)."""
    gen = torch.Generator(device=cuda_device).manual_seed(r + c)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=cuda_device)
    x = (randn(r, c) * 3 + 1).to(dtype)
    w, b = 1 + 0.2 * randn(c), 0.2 * randn(c)
    kw = dict(t_rows=randn(3, c), rows_per_item=-(-r // 3)) if with_t else {}
    before = layer_norm_rows.launches
    y, xs = layer_norm_rows(x, w, b, 1e-6, **kw)
    torch.cuda.synchronize()
    assert layer_norm_rows.launches - before == 1
    y_ref, xs_ref = layer_norm_rows_ref(x, w, b, 1e-6, **kw)
    torch.testing.assert_close(xs, xs_ref, rtol=0, atol=0)
    if dtype == torch.float32:
        assert (y - y_ref).abs().max() <= 1e-5 * y_ref.abs().max()
    else:
        assert_bf16_close(y, y_ref)


@pytest.mark.cuda
def test_layer_norm_rows_width_limits(cuda_device):
    """The widest rows the LayerNorm takes: the library says LN_MAX_C; bf16
    at 4096 (16 pieces a lane) matches its plain version; wider rows, and
    rows not in 16-byte pieces, are refused by name before a launch."""
    lib = load_library("fused_block")
    assert {dt: lib.diff3dhpe_ln_max_c(dt.itemsize) for dt in LN_MAX_C} == LN_MAX_C
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=cuda_device)
    w, b = 1 + 0.2 * randn(4096), 0.2 * randn(4096)
    x = (randn(9, 4096) * 3 + 1).bfloat16()
    kw = dict(t_rows=randn(2, 4096), rows_per_item=5)
    y, xs = layer_norm_rows(x, w, b, 1e-6, **kw)
    y_ref, xs_ref = layer_norm_rows_ref(x, w, b, 1e-6, **kw)
    torch.testing.assert_close(xs, xs_ref, rtol=0, atol=0)
    assert_bf16_close(y, y_ref)
    before = layer_norm_rows.launches
    for x, c in ((x.float(), 4096), (randn(9, 8192).bfloat16(), 8192),
                 (randn(9, 66), 66), (randn(9, 68).bfloat16(), 68)):
        with pytest.raises(ValueError, match="LayerNorm takes C"):
            layer_norm_rows(x, w[:1].expand(c).contiguous(), b[:1].expand(c).contiguous())
    assert layer_norm_rows.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue,with_rscale", [("bias", False), ("gelu", False),
                                                  ("residual", False), ("residual", True)])
@pytest.mark.parametrize("m,n,k", [(170, 576, 192), (16524, 1536, 512), (300, 512, 1024)])
def test_gemm_bf16_matches_ref(cuda_device, m, n, k, epilogue, with_rscale):
    """The block kernels' bf16 GEMM alone, with partial tiles along M, N and
    K, under the bf16 bars."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + k)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=cuda_device)
    a, w = randn(m, k).bfloat16(), (randn(n, k) * k ** -0.5).bfloat16()
    bias = randn(n)
    res = randn(m, n).bfloat16() if epilogue == "residual" else None
    rscale = ((torch.rand(m, 2, generator=gen, device=cuda_device) < 0.7) / 0.7).float() \
        if with_rscale else None
    before = _gemm_bf16.launches
    out = _gemm_bf16(a, w, bias, epilogue, res, rscale)
    torch.cuda.synchronize()
    assert _gemm_bf16.launches - before == 1
    assert_bf16_close(out, _gemm_bf16_ref(a, w, bias, epilogue, res, rscale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,groups,c", [(17, 40, C), (243, 4, C), (27, 9, C), (81, 5, C),
                                        (17, 10, 192)])
def test_attention_block_kernel_matches_ref(cuda_device, dtype, n, groups, c):
    model = _model(cuda_device, embed_dim=c)
    gen = torch.Generator(device=cuda_device).manual_seed(n + 2)
    x = torch.randn(groups * n, c, generator=gen, device=cuda_device).to(dtype)
    counts = lambda: [getattr(fused_attention_block, f"launches{k}")
                      for k in ("", "_bf16", "_ln", "_gemm_f32")]
    before = counts()
    with torch.no_grad():
        out = fused_attention_block(x, model.STEblocks[0], n, c // 64)
        ref = fused_attention_block_ref(x, model.STEblocks[0], n, c // 64)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    assert [a - b for a, b in zip(counts(), before)] == [4, 0 if f32 else 4, 1, 2 if f32 else 0]
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
    else:
        assert_bf16_close(out, ref)


@pytest.mark.cuda
def test_use_pallas_model_runs_through_the_attention_kernels(cuda_device):
    """The module with use_pallas: B6 for every spatial block, B3 for every
    temporal one (81 frames), and the plain module's output."""
    plain = _model(cuda_device, num_frame=81)
    fused = MixSTEDenoiser(num_frame=81, embed_dim=C, depth=1, num_heads=C // 64,
                           use_pallas=True, device=cuda_device).eval()
    fused.load_state_dict(plain.state_dict())
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(3, 81, 17, 5, generator=gen, device=cuda_device)
    t = torch.tensor([3.0, 500.0, 999.0], device=cuda_device)
    counters = (packed_grand_attention, grand_attention_fullseq)
    before = [c.launches for c in counters]
    with torch.no_grad():
        out, ref = fused(x, t), plain(x, t)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1]
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    # At bf16 the same module sends its attention to B6 and B3 at bf16.
    fused16 = MixSTEDenoiser(num_frame=81, embed_dim=C, depth=1, num_heads=C // 64,
                             use_pallas=True, dtype=torch.bfloat16, device=cuda_device).eval()
    fused16.load_state_dict(plain.state_dict())
    before = [c.launches for c in counters] + [packed_grand_attention.launches_bf16]
    with torch.no_grad():
        out16 = fused16(x, t)
    after = [c.launches for c in counters] + [packed_grand_attention.launches_bf16]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    assert out16.dtype == torch.bfloat16 and torch.isfinite(out16.float()).all()
    assert (out16.float() - ref).abs().mean() <= 2e-2 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [17, 243])
def test_trainable_attention_grads(cuda_device, n, d):
    (q, k, v), gen = _qkv_views(cuda_device, 2, 2, n, 7, d=d)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    do = torch.randn(2, 2, n, d, generator=gen, device=cuda_device)
    got = torch.autograd.grad(grand_attention_trainable(q, k, v), (q, k, v), do)
    ref = torch.autograd.grad(grand_attention_fullseq_ref(q, k, v), (q, k, v), do)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [65, 72, 243])
def test_attention_bwd_bf16_matches_ref(cuda_device, n, d):
    """B4 at bf16 (the dq pass, which also forms the rows' softmax
    statistics, and the dk/dv pass, both on wgmma) on strided qkv views
    against its plain version, within the bf16 bars, with the same bits in
    two calls."""
    (q, k, v), gen = _qkv_views(cuda_device, 3, 2, n, n + d, dtype=torch.bfloat16, d=d)
    do = torch.randn(3, n, 2, d, generator=gen, device=cuda_device).bfloat16().transpose(1, 2)
    before = (grand_attention_bwd.launches, grand_attention_bwd.launches_bf16)
    got = grand_attention_bwd(q, k, v, do)
    assert (grand_attention_bwd.launches - before[0],
            grand_attention_bwd.launches_bf16 - before[1]) == (2, 2)
    for a, b in zip(got, grand_attention_bwd_ref(q, k, v, do)):
        assert_bf16_close(a, b)
    for a, b in zip(got, grand_attention_bwd(q, k, v, do)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [72, 243, 256])
def test_attention_bwd_bf16_from_forward_stats_is_bitwise(cuda_device, n, d):
    """B4 at bf16 as the train step calls it, from the rows' statistics
    that the trainable forward's B3 wrote, gives the bits of B4 called
    alone (whose dq pass forms them in B3's order of operations), and the
    same bits again in a second backward."""
    (q, k, v), gen = _qkv_views(cuda_device, 2, 3, n, 7 * n + d, dtype=torch.bfloat16, d=d)
    do = torch.randn(2, n, 3, d, generator=gen, device=cuda_device).bfloat16().transpose(1, 2)
    alone = grand_attention_bwd(q, k, v, do)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = grand_attention_trainable(q, k, v)
    before = grand_attention_bwd.launches_bf16
    got = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    assert grand_attention_bwd.launches_bf16 - before == 2
    again = torch.autograd.grad(out, (q, k, v), do)
    for a, b, c in zip(got, alone, again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [17, 243])
def test_trainable_attention_grads_bf16(cuda_device, n, d):
    """grand_attention_trainable at bf16: B6 or B3 forward, B4 (n > 64) or
    the XLA formulas backward, against the plain versions of the same
    steps, within the bf16 bars."""
    (q, k, v), gen = _qkv_views(cuda_device, 2, 2, n, 11, dtype=torch.bfloat16, d=d)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    do = torch.randn(2, 2, n, d, generator=gen, device=cuda_device).bfloat16()
    out = grand_attention_trainable(q, k, v)
    assert_bf16_close(out, grand_attention_fullseq_ref(q, k, v).detach())
    got = torch.autograd.grad(out, (q, k, v), do)
    if n > 64:
        ref = grand_attention_bwd_ref(q.detach(), k.detach(), v.detach(), do)
    else:
        from diff3dhpe_torch.ops.attention import grand_attention_bwd_xla
        ref = grand_attention_bwd_xla(q.detach(), k.detach(), v.detach(), do)
    for a, b in zip(got, ref):
        assert_bf16_close(a, b)


@pytest.mark.cuda
def test_bf16_fast_train_step_matches_the_bf16_module(cuda_device):
    """One bf16 fast-train step (attn_bwd: B1, B3, B4 and B6 at bf16) at
    B = 4, F = 243, against the bf16 module under autograd on the same t,
    noise and drop-path: the two round at other points (the module's
    LayerNorms return float32, the mirror's bf16), so the bars are the
    loss to 2e-2 relative and every gradient to 1e-1 of its max|g|."""
    from diff3dhpe_torch import make_fast_train_denoise_fn, make_train_denoise_fn

    model = _model(cuda_device, num_frame=243).train()
    module16 = MixSTEDenoiser(num_frame=243, embed_dim=C, depth=1, num_heads=C // 64,
                              dtype=torch.bfloat16, device=cuda_device).train()
    module16.load_state_dict(model.state_dict())
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    gt = torch.randn(4, 243, 17, 3, generator=gen, device=cuda_device) * 0.3
    x2d = torch.rand(4, 243, 17, 2, generator=gen, device=cuda_device) * 2 - 1
    inject = dict(t=torch.randint(0, 1000, (4,), generator=gen, device=cuda_device),
                  noise=torch.randn(4, 243, 17, 3, generator=gen, device=cuda_device),
                  dp_scales=draw_drop_path_scales(gen, 4, 1, 0.1, 243, 17))
    kw = dict(timesteps=1000, sampling_timesteps=5, clip_denoised=True, clip_loss=True)
    fast = GaussianDiffusion.create(make_fast_train_denoise_fn(
        model, 0.1, attn_bwd=True, dtype=torch.bfloat16), **kw)
    plain = GaussianDiffusion.create(make_train_denoise_fn(module16, 0.1), **kw)
    before = grand_attention_bwd.launches_bf16
    loss = fast.training_loss(gt, x2d, **inject)
    got = torch.autograd.grad(loss, list(model.parameters()))
    assert grand_attention_bwd.launches_bf16 - before == 2
    loss16 = plain.training_loss(gt, x2d, **inject)
    want = torch.autograd.grad(loss16, list(module16.parameters()))
    assert abs(loss.item() - loss16.item()) <= 2e-2 * abs(loss16.item())
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-1 * b.abs().max()


@pytest.mark.cuda
def test_fast_train_grads_match_module(cuda_device):
    model = _model(cuda_device, num_frame=81)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(2, 81, 17, 5, generator=gen, device=cuda_device)
    t = torch.tensor([3.0, 700.0], device=cuda_device)
    dp = draw_drop_path_scales(gen, 2, 1, 0.5, 81, 17)
    params = list(model.parameters())
    out = fast_forward_denoise_train_pairs(model, x, t, dp, attn_bwd=True)
    got = torch.autograd.grad((out ** 2).sum(), params)
    ref = model(x, t, dp)
    want = torch.autograd.grad((ref ** 2).sum(), params)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 2e-4 * b.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("mode,qkv_bias", [("s2s", True), ("s2f", True), ("s2s", False)])
def test_fast_forward_matches_module(cuda_device, mode, qkv_bias):
    model = _model(cuda_device, mode=mode, qkv_bias=qkv_bias)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(2, 27, 17, 5, generator=gen, device=cuda_device)
    t = torch.tensor([3.0, 700.0], device=cuda_device)
    with torch.no_grad():
        fast, plain = fast_forward_denoise(model, x, t), model(x, t)
    torch.testing.assert_close(fast, plain, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_eval_step_runs_through_the_kernel(cuda_device):
    model = _model(cuda_device, num_frame=9)
    kw = dict(timesteps=50, sampling_timesteps=5, clip_denoised=True)
    jl, jr = [4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]
    fast = make_eval_step(GaussianDiffusion.create(make_fast_denoise_fn(model), **kw), jl, jr)
    plain = make_eval_step(GaussianDiffusion.create(make_denoise_fn(model), **kw), jl, jr)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x2d = torch.rand(2, 9, 17, 2, generator=gen, device=cuda_device) * 2 - 1
    x_init = torch.randn(4, 9, 17, 3, generator=gen, device=cuda_device)
    fused_transformer_block.launches = 0
    out = fast(x2d, x2d.flip(0), x_init=x_init)
    assert fused_transformer_block.launches == 2 * 1 * 5 * 8  # blocks x steps x kernels
    torch.testing.assert_close(out, plain(x2d, x2d.flip(0), x_init=x_init), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("temporal_mode", ["rows", "cols"])
def test_mixed_eval_step_runs_through_the_kernels(cuda_device, temporal_mode):
    """The mixed eval (bf16 trunk with an f32 head, f32 final step): bf16
    launches on every step but the last, f32 launches on the last, and the
    result no further from the f32 eval than the pure-bf16 eval, by the
    mean per-joint position error."""
    model = _model(cuda_device, num_frame=9)
    kw = dict(timesteps=50, sampling_timesteps=5, clip_denoised=True)
    jl, jr = [4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]
    mixed = make_eval_step(make_mixed_diffusion(model, temporal_mode, **kw), jl, jr)
    bf16 = make_eval_step(GaussianDiffusion.create(
        make_fast_denoise_fn(model, torch.bfloat16, temporal_mode), **kw), jl, jr)
    f32 = make_eval_step(GaussianDiffusion.create(make_denoise_fn(model), **kw), jl, jr)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x2d = torch.rand(2, 9, 17, 2, generator=gen, device=cuda_device) * 2 - 1
    x_init = torch.randn(4, 9, 17, 3, generator=gen, device=cuda_device)
    counters = (fused_transformer_block, fused_temporal_block_cols)
    for c in counters:
        c.launches = c.launches_bf16 = 0
    out = mixed(x2d, x2d.flip(0), x_init=x_init)
    # 5 forwards, 4 of them bf16; per forward 8 kernels for each block call:
    # B1 for both blocks in rows mode, B1 and B2 for one block each in cols.
    want_b1 = (2 if temporal_mode == "rows" else 1) * 8
    assert fused_transformer_block.launches == 5 * want_b1
    assert fused_transformer_block.launches_bf16 == 4 * want_b1
    want_b2 = 0 if temporal_mode == "rows" else 8
    assert fused_temporal_block_cols.launches == 5 * want_b2
    assert fused_temporal_block_cols.launches_bf16 == 4 * want_b2
    ref = f32(x2d, x2d.flip(0), x_init=x_init)
    mpjpe = lambda a: (a - ref).norm(dim=-1).mean()
    dev_mixed, dev_bf16 = mpjpe(out), mpjpe(bf16(x2d, x2d.flip(0), x_init=x_init))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert dev_mixed <= dev_bf16, (dev_mixed, dev_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cols_forward_equals_rows(cuda_device, dtype):
    """B2 on the spatial-major rows computes what B1 computes on their
    transpose, in the same order: the two layouts give the same forward."""
    model = _model(cuda_device, num_frame=27)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(2, 27, 17, 5, generator=gen, device=cuda_device)
    t = torch.tensor([3.0, 700.0], device=cuda_device)
    rows, cols = (fast_forward_denoise(model, x, t, dtype=dtype, temporal_mode=m)
                  for m in ("rows", "cols"))
    torch.testing.assert_close(cols, rows, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [27, 81])
def test_cols_forward_equals_rows_at_head_dim_128(cuda_device, frames):
    """The same at f32 with head_dim 128 (C = 256, 2 heads), through the
    small-group kernel (27 frames) and the tiled one (81), and the forward
    against the plain module."""
    model = _model(cuda_device, num_frame=frames, embed_dim=256, head_dim=128)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn(2, frames, 17, 5, generator=gen, device=cuda_device)
    t = torch.tensor([3.0, 700.0], device=cuda_device)
    with torch.no_grad():
        rows, cols = (fast_forward_denoise(model, x, t, temporal_mode=m) for m in ("rows", "cols"))
        plain = model(x, t)
    torch.testing.assert_close(cols, rows, rtol=0, atol=0)
    torch.testing.assert_close(rows, plain, rtol=2e-4, atol=2e-5)


def _operator_cases(device):
    """Arguments of each ``diff3dhpe::`` operator at a small shape on
    ``device``: B1 (f32 with the time add and drop-path, and bf16), B2 and
    the attention dispatcher at n = 17 (B6) and n = 81 (B3)."""
    from diff3dhpe_torch.ops.fused_block import _block_operands

    model = _model(device)
    ops = tuple(t.detach() if isinstance(t, torch.Tensor) else t
                for t in _block_operands(model.STEblocks[0], model.Spatial_norm))
    g = torch.Generator(device=device).manual_seed(3)
    rand = lambda *shape: torch.randn(*shape, generator=g, device=device)
    x, t_rows = rand(4 * 17, C), rand(4, C)
    dp = (torch.rand(4 * 17, 2, generator=g, device=device) < 0.7).float() / 0.7
    qkv = rand(2, 17, 3, 2, 64)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    long_q, long_k, long_v = (rand(4, 81, 64) for _ in range(3))
    return {
        "fused_transformer_block": (x, t_rows, dp, *ops, 17, 2, 17, 17, 0),
        "fused_transformer_block_high3": (x, t_rows, dp, *ops, 17, 2, 17, 17, 1),
        "fused_transformer_block_bf16": (x.bfloat16(), t_rows, None, *ops, 17, 2, 17, 17, 0),
        "fused_temporal_block_cols": (rand(2 * 27, 17 * C), rand(2, C), None, *ops, 27, 17, 2,
                                      0),
        "fused_temporal_block_cols_default": (rand(2 * 27, 17 * C), rand(2, C), None, *ops, 27,
                                              17, 2, 2),
        "fused_grand_attention": (q, k, v, None),
        "fused_grand_attention_bf16": (q.bfloat16(), k.bfloat16(), v.bfloat16(), None),
        "fused_grand_attention_long": (long_q, long_k, long_v, None),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fused_transformer_block", "fused_transformer_block_high3",
                                  "fused_transformer_block_bf16", "fused_temporal_block_cols",
                                  "fused_temporal_block_cols_default", "fused_grand_attention",
                                  "fused_grand_attention_bf16", "fused_grand_attention_long"])
def test_operators_pass_opcheck_on_the_card(cuda_device, case):
    """``torch.library.opcheck`` on each operator's CUDA implementation (the
    kernel): its fake implementation gives the kernel's shape, dtype and
    strides, and AOT autograd traces it; the kernel is launched and counted
    on its wrapper."""
    from diff3dhpe_torch.ops import read_launches, reset_launches

    args = _operator_cases(cuda_device)[case]
    name = case.replace("_bf16", "").replace("_long", "").replace("_high3", "").replace(
        "_default", "")
    reset_launches()
    torch.library.opcheck(getattr(torch.ops.diff3dhpe, name).default, args)
    assert sum(read_launches().values()) > 0


# ---- the f32 contraction modes "high3" and "default" ------------------------
# "high3": kernel and plain version sum the same exact bf16 products in f32
# in other orders: 1e-5 of max|plain| (2e-5 through a whole block, whose
# LayerNorms pass differences on). "default": a bf16 rounding of an operand
# (q, k, e, v, or an activation between products) flips where the f32 sums
# before it differ in order: max and mean |kernel − plain| within 1e-3 and
# 2.5e-5 of max|plain|, phase 21's bars (chip_smoke.py). The separation r =
# mean|kernel − plain| / mean|plain − plain at "highest"| within phase 21's
# MODE_SEPARATION: a kernel that skipped a rounding or ran another mode sits
# at r >= 0.4 (tests/test_torch_contract_modes.py).
MODE_REL_TOL = {"high3": 1e-5, "default": None}
MODE_SEPARATION = {"default": 0.1, "high3": 0.45}


def _assert_mode_close(out, ref, mode, tol=None, highest=None):
    diff, scale = (out - ref).abs(), ref.abs().max()
    if mode == "default":
        assert diff.max() <= 1e-3 * scale and diff.mean() <= 2.5e-5 * scale, (diff.max(), scale)
    else:
        assert diff.max() <= (tol or MODE_REL_TOL[mode]) * scale, (diff.max(), scale)
    if highest is not None:  # the kernel is nearer its mode's plain version than "highest"
        r = diff.mean() / (ref - highest).abs().mean()
        assert r <= MODE_SEPARATION[mode], r


@pytest.mark.cuda
@pytest.mark.parametrize("lo", [True, False])
@pytest.mark.parametrize("shape", [(1536, 512), (17, 8), (3, 1000, 24)])
def test_split_bf16_matches_ref(cuda_device, shape, lo):
    """The split is exact: bit for bit its plain version."""
    x = torch.randn(*shape, generator=torch.Generator(device=cuda_device).manual_seed(1),
                    device=cuda_device) * 3
    before = split_bf16.launches
    hi, low = split_bf16(x, lo)
    torch.cuda.synchronize()
    assert split_bf16.launches - before == 1
    ref_hi, ref_lo = split_bf16_ref(x, lo)
    assert torch.equal(hi, ref_hi)
    assert (low is None) == (not lo) and (low is None or torch.equal(low, ref_lo))


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("epilogue,with_rscale", [("bias", False), ("gelu", False),
                                                  ("residual", True)])
@pytest.mark.parametrize("m,n,k", [(170, 576, 192), (1000, 1024, 512), (300, 512, 1024)])
def test_gemm_wgmma_f32_matches_ref(cuda_device, m, n, k, epilogue, with_rscale, passes):
    """The f32-output tensor-core GEMM of the modes at 1 and 3 passes, with
    partial tiles along M, N and K."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + n)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=cuda_device)
    (a_hi, a_lo), (w_hi, w_lo) = split_bf16(randn(m, k)), split_bf16(randn(n, k) * k ** -0.5)
    if passes == 1:
        a_lo = w_lo = None
    bias = randn(n)
    res = randn(m, n) if epilogue == "residual" else None
    rscale = ((torch.rand(m, 2, generator=gen, device=cuda_device) < 0.7) / 0.7).float() \
        if with_rscale else None
    before = _gemm_wgmma_f32.launches
    out = _gemm_wgmma_f32(a_hi, a_lo, w_hi, w_lo, bias, epilogue, res, rscale)
    torch.cuda.synchronize()
    assert _gemm_wgmma_f32.launches - before == 1 and out.dtype == torch.float32
    ref = _gemm_wgmma_f32_ref(a_hi, a_lo, w_hi, w_lo, bias, epilogue, res, rscale)
    _assert_mode_close(out, ref, "high3")


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("epilogue,with_rscale", [("bias", False), ("gelu", False),
                                                  ("residual", True), ("residual", False)])
@pytest.mark.parametrize("m,n,k", [(4001, 1536, 512), (333, 2048, 512), (129, 512, 1024)])
def test_gemm_wgmma_f32_tile_loop_and_separation(cuda_device, m, n, k, epilogue, with_rscale,
                                                 passes):
    """The persistent f32-output GEMM over more tiles than the card has SMs
    and at ragged M, at every epilogue, at the depths the blocks contract
    (K = C = 512 and hidden = 1024): against its plain version (1e-5 of
    max|plain|), and nearer it than its mode is to exact f32 sums of the
    same f32 operands (r <= MODE_SEPARATION; at three passes that needs the
    cross terms in their own accumulators); the same bits in two calls.
    hi·hi's accumulator still drops bits at every k-step, so r grows with
    K: 0.10 at K = 512, 0.21 at 1024 (H100 80GB HBM3, 700 W; PERF.md)."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + k)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=cuda_device)
    a, w = randn(m, k), randn(n, k) * k ** -0.5
    (a_hi, a_lo), (w_hi, w_lo) = split_bf16(a), split_bf16(w)
    if passes == 1:
        a_lo = w_lo = None
    bias = randn(n)
    res = randn(m, n) if epilogue == "residual" else None
    rscale = ((torch.rand(m, 2, generator=gen, device=cuda_device) < 0.7) / 0.7).float() \
        if with_rscale else None
    args = (a_hi, a_lo, w_hi, w_lo, bias, epilogue, res, rscale)
    before = _gemm_wgmma_f32.launches
    out = _gemm_wgmma_f32(*args)
    torch.cuda.synchronize()
    assert _gemm_wgmma_f32.launches - before == 1
    ref = _gemm_wgmma_f32_ref(*args)
    _assert_mode_close(out, ref, "high3")
    exact = _gemm_f32_ref(a, w, bias, epilogue, res, rscale)
    r = (out - ref).abs().mean() / (ref - exact).abs().mean()
    assert r <= MODE_SEPARATION["high3" if passes == 3 else "default"], r
    assert torch.equal(out, _gemm_wgmma_f32(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["qkv_views", "separate"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [65, 243, 256])
def test_attention_bwd_f32_default_on_the_tensor_cores(cuda_device, n, d, layout):
    """B4 at f32 under "default": the rounding kernels (one for q, k and v
    where they are views of one qkv projection, else one each; one for dO)
    and the bf16 B4's two tensor-core passes with f32 outputs, against the
    plain version at "default" at the "default" bars and r <= 0.1; the same
    bits in two calls."""
    if layout == "qkv_views":
        (q, k, v), gen = _qkv_views(cuda_device, 3, 2, n, 7 * n + d, d=d)
    else:
        gen = torch.Generator(device=cuda_device).manual_seed(7 * n + d)
        q, k, v = (torch.randn(3, 2, n, d, generator=gen, device=cuda_device) for _ in range(3))
    do = torch.randn(3, n, 2, d, generator=gen, device=cuda_device).transpose(1, 2)
    prec = dict(matmul_precision="default")
    before = grand_attention_bwd.launches
    got = grand_attention_bwd(q, k, v, do, **prec)
    torch.cuda.synchronize()
    assert grand_attention_bwd.launches - before == (4 if layout == "qkv_views" else 6)
    for a, b, h in zip(got, grand_attention_bwd_ref(q, k, v, do, **prec),
                       grand_attention_bwd_ref(q, k, v, do)):
        assert a.dtype == torch.float32
        _assert_mode_close(a, b, "default", highest=h)
    for a, b in zip(got, grand_attention_bwd(q, k, v, do, **prec)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high3", "default"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n,n_pad,groups", [(17, 17, 40), (27, 32, 12), (243, 243, 3),
                                            (81, 81, 4), (32, 32, 8), (65, 80, 4), (243, 256, 2),
                                            (1, 1, 3)])
def test_block_attention_modes_match_ref(cuda_device, mode, d, n, n_pad, groups):
    """The f32 attention step under each mode, the tensor-core kernel
    (csrc/grand_attn_mode.cuh: its 32-key instance up to n = 32), with pad
    query rows: it rounds e relative to the row's maximum, as the plain
    version rounds it; each nearer its mode's plain version than the mode
    is to "highest" (n = 1 has no softmax to round: out is 0 at every
    mode)."""
    heads = 2
    qkv = torch.randn(groups * n_pad, 3 * heads * d, device=cuda_device,
                      generator=torch.Generator(device=cuda_device).manual_seed(n + d))
    before = block_attention.launches
    out = block_attention(qkv, n, heads, n_pad, f32_prec=mode)
    torch.cuda.synchronize()
    assert block_attention.launches - before == 1
    real = lambda a: a.reshape(groups, n_pad, -1)[:, :n]
    ref = block_attention_ref(qkv, n, heads, n_pad, f32_prec=mode)
    exact = block_attention_ref(qkv, n, heads, n_pad)
    _assert_mode_close(real(out), real(ref), mode, highest=real(exact) if n > 1 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high3", "default"])
def test_layer_norm_time_add_modes_match_ref(cuda_device, mode):
    """The time add reads t as bf16(t) or t_hi + t_lo: bit for bit the
    plain version's xs; y to 1e-5 (f32 statistics in another order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x, t = (torch.randn(r, 512, generator=gen, device=cuda_device) for r in (1001, 7))
    w, b = torch.randn(512, device=cuda_device), torch.randn(512, device=cuda_device)
    kw = dict(t_rows=t, rows_per_item=143, f32_prec=mode)
    (y, xs), (ry, rxs) = layer_norm_rows(x, w, b, **kw), layer_norm_rows_ref(x, w, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(xs, rxs)
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-5)
    assert not torch.equal(xs, layer_norm_rows_ref(x, w, b, t_rows=t, rows_per_item=143)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high3", "default"])
@pytest.mark.parametrize("kind", ["rows17", "rows243", "cols", "cols64", "attn_block"])
def test_f32_blocks_under_modes_match_ref(cuda_device, mode, kind):
    """B1 (with the time add and the out-LN), B2 and B5 at f32 under each
    mode: 15 launches a block (8 splits, 4 tensor-core GEMMs, the attention,
    2 LNs) plus the out-LN, no exact f32 GEMM, the attention's and the
    first LN's instances under the mode, the attention on the tensor-core
    kernel; 8 for B5 (4 splits, 2 GEMMs, the attention, 1 LN without the
    time add). At each mode each is nearer its plain version than the
    mode is to "highest" (MODE_SEPARATION)."""
    model = _model(cuda_device, embed_dim=256, head_dim=64 if kind != "rows243" else 128)
    heads = 256 // (64 if kind != "rows243" else 128)
    block = model.STEblocks[0]
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=cuda_device)
    wrapper = (fused_temporal_block_cols if kind.startswith("cols") else
               fused_attention_block if kind == "attn_block" else fused_transformer_block)
    counts = lambda: [getattr(wrapper, k) for k in (
        "launches", "launches_split", "launches_gemm_mode", "launches_gemm_f32",
        "launches_attn_mode", "launches_ln_mode")]
    before = counts()
    with torch.no_grad():
        if kind == "attn_block":
            x = randn(40 * 17, 256)
            out, ref = (f(x, block, 17, heads, f32_prec=mode)
                        for f in (fused_attention_block, fused_attention_block_ref))
            highest = fused_attention_block_ref(x, block, 17, heads)
            want = [8, 4, 2, 0, 1, 0]
        elif kind.startswith("cols"):
            f, j = (27, 17) if kind == "cols" else (64, 5)
            x, t = randn(2 * f, j * 256), randn(2, 256)
            kw = dict(t_rows=t, out_ln=model.Temporal_norm, f32_prec=mode)
            out = fused_temporal_block_cols(x, block, f, j, heads, **kw)
            ref = fused_temporal_block_cols_ref(x, block, f, j, heads, **kw)
            highest = fused_temporal_block_cols_ref(x, block, f, j, heads,
                                                    **dict(kw, f32_prec="highest"))
            want = [16, 8, 4, 0, 1, 1]
        else:
            n = 17 if kind == "rows17" else 243
            x, t = randn(4 * n, 256), randn(2, 256)
            kw = dict(t_rows=t, rows_per_item=2 * n, out_ln=model.Spatial_norm, f32_prec=mode)
            out = fused_transformer_block(x, block, n, heads, **kw)
            ref = fused_transformer_block_ref(x, block, n, heads, **kw)
            highest = fused_transformer_block_ref(x, block, n, heads,
                                                  **dict(kw, f32_prec="highest"))
            want = [16, 8, 4, 0, 1, 1]
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == want
    _assert_mode_close(out, ref, mode, tol=2e-5, highest=highest)


@pytest.mark.cuda
def test_mixed_eval_final_step_modes(cuda_device):
    """The mixed eval step at each final mode: "highest" keeps the exact
    f32 GEMM, "high3" and "default" send the final forward's products (2
    blocks of 4) to the split and the tensor-core GEMM; "high3" lands
    within 1e-4 of max|out| of the exact final step."""
    model = _model(cuda_device)
    gen = lambda: torch.Generator(device=cuda_device).manual_seed(9)
    x2d = torch.randn(2, 27, 17, 2, device=cuda_device, generator=gen())
    kw = dict(timesteps=50, sampling_timesteps=3, clip_denoised=True)
    preds, counts = {}, {}
    for mode in ("highest", "high3", "default"):
        step = make_eval_step(make_mixed_diffusion(model, f32_prec=mode, **kw),
                              [4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16], device=cuda_device)
        before = (fused_transformer_block.launches_gemm_f32,
                  fused_transformer_block.launches_gemm_mode)
        preds[mode] = step(x2d, x2d, generator=gen())
        torch.cuda.synchronize()
        counts[mode] = (fused_transformer_block.launches_gemm_f32 - before[0],
                        fused_transformer_block.launches_gemm_mode - before[1])
    assert counts["highest"] == (8, 0)
    assert counts["high3"] == counts["default"] == (0, 8)
    assert all(torch.isfinite(p).all() for p in preds.values())
    scale = preds["highest"].abs().max()
    assert (preds["high3"] - preds["highest"]).abs().max() <= 1e-4 * scale


# ---- the session matmul precision "default" on B3, B4 and B6 at f32 -------


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [17, 27, 33, 64, 81, 243])
def test_session_default_attention_kernels_match_ref(cuda_device, d, n):
    """B3, B4 and (n <= 64) B6 at f32 under matmul_precision "default" on
    strided qkv views against their plain versions at "default", at the
    "default" bars, each nearer its plain version than "default" is to
    "highest"; B3 with and without B4's statistics (n > 32: the
    tensor-core kernel writes each row's maximum and 1/l)."""
    (q, k, v), gen = _qkv_views(cuda_device, 3, 2, n, 5 * n + d, d=d)
    do = torch.randn(3, n, 2, d, generator=gen, device=cuda_device).transpose(1, 2)
    prec = dict(matmul_precision="default")
    counters = (grand_attention_fullseq, grand_attention_bwd, packed_grand_attention)
    before = [c.launches for c in counters]
    out = grand_attention_fullseq(q, k, v, **prec)
    _assert_mode_close(out, grand_attention_fullseq_ref(q, k, v, **prec), "default",
                       highest=grand_attention_fullseq_ref(q, k, v))
    for a, b, h in zip(grand_attention_bwd(q, k, v, do, **prec),
                       grand_attention_bwd_ref(q, k, v, do, **prec),
                       grand_attention_bwd_ref(q, k, v, do)):
        _assert_mode_close(a, b, "default", highest=h)
    if n <= 64:
        _assert_mode_close(packed_grand_attention(q, k, v, **prec),
                           packed_grand_attention_ref(q, k, v, **prec), "default",
                           highest=packed_grand_attention_ref(q, k, v))
    torch.cuda.synchronize()
    # B4: the rounding of q, k and v (one kernel: views of one projection)
    # and of dO, then its two tensor-core passes.
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 4, int(n <= 64)]
    if n > 32:
        from diff3dhpe_torch.ops.attention import _bwd_stats, _fullseq

        stats = _bwd_stats(q)
        with_stats = _fullseq(q, k, v, None, stats, "default")
        torch.cuda.synchronize()
        assert torch.equal(with_stats, out)
        qb, kb = (t.bfloat16().float() for t in (q, k))
        logits = qb @ kb.transpose(-1, -2) * d ** -0.5
        m = logits.amax(-1)
        inv = 1.0 / torch.exp(logits - m[..., None]).sum(-1)
        n64 = -(-n // 64) * 64
        planes = stats.view(2, 3 * 2, n64)[:, :, :n]
        torch.testing.assert_close(planes[0], m.reshape(6, n), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(planes[1], inv.reshape(6, n), rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 243])
def test_trainable_attention_grads_at_session_default(cuda_device, n):
    """The trainable attention at f32 under "default": the forward (B6 or
    B3) and the backward (the plain formulas at n <= 64, else B4, which forms
    its own statistics) against autograd of the plain module's attention at
    "default" (JAX's VJP keeps the precision)."""
    from diff3dhpe_torch.ops.attention import grand_attention_bwd_xla

    (q, k, v), gen = _qkv_views(cuda_device, 2, 2, n, 11)
    do = torch.randn(2, 2, n, 64, generator=gen, device=cuda_device)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = grand_attention_trainable(q, k, v, matmul_precision="default")
    got = torch.autograd.grad(out, (q, k, v), do)
    ref_out = grand_attention_fullseq_ref(q, k, v, matmul_precision="default")
    _assert_mode_close(out.detach(), ref_out, "default")
    want = (grand_attention_bwd_xla if n <= 64 else grand_attention_bwd_ref)(
        q.detach(), k.detach(), v.detach(), do, matmul_precision="default")
    for a, b in zip(got, want):
        _assert_mode_close(a, b, "default")


# ---- head widths other than 64 and 128 (on the next compiled instance) ------

def _padded(t, width):
    """t [..., d] zero-padded along the last dim to width (a copy)."""
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def _padded_qkv(qkv, heads, d, width):
    """A block's qkv [R, 3·heads·d] with each head zero-padded to width."""
    r = qkv.shape[0]
    return _padded(qkv.view(r, 3, heads, d), width).reshape(r, 3 * heads * width)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 24, 32, 40, 96, 120])
@pytest.mark.parametrize("n", [17, 243])
def test_attention_kernels_at_narrow_head_widths(cuda_device, d, n):
    """Every forward attention kernel at a head width that runs on the next
    compiled instance (64 for d <= 64, else 128): B3 (n > 64) or B6 at f32,
    under the session "default" and at bf16 on strided qkv views, and the
    blocks' attention step in rows (pad query rows too) and in B2's cols
    layout at f32 under each mode and at bf16, each against its plain
    version at its bars and bit for bit the instance's output on copies
    zero-padded to its width with the same scale d^-½."""
    width, heads, scale = (64 if d <= 64 else 128), 3, d ** -0.5
    for dt in (torch.float32, torch.bfloat16):
        (q, k, v), gen = _qkv_views(cuda_device, 5, heads, n, n + d, dt, d=d)
        fn, ref = ((packed_grand_attention, packed_grand_attention_ref) if n <= 64
                   else (grand_attention_fullseq, grand_attention_fullseq_ref))
        for prec in (("highest", "default") if dt == torch.float32 else ("highest",)):
            out = fn(q, k, v, matmul_precision=prec)
            want = ref(q, k, v, matmul_precision=prec)
            if dt == torch.bfloat16:
                assert_bf16_close(out, want)
            elif prec == "default":
                _assert_mode_close(out, want, "default")
            else:
                torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
            padded = fn(*(_padded(t, width) for t in (q, k, v)), scale, matmul_precision=prec)
            assert torch.equal(out, padded[..., :d]), (dt, prec)
        n_pad = n if n > 32 else 24
        for layout, j in (("rows", 0), ("cols", 3)):
            g = (2 if layout == "cols" else 4) * (n_pad if layout == "rows" else n)
            qkv = torch.randn(g * max(j, 1), 3 * heads * d, generator=gen,
                              device=cuda_device).to(dt)
            kw = dict(n_pad=None if j else n_pad, j_groups=j)
            modes = ("highest", "high3", "default") if dt == torch.float32 else ("highest",)
            for mode in modes:
                out = block_attention(qkv, n, heads, f32_prec=mode, **kw)
                want = block_attention_ref(qkv, n, heads, f32_prec=mode, **kw)
                real = (lambda a: a) if j else (lambda a: a.reshape(-1, n_pad, heads * d)[:, :n])
                if dt == torch.bfloat16:
                    assert_bf16_close(real(out), real(want))
                elif mode == "highest":
                    torch.testing.assert_close(real(out), real(want), rtol=1e-5, atol=1e-5)
                else:
                    _assert_mode_close(real(out), real(want), mode)
                padded = block_attention(_padded_qkv(qkv, heads, d, width), n, heads,
                                         f32_prec=mode, scale=scale, **kw)
                rows = padded.shape[0]
                assert torch.equal(real(out), real(
                    padded.view(rows, heads, width)[..., :d].reshape(rows, heads * d))), (
                    dt, mode, layout)
