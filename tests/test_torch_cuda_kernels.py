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

C = 128  # heads = C // 64: the kernel's head width is 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(device, num_frame=27, embed_dim=C, **kw):
    model = MixSTEDenoiser(num_frame=num_frame, embed_dim=embed_dim, depth=1,
                           num_heads=embed_dim // 64, device="cpu", **kw)
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
    before = fused_transformer_block.launches
    with torch.no_grad():
        out = fused_transformer_block(x, model.STEblocks[0], n, heads, **kw)
        ref = fused_transformer_block_ref(x, model.STEblocks[0], n, heads, **kw)
    torch.cuda.synchronize()
    assert fused_transformer_block.launches - before == (8 if with_out_ln else 7)
    real = lambda a: a.reshape(groups, n_pad, c)[:, :n]
    torch.testing.assert_close(real(out), real(ref), rtol=2e-4, atol=2e-5)


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
    before = fused_transformer_block.launches_bf16
    with torch.no_grad():
        out = fused_transformer_block(x, model.STEblocks[0], n, c // 64, **kw)
        ref = fused_transformer_block_ref(x, model.STEblocks[0], n, c // 64, **kw)
    torch.cuda.synchronize()
    assert fused_transformer_block.launches_bf16 - before == (8 if with_out_ln else 7)
    real = lambda a: a.reshape(groups, n_pad, c)[:, :n]
    assert_bf16_close(real(out), real(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,j", [(2, 27, 17), (1, 243, 5), (3, 9, 4)])
def test_cols_kernel_matches_ref(cuda_device, dtype, b, f, j):
    model = _model(cuda_device, num_frame=f)
    gen = torch.Generator(device=cuda_device).manual_seed(f)
    x = torch.randn(b * f, j * C, generator=gen, device=cuda_device).to(dtype)
    kw = dict(t_rows=torch.randn(b, C, generator=gen, device=cuda_device),
              out_ln=model.Temporal_norm,
              dp_scales=((torch.rand(b * j, 2, generator=gen, device=cuda_device) < 0.7) / 0.7).float())
    before = fused_temporal_block_cols.launches
    with torch.no_grad():
        out = fused_temporal_block_cols(x, model.TTEblocks[0], f, j, C // 64, **kw)
        ref = fused_temporal_block_cols_ref(x, model.TTEblocks[0], f, j, C // 64, **kw)
    torch.cuda.synchronize()
    assert fused_temporal_block_cols.launches - before == 8
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
    else:
        assert_bf16_close(out, ref)


def _qkv_views(device, b, h, n, seed):
    """q, k, v [b, h, n, 64] as strided views of one [b, n, 3, h, 64]
    projection, the layout the trainable attention hands to the kernels."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, 64, generator=gen, device=device)
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
    with pytest.raises(ValueError, match="head_dim"):
        packed_grand_attention(*(t[:, :, :17, :32] for t in (q, k, v)))
    with pytest.raises(ValueError, match="float32"):
        fused_grand_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,groups,c", [(17, 40, C), (243, 4, C), (27, 9, C), (81, 5, C),
                                        (17, 10, 192)])
def test_attention_block_kernel_matches_ref(cuda_device, dtype, n, groups, c):
    model = _model(cuda_device, embed_dim=c)
    gen = torch.Generator(device=cuda_device).manual_seed(n + 2)
    x = torch.randn(groups * n, c, generator=gen, device=cuda_device).to(dtype)
    before = fused_attention_block.launches, fused_attention_block.launches_bf16
    with torch.no_grad():
        out = fused_attention_block(x, model.STEblocks[0], n, c // 64)
        ref = fused_attention_block_ref(x, model.STEblocks[0], n, c // 64)
    torch.cuda.synchronize()
    assert fused_attention_block.launches - before[0] == 4
    assert fused_attention_block.launches_bf16 - before[1] == (0 if dtype == torch.float32 else 4)
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
    with pytest.raises(ValueError, match="float32"):
        fused.bfloat16()(x.bfloat16(), t)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 243])
def test_trainable_attention_grads(cuda_device, n):
    (q, k, v), gen = _qkv_views(cuda_device, 2, 2, n, 7)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    do = torch.randn(2, 2, n, 64, generator=gen, device=cuda_device)
    got = torch.autograd.grad(grand_attention_trainable(q, k, v), (q, k, v), do)
    ref = torch.autograd.grad(grand_attention_fullseq_ref(q, k, v), (q, k, v), do)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


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
