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
    fast_forward_denoise_train_pairs, fused_transformer_block, fused_transformer_block_ref,
    grand_attention_bwd, grand_attention_bwd_ref, grand_attention_fullseq,
    grand_attention_fullseq_ref, grand_attention_trainable, make_denoise_fn, make_eval_step,
    make_fast_denoise_fn,
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
