"""The kernel ops refuse autograd: a wrapper that launches a kernel into a
buffer autograd does not see raises under grad mode when an input requires
grad, on the CPU too (its plain version stands in for the kernel), as
``jax.grad`` through JAX's Pallas kernels raises. Training goes through
``grand_attention_trainable`` and ``_FusedPair``, which keep working, and
``fast_train`` on a ``use_pallas`` model trains as on a plain one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch import (
    GaussianDiffusion, fast_forward_denoise_train_pairs, fused_attention_block,
    fused_grand_attention, fused_temporal_block_cols, fused_transformer_block,
    grand_attention_fullseq, grand_attention_trainable, make_fast_train_denoise_fn,
    make_optimizer, make_train_step, packed_grand_attention,
)
from diff3dhpe_torch.models import MixSTEDenoiser
from diff3dhpe_tpu.models import MixSTEDenoiser as FlaxMixSTE
from diff3dhpe_tpu.io.torch_convert import convert_torch_state_dict
from diff3dhpe_tpu.ops import attention as jax_attention
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

J, C, HEADS = 17, 32, 4


def _qkv(n, grad):
    g = torch.Generator().manual_seed(n)
    return [torch.randn(2, HEADS, n, C // HEADS, generator=g).requires_grad_(grad)
            for _ in range(3)]


def _block_calls(model):
    """(name, call) for the three block wrappers on rows of the model's width."""
    x = torch.randn(2 * 9 * J, C, generator=torch.Generator().manual_seed(1))
    return [
        ("fused_transformer_block", lambda: fused_transformer_block(
            x, model.STEblocks[0], J, HEADS, out_ln=model.Spatial_norm)),
        ("fused_temporal_block_cols", lambda: fused_temporal_block_cols(
            x.view(2 * 9, J * C), model.TTEblocks[0], 9, J, HEADS, out_ln=model.Temporal_norm)),
        ("fused_attention_block", lambda: fused_attention_block(x, model.STEblocks[0], J, HEADS)),
    ]


@pytest.mark.parametrize("name,n", [("fused_grand_attention", 17), ("fused_grand_attention", 72),
                                    ("packed_grand_attention", 17),
                                    ("grand_attention_fullseq", 72)])
def test_attention_wrappers_refuse_autograd(name, n):
    op = {"fused_grand_attention": fused_grand_attention,
          "packed_grand_attention": packed_grand_attention,
          "grand_attention_fullseq": grand_attention_fullseq}[name]
    with pytest.raises(RuntimeError, match=f"^{name} has no backward.*grand_attention_trainable"):
        op(*_qkv(n, True))
    with torch.no_grad():
        out = op(*_qkv(n, True))
    torch.testing.assert_close(out, op(*_qkv(n, False)), rtol=0, atol=0)


def test_block_wrappers_refuse_autograd():
    """The block's parameters require grad: outside ``_FusedPair`` the three
    block wrappers raise, naming the op and the fast-train route; under
    no_grad they run."""
    model = MixSTEDenoiser(num_frame=9, embed_dim=C, depth=1, num_heads=HEADS, device="cpu")
    for name, call in _block_calls(model):
        with pytest.raises(RuntimeError, match=f"^{name} has no backward.*fast_train"):
            call()
        with torch.no_grad():
            assert torch.isfinite(call()).all()
    model.requires_grad_(False)
    for _, call in _block_calls(model):  # nothing requires grad: nothing to lose
        assert torch.isfinite(call()).all()


def test_jax_grad_refuses_the_same():
    """JAX's kernel path: jax.grad through ``fused_grand_attention`` at [1,
    2, 72, 64] (B3) raises, as the port's does."""
    q = jnp.asarray(np.random.default_rng(0).standard_normal((1, 2, 72, 64)), jnp.float32)
    with pytest.raises(ValueError, match="reverse-mode"):
        jax.jit(jax.grad(lambda a: jax_attention.fused_grand_attention(a, q, q).sum()))(q)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_grand_attention(*(torch.from_numpy(np.array(q)).requires_grad_()
                                for _ in range(3)))


def test_use_pallas_model_training_raises_as_jax_does():
    """The module with use_pallas at F = 72 (temporal groups over 64, B3 in
    both packages), on the same weights: jax.grad through the flax module
    raises, and so does the port's forward under autograd; under no_grad
    it evaluates. (The port's dispatcher also sends n <= 64 to a kernel, B6,
    so it refuses at F = 9 as well, where JAX's dispatcher keeps the plain
    formulas.)"""
    kw = dict(num_frame=72, num_joints=J, in_chans=2, embed_dim=C, depth=1, num_heads=HEADS,
              mlp_ratio=2.0, qkv_bias=True, with_time_emb=True, mode="s2s")
    port = MixSTEDenoiser(**kw, use_pallas=True, seed=3, device="cpu")
    params = convert_torch_state_dict(port.state_dict(), depth=1)
    flax = FlaxMixSTE(drop_path_rate=0.0, use_pallas=True, **kw)
    x = np.random.default_rng(0).standard_normal((1, 72, J, 5)).astype(np.float32)
    t = np.array([3.0], np.float32)
    with pytest.raises(ValueError, match="reverse-mode"):
        jax.jit(jax.grad(lambda p: flax.apply({"params": p}, x, t).sum()))(params)
    with pytest.raises(RuntimeError, match="^fused_grand_attention has no backward"):
        port(torch.from_numpy(x), torch.from_numpy(t))
    with torch.no_grad():
        assert torch.isfinite(port(torch.from_numpy(x), torch.from_numpy(t))).all()


def test_trainable_paths_still_give_gradients():
    q, k, v = _qkv(72, True)
    torch.autograd.grad(grand_attention_trainable(q, k, v).sum(), (q, k, v))
    model = MixSTEDenoiser(num_frame=9, embed_dim=C, depth=1, num_heads=HEADS, use_pallas=True,
                           device="cpu")
    x, t = torch.randn(2, 9, J, 5), torch.tensor([3.0, 40.0])
    grads = torch.autograd.grad(fast_forward_denoise_train_pairs(model, x, t).sum(),
                                list(model.parameters()))
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)


@pytest.mark.parametrize("attn_bwd", [True, False])
def test_fast_train_on_a_use_pallas_model_matches_the_plain_model(attn_bwd):
    """One AdamW step of ``fast_train`` with drop-path on a ``use_pallas``
    model gives the loss and weights of the same step on a plain model: the
    pair recompute's attention does not depend on ``use_pallas`` (JAX's
    ``make_fast_train_denoise_fn`` takes no such argument)."""
    g = torch.Generator().manual_seed(4)
    gt, x2d = torch.randn(2, 9, J, 3, generator=g), torch.randn(2, 9, J, 2, generator=g)
    t = torch.tensor([5, 600])
    noise = torch.randn(2, 9, J, 3, generator=g)
    dp = tuple(torch.where(torch.rand(1, 2, n, 2, generator=g) < 0.7, 1 / 0.7, 0.0)
               for n in (9, J))
    results = []
    for use_pallas in (True, False):
        model = MixSTEDenoiser(num_frame=9, embed_dim=C, depth=1, num_heads=HEADS,
                               use_pallas=use_pallas, seed=2, device="cpu")
        diffusion = GaussianDiffusion.create(
            make_fast_train_denoise_fn(model, 0.3, attn_bwd=attn_bwd), timesteps=1000,
            sampling_timesteps=5, clip_loss=True)
        optimizer, scheduler = make_optimizer(model.parameters(), 1e-3, 0.99, 10)
        loss = make_train_step(diffusion, optimizer, scheduler)(gt, x2d, t=t, noise=noise,
                                                                 dp_scales=dp)
        results.append((loss, model.state_dict()))
    (loss_a, sd_a), (loss_b, sd_b) = results
    assert torch.equal(loss_a, loss_b)
    for name, p in sd_a.items():
        assert torch.equal(p, sd_b[name]), name
