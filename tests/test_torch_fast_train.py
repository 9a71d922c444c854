"""The port's f32 fast-train path against the JAX package on the CPU, with
the Pallas kernels in interpret mode and f32 contractions at "highest":
B1 with drop-path, the fused forward with drop-path, the pair-boundary
train forward and its gradients (attn_bwd), the drop-path sampler, the
diffusion loss and one AdamW train step. Inputs, weights, t, noise and
drop-path scales are made once (numpy, or JAX's own key splits) and fed to
both packages; gradients are compared by state-dict name
(``state_dict_from_flax`` maps a JAX gradient tree like a param tree)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff3dhpe_torch import (
    GaussianDiffusion, draw_drop_path_scales, fast_forward_denoise,
    fast_forward_denoise_train_pairs, fused_transformer_block, make_fast_train_denoise_fn,
    make_optimizer, make_train_denoise_fn, make_train_step, state_dict_from_flax,
)
from diff3dhpe_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diff3dhpe_tpu.engine import build_train_state
from diff3dhpe_tpu.engine import make_train_step as jax_make_train_step
from diff3dhpe_tpu.engine.steps import make_denoise_fn as jax_make_denoise_fn
from diff3dhpe_tpu.engine.steps import make_fast_train_denoise_fn as jax_make_fast_train_fn
from diff3dhpe_tpu.engine.steps import make_optimizer as jax_make_optimizer
from diff3dhpe_tpu.models import fast_eval as jax_fast
from diff3dhpe_tpu.ops.fused_block import fused_transformer_block as jax_fused_block
from torch_port_helpers import build_pair
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

J = 17


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def pair9():
    """(flax model, numpy params, port model): F = 9, embed 32, 4 heads,
    depth 2, so the temporal groups (n = 9) stay on the plain formulas."""
    return build_pair(np.random.default_rng(1), num_frame=9, embed_dim=32, depth=2, num_heads=4)


def _dp(seed, batch, depth, num_frame, rate=0.5):
    """JAX's drop-path draw, as numpy (rate 0.5 on the last pair drops
    branches in both tables)."""
    sp, tp = jax_fast.draw_drop_path_scales(jax.random.PRNGKey(seed), batch, depth, rate,
                                            num_frame=num_frame, num_joints=J)
    return np.asarray(sp), np.asarray(tp)


def _t(a):
    return torch.tensor(np.asarray(a))


def _grad_rel(expected_tree, port, depth):
    """max over parameters of max|g_port - g_jax| / max|g_jax|."""
    expected = state_dict_from_flax(jax.tree.map(np.asarray, expected_tree), depth)
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert set(expected) == set(grads)
    return {n: float((grads[n] - g).abs().max() / (g.abs().max() + 1e-8))
            for n, g in expected.items()}


@pytest.mark.parametrize("n,groups", [(17, 6), (27, 4)])
def test_block_drop_path_matches_jax(rng, pair9, n, groups):
    _, params, port = pair9
    x = rng.standard_normal((groups * n, 32)).astype(np.float32)
    t = rng.standard_normal((2, 32)).astype(np.float32)
    dp = ((rng.random((groups * n, 2)) < 0.6) / 0.6).astype(np.float32)
    expected = jax_fused_block(
        jnp.asarray(x), params["tte_block_0"], n=n, heads=4, interpret=True,
        out_ln_params=params["temporal_norm"], t_rows=jnp.asarray(t),
        rows_per_item=groups * n // 2, dp_scales=jnp.asarray(dp),
    )
    with torch.no_grad():
        out = fused_transformer_block(_t(x), port.TTEblocks[0], n, 4, t_rows=_t(t),
                                      rows_per_item=groups * n // 2, out_ln=port.Temporal_norm,
                                      dp_scales=_t(dp))
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)


def _train_cfg(num_frame, depth, heads):
    return jax_fast.FastTrainCfg(num_frame=num_frame, num_joints=J, depth=depth, num_heads=heads,
                                 with_time_emb=True, mode="s2s", dtype_name="float32",
                                 temporal_mode="rows", attn_bwd=True)


def _jax_train_pairs(params, x, t, dp, cfg, fwd_kw=None):
    """JAX's pair-boundary train forward at one input and the gradients of
    sum(out²) through its backward, and with ``fwd_kw`` the fused forward
    with the same drop-path, all from one jitted build (jit: the
    interpreted kernels run op by op otherwise, several times slower)."""
    x, t = jnp.asarray(x), jnp.asarray(t)

    def run(p):
        out, vjp = jax.vjp(lambda q: jax_fast.fast_forward_denoise_train_pairs(q, x, t, dp, cfg), p)
        fwd = None if fwd_kw is None else jax_fast.fast_forward_denoise(
            p, x, t, interpret=True, dp_scales=dp, **fwd_kw)
        return out, vjp(2 * out)[0], fwd

    with jax.default_matmul_precision("highest"):
        out, grads, fwd = jax.jit(run)(params)
    return dict(x=x, t=t, dp=dp, train=np.asarray(out), grads=grads,
                fwd=None if fwd is None else np.asarray(fwd))


@pytest.fixture(scope="module")
def jax9(pair9):
    """JAX on pair9 (F = 9, depth 2, 4 heads) at x [3, 9, J, 5] with
    drop-path: the fused forward, the train forward and its gradients."""
    _, params, _ = pair9
    x = np.random.default_rng(0).standard_normal((3, 9, J, 5)).astype(np.float32)
    return _jax_train_pairs(params, x, np.array([3.0, 7.0, 700.0], np.float32), _dp(5, 3, 2, 9),
                            _train_cfg(9, 2, 4),
                            dict(num_frame=9, num_joints=J, depth=2, num_heads=4,
                                 dtype=jnp.float32))


@pytest.fixture(scope="module")
def jax81():
    """(port model, JAX's train forward and gradients) at F = 81, depth 1,
    2 heads: the temporal attention (n = 81 > 64) goes through the B3/B4
    dispatch in both packages."""
    rng = np.random.default_rng(81)
    _, params, port = build_pair(rng, num_frame=81, embed_dim=32, depth=1, num_heads=2)
    x = rng.standard_normal((2, 81, J, 5)).astype(np.float32)
    return port, _jax_train_pairs(params, x, np.array([3.0, 700.0], np.float32),
                                  _dp(9, 2, 1, 81), _train_cfg(81, 1, 2))


def test_forward_and_train_forward_with_drop_path_match_jax(pair9, jax9):
    _, _, port = pair9
    x, t, dp_t = _t(jax9["x"]), _t(jax9["t"]), tuple(_t(a) for a in jax9["dp"])
    out = fast_forward_denoise(port, x, t, dp_t)
    np.testing.assert_allclose(out.numpy(), jax9["fwd"], rtol=1e-5, atol=1e-5)
    out_train = fast_forward_denoise_train_pairs(port, x, t, dp_t, attn_bwd=True)
    np.testing.assert_allclose(out_train.detach().numpy(), jax9["train"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_frame,embed,heads,depth", [(9, 32, 4, 2), (81, 32, 2, 1)])
def test_pair_train_grads_match_jax(request, num_frame, embed, heads, depth):
    """Gradients of sum(out²) through the pair-boundary backward with
    attn_bwd, at F = 9 on pair9 (the temporal groups, n = 9, stay on the
    plain formulas) and at F = 81, where the temporal attention (n = 81 >
    64) goes through the B3/B4 dispatch in both packages."""
    if num_frame == 9:
        port, jax_run = request.getfixturevalue("pair9")[2], request.getfixturevalue("jax9")
    else:
        port, jax_run = request.getfixturevalue("jax81")
    assert (port.num_frame, port.embed_dim, port.num_heads, port.depth) == (
        num_frame, embed, heads, depth)
    port.zero_grad(set_to_none=True)
    out = fast_forward_denoise_train_pairs(port, _t(jax_run["x"]), _t(jax_run["t"]),
                                           tuple(_t(a) for a in jax_run["dp"]), attn_bwd=True)
    (out ** 2).sum().backward()
    rel = _grad_rel(jax_run["grads"], port, depth)
    port.zero_grad(set_to_none=True)
    assert max(rel.values()) < 2e-4, rel


def test_draw_drop_path_scales_distribution():
    """Port of tests/test_fast_train.py::test_draw_drop_path_scales_distribution."""
    depth, b, f, rate = 4, 64, 9, 0.4
    dp_sp, dp_tp = draw_drop_path_scales(torch.Generator().manual_seed(0), b, depth, rate, f, J)
    dp_sp, dp_tp = dp_sp.numpy(), dp_tp.numpy()
    assert dp_sp.shape == (depth, b, f, 2)
    assert dp_tp.shape == (depth, b, J, 2)
    rates = np.linspace(0.0, rate, depth)
    for dp in (dp_sp, dp_tp):
        assert (dp[0] == 1.0).all()  # pair 0 has rate 0
        for i, r in enumerate(rates[1:], start=1):
            keep = 1.0 - r
            for v in np.unique(dp[i]):
                assert np.isclose(v, 0.0) or np.isclose(v, 1.0 / keep, rtol=1e-5), v
            assert abs((dp[i] > 0).mean() - keep) < 0.08
    # One draw per group: the scales vary along the frame / joint axis.
    assert (dp_sp[-1].std(axis=2) > 0).any()
    assert (dp_tp[-1].std(axis=2) > 0).any()


@pytest.mark.parametrize("loss_type,clip_loss", [("l2", True), ("l1", False)])
def test_p_losses_matches_jax(rng, pair9, loss_type, clip_loss):
    model, params, port = pair9
    gt = rng.standard_normal((3, 9, J, 3)).astype(np.float32)
    x2d = rng.standard_normal((3, 9, J, 2)).astype(np.float32)
    noise = rng.standard_normal(gt.shape).astype(np.float32)
    key = jax.random.PRNGKey(4)
    kw = dict(timesteps=1000, sampling_timesteps=9, beta_schedule="cosine",
              loss_type=loss_type, clip_loss=clip_loss)
    ref = JaxDiffusion.create(jax_make_denoise_fn(model), **kw)
    # jit: the flax model op by op compiles each op on its first call.
    expected = np.asarray(jax.jit(lambda p: ref.p_losses(
        p, key, jnp.asarray(gt), jnp.asarray(x2d), noise=jnp.asarray(noise)))(params))
    t = np.asarray(jax.random.randint(jax.random.split(key)[0], (3,), 0, 1000))
    ours = GaussianDiffusion.create(make_train_denoise_fn(port, 0.0), **kw)
    ones = (torch.ones(2, 3, 9, 2), torch.ones(2, 3, J, 2))
    out = ours.p_losses(_t(gt), _t(x2d), t=_t(t), noise=_t(noise), dp_scales=ones)
    np.testing.assert_allclose(out.detach().numpy(), expected, rtol=1e-5, atol=1e-5)


def _keeping_grads(opt):
    """``opt`` whose state also holds the gradients of its last update."""
    def init(params):
        return opt.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def test_train_step_matches_jax():
    """One AdamW step of the fast-train path (attn_bwd, drop-path 0.5) in
    both packages, with JAX's t, noise and drop-path draws replayed from
    its key splits and injected into the port."""
    depth, b, f, lr, rate, T = 1, 2, 9, 1e-3, 0.5, 1000
    rng = np.random.default_rng(7)
    _, params, port = build_pair(rng, num_frame=f, embed_dim=32, depth=depth, num_heads=4)
    gt = rng.standard_normal((b, f, J, 3)).astype(np.float32)
    x2d = rng.standard_normal((b, f, J, 2)).astype(np.float32)
    kw = dict(timesteps=T, sampling_timesteps=9, clip_denoised=True, clip_loss=True,
              beta_schedule="cosine")

    jax_fn = jax_make_fast_train_fn(num_frame=f, num_joints=J, depth=depth, num_heads=4,
                                    dtype=jnp.float32, drop_path_rate=rate, attn_bwd=True)
    ref = JaxDiffusion.create(jax_fn, **kw)
    key = jax.random.PRNGKey(11)
    diff_key, dropout_key = jax.random.split(key)           # engine/steps.py:298
    key_t, key_noise = jax.random.split(diff_key)           # gaussian_diffusion.py:147-150
    t = np.asarray(jax.random.randint(key_t, (b,), 0, T))
    noise = np.asarray(jax.random.normal(key_noise, gt.shape, jnp.float32))
    dp = jax_fast.draw_drop_path_scales(dropout_key, b, depth, rate, num_frame=f, num_joints=J)
    # JAX's train step, compiled once: its optimizer also keeps the
    # gradients it was handed, so the step yields JAX's gradients too.
    opt = _keeping_grads(jax_make_optimizer(lr, 0.99, steps_per_epoch=10))
    state, loss = jax_make_train_step(ref, opt)(
        build_train_state(jax.tree.map(jnp.asarray, params), opt), key, jnp.asarray(gt),
        jnp.asarray(x2d))
    expected_grads = state.opt_state[1]

    ours = GaussianDiffusion.create(
        make_fast_train_denoise_fn(port, drop_path_rate=rate, attn_bwd=True), **kw)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    optimizer, scheduler = make_optimizer(port.parameters(), lr, 0.99, steps_per_epoch=10)
    our_loss = make_train_step(ours, optimizer, scheduler)(
        _t(gt), _t(x2d), t=_t(t), noise=_t(noise), dp_scales=tuple(_t(np.asarray(a)) for a in dp))

    assert abs(our_loss.item() - float(loss)) <= 1e-5 * abs(float(loss))
    rel = _grad_rel(expected_grads, port, depth)
    assert max(rel.values()) < 2e-4, rel
    # Adam's first step moves each parameter by about lr · sign(g): where a
    # gradient is near 0 its sign may differ by rounding, and the step by up
    # to 2 lr. Elsewhere the two updates agree to far below lr.
    new = state_dict_from_flax(jax.tree.map(np.asarray, state.params), depth)
    g = state_dict_from_flax(jax.tree.map(np.asarray, expected_grads), depth)
    for name, p in port.named_parameters():
        allowed = torch.where(g[name].abs() < 1e-5, 2 * lr, 1e-6)
        assert ((p.detach() - new[name]).abs() <= allowed).all(), name
        assert (p.detach() - before[name]).abs().max() > 0, name
