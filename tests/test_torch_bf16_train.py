"""bf16 training of the port against the JAX package on the CPU (ROADMAP
A.5): B4's plain version at bf16 against JAX's Pallas kernel (interpreted),
the bf16 module against flax's ``MixSTEDenoiser(dtype=bfloat16)``, the
gradients of the bf16 pair-boundary backward against ``jax.grad`` of JAX's
``fast_forward_denoise_train_pairs`` at bf16 (``attn_bwd`` off and on, and
at F = 72 through B3/B4), the monolithic backward against JAX's at f32,
``ckpt_blocks`` and ``remat``, the bf16-vs-f32 drift of a 10-step run, and
one bf16 ``Runner.fit`` against JAX's.

The bar at bf16. JAX's bf16 programs are compiled with XLA's
``xla_allow_excess_precision`` off: every value JAX types bf16 is then
rounded to bf16 (by default XLA's CPU compiler keeps some of them, such as a
residual sum feeding a LayerNorm, in float32, a choice of the compiler and
not of JAX's program). A deviation is the mean absolute difference over all
elements, each tensor scaled by the largest |value| of JAX's f32 run. The
port's deviation from that JAX-bf16 run must be at most a quarter of
JAX-bf16's own deviation from JAX's f32 run on the same inputs, so that a
port that ran float32 or skipped a rounding point fails. The forwards and
B4 meet it. The gradients do not, for a reason of JAX's, not the port's
(ROADMAP C.8): JAX's VJP of a bf16 broadcast add (biases, the time
embedding) sums the bf16 cotangent in bf16, torch's autograd in float32, so
the port's gradients lie nearer JAX's f32 ones than JAX-bf16's do (0.73-0.80
of JAX-bf16's deviation from f32) and 0.51-0.55 of that deviation from
JAX-bf16; a float32 port measures 1.0 on both. The gradient bar holds the
port between: at least half of JAX-bf16's deviation from f32 (it rounds
where bf16 rounds), at most all of it, and at most 0.6 of it from JAX-bf16.
Each JAX program is built once, and the three slow ones (the strict builds
at F = 9 and F = 72, JAX's bf16 ``fit``) together in threads
(``jax_builds``)."""
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch import (
    GaussianDiffusion, fast_forward_denoise_train, fast_forward_denoise_train_pairs,
    make_fast_train_denoise_fn, make_optimizer, make_train_denoise_fn, make_train_step,
    state_dict_from_flax,
)
from diff3dhpe_torch.config import Config
from diff3dhpe_torch.engine.runner import Runner, RunLogger
from diff3dhpe_torch.models import MixSTEDenoiser
from diff3dhpe_torch.ops.attention import grand_attention_bwd, grand_attention_bwd_ref
from diff3dhpe_tpu.config import Config as JaxConfig
from diff3dhpe_tpu.engine import runner as jax_runner_module
from diff3dhpe_tpu.engine.runner import Runner as JaxRunner
from diff3dhpe_tpu.models import MixSTEDenoiser as FlaxMixSTE
from diff3dhpe_tpu.models import fast_eval as jax_fast
from diff3dhpe_tpu.ops.attention import grand_attention_bwd_pallas
from test_torch_fit import BASE, _datasets, _jax_draws, _params, _state_on_mesh
from torch_port_helpers import JOINTS_LEFT, JOINTS_RIGHT, build_pair
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

J = 17
QUARTER = 0.25


def strict_jit(fn, *args):
    """fn jitted and run with XLA's excess precision off (module doc)."""
    with jax.default_matmul_precision("highest"):
        compiled = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        return compiled(*args)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def deviation(got, expected, scale):
    """Mean |got - expected| over every element of the tensors, each
    tensor's differences divided by max|scale| of its counterpart."""
    total, count = 0.0, 0
    for a, b, s in zip(got, expected, scale, strict=True):
        a, b, s = (np.asarray(x, np.float64) for x in (a, b, s))
        total += np.abs(a - b).sum() / max(np.abs(s).max(), 1e-30)
        count += a.size
    return total / count


def assert_within_quarter(port, jax_bf16, jax_f32):
    """The bar of the module doc; prints the ratio (``-s`` shows it)."""
    ours, theirs = deviation(port, jax_bf16, jax_f32), deviation(jax_bf16, jax_f32, jax_f32)
    print(f"deviation from JAX-bf16 / JAX-bf16's from f32: {ours / theirs:.4f}")
    assert theirs > 0 and ours <= QUARTER * theirs, (ours, theirs)


def _grads(tree, depth):
    """A JAX gradient tree as the port's parameter order."""
    return state_dict_from_flax(_np(tree), depth)


def _port_grads(port, loss):
    port.zero_grad(set_to_none=True)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    port.zero_grad(set_to_none=True)
    return grads


def _in_order(grads, names):
    return [np.asarray(grads[n], np.float32) for n in names]


def _dp(seed, batch, depth, num_frame, rate=0.5):
    sp, tp = jax_fast.draw_drop_path_scales(jax.random.PRNGKey(seed), batch, depth, rate,
                                            num_frame=num_frame, num_joints=J)
    return np.asarray(sp), np.asarray(tp)


def _cfg(num_frame, depth, heads, dtype_name, attn_bwd):
    return jax_fast.FastTrainCfg(num_frame=num_frame, num_joints=J, depth=depth, num_heads=heads,
                                 with_time_emb=True, mode="s2s", dtype_name=dtype_name,
                                 temporal_mode="rows", attn_bwd=attn_bwd)


def _jax_case(model, params, x, t, dp, num_frame, depth, heads, attn_bwds, module=False):
    """JAX on one input, from one strict build: the gradients of sum(out²)
    through the bf16 pair backward for each ``attn_bwd`` and through the f32
    monolithic backward (with attn_bwd: the f32 reference, and the
    monolithic test's), and with ``module`` the bf16 and f32 module
    forwards."""
    module16 = FlaxMixSTE(num_frame=num_frame, num_joints=J, in_chans=2, embed_dim=32,
                          depth=depth, num_heads=heads, mlp_ratio=2.0, qkv_bias=True,
                          drop_path_rate=0.0, with_time_emb=True, dtype=jnp.bfloat16)

    def grads(fn, p, cfg):
        out, vjp = jax.vjp(lambda q: fn(q, x, t, dp, cfg), p)
        return vjp(2 * out)[0]

    def run(p):
        out = {f"pairs_bf16_{a}": grads(jax_fast.fast_forward_denoise_train_pairs, p,
                                        _cfg(num_frame, depth, heads, "bfloat16", a))
               for a in attn_bwds}
        out["mono_f32"] = grads(jax_fast.fast_forward_denoise_train, p,
                                _cfg(num_frame, depth, heads, "float32", True))
        if module:
            out["module_bf16"] = module16.apply({"params": p}, x, t)
            out["module_f32"] = model.apply({"params": p}, x, t)
        return out

    return _np(strict_jit(run, params))


def _case9():
    """(port model, inputs, JAX's results): F = 9, embed 32, depth 1, 4
    heads (head_dim 8), drop-path scales drawn at rate 0.5."""
    rng = np.random.default_rng(1)
    model, params, port = build_pair(rng, num_frame=9, embed_dim=32, depth=1, num_heads=4)
    x = rng.standard_normal((2, 9, J, 5)).astype(np.float32)
    t, dp = np.array([3.0, 700.0], np.float32), _dp(5, 2, 1, 9)
    return port, (x, t, dp), _jax_case(model, params, x, t, dp, 9, 1, 4, (False, True),
                                       module=True)


def _case72():
    """The same at F = 72, 2 heads (head_dim 16): the temporal attention (n
    = 72 > 64) goes through B3 and B4 in both packages."""
    rng = np.random.default_rng(72)
    model, params, port = build_pair(rng, num_frame=72, embed_dim=32, depth=1, num_heads=2)
    x = rng.standard_normal((2, 72, J, 5)).astype(np.float32)
    t, dp = np.array([3.0, 700.0], np.float32), _dp(9, 2, 1, 72)
    return port, (x, t, dp), _jax_case(model, params, x, t, dp, 72, 1, 2, (True,))


BF16_FIT = dict(compute_dtype="bfloat16", fast_train=True, fast_train_attn_bwd=True,
                drop_path_rate=0.1, remat=True)


def _jax_bf16_fit(jax_dir):
    """JAX's side of ``test_bf16_fit_matches_jax``: its bf16 ``fit`` from
    ``_params()`` and its draws, keyed as the port's ``fit(draws=...)``
    asks for them."""
    kw = {**BASE, **BF16_FIT}
    cfg, jax_cfg = Config(**kw), JaxConfig(**kw, checkpoint=jax_dir)
    port_ds, jax_ds = _datasets(cfg, jax_cfg)
    jax_runner = JaxRunner(jax_cfg, J, JOINTS_LEFT, JOINTS_RIGHT)
    jax_runner.set_params(_params())
    with mock.patch.object(jax_runner_module, "build_train_state",
                           _state_on_mesh(jax_runner.mesh)):
        expected = jax_runner.fit(jax_ds["train"], jax_ds["val"])
    n_val = -(-len(port_ds["val"]) // cfg.batch_size_eval)
    return expected, _jax_draws(cfg, len(port_ds["train"]) // cfg.batch_size, n_val)


@pytest.fixture(scope="module")
def jax_builds(tmp_path_factory):
    """Every JAX result of this file that takes a compile of many seconds
    (the two strict builds and JAX's bf16 fit), started together on first
    use, each once for the file. XLA compiles without holding the GIL, so
    one build's compile overlaps the others' tracing and compiles; the
    tests wait for the result they compare with."""
    with ThreadPoolExecutor(3) as pool:
        yield {"case9": pool.submit(_case9), "case72": pool.submit(_case72),
               "fit": pool.submit(_jax_bf16_fit, str(tmp_path_factory.mktemp("bf16_fit")))}


@pytest.fixture(scope="module")
def case9(jax_builds):
    return jax_builds["case9"].result()


@pytest.fixture(scope="module")
def case72(jax_builds):
    return jax_builds["case72"].result()


def _port_pair_grads(port, inputs, dtype, attn_bwd):
    x, t, dp = inputs
    out = fast_forward_denoise_train_pairs(port, _t(x), _t(t), tuple(_t(a) for a in dp),
                                           attn_bwd=attn_bwd, dtype=dtype)
    assert out.dtype == dtype
    return _port_grads(port, (out.float() ** 2).sum())


@pytest.mark.parametrize("case,attn_bwd", [("case9", False), ("case9", True), ("case72", True)])
def test_bf16_pair_grads_match_jax(request, case, attn_bwd):
    """Gradients of sum(out²) through the bf16 pair backward against
    ``jax.grad`` of JAX's, within the gradient bar of the module doc; the
    same check rejects the port's f32 gradients."""
    port, inputs, expected = request.getfixturevalue(case)
    names = [n for n, _ in port.named_parameters()]
    jax16 = _in_order(_grads(expected[f"pairs_bf16_{attn_bwd}"], port.depth), names)
    jax32 = _in_order(_grads(expected["mono_f32"], port.depth), names)
    theirs = deviation(jax16, jax32, jax32)

    def ratios(dtype):
        got = _in_order(_port_pair_grads(port, inputs, dtype, attn_bwd), names)
        return deviation(got, jax16, jax32) / theirs, deviation(got, jax32, jax32) / theirs

    to_jax16, to_jax32 = ratios(torch.bfloat16)
    print(f"{case} attn_bwd={attn_bwd}: to JAX-bf16 {to_jax16:.4f}, to JAX-f32 {to_jax32:.4f}")
    assert to_jax16 <= 0.6 and 0.5 <= to_jax32 <= 1.0, (to_jax16, to_jax32)
    f32_to_jax16, f32_to_jax32 = ratios(torch.float32)
    assert f32_to_jax16 > 0.6 and f32_to_jax32 < 0.5, (f32_to_jax16, f32_to_jax32)


def test_bf16_module_matches_flax(case9):
    """The bf16 module's forward against flax's ``MixSTEDenoiser(dtype=
    bfloat16)``, within the quarter bar; the output is bf16, as flax's."""
    port, (x, t, _), expected = case9
    model = MixSTEDenoiser(num_frame=9, embed_dim=32, depth=1, num_heads=4,
                           dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(port.state_dict())
    with torch.no_grad():
        out = model(_t(x), _t(t))
    assert out.dtype == torch.bfloat16
    assert_within_quarter([out.float().numpy()], [expected["module_bf16"]],
                          [expected["module_f32"]])
    print(f"bf16 module: equal to JAX-bf16 in {np.mean(out.float().numpy() == expected['module_bf16']):.4f} of the elements")


def test_monolithic_backward_matches_jax_at_f32(case9):
    """The monolithic backward (``fast_forward_denoise_train``) against
    JAX's at f32 with drop-path and attn_bwd: 2e-4 of max|g| per parameter,
    the f32 bar of the fast-train tests."""
    port, (x, t, dp), expected = case9
    out = fast_forward_denoise_train(port, _t(x), _t(t), tuple(_t(a) for a in dp), attn_bwd=True)
    grads = _port_grads(port, (out ** 2).sum())
    for name, g in _grads(expected["mono_f32"], port.depth).items():
        assert float((grads[name] - g).abs().max() / (g.abs().max() + 1e-8)) < 2e-4, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ckpt_blocks_and_remat_change_no_gradient(case9, dtype):
    """``ckpt_blocks`` of the monolithic backward, and the module's
    ``remat_blocks`` and whole-graph ``remat``, give the gradients of the
    same path without them, bit for bit on the CPU."""
    port, (x, t, dp), _ = case9
    x, t, dp = _t(x), _t(t), tuple(_t(a) for a in dp)

    def mono(ckpt):
        out = fast_forward_denoise_train(port, x, t, dp, attn_bwd=True, dtype=dtype,
                                         ckpt_blocks=ckpt)
        return _port_grads(port, (out.float() ** 2).sum())

    def module(remat_blocks, remat):
        model = MixSTEDenoiser(num_frame=9, embed_dim=32, depth=1, num_heads=4, dtype=dtype,
                               remat_blocks=remat_blocks, device="cpu")
        model.load_state_dict(port.state_dict())
        out = make_train_denoise_fn(model, remat=remat)(x, t, dp_scales=dp)
        return _port_grads(model, (out.float() ** 2).sum())

    for got, expected in ((mono(True), mono(False)), (module(True, False), module(False, False)),
                          (module(False, True), module(False, False))):
        for name, g in expected.items():
            assert torch.equal(got[name], g), name


def test_jax_sums_bf16_cotangents_at_bf16():
    """The difference behind the gradient bar (module doc, ROADMAP C.8):
    JAX's VJP of a bf16 broadcast add (a bias) rounds its sum over the rows
    at bf16 along the way, with XLA's excess precision off or on, where
    torch's autograd sums in float32 and rounds once."""
    rows = np.random.default_rng(0).standard_normal((4896, 64)) * 0.01 + 0.01
    g = jnp.asarray(rows, jnp.bfloat16)
    exact = np.asarray(g, np.float64).sum(0)

    def bias_grad(a):
        return jax.vjp(lambda b: a + b, jnp.zeros(64, jnp.bfloat16))[1](a)[0]

    errors = {}
    for name, compiled in (("strict", strict_jit(bias_grad, g)), ("default", jax.jit(bias_grad)(g))):
        errors[name] = np.abs(np.asarray(compiled, np.float64) - exact).mean()
    gt = torch.tensor(np.asarray(g, np.float32)).bfloat16().requires_grad_()
    b = torch.zeros(64, dtype=torch.bfloat16, requires_grad=True)
    (gt.detach() + b).backward(gt.detach())
    ours = np.abs(b.grad.double().numpy() - exact).mean()
    print(f"mean |bias gradient - exact sum|: JAX strict {errors['strict']:.4f}, default "
          f"{errors['default']:.4f}, port {ours:.4f}")
    assert ours < 0.6 * min(errors.values()), (ours, errors)


def test_ckpt_blocks_with_pair_vjp_warns(case9):
    port = case9[0]
    with pytest.warns(UserWarning, match="ckpt_blocks has no effect"):
        make_fast_train_denoise_fn(port, ckpt_blocks=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_fast_train_denoise_fn(port, ckpt_blocks=True, pair_vjp=False)


@pytest.mark.parametrize("n,d", [(72, 64), (243, 128)])
def test_b4_plain_version_at_bf16_matches_pallas(n, d):
    """B4's plain version (the CPU's ``grand_attention_bwd``) at bf16
    against JAX's ``grand_attention_bwd_pallas`` at bf16 in interpret
    mode, within the quarter bar against the kernel at f32; and every
    gradient bf16."""
    rng = np.random.default_rng(n + d)
    q, k, v, do = (rng.standard_normal((3, n, d)).astype(np.float32) for _ in range(4))

    def run(*a):
        bf = [x.astype(jnp.bfloat16) for x in a]
        return (grand_attention_bwd_pallas(*bf, interpret=True),
                grand_attention_bwd_pallas(*a, interpret=True))

    jax16, jax32 = _np(strict_jit(run, q, k, v, do))
    bf16 = [_t(a).bfloat16() for a in (q, k, v, do)]
    got = grand_attention_bwd(*bf16)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, grand_attention_bwd_ref(*bf16)))
    assert_within_quarter([g.float().numpy() for g in got], jax16, jax32)


def _drift_losses(dtype, steps=10):
    """Port copy of tests/test_fast_train.py::test_bf16_training_drift_bounded:
    10 fast-train AdamW steps (lr 1e-3, drop-path 0) from one init on fixed
    batches, with t and noise from one seeded generator."""
    model = MixSTEDenoiser(num_frame=9, embed_dim=32, depth=2, num_heads=8, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    batches = [(torch.tensor(rng.standard_normal((8, 9, J, 3)), dtype=torch.float32),
                torch.tensor(rng.standard_normal((8, 9, J, 2)), dtype=torch.float32))
               for _ in range(steps)]
    diffusion = GaussianDiffusion.create(
        make_fast_train_denoise_fn(model, 0.0, dtype=dtype), timesteps=40,
        sampling_timesteps=4, clip_denoised=True, clip_loss=True, beta_schedule="cosine")
    optimizer, scheduler = make_optimizer(model.parameters(), 1e-3, 0.99, steps_per_epoch=steps)
    step = make_train_step(diffusion, optimizer, scheduler)
    gen = torch.Generator().manual_seed(100)
    return [float(step(gt, x2d, generator=gen)) for gt, x2d in batches]


def test_bf16_training_drift_bounded():
    """JAX's bounds: at most 5% per step and 3% at the end."""
    l32, l16 = _drift_losses(torch.float32), _drift_losses(torch.bfloat16)
    assert np.isfinite(l32).all() and np.isfinite(l16).all()
    rel = [abs(a - b) / max(abs(a), 1e-9) for a, b in zip(l32, l16)]
    assert max(rel) < 0.05, rel
    assert abs(l32[-1] - l16[-1]) / abs(l32[-1]) < 0.03, (l32[-1], l16[-1])
    assert l16 != l32  # the bf16 run did round


def test_bf16_fit_matches_jax(tmp_path, jax_builds):
    """One bf16 ``Runner.fit`` of 2 epochs (fast_train with attn_bwd, remat;
    the validation loss on the bf16 module) against JAX's, with JAX's draws
    replayed through ``fit(draws=...)``. Per-epoch train loss, validation
    MPJPE and the best epoch; the bars are relative to the epochs' values
    (1e-3: bf16 rounding of the loss's inputs through two epochs of
    training)."""
    kw = {**BASE, **BF16_FIT}
    port_dir = str(tmp_path / "port")
    cfg = Config(**kw, checkpoint=port_dir)
    port_ds, _ = _datasets(cfg, JaxConfig(**kw))
    expected, draws = jax_builds["fit"].result()
    runner = Runner(cfg, J, JOINTS_LEFT, JOINTS_RIGHT, logger=RunLogger(port_dir), device="cpu")
    assert runner.model.dtype == torch.bfloat16 and runner.model.remat_blocks
    runner.set_params(_params())
    out = runner.fit(port_ds["train"], port_ds["val"], draws=draws)
    np.testing.assert_allclose(out["losses_train"], expected["losses_train"], rtol=1e-3)
    np.testing.assert_allclose(out["losses_valid"], expected["losses_valid"], rtol=1e-3)
    assert out["best_epoch"] == expected["best_epoch"]
    assert os.path.isdir(out["best_path"])
