"""The module's dropout (``drop_rate``, ``attn_drop_rate``; ROADMAP A.16)
against the JAX package on the CPU.

torch cannot draw JAX's masks, so the same masks, drawn by the port
(``draw_dropout_masks``), are injected into flax: ``injected_masks`` wraps
every ``nn.Dropout.__call__`` through ``flax.linen.intercept_methods`` and
applies flax's own formula (``lax.select(mask, x / keep, 0)``) on the mask
of the call's module path; no file of the JAX package changes. The jitted
JAX programs are traced inside the context.

Bars: the f32 forward to 1e-4 absolute (tests/test_model.py's), the bf16
forward within the quarter bar of tests/test_torch_bf16_train.py (JAX
compiled with excess precision off), the f32 gradients and one AdamW step
at tests/test_torch_fast_train.py's bars (loss 1e-5 relative, gradients
2e-4 of their max); the module with ``remat_blocks`` computes what it
computes without (the masks are inputs of the recompute); two gloo ranks
at "data:1,model:2" against one process at JAX's tensor-parallel bar
(tests/test_parallel.py:88-92: loss 1e-5 relative, gradients 2e-5 of
max(|g|, 1e-3)). The JAX programs are built once, together, in threads of
the module fixture ``setup``, while the ranks run."""
import collections
import contextlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from flax import linen as nn

import torch_tp_ranks as ranks
from diff3dhpe_torch import (
    GaussianDiffusion, draw_drop_path_scales, draw_dropout_masks, make_denoise_fn, make_eval_step,
    make_optimizer, make_train_denoise_fn, make_train_step, state_dict_from_flax,
)
from diff3dhpe_torch.models import MixSTEDenoiser
from diff3dhpe_torch.models.mixste import dropout
from diff3dhpe_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diff3dhpe_tpu.engine import build_train_state
from diff3dhpe_tpu.engine import make_train_step as jax_make_train_step
from diff3dhpe_tpu.engine.steps import make_denoise_fn as jax_make_denoise_fn
from diff3dhpe_tpu.engine.steps import make_optimizer as jax_make_optimizer
from diff3dhpe_tpu.models import MixSTEDenoiser as FlaxMixSTE
from test_torch_bf16_train import assert_within_quarter, strict_jit
from test_torch_fast_train import _keeping_grads
from torch_port_helpers import JOINTS_LEFT, JOINTS_RIGHT, build_pair, port_model
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

F, J, C, DEPTH, HEADS, B = 9, 17, 32, 2, 4, 2
KW = dict(num_frame=F, num_joints=J, in_chans=2, embed_dim=C, depth=DEPTH, num_heads=HEADS,
          mlp_ratio=2.0, qkv_bias=True, with_time_emb=True, mode="s2s")
RATES = dict(drop_rate=0.2, attn_drop_rate=0.3)
TRAIN_KW = dict(timesteps=1000, sampling_timesteps=3, clip_denoised=True, clip_loss=True,
                beta_schedule="cosine")
LR = 1e-3
JOIN_S = 300


def _t(a):
    return torch.tensor(np.asarray(a))


def _mask(masks, path, call, shape):
    """The injected mask of flax's Dropout at module ``path`` (its
    ``call``-th call): the top-level ``Dropout_0`` (pos_drop) is called after
    the spatial and then the temporal position embedding; in a block,
    ``attn/Dropout_0`` is the probabilities' where attn_drop > 0 (then
    ``Dropout_1`` is proj's), ``mlp/Dropout_0`` and ``_1`` fc1's and fc2's."""
    if path == ("Dropout_0",):
        return masks["pos"][call % 2]
    block, mod, name = path
    kind = "spatial" if block.startswith("ste") else "temporal"
    i, idx = int(block.rsplit("_", 1)[1]), int(name.rsplit("_", 1)[1])
    if mod == "attn":
        site = ("attn", "proj")[idx] if f"attn_{kind}" in masks else "proj"
    else:
        site = ("fc1", "fc2")[idx]
    kept = masks[f"{site}_{kind}"][i]
    return kept.reshape(shape)


@contextlib.contextmanager
def injected_masks(masks):
    """Every training-mode call of flax's ``nn.Dropout`` with 0 < rate < 1
    inside the context takes ``masks`` (the port's, as numpy) instead of
    its own draw, in flax's formula (flax/linen/stochastic.py)."""
    masks = {k: np.asarray(v) for k, v in masks.items()}
    calls = collections.Counter()

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if (not isinstance(mod, nn.Dropout) or context.method_name != "__call__"
                or kwargs.get("deterministic", True) or not 0.0 < mod.rate < 1.0):
            return next_fun(*args, **kwargs)
        x = args[0]
        call = calls[mod.path]
        calls[mod.path] += 1
        kept = jnp.asarray(_mask(masks, mod.path, call, x.shape))
        return jax.lax.select(kept, x / (1.0 - mod.rate), jnp.zeros_like(x))

    with nn.intercept_methods(interceptor):
        yield


def _flax(dtype=None, **rates):
    return FlaxMixSTE(drop_path_rate=0.0, dtype=dtype, **rates, **KW)


def _draw_masks(seed, **rates):
    probe = MixSTEDenoiser(**KW, **rates, device="cpu")
    return draw_dropout_masks(probe, torch.Generator().manual_seed(seed), B, F, J)


def _jax_forwards(params, x, t, masks):
    """JAX's training-mode forwards on the injected masks: f32 (plain,
    ``use_pallas``, and the gradient of sum(out²) through ``remat_blocks``),
    and at the rates 1.0."""
    key = jax.random.PRNGKey(0)

    def run(p):
        apply = lambda m: m.apply({"params": p}, x, t, deterministic=False, rngs={"dropout": key})
        out = dict(f32=apply(_flax(**RATES)), pallas=apply(_flax(use_pallas=True, **RATES)),
                   ones=apply(_flax(drop_rate=1.0, attn_drop_rate=1.0)))
        remat = _flax(remat_blocks=True, **RATES)
        out["remat_grad"] = jax.grad(lambda q: jnp.sum(
            remat.apply({"params": q}, x, t, deterministic=False, rngs={"dropout": key}) ** 2))(p)
        return out

    with jax.default_matmul_precision("highest"), injected_masks(masks):
        return jax.tree.map(np.asarray, jax.jit(run)(params))


def _jax_bf16(params, x, t, masks):
    """JAX's bf16 training-mode forward (plain and ``use_pallas``) and its f32
    one on the injected masks, with excess precision off."""
    def run(p):
        apply = lambda m: m.apply({"params": p}, x, t, deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return dict(bf16=apply(_flax(jnp.bfloat16, **RATES)),
                    pallas=apply(_flax(jnp.bfloat16, use_pallas=True, **RATES)),
                    f32=apply(_flax(**RATES)))

    with injected_masks(masks):
        return jax.tree.map(lambda a: np.asarray(a, np.float32), strict_jit(run, params))


def _jax_train(params, key, gt, x2d, masks):
    """(loss, gradients, updated params) of JAX's plain train step."""
    fn = jax_make_denoise_fn(_flax(**RATES))
    opt = _keeping_grads(jax_make_optimizer(LR, 0.99, steps_per_epoch=10))
    step = jax_make_train_step(JaxDiffusion.create(fn, **TRAIN_KW), opt, donate=False)
    state = build_train_state(jax.tree.map(jnp.asarray, params), opt)
    with jax.default_matmul_precision("highest"), injected_masks(masks):
        state, loss = step(state, key, jnp.asarray(gt), jnp.asarray(x2d))
    as_sd = lambda tree: state_dict_from_flax(jax.tree.map(np.asarray, tree), DEPTH)
    return float(loss), as_sd(state.opt_state[1]), as_sd(state.params)


def _jax_train_draws(key, gt_shape):
    """t and noise of JAX's train step (engine/steps.py:298,
    gaussian_diffusion.py:147-150)."""
    diff_key, _ = jax.random.split(key)
    key_t, key_noise = jax.random.split(diff_key)
    return (np.asarray(jax.random.randint(key_t, gt_shape[:1], 0, TRAIN_KW["timesteps"])),
            np.asarray(jax.random.normal(key_noise, gt_shape, jnp.float32)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two gloo ranks running ``torch_tp_ranks.run_dropout_cases`` and, while
    they run, JAX's programs in threads and the one-process references."""
    tmp = tmp_path_factory.mktemp("dropout")
    rng = np.random.default_rng(21)
    _, params, _ = build_pair(rng, **{k: KW[k] for k in ("num_frame", "embed_dim", "depth",
                                                         "num_heads")})
    x = rng.standard_normal((B, F, J, 5)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    gt = rng.standard_normal((B, F, J, 3)).astype(np.float32)
    x2d = rng.standard_normal((B, F, J, 2)).astype(np.float32)
    masks = _draw_masks(5, **RATES)
    key = jax.random.PRNGKey(11)

    weights = MixSTEDenoiser(**ranks.MODEL_KW, seed=3, device="cpu").state_dict()
    rank_rng = np.random.default_rng(0)
    spec = dict(weights=weights, module=RATES,
                gt=torch.from_numpy(rank_rng.standard_normal((4, F, J, 3)).astype(np.float32)),
                x2d=torch.from_numpy(rank_rng.uniform(-1, 1, (4, F, J, 2)).astype(np.float32)))
    torch.save(spec, tmp / "spec.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ranks.run_rank, daemon=True,
                         args=(r, 2, str(tmp / "rendezvous"), str(tmp / "spec.pt"), str(tmp),
                               "run_dropout_cases")) for r in range(2)]
    for p in procs:
        p.start()
    try:
        with ThreadPoolExecutor(3) as pool:
            jobs = dict(f32=pool.submit(_jax_forwards, params, x, t, masks),
                        bf16=pool.submit(_jax_bf16, params, x, t, masks),
                        train=pool.submit(_jax_train, params, key, gt, x2d, masks))
            one = ranks.run_train(weights, (spec["gt"], spec["x2d"]), drop_path=ranks.DROP_PATH,
                                  module=RATES, seed=4)
            jax_res = {k: v.result() for k, v in jobs.items()}
    finally:
        for p in procs:
            p.join(JOIN_S)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
    assert not alive, f"ranks {alive} did not finish in {JOIN_S} s"
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for r, (p, res) in enumerate(zip(procs, got)):
        assert p.exitcode == 0 and "error" not in res, (r, p.exitcode, res.get("error"))
    return dict(params=params, inputs=(x, t, gt, x2d), masks=masks, key=key, jax=jax_res,
                ranks=[g["cases"] for g in got], one=one)


def _with_dtype(port, dtype):
    """``port`` rebuilt at ``dtype`` on its weights."""
    model = MixSTEDenoiser(**KW, **RATES, dtype=dtype, use_pallas=port.use_pallas,
                           remat_blocks=port.remat_blocks, device="cpu")
    model.load_state_dict(port.state_dict())
    return model


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_f32_forward_matches_flax(setup, use_pallas, remat):
    """The training-mode forward at f32 on JAX's masks, with the attention
    dropout's materialised branch taken ahead of ``use_pallas``, as flax's."""
    x, t = setup["inputs"][:2]
    port = port_model(setup["params"], **KW, **RATES, use_pallas=use_pallas, remat_blocks=remat)
    with torch.no_grad():
        out = port(_t(x), _t(t), (None, None, setup["masks"])).numpy()
    expected = setup["jax"]["f32"]["pallas" if use_pallas else "f32"]
    np.testing.assert_allclose(out, expected, atol=1e-4, rtol=0)
    # The masks matter: without them (the evaluation) the output moves.
    with torch.no_grad():
        assert np.abs(port(_t(x), _t(t)).numpy() - out).max() > 1e-2


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_bf16_forward_matches_flax(setup, use_pallas, remat):
    """The bf16 training-mode forward within the quarter bar of JAX's bf16
    one (dropout in bf16: x / keep with keep a bf16 constant)."""
    x, t = setup["inputs"][:2]
    jax_res = setup["jax"]["bf16"]
    port = _with_dtype(port_model(setup["params"], **KW, **RATES, use_pallas=use_pallas,
                                  remat_blocks=remat), torch.bfloat16)
    with torch.no_grad():
        out = port(_t(x), _t(t), (None, None, setup["masks"]))
    assert out.dtype == torch.bfloat16
    assert_within_quarter([out.float().numpy()], [jax_res["pallas" if use_pallas else "bf16"]],
                          [jax_res["f32"]])


def _grads(port, x, t, masks):
    port.zero_grad(set_to_none=True)
    out = port(_t(x), _t(t), None if masks is None else (None, None, masks))
    (out.float() ** 2).sum().backward()
    return {n: p.grad.clone() for n, p in port.named_parameters()}


def test_remat_gradients_match_flax(setup):
    """The gradient of sum(out²) through ``remat_blocks``: against flax's
    remat module on the same masks, and equal to the port's without remat
    (the recompute sees the same masks)."""
    x, t = setup["inputs"][:2]
    params = setup["params"]
    remat = _grads(port_model(params, **KW, **RATES, remat_blocks=True), x, t, setup["masks"])
    plain = _grads(port_model(params, **KW, **RATES), x, t, setup["masks"])
    expected = state_dict_from_flax(jax.tree.map(np.asarray, setup["jax"]["f32"]["remat_grad"]),
                                    DEPTH)
    for name, g in expected.items():
        torch.testing.assert_close(remat[name], plain[name], rtol=0, atol=1e-6)
        assert (remat[name] - g).abs().max() <= 2e-4 * g.abs().max(), name


def test_train_step_matches_jax(setup):
    """One AdamW step of the plain module with dropout against JAX's
    ``make_train_step`` (the flax path), JAX's t and noise injected into
    the port and the port's masks into JAX."""
    x, t, gt, x2d = setup["inputs"]
    loss, grads, new = setup["jax"]["train"]
    port = port_model(setup["params"], **KW, **RATES)
    t_draw, noise = _jax_train_draws(setup["key"], gt.shape)
    optimizer, scheduler = make_optimizer(port.parameters(), LR, 0.99, steps_per_epoch=10)
    step = make_train_step(GaussianDiffusion.create(make_train_denoise_fn(port, 0.0), **TRAIN_KW),
                           optimizer, scheduler)
    our = step(_t(gt), _t(x2d), t=_t(t_draw), noise=_t(noise),
               dp_scales=(None, None, setup["masks"]))
    assert abs(our.item() - loss) <= 1e-5 * abs(loss)
    for name, p in port.named_parameters():
        g = grads[name]
        assert (p.grad - g).abs().max() <= 2e-4 * g.abs().max(), name
        allowed = torch.where(g.abs() < 1e-5, 2 * LR, 1e-6)  # test_torch_fast_train.py's rule
        assert ((p.detach() - new[name]).abs() <= allowed).all(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_one_site_is_flax_bit_for_bit(dtype, rate):
    """``dropout`` on flax's own mask (read off flax's output, x has no
    zeros) equals flax's ``nn.Dropout`` bit for bit: the kept element is x /
    keep with keep a constant of x's dtype, which x · (1 / keep) or, at
    bf16, an f32 keep would miss. flax runs eagerly here: jitted, XLA's CPU
    compiler turns the f32 division by a constant into a product with its
    reciprocal (one ulp apart in a quarter of the elements)."""
    x = np.random.default_rng(4).standard_normal((64, 33)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    want = nn.Dropout(rate).apply({}, xj, deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(2)})
    want = np.asarray(want.astype(jnp.float32))
    kept = torch.from_numpy(want != 0)
    got = dropout(torch.from_numpy(x).to(getattr(torch, dtype)), kept, rate)
    assert 0 < kept.float().mean() < 1
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_rate_one_gives_zeros_and_finite_gradients(setup):
    """At rate 1.0 every site returns zeros, as flax's does (it needs no
    mask there), and the gradients stay finite: 0, not x / 0's NaN."""
    x = torch.randn(3, 5, requires_grad=True)
    out = dropout(x, torch.ones(3, 5, dtype=torch.bool), 1.0)
    out.sum().backward()
    assert torch.equal(out, torch.zeros(3, 5)) and torch.equal(x.grad, torch.zeros(3, 5))
    xs, t = setup["inputs"][:2]
    port = port_model(setup["params"], **KW, drop_rate=1.0, attn_drop_rate=1.0)
    masks = draw_dropout_masks(port, torch.Generator().manual_seed(1), B, F, J)
    out = port(_t(xs), _t(t), (None, None, masks))
    np.testing.assert_allclose(out.detach().numpy(), setup["jax"]["f32"]["ones"], atol=1e-4,
                               rtol=0)
    (out ** 2).sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in port.parameters())


def test_eval_is_unchanged():
    """Evaluation draws no mask: the eval step of a module with dropout
    computes what the module without it computes, bit for bit, and leaves
    the generator where it was."""
    rng = np.random.default_rng(2)
    x2d = torch.from_numpy(rng.uniform(-1, 1, (2, F, J, 2)).astype(np.float32))
    x_init = torch.from_numpy(rng.standard_normal((4, F, J, 3)).astype(np.float32))
    outs = []
    for rates in (RATES, {}):
        model = MixSTEDenoiser(**KW, **rates, seed=2, device="cpu")
        diffusion = GaussianDiffusion.create(make_denoise_fn(model), timesteps=20,
                                             sampling_timesteps=3)
        step = make_eval_step(diffusion, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
        outs.append(step(x2d, x2d.clone(), x_init=x_init))
    assert torch.equal(outs[0], outs[1])
    model = MixSTEDenoiser(**KW, **RATES, seed=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    make_denoise_fn(model)(torch.randn(2, F, J, 5), torch.ones(2), generator=gen)
    assert torch.equal(gen.get_state(), state)


def test_masks_keep_their_share_and_follow_the_drop_path_draw():
    """Each site's kept share lies within 4σ of 1 − rate; the train
    denoiser draws the masks from its generator after the drop-path scales;
    a module without dropout draws none."""
    model = MixSTEDenoiser(**KW, **RATES, device="cpu")
    masks = draw_dropout_masks(model, torch.Generator().manual_seed(3), 8, F, J)
    assert set(masks) == {"pos"} | {f"{s}_{k}" for s in ("attn", "proj", "fc1", "fc2")
                                     for k in ("spatial", "temporal")}
    for name, kept in masks.items():
        p = 1.0 - RATES["attn_drop_rate" if name.startswith("attn") else "drop_rate"]
        sigma = (p * (1 - p) / kept.numel()) ** 0.5
        assert abs(kept.float().mean().item() - p) <= 4 * sigma, name
    draws = make_train_denoise_fn(model, 0.1).draw_dp_scales(torch.Generator().manual_seed(3), 2,
                                                             F, J)
    gen = torch.Generator().manual_seed(3)
    dp = draw_drop_path_scales(gen, 2, DEPTH, 0.1, F, J)
    again = draw_dropout_masks(model, gen, 2, F, J)
    assert len(draws) == 3 and all(torch.equal(a, b) for a, b in zip(draws[:2], dp))
    assert all(torch.equal(draws[2][k], again[k]) for k in again)
    plain = MixSTEDenoiser(**KW, device="cpu")
    assert draw_dropout_masks(plain, torch.Generator(), 2, F, J) is None
    assert len(make_train_denoise_fn(plain, 0.1).draw_dp_scales(torch.Generator(), 2, F, J)) == 2


def test_model_axis_of_two_equals_one_process(setup):
    """The f32 train step with dropout and drop-path at "data:1,model:2"
    on two gloo ranks, every draw from one seed: each rank takes its heads
    of the probabilities' masks and its hidden columns of fc1's from the
    whole draw, so the step is one process's."""
    loss, grads, params = setup["one"]
    for rank in setup["ranks"]:
        r_loss, r_grads, r_params = rank["train"]
        assert abs(r_loss.item() - loss.item()) <= 1e-5 * abs(loss.item())
        for name, g in grads.items():
            bar = 2e-5 * max(g.abs().max().item(), 1e-3)
            assert (r_grads[name] - g).abs().max().item() <= bar, name
    assert all(torch.equal(a, b) for a, b in zip(setup["ranks"][0]["train"][1].values(),
                                                 setup["ranks"][1]["train"][1].values()))
