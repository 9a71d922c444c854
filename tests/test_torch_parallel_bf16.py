"""ROADMAP C.10: two ranks' bf16 fast-train gradients against one
process's, in the port and in the JAX package, on the CPU.

The bf16 fast-train step with the attention backward kernels (drop-path
0.5, 4 heads, global batch 8) on two gloo ranks (tests/torch_parallel_ranks.py
``run_bf16_cases``) against the same step in one process, both given the
same global draws: the ones JAX's ``data:2`` ``shard_map`` step draws per
shard (``fold_in(key, shard)``, diff3dhpe_tpu/engine/steps.py:260-261),
injected as test_torch_parallel.py's ``test_train_step_matches_jax_on_its_data_mesh``
injects them. JAX's own gap: its ``data:2`` step (gradients ``pmean``-ed,
:270-271) against its one-device gradient of the same loss on the same
draws (``p_losses`` with the draws given, diffusion/gaussian_diffusion.py:
137-178). JAX compiles with excess precision off (tests/test_torch_bf16_train.py:
otherwise XLA's CPU keeps bf16-typed values in float32) and without LLVM's
optimisations (the compile time of the interpreted kernels).

The gap is the relative L2 over every parameter's gradient, chip_smoke.py
phase 20b's ``grad_rel_l2``. Each rank rounds its bf16 weight gradients
(the activations' products over its half of the rows) once, and the mean
of two roundings is not one rounding of the whole sum: about 2^-9 relative
per element in both packages. The bar: the port's gap at most 2x JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from concurrent.futures import ThreadPoolExecutor

import torch_parallel_ranks as ranks
from diff3dhpe_torch.io import state_dict_from_flax
from diff3dhpe_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diff3dhpe_tpu.engine import build_train_state
from diff3dhpe_tpu.engine import make_train_step as jax_make_train_step
from diff3dhpe_tpu.engine.steps import make_fast_train_denoise_fn as jax_make_fast_train_fn
from diff3dhpe_tpu.models.fast_eval import FastTrainCfg, fast_forward_denoise_train_pairs
from diff3dhpe_tpu.parallel import make_mesh
from test_torch_parallel import _jax_draws, _keeping_grads
from torch_port_helpers import build_pair
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

WORLD, B = 2, 8
F, J = ranks.F, ranks.J
JOIN_S = 300
OPTIONS = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0}


def grad_rel_l2(got, ref):
    """sqrt(sum |got - ref|^2) / sqrt(sum |ref|^2) over every parameter."""
    num = sum(float(((got[n] - g).double() ** 2).sum()) for n, g in ref.items())
    den = sum(float((g.double() ** 2).sum()) for g in ref.values())
    return (num / den) ** 0.5


def _state_dict(tree):
    grads = state_dict_from_flax(jax.tree.map(np.asarray, tree), ranks.DEPTH)
    return {k: v.float() for k, v in grads.items()}


def _jax_data2(params, key, gt, x2d):
    """(loss, gradients) of JAX's bf16 train step on data:2 (shard_map)."""
    from diff3dhpe_tpu.engine.steps import make_optimizer

    fn = jax_make_fast_train_fn(num_frame=F, num_joints=J, depth=ranks.DEPTH,
                                num_heads=ranks.HEADS, dtype=jnp.bfloat16,
                                drop_path_rate=ranks.DROP_PATH, attn_bwd=True)
    opt = _keeping_grads(make_optimizer(ranks.LR, 0.99, steps_per_epoch=10))
    state = build_train_state(jax.tree.map(jnp.asarray, params), opt)
    step = jax_make_train_step(JaxDiffusion.create(fn, **ranks.TRAIN_KW), opt,
                               mesh=make_mesh("data:2"), donate=False)
    args = (state, key, jnp.asarray(gt), jnp.asarray(x2d))
    state, loss = step.lower(*args).compile(compiler_options=OPTIONS)(*args)
    return float(loss), _state_dict(state.opt_state[1])


def _jax_one_device(params, gt, x2d, draws):
    """(loss, gradients) of JAX's bf16 fast-train loss on the whole batch at
    once, with ``draws`` (t, noise, drop-path scales) given: ``p_losses``
    (diffusion/gaussian_diffusion.py:145-178) spelled out with them."""
    diffusion = JaxDiffusion.create(lambda *a: None, **ranks.TRAIN_KW)
    cfg = FastTrainCfg(num_frame=F, num_joints=J, depth=ranks.DEPTH, num_heads=ranks.HEADS,
                       with_time_emb=True, mode="s2s", dtype_name="bfloat16",
                       temporal_mode="rows", ckpt_blocks=False, attn_bwd=True)
    c = diffusion.constants

    def loss_fn(p, gt, x2d, t, noise, dp_s, dp_t):
        x_noisy = diffusion.q_sample(gt, t, noise)
        out = fast_forward_denoise_train_pairs(p, jnp.concatenate([x2d, x_noisy], axis=-1),
                                               t.astype(jnp.float32), (dp_s, dp_t), cfg)
        coef = jnp.minimum(1.0 + jnp.asarray(c.alphas_cumprod)[t]
                           / jnp.asarray(c.sqrt_one_minus_alphas_cumprod)[t], 3.0)
        return jnp.mean((out - gt) ** 2 * coef.reshape(-1, 1, 1, 1))

    args = (jax.tree.map(jnp.asarray, params), jnp.asarray(gt), jnp.asarray(x2d),
            jnp.asarray(draws["t"].numpy()), jnp.asarray(draws["noise"].numpy()),
            *(jnp.asarray(d.numpy()) for d in draws["dp_scales"]))
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    loss, grads = grad_fn.lower(*args).compile(compiler_options=OPTIONS)(*args)
    return float(loss), _state_dict(grads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawns the two ranks, builds the one-process port's step and JAX's
    two while they run, joins them."""
    tmp = tmp_path_factory.mktemp("parallel_bf16")
    _, params, port = build_pair(np.random.default_rng(15), num_frame=F, embed_dim=ranks.EMBED,
                                 depth=ranks.DEPTH, num_heads=ranks.HEADS)
    rng = np.random.default_rng(0)
    x2d = rng.uniform(-1, 1, (B, F, J, 2)).astype(np.float32)
    gt = rng.standard_normal((B, F, J, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    draws = _jax_draws(key, B, gt.shape, True)
    weights = {k: v.detach().clone() for k, v in port.state_dict().items()}
    batch = (torch.from_numpy(gt), torch.from_numpy(x2d))
    torch.save(dict(weights=weights, batch=batch, draws=draws), tmp / "spec.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ranks.run_rank, daemon=True,
                         args=(r, WORLD, str(tmp / "rendezvous"), str(tmp / "spec.pt"), str(tmp),
                               "run_bf16_cases"))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        with ThreadPoolExecutor(2) as pool:
            data2 = pool.submit(_jax_data2, params, key, gt, x2d)
            one_device = pool.submit(_jax_one_device, params, gt, x2d, draws)
            jax_res = dict(data2=data2.result(), one=one_device.result())
        one = ranks.run_train(weights, True, batch, None, dtype=torch.bfloat16, attn_bwd=True,
                              **draws)
    finally:
        for p in procs:
            p.join(JOIN_S)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
    assert not alive, f"ranks {alive} did not finish in {JOIN_S} s"
    results = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for r, (p, res) in enumerate(zip(procs, results)):
        assert p.exitcode == 0 and "error" not in res, (r, p.exitcode, res.get("error"))
    return dict(ranks=[res["cases"]["train_bf16"] for res in results], one=one, jax=jax_res)


def test_jax_one_device_loss_is_its_data_mesh_loss(run):
    """The one-device loss spelled out with the draws is the loss of JAX's
    data:2 step (the mean of the shards' means), up to bf16 rounding: the
    draws are the same."""
    (loss2, _), (loss1, _) = run["jax"]["data2"], run["jax"]["one"]
    assert abs(loss2 - loss1) <= 1e-2 * abs(loss1), (loss2, loss1)


def test_two_ranks_bf16_gap_is_jax_data_mesh_gap(run):
    """The port's two-rank bf16 gradients part from its one process's by at
    most 2x what JAX's data:2 step's part from its one device's (C.10)."""
    (_, jax2), (_, jax1) = run["jax"]["data2"], run["jax"]["one"]
    jax_gap = grad_rel_l2(jax2, jax1)
    port_gap = grad_rel_l2(run["ranks"][0][1], run["one"][1])
    assert 0 < jax_gap and 0 < port_gap <= 2 * jax_gap, (port_gap, jax_gap)


def test_ranks_agree_and_the_loss_is_the_one_process_loss(run):
    (loss0, grads0, params0), (loss1, grads1, params1) = run["ranks"]
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(grads0[n], grads1[n]) and torch.equal(params0[n], params1[n])
               for n in grads0)
    assert abs(float(loss0) - float(run["one"][0])) <= 1e-2 * abs(float(run["one"][0]))
