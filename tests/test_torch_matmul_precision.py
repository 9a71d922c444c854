"""The session matmul precision, ``Config.matmul_precision`` (ROADMAP
A.14, C.11), against the JAX package on the CPU, Pallas in interpret mode,
at embed 32, 2 heads, depth 1, F = 9.

JAX's Runner sets ``jax_default_matmul_precision`` from the field
(diff3dhpe_tpu/engine/runner.py:93). JAX's CPU contracts float32 exactly
whatever that setting is, so the tests give ``dot_general`` the MXU's
one-pass semantics: its CPU lowering rule is wrapped (pytest's
monkeypatch; no file of the JAX package changes) so that every
``dot_general`` whose operands are float32 and whose canonical precision is
DEFAULT, which is what ``jax.default_matmul_precision("default")`` makes of
``precision=None``, rounds both operands to bf16 (``reduce_precision``)
and contracts them at HIGHEST. Wrapping the lowering and not the
primitive's ``bind`` matters for the gradients: autodiff then still
transposes a DEFAULT product into DEFAULT products, which round their own
operands (the cotangent too), as the TPU does. That reaches every float32
product that names no precision: the flax module's dense layers and
einsums, the fast path's dense layers and head, B3, B4 and B6's tiles in
interpret mode, and the backward's products. JAX's fused blocks B1, B2 and B5 pin their own mode
(``_dot_f32``); the tests pin it to "highest" (``f32_precision_scope``),
the port's default (JAX would otherwise read it from the environment).
Each JAX result at "default" is asserted to differ from its "highest" one.

The bars are ``test_torch_contract_modes.py``'s for "default": one product
within 1/10 of JAX's own default-vs-highest distance (max |·|); beyond one
product mean |·| within 1/10 of it, and the port's own effect JAX's to
10%.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax._src.interpreters import mlir
from jax._src.lax import lax as jax_lax_impl

import diff3dhpe_tpu.ops.fused_block as jax_fb
from diff3dhpe_torch import (
    fast_forward_denoise, fused_attention_block, fused_temporal_block_cols,
    fused_transformer_block, make_eval_step, make_mixed_diffusion, make_optimizer,
    make_train_step, state_dict_from_flax,
)
from diff3dhpe_torch.config import Config
from diff3dhpe_torch.data import PoseDataset, make_synthetic_h36m_like
from diff3dhpe_torch.engine.runner import Runner
from diff3dhpe_torch.io.export import export_eval_step, restore_eval_step
from diff3dhpe_torch.ops.attention import (
    grand_attention_bwd_ref, grand_attention_fullseq_ref, packed_grand_attention_ref,
)
from diff3dhpe_torch.ops.matmul_precision import MATMUL_PRECISIONS, matmul
from diff3dhpe_tpu.config import Config as JaxConfig
from diff3dhpe_tpu.data import PoseDataset as JaxPoseDataset
from diff3dhpe_tpu.data import make_synthetic_h36m_like as jax_make_synthetic
from diff3dhpe_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diff3dhpe_tpu.engine import build_train_state
from diff3dhpe_tpu.engine import make_eval_step as jax_make_eval_step
from diff3dhpe_tpu.engine import make_train_step as jax_make_train_step
from diff3dhpe_tpu.engine.runner import Runner as JaxRunner
from diff3dhpe_tpu.engine.steps import flip_pose_jnp
from diff3dhpe_tpu.engine.steps import make_denoise_fn as jax_make_denoise_fn
from diff3dhpe_tpu.engine.steps import make_fast_denoise_fn as jax_make_fast_denoise_fn
from diff3dhpe_tpu.engine.steps import make_optimizer as jax_make_optimizer
from diff3dhpe_tpu.models.fast_eval import fast_forward_denoise as jax_fast_forward
from diff3dhpe_tpu.ops.attention import (
    grand_attention_bwd_pallas, grand_attention_pallas_3d, packed_grand_attention,
)
from test_torch_contract_modes import EFFECT_TOL, TENTH, quick_compile
from torch_port_helpers import JOINTS_LEFT, JOINTS_RIGHT, build_pair, jax_x_init
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

F, C, HEADS, DEPTH, J = 9, 32, 2, 1, 17
FAST_KW = dict(num_frame=F, num_joints=J, depth=DEPTH, num_heads=HEADS)
DIFF_KW = dict(timesteps=50, sampling_timesteps=1, clip_denoised=True, beta_schedule="cosine")
TRAIN_KW = dict(timesteps=1000, sampling_timesteps=9, clip_denoised=True, clip_loss=True,
                beta_schedule="cosine")
PRECS = ("default", "highest")
KEY = 7


@contextlib.contextmanager
def jax_session(precision):
    """JAX traced inside at session precision ``precision``, with the MXU's
    one bf16 pass for float32 products at DEFAULT, and the fused blocks'
    own mode pinned to "highest"."""
    prim = jax_lax_impl.dot_general_p
    rules = mlir._platform_specific_lowerings["cpu"]
    original = rules[prim]

    def one_pass(ctx, lhs, rhs, *, precision, **params):
        f32 = all(a.dtype == np.float32 for a in ctx.avals_in)
        if f32 and precision == (jax.lax.Precision.DEFAULT,) * 2:
            def rounded(a, b):
                a, b = (jax.lax.reduce_precision(v, exponent_bits=8, mantissa_bits=7)
                        for v in (a, b))
                return prim.bind(a, b, precision=(jax.lax.Precision.HIGHEST,) * 2, **params)

            return mlir.lower_fun(rounded, multiple_results=False)(ctx, lhs, rhs)
        return original.rule(ctx, lhs, rhs, precision=precision, **params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(rules, prim, mlir.LoweringRuleEntry(one_pass, original.inline))
        with jax.default_matmul_precision(precision), jax_fb.f32_precision_scope("highest"):
            yield


def assert_one_product(port, jax_default, jax_highest):
    """Max |port − JAX| at "default" within 1/10 of JAX's own max distance
    between "default" and "highest"."""
    port, got, ref = (np.asarray(a, np.float32) for a in (port, jax_default, jax_highest))
    d_port, d_jax = np.abs(port - got).max(), np.abs(got - ref).max()
    assert d_jax > 0, "JAX's default result equals its highest one: the patch did not reach it"
    assert d_port <= TENTH * d_jax, (d_port, d_jax)


def assert_default_matches(port, port_highest, jax_default, jax_highest):
    """Beyond one product: mean |port − JAX| at "default" within 1/10 of
    JAX's mean default-vs-highest distance, and the port's own effect
    JAX's to 10%; the two packages' "highest" results agree far below it."""
    port, hi, got, ref = (np.asarray(a, np.float32)
                          for a in (port, port_highest, jax_default, jax_highest))
    d = lambda a, b: float(np.abs(a - b).mean())
    jax_effect = d(got, ref)
    assert jax_effect > 0, "JAX's default result equals its highest one"
    assert d(port, got) <= TENTH * jax_effect, (d(port, got), jax_effect)
    assert abs(d(port, hi) / jax_effect - 1) <= EFFECT_TOL, (d(port, hi), jax_effect)
    assert d(hi, ref) <= TENTH * jax_effect, (d(hi, ref), jax_effect)


def _keeping_grads(opt):
    """``opt`` whose state also holds the gradients of its last update."""
    def init(params):
        return opt.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _inputs():
    rng = np.random.default_rng(17)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x2d = rng.uniform(-1, 1, (2, F, J, 2)).astype(np.float32)
    return dict(
        x=f32(2, F, J, 5), time=np.array([3.0, 700.0], np.float32), gt=f32(2, F, J, 3),
        x2d=x2d, x2d_flip=np.array(flip_pose_jnp(jnp.asarray(x2d), JOINTS_LEFT, JOINTS_RIGHT)),
        # B3 [G, N, D] at N = 27, B6 at N = 17, B4's dO.
        q=f32(3, 27, 16), k=f32(3, 27, 16), v=f32(3, 27, 16), do=f32(3, 27, 16),
        qs=f32(8, 17, 16), ks=f32(8, 17, 16), vs=f32(8, 17, 16),
        a=f32(40, 48), w=f32(24, 48))


RUNNER = dict(subjects_train="S1", subjects_test="S9", number_of_frames=F, stride=F,
              embed_dim=C, transformer_depth=DEPTH, num_heads=HEADS, timesteps=50,
              sampling_timesteps=1, batch_size_eval=4, actions="*", mesh_shape="data:1", seed=5)
DATA_KW = dict(subjects=("S1", "S9"), n_frames=60, seed=1)
RUNNER_KEY = 11


def _jax_evaluate(params, precision):
    """JAX's ``Runner.evaluate`` (the plain module, DDIM-1) at session
    ``precision``; the process-wide setting the Runner makes is restored."""
    saved = jax.config.jax_default_matmul_precision
    try:
        jcfg = JaxConfig(**RUNNER, matmul_precision=precision)
        runner = JaxRunner(jcfg, J, JOINTS_LEFT, JOINTS_RIGHT)
        runner.set_params(params)
        jds, jkps = jax_make_synthetic(**DATA_KW)
        test_ds = JaxPoseDataset(jcfg, jds, "data", "test", keypoints_data=jkps)
        m = runner.evaluate(test_ds, action="Walking", key=jax.random.PRNGKey(RUNNER_KEY))
        return {k: np.asarray(m[k]) for k in ("predictions", "e1", "e2", "e3", "ev")}
    finally:
        jax.config.update("jax_default_matmul_precision", saved)


def _jax_programs(model, params, s2f, inp):
    """{name: JAX's result} at the current session precision; ``s2f``: the
    (flax model, params) of the s2f module, whose head takes the weighted
    mean over frames."""
    a = {k: jnp.asarray(v) for k, v in inp.items()}
    dims = ((1,), (1,))
    apply = lambda m, p: jax.jit(lambda q: m.apply({"params": q}, a["x"], a["time"]))(p)
    out = dict(
        dot=jax.jit(lambda x, y: jax.lax.dot_general(x, y, (dims, ((), ()))))(a["a"], a["w"]),
        module=apply(model, params), module_s2f=apply(*s2f),
        b3=grand_attention_pallas_3d(a["q"], a["k"], a["v"], interpret=True),
        b6=packed_grand_attention(a["qs"], a["ks"], a["vs"], interpret=True),
        b4=jnp.stack(grand_attention_bwd_pallas(a["q"], a["k"], a["v"], a["do"],
                                                interpret=True)))
    out["forward"] = quick_compile(jax.jit(lambda p: jax_fast_forward(
        p, a["x"], a["time"], interpret=True, dtype=jnp.float32, **FAST_KW)), params)
    mixed = dataclasses.replace(
        JaxDiffusion.create(jax_make_fast_denoise_fn(dtype=jnp.bfloat16, f32_head=True,
                                                     **FAST_KW), **DIFF_KW),
        final_denoise_fn=jax_make_fast_denoise_fn(dtype=jnp.float32, f32_prec="highest",
                                                  **FAST_KW),
        final_denoise_steps=1)
    step = jax_make_eval_step(mixed, JOINTS_LEFT, JOINTS_RIGHT)
    out["mixed"] = quick_compile(jax.jit(lambda p: step(p, jax.random.PRNGKey(KEY), a["x2d"],
                                                        a["x2d_flip"])), params)
    diffusion = JaxDiffusion.create(jax_make_denoise_fn(model), **TRAIN_KW)
    opt = _keeping_grads(jax_make_optimizer(1e-3, 0.99, steps_per_epoch=10))
    state, loss = jax_make_train_step(diffusion, opt)(
        build_train_state(jax.tree.map(jnp.asarray, params), opt), jax.random.PRNGKey(KEY),
        a["gt"], a["x2d"])
    out["loss"] = loss
    out["grads"] = state_dict_from_flax(jax.tree.map(np.asarray, state.opt_state[1]), DEPTH)
    return {k: v if k == "grads" else np.asarray(v, np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def pair():
    return build_pair(np.random.default_rng(14), num_frame=F, embed_dim=C, depth=DEPTH,
                      num_heads=HEADS)


@pytest.fixture(scope="module")
def pair_s2f():
    return build_pair(np.random.default_rng(15), num_frame=F, embed_dim=C, depth=DEPTH,
                      num_heads=HEADS, mode="s2f")


@pytest.fixture(scope="module")
def jax_results(pair, pair_s2f):
    """{precision: {name: JAX's result}} at "default" and "highest", with
    JAX's ``Runner.evaluate`` ("runner")."""
    model, params, _ = pair
    inp, out = _inputs(), {}
    for precision in PRECS:
        with jax_session(precision):
            out[precision] = _jax_programs(model, params, pair_s2f[:2], inp)
            out[precision]["runner"] = _jax_evaluate(params, precision)
    return out, inp


def _t(a):
    return torch.from_numpy(np.array(a))


def _train_draws(inp):
    """JAX's t and noise of its train step's key (engine/steps.py:298,
    gaussian_diffusion.py:147-150)."""
    diff_key, _ = jax.random.split(jax.random.PRNGKey(KEY))
    key_t, key_noise = jax.random.split(diff_key)
    t = np.asarray(jax.random.randint(key_t, (2,), 0, TRAIN_KW["timesteps"]))
    noise = np.asarray(jax.random.normal(key_noise, inp["gt"].shape, jnp.float32))
    return _t(t), _t(noise)


def _port_train_step(port_params, inp, precision):
    """(loss, {name: gradient}) of one step of ``Runner.fit``'s train step
    (``make_train_step`` on the runner's ``train_diffusion``) at session
    ``precision``, on JAX's draws."""
    cfg = Config(**dict(RUNNER, timesteps=TRAIN_KW["timesteps"], sampling_timesteps=9,
                        drop_path_rate=0.0, clip_loss=True), matmul_precision=precision)
    runner = Runner(cfg, J, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    runner.set_params(port_params)
    optimizer, scheduler = make_optimizer(runner.model.parameters(), 1e-3, 0.99,
                                          steps_per_epoch=10)
    t, noise = _train_draws(inp)
    loss = make_train_step(runner.train_diffusion, optimizer, scheduler)(
        _t(inp["gt"]), _t(inp["x2d"]), t=t, noise=noise)
    return loss.item(), {n: p.grad for n, p in runner.model.named_parameters()}


def _port(port, inp, name, precision):
    """The port's counterpart of JAX's program ``name`` at ``precision``
    (``port``: the s2f module for "module_s2f")."""
    t = lambda k: _t(inp[k])
    prec = dict(matmul_precision=precision)
    with torch.no_grad():
        if name == "dot":
            return matmul(t("a"), t("w").T, precision)
        if name.startswith("module"):
            return port(t("x"), t("time"), **prec)
        if name == "b3":
            return grand_attention_fullseq_ref(t("q"), t("k"), t("v"), **prec)
        if name == "b6":
            return packed_grand_attention_ref(t("qs"), t("ks"), t("vs"), **prec)
        if name == "b4":
            return torch.stack(grand_attention_bwd_ref(t("q"), t("k"), t("v"), t("do"), **prec))
        if name == "forward":
            return fast_forward_denoise(port, t("x"), t("time"), **prec)
    diffusion = make_mixed_diffusion(port, f32_prec="highest", **prec, **DIFF_KW)
    step = make_eval_step(diffusion, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    return step(inp["x2d"], inp["x2d_flip"], x_init=jax_x_init(jax.random.PRNGKey(KEY), 4,
                                                               (F, J, 3)))


@pytest.mark.parametrize("name", ["dot", "module", "module_s2f", "b3", "b6", "b4", "forward",
                                  "mixed"])
def test_default_matches_jax(pair, pair_s2f, jax_results, name):
    """One product (``ops.matmul_precision.matmul`` against ``dot_general``
    with precision None), the plain module's forward (s2s, and s2f with its
    weighted mean over frames), B3, B6 and B4's plain versions, the f32
    fast forward and the mixed eval step with its f32 head (DDIM-1: its one
    step is the float32 final step) at "default" against JAX's at the
    session precision "default"."""
    jax_out, inp = jax_results
    port = (pair_s2f if name == "module_s2f" else pair)[2]
    out = {p: _port(port, inp, name, p) for p in PRECS}
    if name == "dot":
        assert_one_product(out["default"], jax_out["default"][name], jax_out["highest"][name])
    else:
        assert_default_matches(out["default"], out["highest"], jax_out["default"][name],
                               jax_out["highest"][name])


def test_train_step_at_default_matches_jax(pair, jax_results):
    """One step of ``Runner.fit``'s train step (the plain module under
    autograd, AdamW) at "default" against JAX's ``make_train_step`` at the
    session precision "default" on the same t and noise: the loss, and every
    gradient (JAX's transpose keeps the precision, so the backward's
    products round their operands too)."""
    jax_out, inp = jax_results
    params = state_dict_from_flax(pair[1], DEPTH)
    ours = {p: _port_train_step(params, inp, p) for p in PRECS}
    assert_default_matches(ours["default"][0], ours["highest"][0], jax_out["default"]["loss"],
                           jax_out["highest"]["loss"])
    flat = lambda grads: np.concatenate([np.asarray(grads[k], np.float32).ravel()
                                         for k in sorted(jax_out["default"]["grads"])])
    assert_default_matches(flat(ours["default"][1]), flat(ours["highest"][1]),
                           flat(jax_out["default"]["grads"]), flat(jax_out["highest"]["grads"]))


def _port_evaluate(port_params, precision):
    cfg = Config(**RUNNER, matmul_precision=precision)
    runner = Runner(cfg, J, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    runner.set_params(port_params)
    ds, kps = make_synthetic_h36m_like(**DATA_KW)
    test_ds = PoseDataset(cfg, ds, "data", "test", keypoints_data=kps)
    subkeys, k = [], jax.random.PRNGKey(RUNNER_KEY)
    for _ in test_ds.batches(cfg.batch_size_eval):
        k, sub = jax.random.split(k)
        subkeys.append(sub)
    return runner.evaluate(test_ds, action="Walking", x_init=lambda i: jax_x_init(
        subkeys[i], 2 * cfg.batch_size_eval, (F, J, 3)))


def test_runner_evaluate_at_default_matches_jax(pair, jax_results):
    """``Runner.evaluate`` (the plain module, DDIM-1, flip-TTA) with
    ``matmul_precision="default"`` against JAX's Runner built from the same
    field, given JAX's x_T: the predictions under the "default" bars, the
    metrics to 1e-4."""
    jax_out = jax_results[0]
    params = state_dict_from_flax(pair[1], DEPTH)
    preds = {p: _port_evaluate(params, p) for p in PRECS}
    assert_default_matches(preds["default"]["predictions"], preds["highest"]["predictions"],
                           jax_out["default"]["runner"]["predictions"],
                           jax_out["highest"]["runner"]["predictions"])
    for m in ("e1", "e2", "e3", "ev"):
        np.testing.assert_allclose(preds["default"][m], jax_out["default"]["runner"][m],
                                   rtol=1e-4, err_msg=m)


@pytest.mark.parametrize("name", ["module", "b3", "b6", "b4", "forward", "mixed"])
def test_highest_is_the_call_without_it(pair, name):
    """"highest" computes the bits of the call that passes no
    ``matmul_precision`` (what the port computed before the field reached
    it), and "default" moves them."""
    inp, port = _inputs(), pair[2]
    ambient = _port_ambient(port, inp, name)
    assert torch.equal(_port(port, inp, name, "highest"), ambient)
    assert not torch.equal(_port(port, inp, name, "default"), ambient)
    assert torch.equal(_port(port, inp, name, "bfloat16"), _port(port, inp, name, "default"))


def _port_ambient(port, inp, name):
    t = lambda k: _t(inp[k])
    with torch.no_grad():
        if name == "module":
            return port(t("x"), t("time"))
        if name == "b3":
            return grand_attention_fullseq_ref(t("q"), t("k"), t("v"))
        if name == "b6":
            return packed_grand_attention_ref(t("qs"), t("ks"), t("vs"))
        if name == "b4":
            return torch.stack(grand_attention_bwd_ref(t("q"), t("k"), t("v"), t("do")))
        if name == "forward":
            return fast_forward_denoise(port, t("x"), t("time"))
    step = make_eval_step(make_mixed_diffusion(port, f32_prec="highest", **DIFF_KW),
                          JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    return step(inp["x2d"], inp["x2d_flip"], x_init=jax_x_init(jax.random.PRNGKey(KEY), 4,
                                                               (F, J, 3)))


@pytest.mark.parametrize("kind", ["b1", "b2", "b5"])
def test_fused_blocks_do_not_move_with_it(pair, monkeypatch, kind):
    """B1, B2 and B5 contract at their own ``f32_prec`` alone, as JAX's
    ``_dot_f32`` pins it: in the fast forward at "default" (rows for B1,
    cols for B2) each block call is handed its f32_prec and nothing of the
    session precision, and its output equals the same call made directly;
    B5, which no model path runs, takes no such argument."""
    inp, port = _inputs(), pair[2]
    if kind == "b5":
        x = torch.zeros(4 * 17, C)
        with pytest.raises(TypeError, match="matmul_precision"):
            fused_attention_block(x, port.STEblocks[0], 17, HEADS, matmul_precision="default")
        return
    import diff3dhpe_torch.models.fast_eval as fast

    wrapper = fused_transformer_block if kind == "b1" else fused_temporal_block_cols
    name = wrapper.__name__
    calls = []

    def recording(*args, **kwargs):
        out = wrapper(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(fast, name, recording)
    with torch.no_grad():
        fast_forward_denoise(port, _t(inp["x"]), _t(inp["time"]), matmul_precision="default",
                             temporal_mode="rows" if kind == "b1" else "cols")
        assert calls
        for args, kwargs, out in calls:
            assert "matmul_precision" not in kwargs and kwargs["f32_prec"] == "highest"
            assert torch.equal(wrapper(*args, **kwargs), out)


def test_unknown_values_are_refused_by_name():
    """Any value but "highest", "default" and "bfloat16" raises a
    ValueError naming ``matmul_precision``: in the Runner (JAX's "high"
    has no kernel counterpart: Mosaic rejects Precision.HIGH) and in the
    functions that contract."""
    assert MATMUL_PRECISIONS == ("highest", "default", "bfloat16")
    for bad in ("high", "tensorfloat32", "float32", None):
        with pytest.raises(ValueError, match="matmul_precision"):
            Runner(Config(**RUNNER, matmul_precision=bad), J, JOINTS_LEFT, JOINTS_RIGHT,
                   device="cpu")
    x = torch.zeros(2, 9, 8)
    with pytest.raises(ValueError, match="matmul_precision"):
        grand_attention_fullseq_ref(x, x, x, matmul_precision="high")
    with pytest.raises(ValueError, match="matmul_precision"):
        matmul(x, x.transpose(-1, -2), "high")


def test_export_bakes_in_the_precision(pair, tmp_path):
    """The exported eval step at "default" records the field in its
    metadata and computes what the live step computes, bit for bit; the
    live step at "highest" differs."""
    params = state_dict_from_flax(pair[1], DEPTH)
    rng = np.random.default_rng(4)
    x2d = rng.uniform(-1, 1, (2, F, J, 2)).astype(np.float32)
    x_init = rng.standard_normal((4, F, J, 3)).astype(np.float32)
    runners = {p: _runner_at(params, p) for p in PRECS}
    with torch.no_grad():
        live = {p: r.eval_step(x2d, x2d[:, :, ::-1].copy(), x_init=x_init)
                for p, r in runners.items()}
    path = str(tmp_path / "eval.pt2")
    export_eval_step(runners["default"], batch_size=2, path=path)
    step = restore_eval_step(path)
    assert step.meta["matmul_precision"] == "default"
    got = step(params, x2d, x2d[:, :, ::-1].copy(), x_init)
    assert torch.equal(got, live["default"])
    assert not torch.equal(live["default"], live["highest"])


def _runner_at(params, precision):
    runner = Runner(Config(**RUNNER, matmul_precision=precision), J, JOINTS_LEFT, JOINTS_RIGHT,
                    device="cpu")
    runner.set_params(params)
    return runner
