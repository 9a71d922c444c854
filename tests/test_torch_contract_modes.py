"""The float32 contraction modes of the fused blocks ("highest", "high3",
"default"; ROADMAP A.11) against the JAX package on the CPU, Pallas in
interpret mode, at embed 64, 8 heads, depth 1, F = 9, in rows and cols.

The reference for "high3" is JAX's kernels under
``f32_precision_scope("high3")`` (``_dot_f32_3pass``). For "default" JAX's
CPU contracts exactly (tests/test_fast_eval.py:131-133), so the tests
replace ``diff3dhpe_tpu.ops.fused_block._dot_f32`` (pytest's monkeypatch; no
file of the JAX package changes) with the MXU's semantics: at "default" the
f32 operands are rounded to bf16 before the ``dot_general``. Each JAX
result at "default" is asserted to differ from its "highest" one, so that a
cached trace cannot hide the patch.

The bars. One product (``contract`` against ``_dot_f32`` on the same
operands): max |port − jax| at the mode within 1/10 of JAX's own distance
between that mode and "highest". Beyond one product the operands of each
product differ between the two packages by float32 roundings (sums in
another order, exp against exp2, LayerNorm statistics), and both modes'
errors jump where such a difference moves a split: "default" flips a bf16
rounding (one in ~2^16 operands, each worth 2^-9 of it), "high3" changes a
lo half (one operand in ~2^7, each worth 2^-17). So the blocks, forwards,
the mixed eval step and ``Runner.evaluate`` are held by mean |·|, with the
port's "highest" as the reference of each mode's effect (it is JAX's exact
f32 to ~1e-7): at "default" the port's distance from JAX within 1/10 of
JAX's effect (measured: at most 0.04); at "high3" within 0.6 of it
(measured: 0.20 for a block to 0.47 for the forward; an exact-f32 port
would sit at 1.0), since moving the inputs by one float32 rounding moves
the port's own "high3" block by 0.3 of the effect
(``test_high3_moves_with_one_rounding``), so that no bar of 1/10 can hold
between two packages whose float32 arithmetic differs by a rounding; and at both modes the port's own effect equal to JAX's
to 10% (measured: within 2%), which a mode that did not reach the kernels,
in either package, fails. "highest" is held against JAX by the other test
files at the f32 bars (tests/test_torch_fused_block.py), and the ambient
call (no ``f32_prec``) equals it bit for bit.

The mixed eval step and ``Runner.evaluate`` run DDIM-1, whose one step is
the float32 final step: with bf16 trunk steps before it, the two packages'
trunks differ by ~5e-3 (tests/test_torch_mixed_eval.py), which would bury
the final step's mode.
"""
import contextlib
import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diff3dhpe_tpu.ops.fused_block as jax_fb
from diff3dhpe_torch import make_eval_step, make_mixed_diffusion
from diff3dhpe_torch.config import Config
from diff3dhpe_torch.data import PoseDataset, make_synthetic_h36m_like
from diff3dhpe_torch.engine.runner import Runner
from diff3dhpe_torch.models.fast_eval import fast_forward_denoise
from diff3dhpe_torch.ops.attention import grand_attention_stored
from diff3dhpe_torch.ops.fused_block import (
    F32_MODES, bf16_split, contract, fused_attention_block, fused_temporal_block_cols,
    fused_transformer_block,
)
from diff3dhpe_tpu.config import Config as JaxConfig
from diff3dhpe_tpu.data import PoseDataset as JaxPoseDataset
from diff3dhpe_tpu.data import make_synthetic_h36m_like as jax_make_synthetic
from diff3dhpe_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diff3dhpe_tpu.engine import make_eval_step as jax_make_eval_step
from diff3dhpe_tpu.engine.runner import Runner as JaxRunner
from diff3dhpe_tpu.engine.steps import flip_pose_jnp
from diff3dhpe_tpu.engine.steps import make_fast_denoise_fn as jax_make_fast_denoise_fn
from diff3dhpe_tpu.models.fast_eval import fast_forward_denoise as jax_fast_forward
from torch_port_helpers import JOINTS_LEFT, JOINTS_RIGHT, build_pair, jax_x_init, perturb
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

F, C, HEADS, DEPTH, J = 9, 64, 8, 1, 17
B_COLS, J_COLS, GROUPS = 2, 5, 6
FAST_KW = dict(num_frame=F, num_joints=J, depth=DEPTH, num_heads=HEADS)
DIFF_KW = dict(timesteps=50, sampling_timesteps=1, clip_denoised=True, beta_schedule="cosine")
MODES = ("high3", "default")


def _mxu_dot_f32(original):
    """JAX's ``_dot_f32`` with "default" given the MXU's semantics on float32
    operands: both rounded to bf16, their products exact, f32 sums."""
    def dot(a, b, dims):
        if a.dtype != jnp.bfloat16 and jax_fb.f32_contract_mode() == "default":
            # reduce_precision: round to nearest even, which XLA's
            # simplifier cannot fold away as it may a pair of converts.
            a, b = (jax.lax.reduce_precision(v, exponent_bits=8, mantissa_bits=7) for v in (a, b))
            return jax.lax.dot_general(a, b, (dims, ((), ())), preferred_element_type=jnp.float32,
                                       precision=jax.lax.Precision.HIGHEST)
        return original(a, b, dims)

    return dot


@contextlib.contextmanager
def jax_mode(mode):
    """JAX's fused kernels traced inside at contraction ``mode``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fb, "_dot_f32", _mxu_dot_f32(jax_fb._dot_f32))
        with jax_fb.f32_precision_scope(mode):
            yield


# The bars, on mean |difference| (module doc): "default" within 1/10 of
# JAX's own mode effect; "high3" within MEAN_HIGH3 of it, and the port's
# own mode effect the size of JAX's to EFFECT_TOL.
TENTH, MEAN_HIGH3, EFFECT_TOL = 0.1, 0.6, 0.1


def assert_within_tenth(port, jax_mode_out, jax_highest):
    """One product on the same operands: max |port − jax| at the mode
    within 1/10 of max |jax_mode − jax_highest|."""
    port, got, ref = (np.asarray(a, np.float32) for a in (port, jax_mode_out, jax_highest))
    d_port, d_jax = np.abs(port - got).max(), np.abs(got - ref).max()
    assert d_jax > 0, "JAX's mode result equals its highest one: the mode did not reach it"
    assert d_port <= TENTH * d_jax, (d_port, d_jax)


def mode_distances(port, port_highest, jax_mode_out):
    """Mean |·| of the port's distance from JAX at the mode, of JAX's mode
    effect and of the port's (both against the port's "highest", which is
    JAX's exact f32 to ~1e-7: tests/test_torch_fused_block.py)."""
    port, hi, got = (np.asarray(a, np.float32) for a in (port, port_highest, jax_mode_out))
    d = lambda a, b: float(np.abs(a - b).mean())
    return dict(port_vs_jax=d(port, got), jax_effect=d(got, hi), port_effect=d(port, hi))


def assert_mode_matches(port, port_highest, jax_mode_out, mode):
    d = mode_distances(port, port_highest, jax_mode_out)
    bar = TENTH if mode == "default" else MEAN_HIGH3
    assert d["port_vs_jax"] <= bar * d["jax_effect"], d
    # A mode that did not reach JAX's kernels (a cached trace) or the
    # port's leaves its effect at the f32 noise: the ratio fails.
    assert abs(d["port_effect"] / d["jax_effect"] - 1) <= EFFECT_TOL, d


@pytest.fixture(scope="module")
def pair():
    return build_pair(np.random.default_rng(16), num_frame=F, embed_dim=C, depth=DEPTH,
                      num_heads=HEADS)


def _inputs():
    rng = np.random.default_rng(5)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x2d = rng.uniform(-1, 1, (2, F, J, 2)).astype(np.float32)
    return dict(rows=f32(GROUPS * 17, C), t=f32(2, C), cols=f32(B_COLS * F, J_COLS * C),
                t_cols=f32(B_COLS, C), x=f32(2, F, J, 5), time=np.array([3.0, 700.0], np.float32),
                x2d=x2d, x2d_flip=np.array(flip_pose_jnp(jnp.asarray(x2d), JOINTS_LEFT,
                                                         JOINTS_RIGHT)))


def quick_compile(jitted, *args):
    """``jitted(*args)``, compiled without LLVM's optimisations: a third of
    the compile time of these interpreted kernels, the same arithmetic up to
    float32 rounding."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _jax_program(kind, params, inp, key):
    """One of JAX's programs at the current mode, jitted: "blocks" (B1 in
    rows with the time add and the out-LN, B2 in cols, B5, the f32 fast
    forward), "tail" (the bf16 forward with a float32 tail of its one pair)
    or "mixed" (the mixed eval step, DDIM-1, on JAX's x_T)."""
    a = {k: jnp.asarray(v) for k, v in inp.items()}
    if kind == "tail":
        fn = lambda p: dict(tail=jax_fast_forward(
            p, a["x"], a["time"], interpret=True, dtype=jnp.bfloat16, f32_head=True,
            f32_tail_pairs=1, **FAST_KW))
    elif kind == "mixed":
        mixed = dataclasses.replace(
            JaxDiffusion.create(jax_make_fast_denoise_fn(dtype=jnp.bfloat16, f32_head=True,
                                                         **FAST_KW), **DIFF_KW),
            final_denoise_fn=jax_make_fast_denoise_fn(
                dtype=jnp.float32, f32_prec=jax_fb.f32_contract_mode(), **FAST_KW),
            final_denoise_steps=1)
        step = jax_make_eval_step(mixed, JOINTS_LEFT, JOINTS_RIGHT)
        fn = lambda p: dict(mixed=step(p, key, a["x2d"], a["x2d_flip"]))
    else:
        def fn(p):
            b = p["ste_block_0"]
            return dict(
                b1=jax_fb.fused_transformer_block(
                    a["rows"], b, n=17, heads=HEADS, interpret=True, t_rows=a["t"],
                    rows_per_item=GROUPS * 17 // 2, out_ln_params=p["spatial_norm"]),
                b2=jax_fb.fused_temporal_block_cols(
                    a["cols"], p["tte_block_0"], n=F, f8=F, j_groups=J_COLS, heads=HEADS,
                    interpret=True, t_rows=a["t_cols"], out_ln_params=p["temporal_norm"]),
                b5=jax_fb.fused_attention_block(
                    a["rows"], b["norm1"]["scale"], b["norm1"]["bias"],
                    b["attn"]["qkv"]["kernel"], b["attn"]["qkv"]["bias"],
                    b["attn"]["proj"]["kernel"], b["attn"]["proj"]["bias"], n=17, heads=HEADS,
                    interpret=True),
                forward=jax_fast_forward(p, a["x"], a["time"], interpret=True,
                                         dtype=jnp.float32, **FAST_KW))
    return {k: np.asarray(v, np.float32) for k, v in quick_compile(jax.jit(fn), params).items()}


RUNNER = dict(subjects_train="S1", subjects_test="S9", number_of_frames=F, stride=F,
              embed_dim=C, transformer_depth=DEPTH, num_heads=HEADS, timesteps=50,
              sampling_timesteps=1, batch_size_eval=4, actions="*", mesh_shape="data:1", seed=5,
              fast_eval=True, compute_dtype="bfloat16", eval_f32_final_steps=1,
              eval_f32_head=True)
DATA_KW = dict(subjects=("S1", "S9"), n_frames=100, seed=1)


def _runner_params():
    jax_runner = JaxRunner(JaxConfig(**RUNNER), J, JOINTS_LEFT, JOINTS_RIGHT)
    x = jnp.zeros((1, F, J, 5))
    params = jax.jit(jax_runner.model.init)(jax.random.PRNGKey(5), x, jnp.zeros((1,)))["params"]
    return perturb(jax.tree.map(np.asarray, params), np.random.default_rng(2))


def _jax_evaluate(params, key):
    """JAX's ``Runner.evaluate`` at eval_final_prec "default" (mixed, DDIM-1)."""
    jcfg = JaxConfig(**RUNNER, eval_final_prec="default")
    jax_runner = JaxRunner(jcfg, J, JOINTS_LEFT, JOINTS_RIGHT)
    jax_runner.set_params(params)
    jds, jkps = jax_make_synthetic(**DATA_KW)
    test_ds = JaxPoseDataset(jcfg, jds, "data", "test", keypoints_data=jkps)
    b = next(iter(test_ds.batches(jcfg.batch_size_eval)))
    args = (jax_runner.state.params, key, jnp.asarray(b.input_2d), jnp.asarray(b.input_2d_flip))
    compiled = jax_runner.eval_step.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    jax_runner.eval_step = compiled  # evaluate's batches all have this shape
    return jax_runner.evaluate(test_ds, action="Walking", key=key)


KEY, RUNNER_KEY = 7, 11  # the PRNG keys of the eval steps and of Runner.evaluate


def _job(mode, kind, params, inp, runner_params):
    """One of JAX's programs (or ``Runner.evaluate``) at ``mode``, in a
    worker process: tracing holds the interpreter lock, so threads would
    trace the seven in turn."""
    jax.config.update("jax_platforms", "cpu")
    with jax_mode(mode):
        if kind == "runner":
            m = _jax_evaluate(runner_params, jax.random.PRNGKey(RUNNER_KEY))
            return {k: np.asarray(m[k]) for k in ("predictions", "e1", "e2", "e3", "ev")}
        return _jax_program(kind, params, inp, jax.random.PRNGKey(KEY))


@pytest.fixture(scope="module")
def results(pair):
    """{mode: {name: JAX's result}} at "high3" and "default", JAX's
    ``Runner.evaluate`` at "default" ("runner") and the inputs: JAX's
    seven programs traced and compiled in four spawned processes, each
    under its mode."""
    _, params, _ = pair
    inp, runner_params = _inputs(), _runner_params()
    jobs = [(m, k) for m in MODES for k in ("blocks", "tail", "mixed")] + [("default", "runner")]
    with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_job, mode, kind, params, inp, runner_params)
                   for mode, kind in jobs]
        done = [f.result(timeout=600) for f in futures]
    out = {m: {} for m in MODES}
    for (mode, kind), res in zip(jobs, done):
        if kind == "runner":
            out["runner"] = res
        else:
            out[mode].update(res)
    return (out, inp, jax_x_init(jax.random.PRNGKey(KEY), 4, (F, J, 3)), runner_params,
            jax.random.PRNGKey(RUNNER_KEY))


def _port(port, inp, x_init, name, **mode):
    t = lambda k: torch.from_numpy(inp[k])
    blk = port.STEblocks[0]
    with torch.no_grad():
        if name == "b1":
            return fused_transformer_block(t("rows"), blk, 17, HEADS, t_rows=t("t"),
                                           rows_per_item=GROUPS * 17 // 2,
                                           out_ln=port.Spatial_norm, **mode)
        if name == "b2":
            return fused_temporal_block_cols(t("cols"), port.TTEblocks[0], F, J_COLS, HEADS,
                                             t_rows=t("t_cols"), out_ln=port.Temporal_norm,
                                             **mode)
        if name == "b5":
            return fused_attention_block(t("rows"), blk, 17, HEADS, **mode)
        if name == "forward":
            return fast_forward_denoise(port, t("x"), t("time"), **mode)
        if name == "tail":
            return fast_forward_denoise(port, t("x"), t("time"), dtype=torch.bfloat16,
                                        f32_head=True, f32_tail_pairs=1, **mode)
    diffusion = make_mixed_diffusion(port, **mode, **DIFF_KW)
    step = make_eval_step(diffusion, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    return step(inp["x2d"], inp["x2d_flip"], x_init=x_init)


NAMES = ["b1", "b2", "b5", "forward", "tail", "mixed"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_modes_match_jax(pair, results, name, mode):
    """B1, B2, B5, the fused forward with and without a tail, and the mixed
    eval step at "high3" and "default" against JAX's at the same mode."""
    jax_out, inp, x_init = results[:3]
    out = _port(pair[2], inp, x_init, name, f32_prec=mode)
    highest = _port(pair[2], inp, x_init, name, f32_prec="highest")
    assert out.dtype == torch.float32
    assert_mode_matches(out.numpy(), highest.numpy(), jax_out[mode][name], mode)


@pytest.mark.parametrize("name", NAMES)
def test_the_ambient_call_is_highest(pair, name):
    """The call without ``f32_prec`` equals "highest" bit for bit, and
    "high3" and "default" move it."""
    inp, port = _inputs(), pair[2]
    x_init = torch.from_numpy(np.random.default_rng(6).standard_normal((4, F, J, 3)).astype(
        np.float32))
    ambient = _port(port, inp, x_init, name)
    assert torch.equal(_port(port, inp, x_init, name, f32_prec="highest"), ambient)
    for mode in MODES:
        assert not torch.equal(_port(port, inp, x_init, name, f32_prec=mode), ambient)


@pytest.mark.parametrize("mode", F32_MODES)
def test_contract_matches_jax_dot_f32(mode):
    """One product, ``contract`` against JAX's ``_dot_f32``: bit for bit at
    "default" (exact products of bf16 values) and "high3" up to the f32 sums'
    order; the mode moves JAX's result from "highest"."""
    rng = np.random.default_rng(3)
    a, w = rng.standard_normal((48, 96)).astype(np.float32), rng.standard_normal(
        (40, 96)).astype(np.float32)
    dims = ((1,), (1,))
    jax_out = {}
    for m in F32_MODES:
        with jax_mode(m):
            jax_out[m] = np.asarray(jax.jit(lambda x, y: jax_fb._dot_f32(x, y, dims))(a, w))
    out = contract(torch.from_numpy(a), torch.from_numpy(w), mode).numpy()
    if mode == "highest":
        np.testing.assert_allclose(out, jax_out["highest"], rtol=1e-5, atol=1e-5)
    else:
        assert_within_tenth(out, jax_out[mode], jax_out["highest"])
    with pytest.raises(ValueError, match="mode"):
        contract(torch.from_numpy(a), torch.from_numpy(w), "tf32")


def test_bf16_blocks_ignore_the_mode(pair):
    """A bf16 x contracts in one bf16 pass whatever the mode, as JAX's
    ``_dot_f32`` pins bf16 operands to it."""
    port = pair[2]
    x = torch.from_numpy(_inputs()["rows"]).bfloat16()
    with torch.no_grad():
        outs = [fused_transformer_block(x, port.STEblocks[0], 17, HEADS, f32_prec=m)
                for m in F32_MODES]
    assert all(torch.equal(o, outs[0]) for o in outs)
    with pytest.raises(ValueError, match="f32_prec"):
        fused_transformer_block(x.float(), port.STEblocks[0], 17, HEADS, f32_prec="tf32")


def test_runner_evaluate_at_default_matches_jax(results):
    """``Runner.evaluate`` with ``eval_final_prec="default"`` (mixed,
    DDIM-1) against JAX's, given JAX's x_T: the predictions under the
    "default" bar, the port's "highest" run as the reference of the mode's
    effect; the metrics to 1e-4."""
    expected, runner_params, key = results[0]["runner"], results[3], results[4]
    ds, kps = make_synthetic_h36m_like(**DATA_KW)
    preds = {}
    for prec in ("default", "highest"):
        cfg = Config(**RUNNER, eval_final_prec=prec)
        runner = Runner(cfg, J, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
        runner.set_params(runner_params)
        test_ds = PoseDataset(cfg, ds, "data", "test", keypoints_data=kps)
        subkeys, k = [], key
        for _ in test_ds.batches(cfg.batch_size_eval):
            k, sub = jax.random.split(k)
            subkeys.append(sub)
        preds[prec] = runner.evaluate(
            test_ds, action="Walking",
            x_init=lambda i: jax_x_init(subkeys[i], 2 * cfg.batch_size_eval, (F, J, 3)))
    assert_mode_matches(preds["default"]["predictions"], preds["highest"]["predictions"],
                        expected["predictions"], "default")
    for m in ("e1", "e2", "e3", "ev"):
        np.testing.assert_allclose(preds["default"][m], expected[m], rtol=1e-4, err_msg=m)


def _chip_smoke_separation():
    """chip_smoke.py's MODE_SEPARATION, the bars phase 21 holds the attention
    kernel's separation from "highest" to on the card."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.MODE_SEPARATION


def _matmul_t(a, b):
    return torch.matmul(a, b.transpose(-1, -2))


def _two_passes(a, b):
    (a_hi, a_lo), (b_hi, b_lo) = bf16_split(a), bf16_split(b)
    return _matmul_t(a_hi, b_hi) + _matmul_t(a_hi, b_lo)


_mode_dot = lambda mode: (lambda a, b: contract(a, b, mode))
_rnd = lambda a: a.bfloat16().float()
# The attention's two products (q·kᵀ, then e·vᵀ) as a faulty kernel might
# contract them under each mode.
ATTENTION_FAULTS = {
    "default": {"e not rounded": (_mode_dot("default"), lambda e, v: _matmul_t(e, _rnd(v))),
                "v not rounded": (_mode_dot("default"), lambda e, v: _matmul_t(_rnd(e), v)),
                "q, k not rounded": (_matmul_t, _mode_dot("default")),
                "ran high3": (_mode_dot("high3"), _mode_dot("high3"))},
    "high3": {"ran highest": (_matmul_t, _matmul_t),
              "e·v exact": (_mode_dot("high3"), _matmul_t),
              "q·k exact": (_matmul_t, _mode_dot("high3")),
              "two passes": (_two_passes, _two_passes),
              "ran default": (_mode_dot("default"), _mode_dot("default"))},
}


def _attention(qkv, n, heads, first, second):
    """GRAND attention on qkv [R, 3C] in groups of n rows with its two
    products contracted by ``first`` and ``second``."""
    r, c = qkv.shape[0], qkv.shape[1] // 3
    q, k, v = qkv.reshape(r // n, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    dots = iter((first, second))
    return grand_attention_stored(q, k, v, (c // heads) ** -0.5, lambda a: a, v_self=v,
                                  dot=lambda a, b: next(dots)(a, b))


@pytest.mark.parametrize("n", [17, 243])
@pytest.mark.parametrize("mode,fault", [(m, f) for m in ATTENTION_FAULTS
                                        for f in ATTENTION_FAULTS[m]])
def test_separation_bars_catch_a_wrong_mode(mode, fault, n):
    """Phase 21 holds the attention kernel's r = mean|kernel − plain at the
    mode| / mean|plain at the mode − plain at "highest"| within
    MODE_SEPARATION (chip_smoke.py). A kernel that skipped one of the
    mode's roundings, or contracted in another mode, lands outside it by
    more than 1.4 times (at least 0.40 at "default", 0.66 at "high3"):
    shown here on the plain attention at head_dim 64, n = 17 and 243."""
    bar = _chip_smoke_separation()[mode]
    gen = torch.Generator().manual_seed(n)
    qkv = torch.randn((16 if n == 17 else 2) * n, 3 * 128, generator=gen)
    plain = _attention(qkv, n, 2, _mode_dot(mode), _mode_dot(mode))
    highest = _attention(qkv, n, 2, _matmul_t, _matmul_t)
    faulty = _attention(qkv, n, 2, *ATTENTION_FAULTS[mode][fault])
    r = ((faulty - plain).abs().mean() / (plain - highest).abs().mean()).item()
    assert r >= 1.4 * bar, r


@pytest.mark.parametrize("name", ["b1", "b5"])
def test_high3_moves_with_one_rounding(pair, name):
    """Why the blocks are held to JAX at "high3" by MEAN_HIGH3 and not by
    1/10: moving each input by one float32 rounding moves the port's own
    "high3" block by more than 1/10 of the mode's effect (a lo half rounds
    the other way where its operand moved), while it moves the "highest"
    block by far less. Two packages whose float32 arithmetic before a split
    differs by a rounding can therefore not agree at "high3" to 1/10 of its
    effect; the bar, 0.6, is about twice this floor (measured: 0.30 for B1,
    0.31 for B5)."""
    port = pair[2]
    x = torch.from_numpy(_inputs()["rows"])
    up = np.random.default_rng(8).random(x.shape) < 0.5
    x_moved = torch.from_numpy(np.nextafter(x.numpy(), np.where(up, np.float32(np.inf),
                                                                np.float32(-np.inf))))
    assert (x_moved != x).all()
    inp = _inputs()
    out = {}
    for prec in ("high3", "highest"):
        for key, rows in (("x", x), ("moved", x_moved)):
            out[prec, key] = _port(port, dict(inp, rows=rows.numpy()), None, name,
                                   f32_prec=prec)
    effect = (out["high3", "x"] - out["highest", "x"]).abs().mean()
    floor = ((out["high3", "x"] - out["high3", "moved"]).abs().mean() / effect).item()
    highest_moves = ((out["highest", "x"] - out["highest", "moved"]).abs().mean()
                     / effect).item()
    assert floor > TENTH and highest_moves < TENTH, (floor, highest_moves)
