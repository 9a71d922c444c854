"""The mixed eval's float32 precision tail (JAX ``fast_forward_denoise(
f32_tail_pairs=k)``, models/fast_eval.py:128-133, :210-215; the runner's
``eval_f32_tail_pairs``, engine/runner.py:147-169) against the JAX package
on the CPU, Pallas in interpret mode, at embed 32, depth 2, 9 frames.

JAX runs the tail under ``f32_prec`` ("high3" for the runner's default
``eval_final_prec``); the port's float32 kernels contract in exact float32
for "high3" and "highest" alike (ROADMAP C.2), so its tail is held against
JAX's at both. JAX's programs are compiled with XLA's excess precision off
(``tests/test_torch_bf16_train.py``), so that every value JAX types bf16 is
rounded to bf16 as the port rounds it. The bars:

- k = 1 (a bf16 pair, then a float32 pair and head): the bf16 bars, max
  |port - jax| <= 1e-2 and mean <= 1e-3 of max|jax| (``assert_bf16_bars``);
- k = 2 = depth (only the fusion layer and the position embedding at
  bf16): every block pair's output against JAX's at the float32 bars,
  rtol 2e-4 and atol 2e-5, and the forward at the bf16 bars, since its
  input went through the same bf16 fusion layer;
- ``Runner`` with ``eval_f32_tail_pairs`` against JAX's ``Runner.evaluate``
  on the same weights and x_T, at the bars of tests/test_torch_runner.py's
  mixed runs, and the refusals, each naming its field.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diff3dhpe_torch.models.fast_eval as port_fast_eval
import diff3dhpe_tpu.models.fast_eval as jax_fast_eval
from diff3dhpe_torch import fast_forward_denoise, make_fast_denoise_fn
from diff3dhpe_torch.config import Config
from diff3dhpe_torch.data import PoseDataset, make_synthetic_h36m_like
from diff3dhpe_torch.engine.runner import Runner, check_supported
from diff3dhpe_tpu.config import Config as JaxConfig
from diff3dhpe_tpu.data import PoseDataset as JaxPoseDataset
from diff3dhpe_tpu.data import make_synthetic_h36m_like as jax_synthetic
from diff3dhpe_tpu.engine.runner import Runner as JaxRunner
from torch_port_helpers import (
    JOINTS_LEFT, JOINTS_RIGHT, assert_bf16_bars, build_pair, jax_x_init, perturb,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

F, C, HEADS, DEPTH = 9, 32, 4, 2
F8 = 16  # JAX pads the frames to a multiple of 8
FAST_KW = dict(num_frame=F, num_joints=17, depth=DEPTH, num_heads=HEADS)
# (tail pairs, layout, JAX's f32_prec): the runner's default "high3" at
# k = 1, and at k = depth the exact-f32 "highest" whose pairs the float32
# bars hold.
CASES = [(1, "rows", "high3"), (1, "cols", "high3"), (2, "rows", "highest"),
         (2, "cols", "highest")]


def _strict_lowered(lowered):
    """A lowered program compiled with XLA's excess precision off (module
    doc)."""
    return lowered.compile(compiler_options={"xla_allow_excess_precision": False})


@pytest.fixture(scope="module")
def pair():
    return build_pair(np.random.default_rng(11), num_frame=F, embed_dim=C, depth=DEPTH,
                      num_heads=HEADS)


@pytest.fixture(scope="module")
def jax_runs(pair):
    """(x, t, {(k, mode, prec): (JAX's tail forward, [each block pair's
    output as [B, F, J, C]])}), one strict program a case, traced in turn
    and compiled together in threads (XLA's compiles overlap). The pair
    outputs are the temporal block calls', read through a recording wrapper
    of the JAX module's block functions (nothing in the JAX package
    changes)."""
    from concurrent.futures import ThreadPoolExecutor

    _, params, _ = pair
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, F, 17, 5)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    b = x.shape[0]
    recorded = []
    rows_fn, cols_fn = jax_fast_eval.fused_transformer_block, jax_fast_eval.fused_temporal_block_cols

    def rows_rec(x_rows, *a, **kw):
        out = rows_fn(x_rows, *a, **kw)
        recorded.append(("rows", kw.get("n"), out))
        return out

    def cols_rec(x_cols, *a, **kw):
        out = cols_fn(x_cols, *a, **kw)
        recorded.append(("cols", kw.get("n"), out))
        return out

    def pair_outputs(calls):
        outs = []
        for kind, n, out in calls:
            if n != F:  # a spatial call
                continue
            if kind == "rows":  # [B*J*F8, C] frame-contiguous
                outs.append(out.reshape(b, 17, F8, C)[:, :, :F].transpose(0, 2, 1, 3))
            else:  # [B*F8, J*C]
                outs.append(out.reshape(b, F8, 17, C)[:, :F])
        return outs

    def case(k, mode, prec):
        def run(p, xj, tj):
            recorded.clear()
            y = jax_fast_eval.fast_forward_denoise(
                p, xj, tj, interpret=True, dtype=jnp.bfloat16, f32_head=True, f32_prec=prec,
                f32_tail_pairs=k, temporal_mode=mode, **FAST_KW)
            return y, pair_outputs(list(recorded))
        return run

    args = (params, jnp.asarray(x), jnp.asarray(t))
    jax_fast_eval.fused_transformer_block = rows_rec
    jax_fast_eval.fused_temporal_block_cols = cols_rec
    try:
        lowered = [jax.jit(case(*c)).lower(*args) for c in CASES]
    finally:
        jax_fast_eval.fused_transformer_block = rows_fn
        jax_fast_eval.fused_temporal_block_cols = cols_fn
    with ThreadPoolExecutor(len(CASES)) as pool:
        compiled = list(pool.map(_strict_lowered, lowered))
    return x, t, {c: fn(*args) for c, fn in zip(CASES, compiled)}


@pytest.mark.parametrize("k,mode,prec", CASES)
def test_tail_forward_matches_jax(pair, jax_runs, k, mode, prec):
    """The denoiser the mixed mode's final step calls
    (``make_fast_denoise_fn(bf16, f32_head=True, f32_tail_pairs=k)``: the
    trunk's first pairs on the bf16 snapshot, the tail on the float32
    weights) against JAX's, at the bf16 bars; float32 out."""
    _, _, port = pair
    x, t, got = jax_runs
    expected, _ = got[(k, mode, prec)]
    fn = make_fast_denoise_fn(port, torch.bfloat16, mode, f32_head=True, f32_tail_pairs=k)
    out = fn(torch.from_numpy(x), torch.from_numpy(t))
    assert out.dtype == torch.float32 and str(expected.dtype) == "float32"
    assert_bf16_bars(out.numpy(), expected)
    # The tail changes the forward: it is neither the bf16 one nor the f32 one.
    bf16 = fast_forward_denoise(port, torch.from_numpy(x), torch.from_numpy(t),
                                dtype=torch.bfloat16, temporal_mode=mode, f32_head=True)
    f32 = fast_forward_denoise(port, torch.from_numpy(x), torch.from_numpy(t),
                               temporal_mode=mode)
    assert not torch.equal(out, bf16) and not torch.equal(out, f32)


@pytest.mark.parametrize("mode", ["rows", "cols"])
def test_full_tail_pairs_match_jax_at_f32_bars(pair, jax_runs, mode, monkeypatch):
    """k = depth: only the fusion layer and the spatial position embedding
    ran at bf16, so every block pair's output equals JAX's exact-f32 tail
    ("highest") at the float32 bars, and the forward matches at the bf16
    bars. (JAX's "high3" is a three-pass bf16 product, not exact f32: its
    pairs part from the exact ones by up to ~2e-5, which C.2 and A.11
    leave to the port's own three-pass mode.)"""
    prec = "highest"
    _, _, port = pair
    x, t, got = jax_runs
    expected, jax_pairs = got[(DEPTH, mode, prec)]
    outs = []
    fused_pair = port_fast_eval._fused_pair

    def recording(*a, **kw):
        out = fused_pair(*a, **kw)
        outs.append(out)
        return out

    monkeypatch.setattr(port_fast_eval, "_fused_pair", recording)
    y = make_fast_denoise_fn(port, torch.bfloat16, mode, f32_head=True, f32_tail_pairs=DEPTH)(
        torch.from_numpy(x), torch.from_numpy(t))
    assert len(outs) == len(jax_pairs) == DEPTH
    for mine, theirs in zip(outs, jax_pairs):
        assert mine.dtype == torch.float32
        np.testing.assert_allclose(mine.numpy().reshape(2, F, 17, C), np.asarray(theirs),
                                   rtol=2e-4, atol=2e-5)
    assert_bf16_bars(y.numpy(), expected)


BASE = dict(subjects_train="S1", subjects_test="S9", number_of_frames=F, stride=F, embed_dim=C,
            transformer_depth=DEPTH, num_heads=HEADS, timesteps=50, sampling_timesteps=3,
            batch_size_eval=4, actions="*", mesh_shape="data:1", seed=5, fast_eval=True,
            compute_dtype="bfloat16", eval_f32_final_steps=1, eval_f32_head=True)


@pytest.mark.parametrize("tail", [1])
def test_runner_with_a_tail_matches_jax(tail):
    """``Runner.evaluate`` with ``eval_f32_tail_pairs`` against JAX's on the
    same perturbed weights and x_T (JAX's per-batch key draws, replayed):
    the report's errors at the mixed runs' bar of tests/test_torch_runner.py
    (rtol 2e-3, atol 1e-3 mm: the bf16 steps round in another order in the
    two packages, and over the DDIM steps the predictions part by ~2e-3 of
    their range on average, as the mixed runs' do)."""
    kw = {**BASE, "eval_f32_tail_pairs": tail}
    cfg, jax_cfg = Config(**kw), JaxConfig(**kw)
    ds, kps = make_synthetic_h36m_like(subjects=("S1", "S9"), n_frames=100, seed=1)
    jds, jkps = jax_synthetic(subjects=("S1", "S9"), n_frames=100, seed=1)
    test_ds = PoseDataset(cfg, ds, "data", "test", keypoints_data=kps)
    jax_test = JaxPoseDataset(jax_cfg, jds, "data", "test", keypoints_data=jkps)
    jax_runner = JaxRunner(jax_cfg, 17, JOINTS_LEFT, JOINTS_RIGHT)
    x = jnp.zeros((1, F, 17, 5))
    params = jax.jit(jax_runner.model.init)(jax.random.PRNGKey(cfg.seed), x, jnp.zeros((1,)))
    params = perturb(jax.tree.map(np.asarray, params["params"]), np.random.default_rng(2))
    jax_runner.set_params(params)
    runner = Runner(cfg, 17, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    runner.set_params(params)
    key = jax.random.PRNGKey(11)
    expected = jax_runner.evaluate(jax_test, action="Walking", key=key)

    rows = 2 * cfg.batch_size_eval
    subkeys = []
    for _ in test_ds.batches(cfg.batch_size_eval):
        key, sub = jax.random.split(key)
        subkeys.append(sub)
    out = runner.evaluate(test_ds, action="Walking",
                          x_init=lambda i: jax_x_init(subkeys[i], rows, (F, 17, 3)))
    assert out["predictions"].shape == expected["predictions"].shape
    for k in ("e1", "e2", "e3", "ev"):
        np.testing.assert_allclose(out[k], expected[k], rtol=2e-3, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("overrides,field", [
    (dict(eval_f32_tail_pairs=1, fast_eval=False), "eval_f32_tail_pairs"),
    (dict(eval_f32_tail_pairs=1, compute_dtype="float32"), "eval_f32_tail_pairs"),
    (dict(eval_f32_tail_pairs=1, eval_f32_final_steps=0), "eval_f32_tail_pairs"),
])
def test_tail_refusals_name_the_field(overrides, field):
    cfg = Config(**{**BASE, **overrides})
    with pytest.raises(ValueError, match=f"^{field}="):
        check_supported(cfg)
    with pytest.raises(ValueError, match=f"^{field}="):
        Runner(cfg, 17, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")


def test_tail_refuses_drop_path(pair):
    """JAX's assert (fast_eval.py:130-132): the tail is an eval feature."""
    _, _, port = pair
    dp = (torch.ones(DEPTH, 1, F, 2), torch.ones(DEPTH, 1, 17, 2))
    with pytest.raises(ValueError, match="f32_tail_pairs"):
        fast_forward_denoise(port, torch.zeros(1, F, 17, 5), torch.ones(1), dp,
                             dtype=torch.bfloat16, f32_tail_pairs=1)
