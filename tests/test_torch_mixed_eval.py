"""The bf16 path of the port and the shipped "mixed" eval (bench.py:101-135:
a bf16 trunk with an f32 head for the DDIM steps, the f32 fast forward for
the last one) against the JAX package on the CPU, Pallas in interpret mode:

- B1's plain version at bf16 against JAX ``fused_transformer_block`` on a
  bf16 x (the bf16 bars: the two round at the same points);
- the bf16 fast forward, with and without ``f32_head``, in both layouts;
- the DDIM update's promotion of a bf16 x0 estimate;
- the mixed eval step against JAX's, whose final step runs at
  ``f32_prec="high3"``: both are held against the flax f32 eval;
- the port's f32 final step against JAX's high3 and exact-f32 forwards.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch import (
    GaussianDiffusion, bf16_snapshot, fast_forward_denoise, fused_transformer_block,
    fused_transformer_block_ref, make_eval_step, make_fast_denoise_fn, make_mixed_diffusion,
)
from diff3dhpe_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diff3dhpe_tpu.engine import make_denoise_fn as jax_make_denoise_fn
from diff3dhpe_tpu.engine import make_eval_step as jax_make_eval_step
from diff3dhpe_tpu.engine.steps import flip_pose_jnp
from diff3dhpe_tpu.engine.steps import make_fast_denoise_fn as jax_make_fast_denoise_fn
from diff3dhpe_tpu.models.fast_eval import fast_forward_denoise as jax_fast_forward
from diff3dhpe_tpu.ops.fused_block import fused_transformer_block as jax_fused_block
from torch_port_helpers import (
    JOINTS_LEFT, JOINTS_RIGHT, assert_bf16_bars, build_pair, jax_x_init,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

F, C, HEADS, DEPTH = 9, 32, 4, 1
FAST_KW = dict(num_frame=F, num_joints=17, depth=DEPTH, num_heads=HEADS)
DIFF_KW = dict(timesteps=50, sampling_timesteps=3, clip_denoised=True, beta_schedule="cosine")


@pytest.fixture(scope="module")
def pair():
    """(flax model, numpy params, port model) at F = 9, embed 32, depth 1."""
    return build_pair(np.random.default_rng(1), num_frame=F, embed_dim=C, depth=DEPTH,
                      num_heads=HEADS)


@pytest.mark.parametrize("n,n_pad,with_t,with_out_ln,with_dp", [
    (17, None, True, True, False), (27, 32, True, True, True), (9, None, False, False, False),
])
def test_bf16_block_ref_matches_jax(rng, pair, n, n_pad, with_t, with_out_ln, with_dp):
    _, params, port = pair
    groups, items = 6, 2
    r = groups * (n_pad or n)
    x = jnp.asarray(rng.standard_normal((r, C)).astype(np.float32)).astype(jnp.bfloat16)
    t = rng.standard_normal((items, C)).astype(np.float32) if with_t else None
    dp = ((rng.random((r, 2)) < 0.6) / 0.6).astype(np.float32) if with_dp else None
    expected = jax.jit(lambda a: jax_fused_block(
        a, params["ste_block_0"], n=n, heads=HEADS, interpret=True, pre_padded_n8=n_pad,
        out_ln_params=params["spatial_norm"] if with_out_ln else None,
        t_rows=None if t is None else jnp.asarray(t), rows_per_item=r // items if with_t else None,
        dp_scales=None if dp is None else jnp.asarray(dp)))(x)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    kw = dict(n_pad=n_pad, t_rows=None if t is None else torch.from_numpy(t),
              rows_per_item=r // items if with_t else None,
              out_ln=port.Spatial_norm if with_out_ln else None,
              dp_scales=None if dp is None else torch.from_numpy(dp))
    with torch.no_grad():
        ref = fused_transformer_block_ref(xt, port.STEblocks[0], n, HEADS, **kw)
        out = fused_transformer_block(xt, port.STEblocks[0], n, HEADS, **kw)
        f32 = fused_transformer_block_ref(xt.float(), port.STEblocks[0], n, HEADS, **kw)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, rtol=0, atol=0)  # a CPU tensor takes the plain version
    real = lambda a: np.asarray(a, np.float32).reshape(groups, n_pad or n, C)[:, :n]
    assert_bf16_bars(real(ref.float().numpy()), real(expected.astype(jnp.float32)))
    # The bf16 path does round: it is not the f32 block stored in bf16.
    assert not torch.equal(ref, f32.bfloat16())


def _forward_kw(name):
    """JAX fast_forward_denoise's settings for a forward of the tests below:
    "bf16-<f32_head>-<layout>" or "f32-<f32_prec>-<layout>"."""
    dt, opt, mode = name.split("-")
    if dt == "bf16":
        return dict(dtype=jnp.bfloat16, f32_head=opt == "True", temporal_mode=mode)
    return dict(dtype=jnp.float32, f32_prec=opt, temporal_mode=mode)


FORWARDS = [f"bf16-{h}-{m}" for h in (False, True) for m in ("rows", "cols")] + [
    f"f32-{p}-{m}" for p in ("highest", "high3") for m in ("rows", "cols")]


@pytest.fixture(scope="module")
def forward_inputs(pair):
    """(x, t, the flax f32 output, {name: JAX's fast forward}) for the
    forward tests, the JAX side from one jitted build (each forward is its
    own graph in it)."""
    model, params, _ = pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, F, 17, 5)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    xj, tj = jnp.asarray(x), jnp.asarray(t)
    flax, fast = jax.jit(lambda p: (model.apply({"params": p}, xj, tj), {
        name: jax_fast_forward(p, xj, tj, interpret=True, **_forward_kw(name), **FAST_KW)
        for name in FORWARDS}))(params)
    return x, t, np.asarray(flax), fast


@pytest.mark.parametrize("f32_head,temporal_mode", [
    (False, "rows"), (True, "rows"), (False, "cols"), (True, "cols"),
])
def test_bf16_forward_matches_jax(pair, forward_inputs, f32_head, temporal_mode):
    """The bf16 fast forward against JAX's at the same settings (within
    2e-2 of max|jax|), and no further from the flax f32 output than 1.5x
    JAX bf16's own deviation."""
    _, _, port = pair
    x, t, flax, fast = forward_inputs
    expected = fast[f"bf16-{f32_head}-{temporal_mode}"]
    out = fast_forward_denoise(port, torch.from_numpy(x), torch.from_numpy(t),
                               dtype=torch.bfloat16, temporal_mode=temporal_mode,
                               f32_head=f32_head)
    want_dtype = torch.float32 if f32_head else torch.bfloat16
    assert out.dtype == want_dtype and str(expected.dtype) == str(want_dtype).split(".")[1]
    expected = np.asarray(expected.astype(jnp.float32))
    out = out.float().numpy()
    assert np.abs(out - expected).max() <= 2e-2 * np.abs(expected).max()
    assert np.abs(out - flax).max() <= 1.5 * np.abs(expected - flax).max()
    # The snapshot the bf16 denoise_fn holds gives the same forward.
    snap = bf16_snapshot(port, f32_head)
    again = fast_forward_denoise(snap, torch.from_numpy(x), torch.from_numpy(t),
                                 dtype=torch.bfloat16, temporal_mode=temporal_mode,
                                 f32_head=f32_head)
    np.testing.assert_array_equal(again.float().numpy(), out)


def test_bf16_snapshot_is_taken_once(pair):
    _, _, port = pair
    fn = make_fast_denoise_fn(port, torch.bfloat16)
    live = make_fast_denoise_fn(port)
    x, t = torch.randn(1, F, 17, 5, generator=torch.Generator().manual_seed(0)), torch.ones(1)
    before, before_live = fn(x, t), live(x, t)
    assert before.dtype == torch.bfloat16 and before_live.dtype == torch.float32
    with torch.no_grad():
        port.head[1].bias.add_(1.0)
    try:
        torch.testing.assert_close(fn(x, t), before, rtol=0, atol=0)  # the snapshot
        assert (live(x, t) - before_live).abs().min() > 0.5           # the live weights
    finally:
        with torch.no_grad():
            port.head[1].bias.sub_(1.0)
    snap = bf16_snapshot(port)
    assert snap.STEblocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert snap.STEblocks[0].attn.qkv.bias.dtype == torch.float32
    assert snap.STEblocks[0].norm1.weight.dtype == torch.float32
    assert snap.time_mlp[1].bias.dtype == torch.bfloat16
    assert bf16_snapshot(port, f32_head=True).head[1].weight.dtype == torch.float32


def test_ddim_promotes_a_bf16_estimate_as_jax_does(rng):
    """A denoiser that returns bf16: the sampler's state stays float32 and
    takes the estimate exactly, as JAX's float32 step tables promote it."""
    x_cond = rng.standard_normal((2, F, 17, 2)).astype(np.float32)
    x_init = rng.standard_normal((2, F, 17, 3)).astype(np.float32)
    kw = dict(timesteps=50, sampling_timesteps=4, clip_denoised=True, beta_schedule="cosine")

    def jax_fn(params, x, t, key):
        return (0.9 * x[..., 2:] + 1e-3 * t[:, None, None, None]).astype(jnp.bfloat16)

    def torch_fn(x, t):
        return (0.9 * x[..., 2:] + 1e-3 * t[:, None, None, None]).bfloat16()

    expected = JaxDiffusion.create(jax_fn, **kw).ddim_sample_loop(
        None, jax.random.PRNGKey(0), jnp.asarray(x_cond), x_init.shape, x_init=jnp.asarray(x_init))
    out = GaussianDiffusion.create(torch_fn, **kw).ddim_sample_loop(
        torch.from_numpy(x_cond), x_init.shape, x_init=torch.from_numpy(x_init))
    assert out.dtype == torch.float32 and expected.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), rtol=1e-6, atol=1e-6)


def _jax_mixed_diffusion(temporal_mode):
    """JAX's mixed eval wired exactly as bench.py wires it: a bf16 trunk
    with an f32 head, and the f32 fast forward at f32_prec="high3" for the
    final step."""
    jd = JaxDiffusion.create(jax_make_fast_denoise_fn(
        dtype=jnp.bfloat16, f32_head=True, temporal_mode=temporal_mode, **FAST_KW), **DIFF_KW)
    return dataclasses.replace(jd, final_denoise_fn=jax_make_fast_denoise_fn(
        dtype=jnp.float32, f32_prec="high3", temporal_mode=temporal_mode, **FAST_KW),
        final_denoise_steps=1)


@pytest.fixture(scope="module")
def eval_inputs(pair):
    """(x2d, x2d_flip, key, x_init, the flax f32 eval, {name: JAX's eval})
    for the eval tests: JAX's mixed eval in both layouts ("mixed-rows",
    "mixed-cols") and its pure-bf16 eval ("bf16"), all four JAX evals from
    one jitted build."""
    model, params, _ = pair
    rng = np.random.default_rng(4)
    x2d = rng.uniform(-1, 1, (2, F, 17, 2)).astype(np.float32)
    x2d_flip = np.array(flip_pose_jnp(jnp.asarray(x2d), JOINTS_LEFT, JOINTS_RIGHT))
    key = jax.random.PRNGKey(7)
    diffusions = {
        "f32": JaxDiffusion.create(jax_make_denoise_fn(model), **DIFF_KW),
        "mixed-rows": _jax_mixed_diffusion("rows"), "mixed-cols": _jax_mixed_diffusion("cols"),
        "bf16": JaxDiffusion.create(jax_make_fast_denoise_fn(dtype=jnp.bfloat16, **FAST_KW),
                                    **DIFF_KW),
    }
    steps = {name: jax_make_eval_step(d, JOINTS_LEFT, JOINTS_RIGHT)
             for name, d in diffusions.items()}
    evals = jax.jit(lambda p, k, a, b: {name: s(p, k, a, b) for name, s in steps.items()})(
        params, key, jnp.asarray(x2d), jnp.asarray(x2d_flip))
    evals = {name: np.asarray(e) for name, e in evals.items()}
    return x2d, x2d_flip, key, jax_x_init(key, 4, (F, 17, 3)), evals.pop("f32"), evals


@pytest.mark.parametrize("temporal_mode", ["rows", "cols"])
def test_mixed_eval_matches_jax(pair, eval_inputs, temporal_mode):
    """The mixed eval step, wired in JAX exactly as bench.py wires it, and
    in the port by ``make_mixed_diffusion``, on the same x_T: the port's
    deviation from the flax f32 eval is at most 1.5x JAX's + 1e-4. (At
    these sizes the two differ by about 4e-3 to 6e-3, from the bf16 trunk
    steps; the final steps alone differ by ~8e-6: test below.)"""
    _, _, port = pair
    x2d, x2d_flip, key, x_init, ref, evals = eval_inputs
    expected = evals[f"mixed-{temporal_mode}"]
    step = make_eval_step(make_mixed_diffusion(port, temporal_mode, **DIFF_KW),
                          JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
    out = step(x2d, x2d_flip, x_init=x_init)
    assert out.dtype == torch.float32 and out.shape == expected.shape
    dev_port, dev_jax = np.abs(out.numpy() - ref).max(), np.abs(expected - ref).max()
    assert dev_port <= 1.5 * dev_jax + 1e-4, (dev_port, dev_jax)


def test_bf16_eval_matches_jax(pair, eval_inputs):
    """Pure bf16 (bench.py's opt-in "bfloat16": a bf16 output rounded to
    bf16 before every DDIM update), held like the mixed eval; and the
    mixed eval is closer to the f32 eval than it."""
    _, _, port = pair
    x2d, x2d_flip, key, x_init, ref, evals = eval_inputs
    expected = evals["bf16"]
    bf16 = make_eval_step(GaussianDiffusion.create(make_fast_denoise_fn(port, torch.bfloat16),
                                                   **DIFF_KW), JOINTS_LEFT, JOINTS_RIGHT,
                          device="cpu")
    out = bf16(x2d, x2d_flip, x_init=x_init).numpy()
    dev_port, dev_jax = np.abs(out - ref).max(), np.abs(expected - ref).max()
    assert dev_port <= 1.5 * dev_jax + 1e-4, (dev_port, dev_jax)
    mixed = make_eval_step(make_mixed_diffusion(port, **DIFF_KW), JOINTS_LEFT, JOINTS_RIGHT,
                           device="cpu")
    assert np.abs(mixed(x2d, x2d_flip, x_init=x_init).numpy() - ref).max() <= dev_port


@pytest.mark.parametrize("temporal_mode", ["rows", "cols"])
def test_f32_final_step_against_high3(pair, forward_inputs, temporal_mode):
    """The mixed final step: the port's f32 forward contracts in full
    float32, JAX's under "high3" (bf16x3, a TPU workaround). The port is
    within the f32 bar of JAX's exact-f32 forward ("highest"), and within
    1e-5 of max|out| of JAX high3 (measured: 4.5e-6 at these sizes)."""
    _, _, port = pair
    x, t, _, fast = forward_inputs
    out = fast_forward_denoise(port, torch.from_numpy(x), torch.from_numpy(t),
                               temporal_mode=temporal_mode).numpy()
    for prec, bound in (("highest", None), ("high3", 1e-5)):
        expected = np.asarray(fast[f"f32-{prec}-{temporal_mode}"])
        if bound is None:
            np.testing.assert_allclose(out, expected, rtol=2e-4, atol=2e-5)
        else:
            assert np.abs(out - expected).max() <= bound * np.abs(expected).max()
