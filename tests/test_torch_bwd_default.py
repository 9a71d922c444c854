"""B4 at float32 under the session precision "default" (ROADMAP A.14): the
rounding-point identity its kernel rests on, against the port's plain
version and JAX's B4 on the CPU (Pallas in interpret mode), and the
three-pass GEMM of the contraction mode "high3" summed as its kernel sums
it, against JAX's ``_dot_f32_3pass``.

On the card, B4 under "default" rounds q, k, v and dO to bf16 once and runs
the bfloat16 backward's two tensor-core passes with float32 outputs. That
is "default" term for term: every product takes bf16-rounded operands and
sums in float32; S, dP, P and D = Σ dP∘P stay float32; dS and P are rounded
only as the operands of their products; dq and dk leave unrounded; dv's
"− dO" takes the unrounded dO (JAX's tile: ``dot(pq, do) − dof``,
diff3dhpe_tpu/ops/attention.py:298). ``composition`` writes that model
out with float32 sums, and the tests hold it against
``grand_attention_bwd_ref(..., matmul_precision="default")`` (the same
arithmetic: float32 bars) and against JAX's ``grand_attention_bwd_pallas``
with ``dot_general`` given the MXU's one bf16 pass
(``test_torch_matmul_precision.jax_session``; no file of the JAX package
changes), at that file's bar for B4, whose results are products of
products: mean |port − JAX| within 1/10 of JAX's own default-vs-highest
distance, and the port's own effect JAX's to 10%. The oracle the card's
checks hold B4's max against, the plain formulas with S and dP summed
exactly (``utils.mode_attn_profile.b4_default_exact``), is held against
the plain version at the "default" mean bar.

The f32-output GEMM's three passes sum A_hi·W_hi in one set of
accumulators and A_hi·W_lo + A_lo·W_hi in a second, added once:
``_gemm_wgmma_f32_ref`` sums them in that order, held against JAX's
``_dot_f32`` at "high3" at ``test_torch_contract_modes.py``'s bar for one
product (1/10 of JAX's own high3-vs-highest distance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diff3dhpe_tpu.ops.fused_block as jax_fb
from diff3dhpe_torch.ops.attention import grand_attention_bwd_ref
from diff3dhpe_torch.ops.fused_block import _gemm_wgmma_f32_ref, split_bf16_ref
from diff3dhpe_torch.utils.mode_attn_profile import b4_default_exact
from diff3dhpe_tpu.ops.attention import grand_attention_bwd_pallas
from test_torch_contract_modes import F32_MODES, assert_within_tenth, jax_mode
from test_torch_matmul_precision import assert_default_matches, jax_session
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

G = 3
CASES = [(n, d) for n in (17, 65, 243) for d in (64, 128)]


def composition(q, k, v, do, scale=None):
    """(dq, dk, dv) of B4 under "default" as its kernels form them: q, k, v
    and do rounded to bf16 once, then the bfloat16 backward's formulas with
    float32 sums, outputs left in float32, dv's "− do" on the float32
    do."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    rnd = lambda t: t.to(torch.bfloat16).float()
    qb, kb, vb, gb = (rnd(t) for t in (q, k, v, do))
    p = torch.softmax(qb @ kb.transpose(-1, -2) * scale, dim=-1)
    dp = gb @ vb.transpose(-1, -2)
    dsum = (dp * p).sum(dim=-1, keepdim=True)
    ds = rnd(p * (dp - dsum) * scale)
    return ds @ kb, ds.transpose(-1, -2) @ qb, rnd(p).transpose(-1, -2) @ gb - do


def _inputs(n, d):
    rng = np.random.default_rng(7 * n + d)
    return [rng.standard_normal((G, n, d)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("n,d", CASES)
def test_composition_is_the_plain_version_at_default(n, d):
    """The composition and B4's plain version at "default" do the same
    arithmetic: equal to float32 rounding, and both apart from "highest"."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(n, d))
    got = composition(q, k, v, do)
    want = grand_attention_bwd_ref(q, k, v, do, matmul_precision="default")
    highest = grand_attention_bwd_ref(q, k, v, do)
    for a, b, h in zip(got, want, highest):
        assert a.dtype == torch.float32
        scale = b.abs().max()
        assert (a - b).abs().max() <= 1e-6 * scale, ((a - b).abs().max(), scale)
        assert (b - h).abs().max() > 1e-4 * scale


@pytest.mark.parametrize("n,d", CASES)
def test_exact_sum_oracle_is_the_plain_version_but_for_the_sums(n, d):
    """``b4_default_exact`` (S and dP summed exactly, the oracle that phase
    21b of chip_smoke.py holds B4's max against) and the plain version at
    "default" take the same rounding points: they part only where the
    plain version's float32 sums of S and dP turn a bf16 rounding, within
    the "default" mean bar (2.5e-5 of max|plain|) and r <= 0.1 from
    "highest"; the oracle's S and dP are float32 roundings of float64 sums
    of the bf16 products."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(n, d))
    got = b4_default_exact(q, k, v, do)
    want = grand_attention_bwd_ref(q, k, v, do, matmul_precision="default")
    highest = grand_attention_bwd_ref(q, k, v, do)
    for a, b, h in zip(got, want, highest):
        assert a.dtype == torch.float32
        diff, scale = (a - b).abs(), b.abs().max()
        assert diff.mean() <= 2.5e-5 * scale, (diff.mean(), scale)
        assert diff.mean() <= 0.1 * (b - h).abs().mean()


@pytest.fixture(scope="module")
def jax_b4():
    """{(n, d): {precision: JAX's (dq, dk, dv) stacked}} of B4's Pallas
    kernel in interpret mode, "default" with the MXU's one bf16 pass."""
    out = {}
    for n, d in CASES:
        arrays = [jnp.asarray(a) for a in _inputs(n, d)]
        out[n, d] = {}
        for precision in ("default", "highest"):
            with jax_session(precision):
                out[n, d][precision] = np.asarray(jnp.stack(
                    grand_attention_bwd_pallas(*arrays, interpret=True)), np.float32)
    return out


@pytest.mark.parametrize("n,d", CASES)
def test_composition_matches_jax_b4_at_one_pass(jax_b4, n, d):
    """The composition against JAX's B4 (``_grand_attn_bwd_tile`` at
    precision None) with the MXU's one pass, for dq, dk and dv each, at
    ``test_torch_matmul_precision.py``'s bars for B4 (the port's "highest"
    is its plain version's)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(n, d))
    got = composition(q, k, v, do)
    highest = grand_attention_bwd_ref(q, k, v, do)
    for i, (a, h) in enumerate(zip(got, highest)):
        assert_default_matches(a.numpy(), h.numpy(), jax_b4[n, d]["default"][i],
                               jax_b4[n, d]["highest"][i])


@pytest.mark.parametrize("m,n,k", [(48, 40, 96), (130, 24, 512)])
def test_three_pass_gemm_matches_jax_dot_f32_3pass(m, n, k):
    """``_gemm_wgmma_f32_ref`` at three passes on split operands, hh + (hl +
    lh), against JAX's ``_dot_f32`` at "high3" on the f32 operands; at one
    pass against JAX's at "default"."""
    rng = np.random.default_rng(m + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)
    jax_out = {}
    for mode in F32_MODES:
        with jax_mode(mode):
            jax_out[mode] = np.asarray(
                jax.jit(lambda x, y: jax_fb._dot_f32(x, y, ((1,), (1,))))(a, w))
    (a_hi, a_lo), (w_hi, w_lo) = split_bf16_ref(torch.from_numpy(a)), split_bf16_ref(
        torch.from_numpy(w))
    three = _gemm_wgmma_f32_ref(a_hi, a_lo, w_hi, w_lo).numpy()
    assert_within_tenth(three, jax_out["high3"], jax_out["highest"])
    one = _gemm_wgmma_f32_ref(a_hi, None, w_hi, None).numpy()
    assert_within_tenth(one, jax_out["default"], jax_out["highest"])
