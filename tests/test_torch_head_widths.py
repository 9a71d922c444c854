"""Head widths other than 64 and 128 (JAX's ``--num-heads``: the fused
kernels are head-count-parametric, tests/test_fast_eval.py:76-99) through
the port on the CPU, against the JAX package, at head_dim 16, 24 and 32
(embed 48 with 3 and 2 heads, embed 64 with 2), depth 1, 9 frames:

- B1's plain version at f32 and bf16 against JAX ``fused_transformer_block``
  in interpret mode (the tests/test_torch_fused_block.py bar, rtol 2e-4 and
  atol 2e-5; the bf16 bars of ``torch_port_helpers.assert_bf16_bars``);
- B3 at bf16 against ``grand_attention_pallas_3d`` (the bf16 bars, as
  tests/test_torch_bf16_attention.py);
- the fused forward at f32 ("highest"), at bf16 and at the contraction mode
  "high3" against JAX's ``fast_forward_denoise(interpret=True)`` at the
  same settings (f32: tests/test_torch_fast_eval.py's bar; bf16:
  tests/test_torch_mixed_eval.py's, 2e-2 of max|jax| and no further from
  the flax f32 output than 1.5x JAX bf16's own deviation; "high3":
  tests/test_torch_contract_modes.py's, mean |port − jax| within 0.6 of
  JAX's own high3-vs-highest mean, and the port's own effect JAX's to 10%);
- the ``use_pallas`` denoiser against the flax one (1e-4 absolute, as
  tests/test_torch_attention_hd128.py).

On the CPU every wrapper runs its plain version, which takes every width;
the CUDA kernels are held against those plain versions at head_dim 32 and
96 by chip_smoke.py (phase 24) and tests/test_torch_cuda_kernels.py. Also
what ``check_supported`` and ``check_trainable`` accept and refuse on a
CUDA device by head width and by frame count (ROADMAP C.17): decided from
the device's type, no card needed. Each width's JAX programs are one
jitted call, the three built in threads (module fixture ``jax_outputs``)."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff3dhpe_torch.config import Config
from diff3dhpe_torch.engine.runner import check_supported, check_trainable
from diff3dhpe_torch.models import fast_forward_denoise
from diff3dhpe_torch.ops import attention as port_attention
from diff3dhpe_torch.ops import fused_transformer_block
from diff3dhpe_torch.ops.attention import MAX_N, takes_head_dim
from diff3dhpe_tpu.models import MixSTEDenoiser as FlaxMixSTE
from diff3dhpe_tpu.models.fast_eval import fast_forward_denoise as jax_fast_forward
from diff3dhpe_tpu.ops.attention import grand_attention_pallas_3d
from diff3dhpe_tpu.ops.fused_block import fused_transformer_block as jax_fused_block
from torch_port_helpers import assert_bf16_bars, build_pair, port_model
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

F, J = 9, 17
WIDTHS = {16: (48, 3), 24: (48, 2), 32: (64, 2)}  # head_dim: (embed, heads)
FAST_KW = dict(num_frame=F, num_joints=J, depth=1)
FORWARDS = {"f32": dict(dtype=jnp.float32), "bf16": dict(dtype=jnp.bfloat16),
            "high3": dict(dtype=jnp.float32, f32_prec="high3")}
BLOCK_GROUPS = 6  # B1's spatial groups of J rows


def _inputs(d):
    c = WIDTHS[d][0]
    rng = np.random.default_rng(d)
    return dict(x=rng.standard_normal((2, F, J, 5)).astype(np.float32),
                t=np.array([3.0, 700.0], np.float32),
                rows=rng.standard_normal((BLOCK_GROUPS * J, c)).astype(np.float32),
                t_rows=rng.standard_normal((2, c)).astype(np.float32),
                qkv=rng.standard_normal((3, 4, 27, d)).astype(np.float32))


def _jax_width(d):
    """(port model, inputs, heads, flax params, {name: JAX's output}) at
    head width d: a depth-1 denoiser's flax params and its port, and JAX's
    block, attention, fast forwards and flax outputs on them from one jitted
    program, compiled at backend optimisation level 0 (the interpreted
    kernels' programs compile in a fraction of the time, to the same
    results up to float32 rounding)."""
    c, heads = WIDTHS[d]
    _, params, port = build_pair(np.random.default_rng(d), num_frame=F, embed_dim=c, depth=1,
                                 num_heads=heads)
    inp = _inputs(d)

    def program(p):
        x, t = jnp.asarray(inp["x"]), jnp.asarray(inp["t"])
        rows, t_rows = jnp.asarray(inp["rows"]), jnp.asarray(inp["t_rows"])
        block = dict(out_ln_params=p["spatial_norm"], t_rows=t_rows,
                     rows_per_item=BLOCK_GROUPS * J // 2, interpret=True)
        res = {f"fast {k}": jax_fast_forward(p, x, t, num_heads=heads, interpret=True, **kw,
                                             **FAST_KW)
               for k, kw in FORWARDS.items()}
        res["block f32"] = jax_fused_block(rows, p["ste_block_0"], n=J, heads=heads, **block)
        res["block bf16"] = jax_fused_block(rows.astype(jnp.bfloat16), p["ste_block_0"], n=J,
                                            heads=heads, **block)
        q, k, v = (a.astype(jnp.bfloat16) for a in jnp.asarray(inp["qkv"]))
        res["attn bf16"] = grand_attention_pallas_3d(q, k, v, interpret=True)
        kw = dict(num_frame=F, num_joints=J, in_chans=2, embed_dim=c, depth=1, num_heads=heads,
                  mlp_ratio=2.0, qkv_bias=True, with_time_emb=True, mode="s2s")
        res["flax"] = FlaxMixSTE(drop_path_rate=0.0, **kw).apply({"params": p}, x, t)
        res["flax pallas"] = FlaxMixSTE(drop_path_rate=0.0, use_pallas=True, **kw).apply(
            {"params": p}, x, t)
        return res

    with jax.default_matmul_precision("highest"):
        got = jax.jit(program).lower(params).compile(
            compiler_options={"xla_backend_optimization_level": 0})(params)
    return port, inp, heads, params, {k: np.asarray(v.astype(jnp.float32))
                                      for k, v in got.items()}


@pytest.fixture(scope="module")
def jax_outputs():
    """{head_dim: _jax_width(head_dim)}, the widths built in threads (XLA
    compiles outside the GIL)."""
    with ThreadPoolExecutor(len(WIDTHS)) as pool:
        return dict(zip(WIDTHS, pool.map(_jax_width, WIDTHS)))


@pytest.mark.parametrize("d", sorted(WIDTHS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_matches_jax_at_head_width(jax_outputs, d, dtype):
    port, inp, heads, _, jax_out = jax_outputs[d]
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = torch.from_numpy(inp["rows"]).to(dt)
    with torch.no_grad():
        out = fused_transformer_block(x, port.STEblocks[0], J, heads,
                                      t_rows=torch.from_numpy(inp["t_rows"]),
                                      rows_per_item=BLOCK_GROUPS * J // 2,
                                      out_ln=port.Spatial_norm).float().numpy()
    expected = jax_out[f"block {dtype}"]
    if dtype == "f32":
        np.testing.assert_allclose(out, expected, rtol=2e-4, atol=2e-5)
    else:
        assert_bf16_bars(out, expected)


@pytest.mark.parametrize("d", sorted(WIDTHS))
def test_fullseq_bf16_matches_jax_at_head_width(jax_outputs, d):
    _, inp, _, _, jax_out = jax_outputs[d]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in inp["qkv"])
    out = port_attention.grand_attention_fullseq(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 27, d)
    assert_bf16_bars(out.float().numpy(), jax_out["attn bf16"])


@pytest.mark.parametrize("d", sorted(WIDTHS))
@pytest.mark.parametrize("kind", sorted(FORWARDS))
def test_fast_forward_matches_jax_at_head_width(jax_outputs, d, kind):
    port, inp, heads, _, jax_out = jax_outputs[d]
    x, t = torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"])
    run = lambda **kw: fast_forward_denoise(port, x, t, **kw).float().numpy()
    expected = jax_out[f"fast {kind}"]
    if kind == "f32":
        np.testing.assert_allclose(run(), expected, rtol=2e-4, atol=2e-5)
    elif kind == "bf16":
        out, flax = run(dtype=torch.bfloat16), jax_out["flax"]
        assert np.abs(out - expected).max() <= 2e-2 * np.abs(expected).max()
        assert np.abs(out - flax).max() <= 1.5 * np.abs(expected - flax).max()
    else:
        out, port_highest = run(f32_prec="high3"), run()
        jax_effect = np.abs(expected - jax_out["fast f32"]).mean()
        port_effect = np.abs(out - port_highest).mean()
        assert jax_effect > 0, "JAX's high3 forward equals its highest one"
        assert np.abs(out - expected).mean() <= 0.6 * jax_effect, (out, jax_effect)
        assert abs(port_effect / jax_effect - 1) <= 0.1, (port_effect, jax_effect)


@pytest.mark.parametrize("d", sorted(WIDTHS))
def test_use_pallas_model_matches_flax_at_head_width(jax_outputs, d):
    _, inp, heads, params, jax_out = jax_outputs[d]
    c = WIDTHS[d][0]
    fused = port_model(params, use_pallas=True, num_frame=F, num_joints=J, in_chans=2,
                       embed_dim=c, depth=1, num_heads=heads, mlp_ratio=2.0, qkv_bias=True,
                       with_time_emb=True, mode="s2s")
    with torch.no_grad():
        out = fused(torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]))
    np.testing.assert_allclose(out.numpy(), jax_out["flax pallas"], rtol=0, atol=1e-4)


def test_takes_head_dim_is_the_kernels_rule():
    """The Python mirror of csrc/grand_attn.cuh::takes_head_dim."""
    assert [d for d in range(0, 300) if takes_head_dim(d)] == list(range(8, 129, 8))


FLAGSHIP = dict(subjects_train="S1", subjects_test="S9", number_of_frames=243, stride=243,
                embed_dim=512, transformer_depth=8, timesteps=50, sampling_timesteps=9,
                batch_size_eval=2, actions="*")
MIXED = dict(fast_eval=True, compute_dtype="bfloat16", eval_f32_final_steps=1, eval_f32_head=True)


@pytest.mark.parametrize("overrides", [
    dict(fast_eval=True),                                     # f32
    MIXED,                                                    # the mixed mode ("high3" final)
    dict(fast_eval=True, compute_dtype="bfloat16"),           # pure bf16
    dict(use_pallas_attention=True),
    dict(embed_dim=384, num_heads=4, **MIXED),                # head_dim 96 on the 128 instance
    dict(embed_dim=384, num_heads=4, use_pallas_attention=True),
])
def test_check_supported_accepts_sixteen_heads_on_cuda(overrides):
    """``--num-heads 16`` at embed 512 (head_dim 32), and 4 at 384 (96),
    on every serving path."""
    check_supported(Config(**{**FLAGSHIP, "num_heads": 16, **overrides}), torch.device("cuda"))


@pytest.mark.parametrize("overrides", [
    dict(num_heads=2, **MIXED),                               # head_dim 256
    dict(embed_dim=480, num_heads=24, fast_eval=True, compute_dtype="bfloat16"),  # 20
])
def test_check_supported_refuses_widths_past_the_rule(overrides):
    cfg = Config(**{**FLAGSHIP, **overrides})
    with pytest.raises(ValueError, match="^num_heads="):
        check_supported(cfg, torch.device("cuda"))
    check_supported(cfg, torch.device("cpu"))


@pytest.mark.parametrize("attn_bwd", [False, True])
def test_check_trainable_refuses_fast_train_at_head_dim_32(attn_bwd):
    """The serving path takes head_dim 32, fused training not yet (its
    attention backward B4 is compiled for 64 and 128: ROADMAP A.20)."""
    cfg = Config(**{**FLAGSHIP, "num_heads": 16, "fast_train": True,
                    "fast_train_attn_bwd": attn_bwd})
    check_supported(cfg, "cuda")
    with pytest.raises(ValueError, match="^num_heads=16 .*fused training take head_dim"):
        check_trainable(cfg, "cuda")
    check_trainable(cfg, "cpu")
    check_trainable(cfg.replace(fast_train=False, fast_train_attn_bwd=False), "cuda")


@pytest.mark.parametrize("overrides,check", [
    (dict(fast_eval=True), check_supported),
    (MIXED, check_supported),
    (dict(use_pallas_attention=True), check_supported),
    (dict(fast_train=True, use_pallas_attention=True, fast_eval=True), check_trainable),
    (dict(fast_train=True, fast_train_attn_bwd=True), check_trainable),
])
def test_frames_past_the_kernels_key_limit_are_refused_by_name(overrides, check):
    """ROADMAP C.17: a 351-frame window on a kernel path is refused before
    the run, naming ``number_of_frames``; the same config runs on the CPU,
    and 256 frames, the kernels' limit, pass."""
    cfg = Config(**{**FLAGSHIP, "number_of_frames": 351, "stride": 351, **overrides})
    with pytest.raises(ValueError, match=f"^number_of_frames=351 .*at most {MAX_N} keys"):
        check(cfg, "cuda")
    check(cfg, "cpu")
    check(cfg.replace(number_of_frames=MAX_N, stride=MAX_N), "cuda")


def test_the_plain_module_takes_every_length_on_cuda():
    check_trainable(Config(**{**FLAGSHIP, "number_of_frames": 351, "stride": 351}), "cuda")
