"""The attention scale against the JAX package on the CPU (ROADMAP A.17):
the module's ``qk_scale`` (plain and ``use_pallas``, f32 and bf16), and the
``scale`` of B1, B2 and B5, whose plain versions are held against JAX's
Pallas kernels in interpret mode at f32, bf16 and the contraction modes
"high3" and "default". Beside them, the fused paths' refusal of a module
with ``qk_scale`` or dropout, and ``GaussianDiffusion.create``'s p2 loss
weight (A.18).

Bars: the module at f32 to 1e-4 absolute (tests/test_model.py's), at bf16
within the quarter bar of tests/test_torch_bf16_train.py (JAX compiled
with excess precision off), and with ``use_pallas`` at bf16 within
``torch_port_helpers.assert_bf16_bars``: there the port's dispatcher sends
the joints' groups to B6, which rounds where JAX's packed kernel does, and
JAX's dispatcher to its plain formulas (a deliberate difference in
ROADMAP), so the two round at different points; the blocks at f32 to rtol
2e-4, atol 2e-5 (tests/test_torch_fused_block.py), at bf16 within
``torch_port_helpers.assert_bf16_bars``, under the modes by
tests/test_torch_contract_modes.py's ``assert_mode_matches`` (JAX's
``_dot_f32`` given the MXU's semantics at "default", as there). JAX's
programs are built once for the file, together, in threads of the module
fixture ``jax_results`` (the mode is a context variable of the thread that
traces)."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diff3dhpe_tpu.ops.fused_block as jax_fb
import torch_tp_ranks as ranks
from diff3dhpe_torch import (
    GaussianDiffusion, fast_forward_denoise, fast_forward_denoise_train,
    fast_forward_denoise_train_pairs, make_denoise_fn, make_fast_denoise_fn,
    make_fast_train_denoise_fn, make_mixed_diffusion,
)
from diff3dhpe_torch.config import Config
from diff3dhpe_torch.engine.runner import Runner
from diff3dhpe_torch.io.export import export_eval_step
from diff3dhpe_torch.models import MixSTEDenoiser
from diff3dhpe_torch.ops import fused_block
from diff3dhpe_torch.parallel.tensor import shard_model
from diff3dhpe_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diff3dhpe_tpu.models import MixSTEDenoiser as FlaxMixSTE
from test_torch_bf16_train import assert_within_quarter, strict_jit
from test_torch_contract_modes import _mxu_dot_f32, assert_mode_matches, quick_compile
from torch_port_helpers import (
    JOINTS_LEFT, JOINTS_RIGHT, assert_bf16_bars, build_pair, port_model,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

F, J, C, DEPTH, HEADS, B = 9, 17, 32, 1, 4, 2
KW = dict(num_frame=F, num_joints=J, in_chans=2, embed_dim=C, depth=DEPTH, num_heads=HEADS,
          mlp_ratio=2.0, qkv_bias=True, with_time_emb=True, mode="s2s")
QK_SCALES = (None, 0.0, 0.1)
SCALE = 0.1  # the blocks' (head_dim 8: d^-½ = 0.354)
GROUPS, B_COLS, J_COLS = 6, 2, 5
BLOCK_MODES = ("highest", "high3", "default", "bf16")
F_LONG = 81  # frames beyond 64: JAX's dispatcher and the port's both run B3


def _t(a):
    return torch.tensor(np.asarray(a))


def _inputs():
    rng = np.random.default_rng(8)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return dict(x=f32(B, F, J, 5), x_long=f32(B, F_LONG, J, 5),
                time=np.array([3.0, 700.0], np.float32), rows=f32(GROUPS * 17, C),
                t=f32(2, C), cols=f32(B_COLS * F, J_COLS * C), t_cols=f32(B_COLS, C))


def _flax(qk, pallas, dtype=None, num_frame=F):
    return FlaxMixSTE(drop_path_rate=0.0, qk_scale=qk, use_pallas=pallas, dtype=dtype,
                      **dict(KW, num_frame=num_frame))


def _module_run(p, inp, dtype):
    return {f"{qk}/{pallas}": _flax(qk, pallas, dtype).apply({"params": p}, inp["x"],
                                                              inp["time"])
            for qk in QK_SCALES for pallas in (False, True)}


def _jax_modules(params, params_long, inp):
    """JAX's module forwards at each ``qk_scale``, plain and ``use_pallas``:
    f32 and, strict, bf16; at F_LONG the f32 ``use_pallas`` one at 0.1."""
    with jax_fb.f32_precision_scope("highest"), jax.default_matmul_precision("highest"):
        f32 = jax.jit(lambda p: _module_run(p, inp, None))(params)
        long = jax.jit(lambda p: _flax(SCALE, True, num_frame=F_LONG).apply(
            {"params": p}, inp["x_long"], inp["time"]))(params_long)
    bf16 = strict_jit(lambda p: _module_run(p, inp, jnp.bfloat16), params)
    as_np = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return dict(f32=as_np(f32), bf16=as_np(bf16), long=np.asarray(long))


def _jax_blocks(params, inp, mode):
    """B1 (rows, with the time add and the out-LN), B2 (cols) and B5 at
    SCALE, interpreted, at float32 contraction ``mode`` or ("bf16") on bf16
    rows."""
    dt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    a = {k: jnp.asarray(v) for k, v in inp.items()}
    rows, cols = a["rows"].astype(dt), a["cols"].astype(dt)

    def fn(p):
        b = p["ste_block_0"]
        return dict(
            b1=jax_fb.fused_transformer_block(
                rows, b, n=17, heads=HEADS, scale=SCALE, interpret=True, t_rows=a["t"],
                rows_per_item=GROUPS * 17 // 2, out_ln_params=p["spatial_norm"]),
            b2=jax_fb.fused_temporal_block_cols(
                cols, p["tte_block_0"], n=F, f8=F, j_groups=J_COLS, heads=HEADS, scale=SCALE,
                interpret=True, t_rows=a["t_cols"], out_ln_params=p["temporal_norm"]),
            b5=jax_fb.fused_attention_block(
                rows, b["norm1"]["scale"], b["norm1"]["bias"], b["attn"]["qkv"]["kernel"],
                b["attn"]["qkv"]["bias"], b["attn"]["proj"]["kernel"], b["attn"]["proj"]["bias"],
                n=17, heads=HEADS, scale=SCALE, interpret=True))

    with jax_fb.f32_precision_scope("highest" if mode == "bf16" else mode):
        out = quick_compile(jax.jit(fn), params)
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_results():
    """(params, params at F_LONG, inputs, JAX's module forwards, {mode:
    JAX's blocks}): every JAX program of the file, traced in threads under
    ``_mxu_dot_f32`` (which changes "default" alone)."""
    rng = np.random.default_rng(12)
    _, params, _ = build_pair(rng, num_frame=F, embed_dim=C, depth=DEPTH, num_heads=HEADS)
    _, params_long, _ = build_pair(rng, num_frame=F_LONG, embed_dim=C, depth=DEPTH,
                                   num_heads=HEADS)
    inp = _inputs()
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(len(BLOCK_MODES) + 1) as pool:
        mp.setattr(jax_fb, "_dot_f32", _mxu_dot_f32(jax_fb._dot_f32))
        modules = pool.submit(_jax_modules, params, params_long, inp)
        blocks = {m: pool.submit(_jax_blocks, params, inp, m) for m in BLOCK_MODES}
        return (params, params_long, inp, modules.result(),
                {m: f.result() for m, f in blocks.items()})


def _bf16_module(port):
    model = MixSTEDenoiser(**KW, qk_scale=port.qk_scale, use_pallas=port.use_pallas,
                           dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(port.state_dict())
    return model


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("qk", QK_SCALES)
def test_module_scale_matches_flax(jax_results, qk, pallas):
    """The module at ``qk_scale`` against flax's at f32 and bf16, plain and
    ``use_pallas`` (the dispatcher's plain versions here); None and 0.0 both
    run head_dim^-½ (JAX's ``or``), bit for bit, and 0.1 moves the output."""
    params, _, inp, jax_mod, _ = jax_results
    key = f"{qk}/{pallas}"
    port = port_model(params, **KW, qk_scale=qk, use_pallas=pallas)
    x, t = _t(inp["x"]), _t(inp["time"])
    with torch.no_grad():
        out = port(x, t)
        out16 = _bf16_module(port)(x, t)
        default = port_model(params, **KW, use_pallas=pallas)(x, t)
    np.testing.assert_allclose(out.numpy(), jax_mod["f32"][key], atol=1e-4, rtol=0)
    if pallas:  # B6 rounds where JAX's packed kernel does, not its plain formulas (ROADMAP)
        assert_bf16_bars(out16.float().numpy(), jax_mod["bf16"][key])
    else:
        assert_within_quarter([out16.float().numpy()], [jax_mod["bf16"][key]],
                              [jax_mod["f32"][f"{qk}/False"]])
    if qk:
        assert (out - default).abs().max() > 1e-3
    else:
        assert torch.equal(out, default)


def test_use_pallas_scale_reaches_b3(jax_results):
    """At F_LONG frames the temporal attention goes through B3 (the port's
    plain version; JAX's interpreted kernel) at qk_scale 0.1."""
    _, params_long, inp, jax_mod, _ = jax_results
    port = port_model(params_long, **dict(KW, num_frame=F_LONG), qk_scale=SCALE, use_pallas=True)
    with torch.no_grad():
        out = port(_t(inp["x_long"]), _t(inp["time"]))
    np.testing.assert_allclose(out.numpy(), jax_mod["long"], atol=1e-4, rtol=0)


def _port_block(port, inp, name, mode, **kw):
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    prec = dict(f32_prec="highest" if mode == "bf16" else mode, **kw)
    t = lambda k: _t(inp[k])
    with torch.no_grad():
        if name == "b1":
            return fused_block.fused_transformer_block(
                t("rows").to(dt), port.STEblocks[0], 17, HEADS, t_rows=t("t"),
                rows_per_item=GROUPS * 17 // 2, out_ln=port.Spatial_norm, **prec)
        if name == "b2":
            return fused_block.fused_temporal_block_cols(
                t("cols").to(dt), port.TTEblocks[0], F, J_COLS, HEADS, t_rows=t("t_cols"),
                out_ln=port.Temporal_norm, **prec)
        return fused_block.fused_attention_block(t("rows").to(dt), port.STEblocks[0], 17, HEADS,
                                                 **prec)


@pytest.mark.parametrize("mode", BLOCK_MODES)
@pytest.mark.parametrize("name", ["b1", "b2", "b5"])
def test_block_scale_matches_jax(jax_results, name, mode):
    """B1, B2 and B5 (their plain versions behind the wrappers) at scale 0.1
    against JAX's interpreted kernels at the same scale."""
    params, _, inp, _, jax_blocks = jax_results
    port = port_model(params, **KW)
    out = _port_block(port, inp, name, mode, scale=SCALE)
    want = jax_blocks[mode][name]
    if mode == "highest":
        np.testing.assert_allclose(out.numpy(), want, rtol=2e-4, atol=2e-5)
    elif mode == "bf16":
        assert out.dtype == torch.bfloat16
        assert_bf16_bars(out.float().numpy(), want)
    else:
        highest = _port_block(port, inp, name, "highest", scale=SCALE)
        assert_mode_matches(out.numpy(), highest.numpy(), want, mode)
    # The scale reaches the block.
    assert (out.float() - _port_block(port, inp, name, mode).float()).abs().max() > 1e-3


@pytest.mark.parametrize("mode", BLOCK_MODES)
def test_block_scale_none_is_the_call_without_it(jax_results, mode):
    """``scale=None`` is the call without the argument, bit for bit, which
    is head_dim^-½ given explicitly; the operators take the same calls
    (their schemas end in ``float? scale=None``)."""
    params, _, inp, _, _ = jax_results
    port = port_model(params, **KW)
    for name in ("b1", "b2", "b5"):
        ambient = _port_block(port, inp, name, mode)
        assert torch.equal(_port_block(port, inp, name, mode, scale=None), ambient)
        assert torch.equal(_port_block(port, inp, name, mode, scale=(C // HEADS) ** -0.5),
                           ambient)
    for op in (torch.ops.diff3dhpe.fused_transformer_block,
               torch.ops.diff3dhpe.fused_temporal_block_cols):
        assert str(op.default._schema).endswith("float? scale=None) -> Tensor")


def test_scale_stays_the_global_head_width_under_a_model_axis():
    """``shard_model`` divides ``num_heads``, not ``head_dim``: each rank's
    attention keeps the whole module's scale."""
    class Mesh:
        model_size, model_rank, model_group, shape = 2, 1, None, "data:1,model:2"

    for qk in (None, 0.1):
        model = MixSTEDenoiser(**dict(KW, num_heads=8), qk_scale=qk, device="cpu")
        scale = model.STEblocks[0].attn.scale
        shard_model(model, Mesh())
        for blk in (*model.STEblocks, *model.TTEblocks):
            assert blk.attn.num_heads == 4 and blk.attn.scale == scale == (qk or 4 ** -0.5)


@pytest.mark.parametrize("field", ["qk_scale", "drop_rate", "attn_drop_rate"])
def test_fused_paths_refuse_the_field(field):
    """The fused eval, the fused training (pairs and monolithic) and their
    factories raise a ValueError naming the field, where JAX's fused paths
    run head_dim^-½ and no dropout whatever the module says; the plain
    module runs it, and ``qk_scale=0`` (head_dim^-½) is not refused."""
    model = MixSTEDenoiser(**KW, **{field: 0.1}, device="cpu")
    x, t = torch.randn(2, F, J, 5), torch.tensor([3.0, 7.0])
    calls = [lambda: fast_forward_denoise(model, x, t),
             lambda: fast_forward_denoise_train_pairs(model, x, t),
             lambda: fast_forward_denoise_train(model, x, t),
             lambda: make_fast_denoise_fn(model, torch.bfloat16),
             lambda: make_fast_train_denoise_fn(model),
             lambda: make_mixed_diffusion(model, timesteps=20, sampling_timesteps=3)]
    for call in calls:
        with pytest.raises(ValueError, match=field):
            call()
    make_denoise_fn(model)(x, t)
    with torch.no_grad():
        fast_forward_denoise(MixSTEDenoiser(**KW, qk_scale=0.0, device="cpu"), x, t)


def test_export_refuses_a_fused_step_with_qk_scale(tmp_path):
    """``export_eval_step`` of a fused eval refuses a module with
    ``qk_scale``, before it traces; the plain eval exports it."""
    fit = {k: v for k, v in ranks.FIT.items() if k not in ("embed_dim", "num_heads")}
    for fast_eval in (True, False):
        runner = Runner(Config(**fit, embed_dim=C, num_heads=HEADS, fast_eval=fast_eval,
                               checkpoint=str(tmp_path)),
                        J, JOINTS_LEFT, JOINTS_RIGHT, device="cpu")
        runner.model = MixSTEDenoiser(**dict(KW, depth=ranks.DEPTH), qk_scale=SCALE, device="cpu")
        if fast_eval:
            with pytest.raises(ValueError, match="qk_scale"):
                export_eval_step(runner, batch_size=2)
        else:
            assert export_eval_step(runner, batch_size=2)


@pytest.mark.parametrize("gamma,k", [(0.0, 1.0), (1.0, 2.0)])
def test_create_takes_the_p2_loss_weight(gamma, k):
    """``GaussianDiffusion.create``'s p2 weight arguments give JAX's
    ``constants.p2_loss_weight``."""
    kw = dict(timesteps=50, sampling_timesteps=5, p2_loss_weight_gamma=gamma,
              p2_loss_weight_k=k)
    ours = GaussianDiffusion.create(lambda x, t: x, **kw).constants.p2_loss_weight
    theirs = JaxDiffusion.create(lambda p, x, t: x, **kw).constants.p2_loss_weight
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
    assert (gamma == 0.0) == bool(np.all(np.asarray(ours) == 1.0))
