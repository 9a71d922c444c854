"""The port's tensor parallelism (``parallel.tensor``, the ``model`` axis of
``mesh_shape``) on the CPU: four ranks of one gloo group, spawned once for
the module (tests/torch_tp_ranks.py, which imports no JAX), run every case
at "data:2,model:2" (and the train steps, the fused training's ``fit`` and
the fused eval at "data:1,model:2" on two groups of two side by side);
this process meanwhile builds JAX's references on its virtual 8-device
mesh (``make_mesh("data:2,model:2")`` and ``make_mesh("data:1,model:2")``,
the params placed by ``shard_params``; JAX's sharded artifacts through its
``Runner``) and the one-process port's.

Bars: the rule against JAX's ``param_sharding_rules`` exactly; the round
trip bit for bit; the f32 train step against JAX's flax-path step on its
mesh at tests/test_torch_fast_train.py's bars (loss 1e-5 relative, each
gradient to 2e-4 of its max) and against the one-process port at JAX's own
tensor-parallel bar (tests/test_parallel.py:88-92: loss 1e-5 relative,
gradients 2e-5 of max(|g|, 1e-3)); the bf16 step's relative L2 gap from
the one-process port at most 2x JAX's own "data:2,model:2"-vs-one-device
gap on the same draws (ROADMAP C.10's rule); the eval against JAX's on
its mesh at tests/test_torch_eval.py's bars (rtol 1e-4, atol 1e-4) and
against the one process at 1e-5 absolute (tests/test_parallel.py:158-159);
the fused eval on the gathered replica bit for bit where the ranks run the
whole batch ("data:1,model:2"), and to 1e-5 at "data:2,model:2" (the
batch split as in tests/test_torch_parallel.py); ``fit`` and resume at
``test_fit_equals_the_one_process_fit``'s bars (1e-5 relative). The fused
training at "data:1,model:2" (whole weights gathered from the shards):
bit for bit the one-process port (step, ``fit`` and its resume), and
against JAX's step on its mesh at tests/test_torch_fast_train.py's bars
at f32 and tests/test_torch_bf16_train.py's gradient bar at bf16. The
sharded export at "data:2,model:2": bit for bit the live step, and
against JAX's sharded artifact at tests/test_torch_export.py's bar (f32,
1e-4 absolute) and tests/test_torch_mixed_eval.py's (mixed: the distance
from JAX's f32 artifact at most 1.5x JAX's mixed one's + 1e-4).
"""
import os
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_tp_ranks as ranks
from diff3dhpe_torch.config import Config
from diff3dhpe_torch.engine import flip_pose
from diff3dhpe_torch.engine.runner import check_supported, check_trainable
from diff3dhpe_torch.io import state_dict_from_flax
from diff3dhpe_torch.io.export import restore_eval_step
from diff3dhpe_torch.parallel import check_mesh_shape
from diff3dhpe_torch.parallel.tensor import param_sharding_rules
from diff3dhpe_tpu.config import Config as JaxConfig
from diff3dhpe_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diff3dhpe_tpu.engine import build_train_state
from diff3dhpe_tpu.engine import make_eval_step as jax_make_eval_step
from diff3dhpe_tpu.engine import make_train_step as jax_make_train_step
from diff3dhpe_tpu.engine.runner import Runner as JaxRunner
from diff3dhpe_tpu.engine.steps import make_denoise_fn as jax_make_denoise_fn
from diff3dhpe_tpu.engine.steps import make_fast_train_denoise_fn as jax_make_fast_train_fn
from diff3dhpe_tpu.engine.steps import make_optimizer as jax_make_optimizer
from diff3dhpe_tpu.io.export import export_eval_step as jax_export_eval_step
from diff3dhpe_tpu.io.export import restore_eval_step as jax_restore_eval_step
from diff3dhpe_tpu.models import MixSTEDenoiser as FlaxMixSTE
from diff3dhpe_tpu.models import fast_eval as jax_fast
from diff3dhpe_tpu.parallel import make_mesh
from diff3dhpe_tpu.parallel import param_sharding_rules as jax_rules
from diff3dhpe_tpu.parallel import shard_params as jax_shard_params
from test_torch_bf16_train import deviation
from test_torch_parallel import _jax_draws, _keeping_grads
from torch_parallel_ranks import cli_main_one
from torch_port_helpers import build_pair, jax_x_init
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

WORLD, B = 4, 4
F, J = ranks.F, ranks.J
JL, JR = ranks.JOINTS_LEFT, ranks.JOINTS_RIGHT
SELF_EVAL = ["plain/2/0.0", "pallas/1/0.0", "plain/1/0.5"]  # module / repeat_n / eta
JOIN_S = 300  # a hung rank fails its test; each rank's collectives time out at 120 s
# JAX's bf16 programs as tests/test_torch_parallel_bf16.py compiles them;
# its fused f32 programs (the fast-train step, the restored artifacts) at
# the backend's optimisation level 0 too, which halves their compiles.
OPTIONS = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0}
FAST_OPTIONS = {"xla_backend_optimization_level": 0}


def _state_dict(tree):
    return {k: v.numpy() for k, v in state_dict_from_flax(jax.tree.map(np.asarray, tree),
                                                          ranks.DEPTH).items()}


def _jax_train(params, key, gt, x2d, mesh, dtype=None, fast=False):
    """(loss, gradients as a state dict) of JAX's flax-path train step, or
    with ``fast`` its fused training path (``attn_bwd``, drop-path
    DROP_PATH), the params placed by ``shard_params`` on ``mesh`` (None:
    one device)."""
    if fast:
        fn = jax_make_fast_train_fn(num_frame=F, num_joints=J, depth=ranks.DEPTH,
                                    num_heads=ranks.HEADS, dtype=dtype or jnp.float32,
                                    drop_path_rate=ranks.DROP_PATH, attn_bwd=True)
    else:
        fn = jax_make_denoise_fn(FlaxMixSTE(drop_path_rate=0.0, dtype=dtype, **ranks.MODEL_KW))
    opt = _keeping_grads(jax_make_optimizer(ranks.LR, 0.99, steps_per_epoch=10))
    p = jax.tree.map(jnp.asarray, params)
    state = build_train_state(p if mesh is None else jax_shard_params(p, mesh), opt)
    step = jax_make_train_step(JaxDiffusion.create(fn, **ranks.TRAIN_KW), opt, mesh=mesh,
                               donate=False)
    args = (state, key, jnp.asarray(gt), jnp.asarray(x2d))
    options = OPTIONS if dtype is not None else (FAST_OPTIONS if fast else {})
    state, loss = step.lower(*args).compile(compiler_options=options)(*args)
    return float(loss), _state_dict(state.opt_state[1])


def _jax_eval(params, key, x2d, x2d_flip, mesh, repeat_n):
    model = FlaxMixSTE(drop_path_rate=0.0, **ranks.MODEL_KW)
    diffusion = JaxDiffusion.create(jax_make_denoise_fn(model), **ranks.EVAL_KW)
    step = jax_make_eval_step(diffusion, JL, JR, mesh=mesh, repeat_n=repeat_n)
    return np.asarray(step(jax_shard_params(jax.tree.map(jnp.asarray, params), mesh), key,
                           x2d, x2d_flip))


def _jax_fast_draws(key, gt_shape):
    """The t, noise and drop-path scales of JAX's fused train step at
    "data:1,model:2", its jit path (engine/steps.py:298): split(key), then
    p_losses's split and draw_drop_path_scales on the dropout key."""
    diff_key, dropout_key = jax.random.split(key)
    key_t, key_noise = jax.random.split(diff_key)
    sp, tp = jax_fast.draw_drop_path_scales(dropout_key, gt_shape[0], ranks.DEPTH,
                                            ranks.DROP_PATH, num_frame=F, num_joints=J)
    as_torch = lambda a: torch.from_numpy(np.array(a))
    return dict(t=as_torch(jax.random.randint(key_t, gt_shape[:1], 0,
                                              ranks.TRAIN_KW["timesteps"])),
                noise=as_torch(jax.random.normal(key_noise, gt_shape, jnp.float32)),
                dp_scales=(as_torch(sp), as_torch(tp)))


def _jax_export(params, key, x2d, x2d_flip, mode):
    """JAX's sharded artifact of the Runner's fused eval ("f32" or "mixed")
    at data:2,model:2 and global batch B, restored and run on ``params``."""
    cfg = JaxConfig(**{**ranks.FIT, "batch_size_eval": B, **ranks.FUSED[mode],
                       "mesh_shape": ranks.MESH})
    runner = JaxRunner(cfg, J, JL, JR)
    runner.set_params(jax.tree.map(jnp.asarray, params))
    step = jax_restore_eval_step(jax_export_eval_step(runner, B, sharded=True))
    args = (runner.state.params, key, x2d, x2d_flip)
    return np.asarray(jax.jit(step).lower(*args).compile(compiler_options=FAST_OPTIONS)(*args))


def _jax_references(params, key_eval, key_train, gt, x2d, x2d_flip):
    """JAX on data:2,model:2 and data:1,model:2 (and one device for the
    bf16 gap), in threads."""
    mesh, pair = make_mesh(ranks.MESH), make_mesh("data:1,model:2")
    with jax.default_matmul_precision("highest"), ThreadPoolExecutor(8) as pool:
        jobs = {"train": pool.submit(_jax_train, params, key_train, gt, x2d, mesh),
                "bf16_mesh": pool.submit(_jax_train, params, key_train, gt, x2d, mesh,
                                         jnp.bfloat16),
                "bf16_one": pool.submit(_jax_train, params, key_train, gt, x2d, None,
                                        jnp.bfloat16)}
        for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
            jobs[f"fast/{name}"] = pool.submit(_jax_train, params, key_train, gt, x2d, pair,
                                               dtype, fast=True)
        jobs.update({f"eval/{r}": pool.submit(_jax_eval, params, key_eval, x2d, x2d_flip, mesh, r)
                     for r in (1, 2)})
        jobs.update({f"export/{mode}": pool.submit(_jax_export, params, key_eval, x2d, x2d_flip,
                                                   mode) for mode in ranks.FUSED})
        return {k: v.result() for k, v in jobs.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawns the four ranks, builds the references while they run, joins
    them. Returns dict(ranks=[rank results], jax=..., one=..., spec=...)."""
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    _, params, port = build_pair(np.random.default_rng(19), num_frame=F, embed_dim=ranks.EMBED,
                                 depth=ranks.DEPTH, num_heads=ranks.HEADS)
    rng = np.random.default_rng(0)
    x2d = torch.from_numpy(rng.uniform(-1, 1, (B, F, J, 2)).astype(np.float32))
    gt = torch.from_numpy(rng.standard_normal((B, F, J, 3)).astype(np.float32))
    x2d_flip = flip_pose(x2d, JL, JR)
    key_eval, key_train = jax.random.PRNGKey(7), jax.random.PRNGKey(11)
    weights = {k: v.detach().clone() for k, v in port.state_dict().items()}
    torch.save(weights, tmp / "w.bin")
    spec = dict(weights=weights, weights_path=str(tmp / "w.bin"), x2d=x2d, x2d_flip=x2d_flip,
                gt=gt, jax_x_init={r: torch.from_numpy(jax_x_init(key_eval, 2 * B * r, (F, J, 3)))
                                   for r in (1, 2)},
                jax_draws=_jax_draws(key_train, B, tuple(gt.shape), False),
                jax_fast_draws=_jax_fast_draws(key_train, tuple(gt.shape)),
                self_eval=SELF_EVAL, fit_dir=str(tmp / "fit"), resume_dir=str(tmp / "resume"),
                one_epoch_0=str(tmp / "fit_one" / "epoch_0"))
    torch.save(spec, tmp / "spec.pt")

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ranks.run_rank, daemon=True,
                         args=(r, WORLD, str(tmp / "rendezvous"), str(tmp / "spec.pt"), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # The one-process fit first: the ranks resume its epoch_0.
        one = {}
        runner, train_ds, val_ds = ranks.fit_runner(tmp / "fit_one")
        one["fit"] = ranks.fit_summary(runner.fit(train_ds, val_ds))
        jax_res = _jax_references(params, key_eval, key_train, gt.numpy(), x2d.numpy(),
                                  x2d_flip.numpy())
        batch = (gt, x2d)
        one["train"] = ranks.run_train(weights, batch, drop_path=ranks.DROP_PATH, seed=4)
        one["train_bf16"] = ranks.run_train(weights, batch, dtype=torch.bfloat16,
                                            **spec["jax_draws"])
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            one[f"fast_train/{name}"] = ranks.run_train(weights, batch, None, dtype,
                                                        ranks.DROP_PATH, fast=True,
                                                        **spec["jax_fast_draws"])
        one["fast_fit"] = ranks.fast_fit(str(tmp / "fast_fit_one"))
        one["eval"] = {}
        for key in SELF_EVAL:
            kind, r, eta = key.split("/")
            step = ranks.eval_step(ranks.model(weights, use_pallas=kind == "pallas"), int(r),
                                   eta=float(eta))
            one["eval"][key] = step(x2d, x2d_flip, generator=torch.Generator().manual_seed(3))
        one["fused"] = {mode: ranks.fused_eval(weights, mode, x2d=x2d, x2d_flip=x2d_flip,
                                               x_init=spec["jax_x_init"][1])
                        for mode in ranks.FUSED}
        one["cli"] = {k: [float(e) for e in v] for k, v in cli_main_one(
            ranks.cli_argv(spec["weights_path"], tmp / "cli_one")).items()}
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
    # The four-rank run's epoch_0 resumed in one process.
    runner, train_ds, val_ds = ranks.fit_runner(tmp / "resumed_one")
    one["resumed"] = ranks.fit_summary(runner.fit(train_ds, val_ds,
                                                  resume=str(tmp / "fit" / "epoch_0")))
    try:  # the four-rank artifact in one process
        restore_eval_step(str(tmp / "sharded_f32.pt2"))
        one["restore_sharded"] = None
    except ValueError as e:
        one["restore_sharded"] = str(e)
    return dict(ranks=[res["cases"] for res in results], jax=jax_res, one=one, spec=spec,
                params=params)


def test_the_rule_is_jax_param_sharding_rules():
    """For every parameter of the tiny model, the port's split dim is JAX's
    ``param_sharding_rules`` on "data:2,model:2", through the weight
    bridge's name map (each flax leaf filled with its index, so that a
    port name finds its flax path): a kernel's [in, out] axis j is the port's
    [out, in] axis 1 - j."""
    model = FlaxMixSTE(drop_path_rate=0.0, **ranks.MODEL_KW)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, F, J, 5)),
                            jnp.zeros((1,)))["params"]
    mesh = make_mesh(ranks.MESH)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    specs = [jax_rules(tuple(k.key for k in path), leaf, mesh) for path, leaf in leaves]
    filled = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.float32) for i, (_, leaf) in enumerate(leaves)])
    names = state_dict_from_flax(filled, ranks.DEPTH)
    assert len(names) == len(leaves)
    split = 0
    for name, t in names.items():
        i = int(t.reshape(-1)[0])
        spec, ndim = tuple(specs[i]), leaves[i][1].ndim
        jax_dim = next((d for d, axis in enumerate(spec) if axis == "model"), None)
        want = None if jax_dim is None else (1 - jax_dim if ndim == 2 else jax_dim)
        assert param_sharding_rules(name) == want, (name, spec)
        split += want is not None
    assert split == 2 * ranks.DEPTH * 6  # qkv (2), proj, fc1 (2), fc2 in each block


def test_ranks_lay_out_both_axes(run):
    """rank = d·M + m, as JAX's make_mesh reshapes its devices."""
    assert [res["mesh"] for res in run["ranks"]] == [
        f"DataMesh(rank={r}, size=4, backend='gloo', device='cpu', data={r // 2}/2, "
        f"model={r % 2}/2)" for r in range(WORLD)]


def test_shard_then_gather_is_bit_for_bit(run):
    """Every rank's shards gather back to the whole state dict, in the
    reference's order; qkv's shard holds whole heads of q, k and v."""
    c = ranks.EMBED
    for res in run["ranks"]:
        assert res["round_trip"]["equal"]
        shapes = res["round_trip"]["shapes"]
        assert shapes["STEblocks.0.attn.qkv.weight"] == (3 * c // 2, c)
        assert shapes["STEblocks.0.attn.proj.weight"] == (c, c // 2)
        assert shapes["TTEblocks.0.mlp.fc2.weight"] == (c, c)  # hidden 2C, half of it
        assert shapes["STEblocks.0.attn.proj.bias"] == (c,)


def _scaled_max(grads, expected, floor):
    return {n: float(np.abs(grads[n].numpy() - g).max() / max(np.abs(g).max(), floor))
            for n, g in expected.items()}


def test_train_step_matches_jax_on_its_mesh(run):
    """One f32 step of the plain module at global batch 4 on data:2,model:2,
    JAX's t and noise injected, against JAX's flax-path step on its mesh."""
    jax_loss, jax_grads = run["jax"]["train"]
    for res in run["ranks"]:
        loss, grads, _ = res["train_jax"]
        assert abs(float(loss) - jax_loss) <= 1e-5 * abs(jax_loss)
        assert set(grads) == set(jax_grads)
        rel = _scaled_max(grads, jax_grads, 1e-8)
        assert max(rel.values()) < 2e-4, rel


@pytest.mark.parametrize("shape", [ranks.MESH, "data:1,model:2"])
def test_train_step_equals_the_one_process_port(run, shape):
    """The step with drop-path 0.5, every rank drawing the global batch's t,
    noise and scales from a generator seeded alike, against one process:
    JAX's own tensor-parallel bar. At data:1,model:2 each pair of ranks is
    its own mesh, side by side."""
    one_loss, one_grads, _ = run["one"]["train"]
    one_grads = {k: v.numpy() for k, v in one_grads.items()}
    for res in run["ranks"]:
        loss, grads, _ = res[f"train_self/{shape}"]
        assert abs(float(loss) - float(one_loss)) <= 1e-5 * abs(float(one_loss))
        rel = _scaled_max(grads, one_grads, 1e-3)
        assert max(rel.values()) < 2e-5, rel


@pytest.mark.parametrize("key", ["train_jax", f"train_self/{ranks.MESH}",
                                 "train_self/data:1,model:2", "train_bf16"])
def test_ranks_end_with_the_same_parameters(run, key):
    """After the AdamW step every rank holds the same whole parameters bit
    for bit (each rank checked its replicated parameters and shards with
    ``check_params_replicated`` too)."""
    (loss0, grads0, params0), *rest = (res[key] for res in run["ranks"])
    for loss, grads, params in rest:
        assert torch.equal(loss, loss0)
        for name in params0:
            assert torch.equal(grads[name], grads0[name]), name
            assert torch.equal(params[name], params0[name]), name


def test_bf16_gap_is_within_twice_jax_tensor_parallel_gap(run):
    """The bf16 step (the plain module at compute_dtype bfloat16, JAX's
    draws) on data:2,model:2 against one process: relative L2 over every
    gradient at most 2x what JAX's step on its mesh parts from its one
    device's on the same draws."""
    from test_torch_parallel_bf16 import grad_rel_l2

    (_, mesh_grads), (_, one_grads) = run["jax"]["bf16_mesh"], run["jax"]["bf16_one"]
    as_torch = lambda g: {k: torch.from_numpy(v) for k, v in g.items()}
    jax_gap = grad_rel_l2(as_torch(mesh_grads), as_torch(one_grads))
    port_gap = grad_rel_l2(run["ranks"][0]["train_bf16"][1], run["one"]["train_bf16"][1])
    assert 0 < jax_gap and port_gap <= 2 * jax_gap, (port_gap, jax_gap)
    loss, one_loss = float(run["ranks"][0]["train_bf16"][0]), float(run["one"]["train_bf16"][0])
    assert abs(loss - one_loss) <= 1e-2 * abs(one_loss)


@pytest.mark.parametrize("repeat_n", [1, 2])
def test_eval_matches_jax_on_its_mesh(run, repeat_n):
    """The plain module's flip-TTA DDIM eval at data:2,model:2, JAX's x_T
    injected, against JAX's eval step on its mesh; every rank holds the
    whole prediction."""
    out0 = run["ranks"][0][f"eval_jax/{repeat_n}"]
    for res in run["ranks"][1:]:
        assert torch.equal(res[f"eval_jax/{repeat_n}"], out0)
    expected = run["jax"][f"eval/{repeat_n}"]
    assert out0.shape == expected.shape == (B, F, J, 3)
    np.testing.assert_allclose(out0.numpy(), expected, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("key", SELF_EVAL)
def test_eval_equals_the_one_process_port(run, key):
    """The plain and use_pallas modules (the dispatcher's plain versions on
    the CPU, at 4 local heads) at data:2,model:2 against one process, both
    drawing x_T (and with eta > 0 the per-step noise) from a generator
    seeded alike."""
    out0 = run["ranks"][0][f"eval_self/{key}"]
    for res in run["ranks"][1:]:
        assert torch.equal(res[f"eval_self/{key}"], out0)
    np.testing.assert_allclose(out0.numpy(), run["one"]["eval"][key].numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["f32", "mixed"])
def test_fused_eval_runs_on_the_gathered_replica(run, mode):
    """The Runner's fused eval under a model axis runs a whole replica of
    the gathered weights: bit for bit the one-process fused eval where each
    rank runs the whole batch (data:1,model:2), and to 1e-5 where the data
    ranks split it (data:2,model:2)."""
    one = run["one"]["fused"][mode]
    for res in run["ranks"]:
        assert torch.equal(res[f"fused/{mode}/data:1,model:2"], one)
        np.testing.assert_allclose(res[f"fused/{mode}/{ranks.MESH}"].numpy(), one.numpy(),
                                   rtol=0, atol=1e-5)


def test_fit_equals_the_one_process_fit(run):
    """Runner.fit, 2 epochs of the plain module at global batch 16 with
    validation: four ranks at data:2,model:2 against one process, drawing
    from the same seeds, to f32 summation order (1e-5 relative)."""
    got = [res["fit"] for res in run["ranks"]]
    one = run["one"]["fit"]
    for k in ("losses_train", "losses_valid", "best_epoch", "min_loss"):
        assert all(g[k] == got[0][k] for g in got), k
    for k in ("losses_train", "losses_valid", "min_loss"):
        np.testing.assert_allclose(got[0][k], one[k], rtol=1e-5, err_msg=k)
    assert got[0]["best_epoch"] == one["best_epoch"]


def test_fit_writes_on_rank_0_only(run):
    fits = [res["fit"] for res in run["ranks"]]
    assert all(f["saves"] == [] and f["stdout"] == "" for f in fits[1:])
    assert {os.path.basename(p) for p in fits[0]["saves"]} >= {"epoch_0", "epoch_1", "best_epoch"}
    assert "Epoch: 1, Time(mins):" in fits[0]["stdout"]
    files = sorted(os.listdir(run["spec"]["fit_dir"]))
    assert {"epoch_0", "epoch_1", "best_epoch"} <= set(files)
    assert len([f for f in files if f.startswith("log_")]) == 1, files


def test_tensor_parallel_checkpoint_resumes_in_one_process(run):
    """The four-rank epoch_0 (the whole model and AdamW moments, gathered)
    resumed in one process: its epoch 1 against the four-rank run's."""
    fit0, resumed = run["ranks"][0]["fit"], run["one"]["resumed"]
    assert len(resumed["losses_train"]) == 1
    np.testing.assert_allclose(resumed["losses_train"], fit0["losses_train"][1:], rtol=1e-5)
    np.testing.assert_allclose(resumed["losses_valid"], fit0["losses_valid"][1:], rtol=1e-5)


def test_one_process_checkpoint_resumes_under_tensor_parallelism(run):
    """The one-process epoch_0 resumed at data:2,model:2 (every rank takes
    its shards of the model and of the moments): its epoch 1 against the
    one-process run's."""
    one = run["one"]["fit"]
    for res in run["ranks"]:
        resumed = res["resumed"]
        assert len(resumed["losses_train"]) == 1
        np.testing.assert_allclose(resumed["losses_train"], one["losses_train"][1:], rtol=1e-5)
        np.testing.assert_allclose(resumed["losses_valid"], one["losses_valid"][1:], rtol=1e-5)


def test_cli_evaluate_at_data_2_model_2_prints_one_report(run):
    """cli.run.main --evaluate --mesh-shape data:2,model:2 in the ranks'
    group: rank 0 prints the report, equal to the one-process run's; the
    other ranks print their INFO line naming both axes."""
    clis = [res["cli"] for res in run["ranks"]]
    for k, v in run["one"]["cli"].items():
        np.testing.assert_allclose(clis[0]["errors"][k], v, rtol=1e-5, err_msg=k)
        assert all(c["errors"][k] == clis[0]["errors"][k] for c in clis)
    assert "Protocol #1   (MPJPE) action-wise average:" in clis[0]["stdout"]
    for r, c in enumerate(clis):
        line = (f"INFO: mesh data:2,model:2 (data parallel x tensor parallel): world size 4, "
                f"backend gloo, rank {r} (data {r // 2}, model {r % 2}) on device cpu")
        assert line in c["stdout"]
        if r:
            assert c["stdout"].strip() == line


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fast_train_at_data_1_model_2_equals_the_one_process_port(run, dtype):
    """One AdamW step of the fused training path (``attn_bwd``, drop-path
    0.5, JAX's draws) at data:1,model:2: every rank gathers the whole
    weights, runs the one-process step on them, keeps its slices of the
    whole gradients and steps its shards. The loss, the gathered gradients
    and the updated whole weights are the one process's bit for bit."""
    one_loss, one_grads, one_params = run["one"][f"fast_train/{dtype}"]
    for res in run["ranks"]:
        loss, grads, params = res[f"fast_train/{dtype}"]
        assert torch.equal(loss, one_loss)
        assert list(grads) == list(one_grads) and list(params) == list(one_params)
        for name in one_grads:
            assert torch.equal(grads[name], one_grads[name]), name
            assert torch.equal(params[name], one_params[name]), name
    assert any(not torch.equal(one_params[n], w) for n, w in run["spec"]["weights"].items())


def test_fast_train_at_data_1_model_2_matches_jax_on_its_mesh(run):
    """The f32 step against JAX's ``make_train_step`` on
    ``make_mesh("data:1,model:2")`` (its jit path: the params sharded, XLA
    gathering them for the Pallas calls), JAX's draws injected:
    tests/test_torch_fast_train.py's bars, the loss to 1e-5 relative and
    each gradient to 2e-4 of its max."""
    jax_loss, jax_grads = run["jax"]["fast/f32"]
    loss, grads, _ = run["ranks"][0]["fast_train/f32"]
    assert abs(float(loss) - jax_loss) <= 1e-5 * abs(jax_loss)
    rel = _scaled_max(grads, jax_grads, 1e-8)
    assert max(rel.values()) < 2e-4, rel


def test_bf16_fast_train_at_data_1_model_2_is_within_jax_bf16_bar(run):
    """The bf16 step against JAX's bf16 step on its "data:1,model:2" mesh
    (compiled with excess precision off), on JAX's draws, at
    tests/test_torch_bf16_train.py's gradient bar: the mean deviation over
    every gradient, each scaled by max|JAX's f32 gradient| (JAX's f32 step
    on the same mesh), from JAX-bf16 at most 0.6 of JAX-bf16's own from
    JAX-f32, and from JAX-f32 between 0.5 and 1.0 of it; the loss to 1e-2
    relative of JAX-bf16's."""
    names = list(run["jax"]["fast/f32"][1])
    jax16, jax32 = ([g[n] for n in names] for g in (run["jax"]["fast/bf16"][1],
                                                    run["jax"]["fast/f32"][1]))
    loss, grads, _ = run["ranks"][0]["fast_train/bf16"]
    got = [grads[n].numpy() for n in names]
    theirs = deviation(jax16, jax32, jax32)
    to_jax16 = deviation(got, jax16, jax32) / theirs
    to_jax32 = deviation(got, jax32, jax32) / theirs
    assert theirs > 0 and to_jax16 <= 0.6 and 0.5 <= to_jax32 <= 1.0, (to_jax16, to_jax32)
    jax_loss = run["jax"]["fast/bf16"][0]
    assert abs(float(loss) - jax_loss) <= 1e-2 * abs(jax_loss)


def test_fast_fit_at_data_1_model_2_equals_the_one_process_fit(run):
    """``Runner.fit`` with fast_train at data:1,model:2 (2 epochs of 6
    steps, a checkpoint each, no validation), then resumed from its own
    epoch_0: each pair's losses, its resumed epoch and its final whole
    weights are the one process's bit for bit (the replica is loaded from
    the shards before every step, after the resume too)."""
    one = run["one"]["fast_fit"]
    assert len(one["losses"]) == 2 and one["resumed"] == one["losses"][1:]
    for res in run["ranks"]:
        got = res["fast_fit"]
        assert got["losses"] == one["losses"] and got["resumed"] == one["resumed"]
        assert list(got["state"]) == list(one["state"])
        for name, value in one["state"].items():
            assert torch.equal(got["state"][name], value), name


@pytest.mark.parametrize("mode", list(ranks.FUSED))
def test_sharded_export_under_a_model_axis_equals_the_live_step(run, mode):
    """The Runner's fused eval exported sharded at data:2,model:2 (global
    batch 4, local 2): rank 0 writes it, its metadata records both axes and
    the global batch, and each rank's restore on the whole weights equals
    its live ``runner.eval_step`` bit for bit."""
    exports = [res[f"export/{mode}"] for res in run["ranks"]]
    assert exports[0]["bytes"] > 0 and all(e["bytes"] is None for e in exports[1:])
    for e in exports:
        assert e["meta"]["sharded"] == dict(world_size=WORLD, data=2, model=2, global_batch=B)
        assert e["meta"]["batch_size"] == B // 2
        assert e["served"].shape == (B, F, J, 3)
        assert torch.equal(e["served"], e["live"])
        assert torch.equal(e["served"], exports[0]["served"])


def test_sharded_export_under_a_model_axis_matches_jax(run):
    """The restored f32 and mixed artifacts against JAX's sharded artifacts
    of the same mesh (its Runner at data:2,model:2), JAX's x_T injected:
    f32 within 1e-4 absolute; mixed no farther from JAX's f32 artifact than
    1.5x JAX's mixed one, + 1e-4."""
    f32, mixed = (run["ranks"][0][f"export/{m}"]["served"].numpy() for m in ("f32", "mixed"))
    jax_f32, jax_mixed = run["jax"]["export/f32"], run["jax"]["export/mixed"]
    assert jax_f32.shape == f32.shape == (B, F, J, 3)
    np.testing.assert_allclose(f32, jax_f32, rtol=0, atol=1e-4)
    dev_port, dev_jax = np.abs(mixed - jax_f32).max(), np.abs(jax_mixed - jax_f32).max()
    assert dev_port <= 1.5 * dev_jax + 1e-4, (dev_port, dev_jax)


def test_sharded_export_refuses_another_mesh_shape(run):
    """The data:2,model:2 artifact restored under data:4 on the same four
    ranks, and in one process, raises a ValueError naming both shapes."""
    want = r"^this eval step was exported for mesh_shape 'data:2,model:2' \(4 rank\(s\)\)"
    for res in run["ranks"]:
        assert re.search(want + r".*restored under mesh_shape 'data:4,model:1' \(4 rank",
                         res["export/data:4"] or ""), res["export/data:4"]
    assert re.search(want + ".*restored in one process", run["one"]["restore_sharded"] or ""), \
        run["one"]["restore_sharded"]


def test_cli_export_sharded_at_data_2_model_2(run):
    """cli.export --export-sharded --mesh-shape data:2,model:2 in the
    ranks' group: rank 0 writes the artifact and prints its line (2 rows a
    rank of 4 ranks), the other ranks print nothing; restored in every
    rank, the prediction is the same on each."""
    clis = [res["export/cli"] for res in run["ranks"]]
    assert "per rank 2 rows of 4 ranks (data:2,model:2)" in clis[0]["stdout"]
    assert "Exported eval step ->" in clis[0]["stdout"]
    assert all("Exported" not in c["stdout"] for c in clis[1:])
    for c in clis:
        assert c["meta"]["sharded"] == dict(world_size=WORLD, data=2, model=2, global_batch=B)
        assert torch.isfinite(c["served"]).all() and c["served"].shape == (B, F, J, 3)
        assert torch.equal(c["served"], clis[0]["served"])


TINY = dict(embed_dim=32, transformer_depth=1, number_of_frames=9)


@pytest.mark.parametrize("fields,world,field", [
    (dict(num_heads=6, mesh_shape="data:1,model:4"), 4, "num_heads=6"),
    (dict(num_heads=4, mlp_ratio=1.03125, mesh_shape="data:1,model:4"), 4, "mlp_ratio"),
    (dict(num_heads=8, mesh_shape="data:2,model:2"), 2, "mesh_shape="),
    (dict(num_heads=8, mesh_shape="data:2,model:2"), 8, "mesh_shape="),
])
def test_refusals_name_their_field(fields, world, field):
    """M dividing neither the heads nor the hidden width, and N·M other than
    the world size, raise a ValueError naming the field (and mesh_shape)."""
    with pytest.raises(ValueError, match=field) as e:
        check_supported(Config(**TINY, **fields), "cpu", world)
    assert "mesh_shape=" in str(e.value)


@pytest.mark.parametrize("spec,world,refused", [
    ("data:2,model:2", 4, True), ("data:1,model:4", 4, False), ("model:2", 2, False),
    ("data:4,model:2", 8, True), ("data:1,model:2", 2, False)])
def test_fast_train_refuses_a_model_axis(spec, world, refused):
    """fast_train beside a data axis > 1 raises, naming fast_train and
    mesh_shape, as JAX's train step does; at a data axis of 1 it trains on
    whole weights gathered from the shards. The plain module trains under
    every mesh."""
    cfg = Config(**TINY, num_heads=8, mesh_shape=spec, fast_train=True)
    check_mesh_shape(spec, world)
    check_supported(cfg, "cpu", world)
    if refused:
        with pytest.raises(ValueError, match="^fast_train=True.*mesh_shape="):
            check_trainable(cfg, "cpu", world)
    else:
        check_trainable(cfg, "cpu", world)
    check_trainable(Config(**TINY, num_heads=8, mesh_shape=spec), "cpu", world)
