"""The port's data parallelism (``diff3dhpe_torch/parallel``, the ``mesh``
of ``engine.steps``, ``Runner``, the CLI and the sharded export) on the
CPU: two ranks of one gloo group, spawned once for the module
(tests/torch_parallel_ranks.py, which imports no JAX), run every case;
this process meanwhile builds JAX's references on its virtual 8-device
mesh (``make_mesh("data:2")``) and the one-process port's, then each test
reads what the ranks saved.

Bars: the eval against JAX as tests/test_torch_eval.py's (rtol 1e-4, atol
1e-4; JAX's x_T rebuilt by ``jax_x_init`` and injected as the global x_T),
the train step as tests/test_torch_fast_train.py's (loss 1e-5 relative,
each gradient to 2e-4 of its max), the two-rank eval against the
one-process port 1e-5 absolute (JAX's own mesh-invariance bar,
tests/test_parallel.py:158-159), the two-rank train step against the
one-process one 1e-5 relative (f32 sums in another order), and every
cross-rank and export comparison bit for bit."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_ranks as ranks
from diff3dhpe_torch.config import Config
from diff3dhpe_torch.engine import flip_pose
from diff3dhpe_torch.engine.runner import Runner, check_supported, check_trainable
from diff3dhpe_torch.io import state_dict_from_flax
from diff3dhpe_torch.io.export import restore_eval_step
from diff3dhpe_torch.parallel import DataMesh, check_mesh_shape, parse_mesh_shape
from diff3dhpe_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from diff3dhpe_tpu.engine import build_train_state
from diff3dhpe_tpu.engine import make_eval_step as jax_make_eval_step
from diff3dhpe_tpu.engine import make_train_step as jax_make_train_step
from diff3dhpe_tpu.engine.steps import make_denoise_fn as jax_make_denoise_fn
from diff3dhpe_tpu.engine.steps import make_fast_denoise_fn as jax_make_fast_denoise_fn
from diff3dhpe_tpu.engine.steps import make_fast_train_denoise_fn as jax_make_fast_train_fn
from diff3dhpe_tpu.engine.steps import make_optimizer as jax_make_optimizer
from diff3dhpe_tpu.models import fast_eval as jax_fast
from diff3dhpe_tpu.parallel import make_mesh
from torch_port_helpers import build_pair, jax_x_init
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

WORLD, B = 2, 4
F, J = ranks.F, ranks.J
JL, JR = ranks.JOINTS_LEFT, ranks.JOINTS_RIGHT
SELF_EVAL = ["plain/2/0.0", "fused/1/0.0", "plain/1/0.5"]  # module / repeat_n / eta
JOIN_S = 300  # a hung rank fails its test; each rank's collectives time out at 120 s


def _keeping_grads(opt):
    """``opt`` whose state also holds the gradients of its last update."""
    def init(params):
        return opt.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _jax_train(diffusion, params, key, gt, x2d, mesh):
    """(loss, gradients as a state dict) of JAX's train step on ``mesh``."""
    opt = _keeping_grads(jax_make_optimizer(ranks.LR, 0.99, steps_per_epoch=10))
    state = build_train_state(jax.tree.map(jnp.asarray, params), opt)
    state, loss = jax_make_train_step(diffusion, opt, mesh=mesh)(state, key, jnp.asarray(gt),
                                                                 jnp.asarray(x2d))
    grads = state_dict_from_flax(jax.tree.map(np.asarray, state.opt_state[1]), ranks.DEPTH)
    return float(loss), {k: v.numpy() for k, v in grads.items()}


def _jax_draws(key, rows, gt_shape, per_shard):
    """The t and noise (and, ``per_shard``, the drop-path scales) that JAX's
    train step draws on ``data:2``: from split(key) on the SPMD path
    (engine/steps.py:298), or on the shard_map path from
    split(fold_in(key, shard)) for each shard's rows (:260-261), then
    p_losses's split (diffusion/gaussian_diffusion.py:147-150) and
    draw_drop_path_scales, concatenated in rank order."""
    keys = [jax.random.fold_in(key, i) for i in range(WORLD)] if per_shard else [key]
    t, noise, sp, tp = [], [], [], []
    for k in keys:
        diff_key, dropout_key = jax.random.split(k)
        key_t, key_noise = jax.random.split(diff_key)
        n = rows // len(keys)
        t.append(np.asarray(jax.random.randint(key_t, (n,), 0, ranks.TRAIN_KW["timesteps"])))
        noise.append(np.asarray(jax.random.normal(key_noise, (n,) + gt_shape[1:], jnp.float32)))
        if per_shard:
            dp = jax_fast.draw_drop_path_scales(dropout_key, n, ranks.DEPTH, ranks.DROP_PATH,
                                                num_frame=F, num_joints=J)
            sp.append(np.asarray(dp[0]))
            tp.append(np.asarray(dp[1]))
    draws = dict(t=torch.from_numpy(np.concatenate(t)),
                 noise=torch.from_numpy(np.concatenate(noise)))
    if per_shard:
        draws["dp_scales"] = (torch.from_numpy(np.concatenate(sp, 1)),
                              torch.from_numpy(np.concatenate(tp, 1)))
    return draws


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawns the ranks, builds the references while they run, joins them.
    Returns dict(ranks=[rank results], jax=..., one=... (the one-process
    port), spec=...)."""
    tmp = tmp_path_factory.mktemp("parallel")
    model, params, port = build_pair(np.random.default_rng(15), num_frame=F,
                                     embed_dim=ranks.EMBED, depth=ranks.DEPTH,
                                     num_heads=ranks.HEADS)
    rng = np.random.default_rng(0)
    x2d = torch.from_numpy(rng.uniform(-1, 1, (B, F, J, 2)).astype(np.float32))
    gt = torch.from_numpy(rng.standard_normal((B, F, J, 3)).astype(np.float32))
    key_eval, key_train = jax.random.PRNGKey(7), jax.random.PRNGKey(11)
    x_inits = {r: torch.from_numpy(jax_x_init(key_eval, 2 * B * r, (F, J, 3))) for r in (1, 2)}
    weights = {k: v.detach().clone() for k, v in port.state_dict().items()}
    torch.save(weights, tmp / "w.bin")
    spec = dict(weights=weights, weights_path=str(tmp / "w.bin"), x2d=x2d,
                x2d_flip=flip_pose(x2d, JL, JR), gt=gt,
                jax_x_init={f"{m}/{r}": x_inits[r] for m in ("plain", "fused") for r in (1, 2)},
                self_eval=SELF_EVAL,
                jax_train_draws={"plain": _jax_draws(key_train, B, tuple(gt.shape), False),
                                 "fast": _jax_draws(key_train, B, tuple(gt.shape), True)},
                fit_dir=str(tmp / "fit"), artifact=str(tmp / "eval_sharded.pt2"))
    torch.save(spec, tmp / "spec.pt")

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ranks.run_rank, daemon=True,
                         args=(r, WORLD, str(tmp / "rendezvous"), str(tmp / "spec.pt"), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # JAX on data:2 (its plain paths under sharding constraints, its
        # fused ones under shard_map), while the ranks run.
        mesh = make_mesh("data:2")
        jax_eval = {}
        with jax.default_matmul_precision("highest"):
            for m in ("plain", "fused"):
                fn = jax_make_denoise_fn(model) if m == "plain" else jax_make_fast_denoise_fn(
                    num_frame=F, num_joints=J, depth=ranks.DEPTH, num_heads=ranks.HEADS,
                    dtype=jnp.float32)
                diffusion = JaxDiffusion.create(fn, **ranks.EVAL_KW)
                for r in (1, 2):
                    step = jax_make_eval_step(diffusion, JL, JR, mesh=mesh, repeat_n=r)
                    jax_eval[f"{m}/{r}"] = np.asarray(step(params, key_eval, x2d.numpy(),
                                                           spec["x2d_flip"].numpy()))
            fast_fn = jax_make_fast_train_fn(num_frame=F, num_joints=J, depth=ranks.DEPTH,
                                             num_heads=ranks.HEADS, dtype=jnp.float32,
                                             drop_path_rate=ranks.DROP_PATH)
            jax_train = {
                key: _jax_train(JaxDiffusion.create(fn, **ranks.TRAIN_KW), params, key_train,
                                gt.numpy(), x2d.numpy(), mesh)
                for key, fn in (("plain", jax_make_denoise_fn(model)), ("fast", fast_fn))}
        # The one-process port on the same inputs and generator seeds.
        one = dict(eval={}, train=ranks.run_train(weights, True, (gt, x2d), seed=4))
        for key in SELF_EVAL:
            m, r, eta = key.split("/")
            one["eval"][key] = ranks.eval_step(ranks.model(weights), m == "fused", int(r),
                                               eta=float(eta))(
                x2d, spec["x2d_flip"], generator=torch.Generator().manual_seed(3))
        runner, train_ds, val_ds = ranks.fit_runner(tmp / "fit_one")
        one["fit"] = ranks.fit_summary(runner.fit(train_ds, val_ds))
        one["cli"] = {k: [float(e) for e in v] for k, v in ranks.cli_main_one(
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
    # The two-rank epoch_0 resumed in one process.
    runner, train_ds, val_ds = ranks.fit_runner(tmp / "fit_resumed")
    one["resumed"] = ranks.fit_summary(runner.fit(train_ds, val_ds,
                                                  resume=str(tmp / "fit" / "epoch_0")))
    return dict(ranks=[res["cases"] for res in results], meshes=[res["mesh"] for res in results],
                jax=dict(eval=jax_eval, train=jax_train), one=one, spec=spec, tmp=tmp)


def test_ranks_start_on_gloo(run):
    assert run["meshes"] == [f"DataMesh(rank={r}, size={WORLD}, backend='gloo', device='cpu')"
                             for r in range(WORLD)]


@pytest.mark.parametrize("key", ["plain/1", "plain/2", "fused/1", "fused/2"])
def test_eval_matches_jax_on_its_data_mesh(run, key):
    """Two ranks' flip-TTA eval (the module, or the fused f32 forward;
    repeat_n 1 and 2) gathered, against JAX's make_eval_step on data:2 on
    the same weights and x_T. Every rank holds the whole prediction."""
    out0, out1 = (res[f"eval_jax/{key}"] for res in run["ranks"])
    assert torch.equal(out0, out1)
    expected = run["jax"]["eval"][key]
    assert out0.shape == expected.shape == (B, F, J, 3)
    np.testing.assert_allclose(out0.numpy(), expected, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("key", SELF_EVAL)
def test_eval_equals_the_one_process_port(run, key):
    """Both draw from a generator seeded alike: the ranks draw the global
    x_T (and with eta > 0 the per-step noise) and keep their rows, so the
    prediction does not depend on the world size."""
    out0, out1 = (res[f"eval_self/{key}"] for res in run["ranks"])
    assert torch.equal(out0, out1)
    np.testing.assert_allclose(out0.numpy(), run["one"]["eval"][key].numpy(), rtol=0, atol=1e-5)


def _grad_rel(grads, expected):
    assert set(grads) == set(expected)
    return {n: float(np.abs(grads[n].numpy() - g).max() / (np.abs(g).max() + 1e-8))
            for n, g in expected.items()}


@pytest.mark.parametrize("key", ["plain", "fast"])
def test_train_step_matches_jax_on_its_data_mesh(run, key):
    """One step at global batch 4 on two ranks, against JAX's train step on
    data:2: the plain module (drop-path 0) against the SPMD path, and
    fast_train (drop-path 0.5) against the shard_map path, whose per-shard
    draws are injected as the global ones in rank order. Gradients, not
    post-AdamW parameters (tests/test_parallel.py:62-68)."""
    loss, grads, _ = run["ranks"][0][f"train_jax/{key}"]
    jax_loss, jax_grads = run["jax"]["train"][key]
    assert abs(float(loss) - jax_loss) <= 1e-5 * abs(jax_loss)
    rel = _grad_rel(grads, jax_grads)
    assert max(rel.values()) < 2e-4, rel


def test_train_step_equals_the_one_process_port(run):
    """The fast-train step with drop-path, both drawing from a generator
    seeded alike: the ranks draw the global batch's t, noise and scales and
    keep their rows; the gradients averaged over the ranks are the one
    process's up to f32 summation order."""
    loss, grads, _ = run["ranks"][0]["train_self"]
    one_loss, one_grads, _ = run["one"]["train"]
    assert abs(float(loss) - float(one_loss)) <= 1e-5 * abs(float(one_loss))
    rel = _grad_rel(grads, {k: v.numpy() for k, v in one_grads.items()})
    assert max(rel.values()) < 1e-5, rel


@pytest.mark.parametrize("key", ["train_jax/plain", "train_jax/fast", "train_self"])
def test_ranks_given_other_rows_end_with_equal_parameters(run, key):
    """Each rank ran other rows; the averaged gradients (no module wrapper,
    so nothing can leave them unreduced) give every rank the same step."""
    (loss0, grads0, params0), (loss1, grads1, params1) = (res[key] for res in run["ranks"])
    assert torch.equal(loss0, loss1)
    for name in params0:
        assert torch.equal(grads0[name], grads1[name]), name
        assert torch.equal(params0[name], params1[name]), name
    assert any(not torch.equal(params0[n], ranks.model(run["spec"]["weights"]).state_dict()[n])
               for n in params0)


def test_indivisible_batches_raise(run):
    """Global batch 3 on two ranks: eval and train raise "does not divide",
    as JAX's shard_map paths do (tests/test_parallel.py:162-197); the port
    raises on every path, where JAX's plain path lets XLA pad."""
    for res in run["ranks"]:
        assert res["indivisible"] == dict(eval=True, train=True)


def test_fit_equals_the_one_process_fit(run):
    """Runner.fit, 2 epochs of fast_train at global batch 16 with
    validation: two ranks against one process, drawing from the same
    seeds, to f32 summation order (1e-5 relative)."""
    got0, got1 = (res["fit"] for res in run["ranks"])
    one = run["one"]["fit"]
    for k in ("losses_train", "losses_valid", "best_epoch", "min_loss"):
        assert got0[k] == got1[k], k
    for k in ("losses_train", "losses_valid", "min_loss"):
        np.testing.assert_allclose(got0[k], one[k], rtol=1e-5, err_msg=k)
    assert got0["best_epoch"] == one["best_epoch"]


def test_fit_writes_on_rank_0_only(run):
    """Rank 0 writes the checkpoints (epoch_0, epoch_1, and best_epoch at
    each new best) and the logs; rank 1 writes and prints nothing."""
    fit0, fit1 = (res["fit"] for res in run["ranks"])
    fit_dir = run["spec"]["fit_dir"]
    assert fit1["saves"] == [] and fit1["stdout"] == ""
    assert {os.path.basename(p) for p in fit0["saves"]} >= {"epoch_0", "epoch_1", "best_epoch"}
    assert "Epoch: 1, Time(mins):" in fit0["stdout"]
    files = sorted(os.listdir(fit_dir))
    assert {"epoch_0", "epoch_1", "best_epoch"} <= set(files)
    assert len([f for f in files if f.startswith("log_")]) == 1, files


def test_two_rank_checkpoint_resumes_in_one_process(run):
    """The two-rank run's epoch_0 (a state dict as any world size writes
    it) resumed in one process: its epoch 1 against the two-rank run's, to
    f32 summation order (1e-5 relative, chip_smoke phase 11's resume bar)."""
    fit0, resumed = run["ranks"][0]["fit"], run["one"]["resumed"]
    assert len(resumed["losses_train"]) == 1
    np.testing.assert_allclose(resumed["losses_train"], fit0["losses_train"][1:], rtol=1e-5)
    np.testing.assert_allclose(resumed["losses_valid"], fit0["losses_valid"][1:], rtol=1e-5)


def test_cli_evaluate_in_two_ranks_prints_one_report(run):
    """cli.run.main --evaluate --mesh-shape data:2 in the ranks' group:
    rank 0 prints the report, which equals the one-process run's, and rank
    1 prints only its INFO line."""
    cli0, cli1 = (res["cli"] for res in run["ranks"])
    for k, v in run["one"]["cli"].items():
        np.testing.assert_allclose(cli0["errors"][k], v, rtol=1e-5, err_msg=k)
        assert cli1["errors"][k] == cli0["errors"][k]
    assert "Protocol #1   (MPJPE) action-wise average:" in cli0["stdout"]
    assert "INFO: data parallel: world size 2, backend gloo, rank 0 on device cpu" in cli0["stdout"]
    assert cli1["stdout"].strip() == ("INFO: data parallel: world size 2, backend gloo, rank 1 on "
                                      "device cpu")


def test_sharded_export_round_trip(run):
    """Rank 0 writes the per-rank program (local batch 2 of global 4); each
    rank restores it, runs its rows of the global inputs and gathers: bit
    for bit the live two-rank step."""
    e0, e1 = (res["export"] for res in run["ranks"])
    assert e0["bytes"] > 0 and e1["bytes"] is None
    assert e0["meta"] == e1["meta"] == dict(world_size=WORLD, data=WORLD, model=1,
                                            global_batch=B)
    for e in (e0, e1):
        assert e["served"].shape == (B, F, J, 3)
        assert torch.equal(e["served"], e["live"])
    assert torch.equal(e0["served"], e1["served"])


def test_sharded_export_refuses_another_world_size(run):
    with pytest.raises(ValueError, match=r"exported for mesh_shape 'data:2,model:1' \(2 "
                                         r"rank\(s\)\).*restored in one process"):
        restore_eval_step(run["spec"]["artifact"])


def test_check_replicated(run):
    """Weights that differ on one rank raise on every rank."""
    for res in run["ranks"]:
        assert res["replicated"] == dict(same=True, differing_raised=True)


@pytest.mark.parametrize("spec,world,ok", [
    (None, 2, True), ("data:2", 2, True), (" data:2 ", 2, True), ("data:2,model:1", 2, True),
    ("data:1", 1, True), ("data:2,model:2", 2, False), ("data:4", 2, False),
    ("data:1", 2, False), ("model:2", 1, False),
    ("data:2,model:2", 4, True), ("model:2", 2, True), ("data:1,model:2", 2, True),
])
def test_mesh_shape_against_the_world_size(spec, world, ok):
    """check_supported takes "data:N,model:M" where N·M is the world size
    and refuses any other size, naming mesh_shape: "data:2,model:2" needs 4
    ranks and "model:2" 2, so each is refused at a world of 2 and 1."""
    cfg = Config(mesh_shape=spec, embed_dim=32, transformer_depth=1, num_heads=4,
                 number_of_frames=9)
    if ok:
        check_mesh_shape(spec, world)
        check_supported(cfg, "cpu", world)
    else:
        with pytest.raises(ValueError, match="^mesh_shape="):
            check_supported(cfg, "cpu", world)


@pytest.mark.parametrize("spec", ["x:2", "data:0", "data:two", "data"])
def test_malformed_mesh_shape(spec):
    with pytest.raises(ValueError, match="^mesh_shape="):
        parse_mesh_shape(spec, 2)


MIXED = dict(fast_eval=True, compute_dtype="bfloat16", eval_f32_final_steps=1,
             eval_f32_head=True)


@pytest.mark.parametrize("fields", [
    {}, dict(use_pallas_attention=True), dict(fast_eval=True),
    dict(fast_eval=True, compute_dtype="bfloat16"), MIXED, dict(MIXED, eval_f32_tail_pairs=1),
    dict(fast_train=True), dict(fast_train=True, compute_dtype="bfloat16"),
    dict(fast_train=True, fast_train_attn_bwd=True),
    dict(fast_train=True, fast_train_pair_vjp=False),
])
def test_data_axis_is_taken_on_every_path(fields):
    """"data:4" with 4 ranks, for the module, use_pallas, the fused evals
    (f32, bf16, mixed, the tail) and fast_train (f32, bf16, attn_bwd, the
    monolithic backward), at a CUDA device's checks too."""
    cfg = Config(mesh_shape="data:4", embed_dim=256, transformer_depth=1, num_heads=4,
                 number_of_frames=9, **fields)
    for device in ("cpu", "cuda"):
        (check_trainable if cfg.fast_train else check_supported)(cfg, device, 4)


def test_shard_keeps_the_rank_rows_of_every_group():
    """x_T of B = 4 rows, flip-TTA and repeat_n 2 on two ranks: rank 1
    keeps rows h·8 + s·4 + [2, 3] for each hypothesis h and half s; the
    gather puts the rows back in rank order."""
    mesh = DataMesh.__new__(DataMesh)
    mesh.rank, mesh.size = 1, 2
    x = torch.arange(16).reshape(16, 1)
    assert mesh.rows(4) == slice(2, 4)
    assert mesh.shard(x, 4).flatten().tolist() == [2, 3, 6, 7, 10, 11, 14, 15]
    noises = torch.arange(32).reshape(2, 16)
    assert mesh.shard(noises, 4, dim=1).tolist() == [[2, 3, 6, 7, 10, 11, 14, 15],
                                                     [18, 19, 22, 23, 26, 27, 30, 31]]
    with pytest.raises(ValueError, match="does not divide"):
        mesh.rows(3)


def test_runner_in_one_process_has_no_mesh():
    runner = Runner(Config(embed_dim=32, transformer_depth=1, num_heads=4, number_of_frames=9),
                    J, JL, JR, device="cpu")
    assert runner.mesh is None and runner.world_size == 1 and runner.is_main
