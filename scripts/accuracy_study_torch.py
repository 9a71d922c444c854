"""Accuracy study of the PyTorch port: eval-path deviations on TRAINED weights.

Port of ``scripts/accuracy_study.py`` (the JAX package's study, which stays
as it is). Trains the flagship-shaped 243-frame model on the synthetic
``motion="latent"`` lifting task through the port's ``Runner.fit`` (or
reuses the checkpoint of an earlier run), then evaluates the SAME weights
through every eval path of the port under the same x_T, and gates each
against the plain f32 module (``plain_f32``) with the JAX study's rule
(``compute_gate``: |delta| <= 0.1 mm AND <= 0.5% of the baseline, on each
of e1, e2, e3 and ev). It reports (a) the full test protocol's metrics and
(b) raw per-prediction deviations on a fixed test and a fixed val batch.

JAX draws x_T per row from folded PRNG keys, which torch cannot reproduce,
so every variant's x_T comes from numpy (``x_t``): one draw per test batch
from ``np.random.default_rng([NOISE_SEED, 0, batch])``, and one per fixed
batch. A variant with ``repeat_n`` hypotheses draws repeat_n times the rows,
the first hypothesis's equal to the other variants' draw.

Run on the card:  python scripts/accuracy_study_torch.py
Knobs (as the JAX script's): STUDY_EPOCHS (100), STUDY_FRAMES (243),
STUDY_EMBED (512), STUDY_DEPTH (8), STUDY_BATCH (8), STUDY_ACTIONS (8),
STUDY_DDIM (9), STUDY_HEADS (8; other counts write *_h{H} files),
STUDY_VARIANTS (a comma-separated subset; plain_f32 always runs),
STUDY_REUSE (1: reuse a finished checkpoint), STUDY_FRESH (1: re-run every
variant; a run that trains re-runs them too), STUDY_TRAIN_DTYPE
(bfloat16). Added here: STUDY_ATTN_BWD (1: train with the attention
backward kernels, fast_train_attn_bwd; 0: fast_train alone, as JAX's study
trained, into *_no_attn_bwd files), STUDY_DIR (where the checkpoint, the per-variant
npz files and the JSON go; default scripts/), STUDY_DEVICE (cuda; cpu for
tests) and STUDY_MAX_MINUTES (stop training after the first epoch that
ends past it; the JSON records the epochs run).
A run that was cut resumes: training from its newest checkpoint (until
``train_done.json`` marks it finished), the variants from their npz files.
"""
from __future__ import annotations

import glob
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# The gate, as scripts/accuracy_study.py:50-115 defines it: both budgets on
# every protocol metric, each against its own baseline value.
ABS_BUDGET_MM, REL_BUDGET = 0.1, 0.005
GATED_METRICS = ("e1", "e2", "e3", "ev")
# Variants at another operating point (multi-hypothesis averaging is meant
# to move the metric) are reported but not gated.
NON_GATED_PREFIXES = ("rep",)
BASELINE = "plain_f32"
# scripts/accuracy_study.json: JAX's best validation MPJPE on the same task
# and shape after 100 epochs of bf16 training on a TPU v5e.
JAX_BEST_VAL_MPJPE_MM = 7.824626169167459
NOISE_SEED = 123

# (name, Config patch, JAX counterpart). Every variant evaluates at DDIM-9.
VARIANTS = (
    ("plain_f32", dict(fast_eval=False, compute_dtype="float32"), "flax_f32"),
    ("pallas_f32", dict(fast_eval=False, compute_dtype="float32", use_pallas_attention=True),
     None),
    ("fast_f32", dict(fast_eval=True, compute_dtype="float32"), "fast_f32_mxhighest"),
    # Every step's f32 fused forward at the contraction mode "default"
    # (F32_PREC below; JAX's DIFF_FUSED_F32_PREC=default).
    ("fast_f32_mxdefault", dict(fast_eval=True, compute_dtype="float32"), "fast_f32_mxdefault"),
    ("fast_bf16", dict(fast_eval=True, compute_dtype="bfloat16"), "fast_bf16"),
    ("fast_bf16_f32head", dict(fast_eval=True, compute_dtype="bfloat16", eval_f32_head=True),
     "fast_bf16_f32head"),
    ("fast_mixed1", dict(fast_eval=True, compute_dtype="bfloat16", eval_f32_head=True,
                         eval_f32_final_steps=1, eval_final_prec="high3"), "fast_mixed1_h3"),
    ("fast_mixed1_default", dict(fast_eval=True, compute_dtype="bfloat16", eval_f32_head=True,
                                 eval_f32_final_steps=1, eval_final_prec="default"),
     "fast_mixed1"),
    ("fast_mixed2", dict(fast_eval=True, compute_dtype="bfloat16", eval_f32_head=True,
                         eval_f32_final_steps=2, eval_final_prec="high3"), "fast_mixed2_hx"),
    ("fast_f32_rep4", dict(fast_eval=True, compute_dtype="float32", repeat_n=4),
     "fast_f32_rep4"),
    # The float32 tail of the final step's forward (JAX's fails the gate at
    # every depth: scripts/accuracy_study.json).
    *((f"fast_mixed1_h3_tail{k}", dict(fast_eval=True, compute_dtype="bfloat16",
                                       eval_f32_head=True, eval_f32_final_steps=1,
                                       eval_final_prec="high3", eval_f32_tail_pairs=k),
       f"fast_mixed1_h3_tail{k}") for k in (6, 4, 2)),
)
# The contraction mode of a float32 fused eval, where a variant's is not
# "highest": the Config's eval_final_prec reaches only the mixed mode's
# final steps, so the study passes it to the f32 forward itself.
F32_PREC = {"fast_f32_mxdefault": "default"}
# JAX's table (scripts/accuracy_study.json), whose gate verdicts the
# table sets beside the port's.
JAX_TABLE = os.path.join(ROOT, "scripts", "accuracy_study.json")


def is_gated(name: str) -> bool:
    return not any(p in name for p in NON_GATED_PREFIXES)


def compute_gate(results, baseline):
    """Pass/fail per eval path against the ``plain_f32`` baseline: JAX's
    ``compute_gate`` (scripts/accuracy_study.py:76-115), whose baseline
    path is named ``flax_f32``.

    results: {path_name: {"e1": mm, "e2": mm, "e3": mm, "ev": mm}};
    ``baseline``: the plain_f32 metrics dict (a bare float is an e1-only
    baseline). Every metric of GATED_METRICS present in both is gated by
    |delta| <= ABS_BUDGET_MM and <= REL_BUDGET of that metric's baseline;
    a path passes only if all its metrics pass."""
    if not isinstance(baseline, dict):
        baseline = {"e1": float(baseline)}
    gate = {}
    for k, r in results.items():
        if k == BASELINE or not is_gated(k):
            continue
        row, all_pass = {}, True
        for m in GATED_METRICS:
            if m not in baseline or m not in r:
                continue
            base = baseline[m]
            delta = r[m] - base
            ok = bool(abs(delta) <= ABS_BUDGET_MM and abs(delta) <= REL_BUDGET * base)
            row[m] = dict(
                delta_mm=round(delta, 5),
                delta_rel=round(delta / base, 6),
                passes_abs=bool(abs(delta) <= ABS_BUDGET_MM),
                passes_rel=bool(abs(delta) <= REL_BUDGET * base),
                passes=ok,
            )
            all_pass = all_pass and ok
        # e1's fields at the top level, as in JAX's table.
        gate[k] = dict(row.get("e1", {}), metrics=row, passes_all=all_pass)
        if "passes" in gate[k]:
            gate[k]["passes_e1"] = gate[k]["passes"]
            gate[k]["passes"] = all_pass
    return gate


def settings(env=None) -> dict:
    """The study's settings from the STUDY_* knobs."""
    env = os.environ if env is None else env
    get = lambda name, default: env.get(name, default)
    heads = int(get("STUDY_HEADS", "8"))
    attn_bwd = get("STUDY_ATTN_BWD", "1") == "1"
    max_minutes = get("STUDY_MAX_MINUTES", "")
    return dict(
        frames=int(get("STUDY_FRAMES", "243")),
        embed=int(get("STUDY_EMBED", "512")),
        depth=int(get("STUDY_DEPTH", "8")),
        epochs=int(get("STUDY_EPOCHS", "100")),
        batch=int(get("STUDY_BATCH", "8")),
        actions=int(get("STUDY_ACTIONS", "8")),
        ddim=int(get("STUDY_DDIM", "9")),
        heads=heads,
        attn_bwd=attn_bwd,
        variants=[v for v in get("STUDY_VARIANTS", "").split(",") if v],
        reuse=get("STUDY_REUSE", "1") == "1",
        fresh=get("STUDY_FRESH", "0") == "1",
        train_dtype=get("STUDY_TRAIN_DTYPE", "bfloat16"),
        out_dir=get("STUDY_DIR", os.path.join(ROOT, "scripts")),
        device=get("STUDY_DEVICE", "cuda"),
        max_minutes=float(max_minutes) if max_minutes else None,
        suffix=("" if heads == 8 else f"_h{heads}") + ("" if attn_bwd else "_no_attn_bwd"),
    )


def study_config(s, checkpoint: str):
    """The training Config of scripts/accuracy_study.py:126-153."""
    from diff3dhpe_torch.config import Config

    cfg = Config(
        number_of_frames=s["frames"], stride=s["frames"], embed_dim=s["embed"],
        transformer_depth=s["depth"], timesteps=1000, sampling_timesteps=5,
        batch_size=s["batch"], batch_size_eval=4 * s["batch"], epochs=s["epochs"],
        num_heads=s["heads"], learning_rate=4e-4, subjects_train="S1,S5", subjects_test="S9",
        checkpoint=checkpoint, patience=s["epochs"],
        # The fused training forward in the training dtype with the
        # attention backward kernels (unless STUDY_ATTN_BWD=0); validation
        # (checkpoint selection) through the fused eval. Each variant below
        # sets its own eval path.
        fast_train=True, fast_train_attn_bwd=s["attn_bwd"], compute_dtype=s["train_dtype"],
        fast_eval=True, remat=s["frames"] > 100,
    )
    if s["max_minutes"] is not None:
        cfg = cfg.replace(max_time=s["max_minutes"] / 60.0)
    return cfg


def fingerprint(s) -> dict:
    return dict(frames=s["frames"], embed=s["embed"], depth=s["depth"], actions=s["actions"],
                motion="latent", seed=0, port="torch",
                **({} if s["heads"] == 8 else dict(heads=s["heads"])),
                **({} if s["attn_bwd"] else dict(attn_bwd=False)))


def _guard(directory: str, fp: dict, what: str) -> None:
    """Refuses a directory holding another study's artifacts (the
    fingerprint guard of scripts/accuracy_study.py:154-180), then stamps
    it, before any device work."""
    fp_path = os.path.join(directory, "task_fingerprint.json")
    if os.path.exists(fp_path):
        with open(fp_path) as f:
            if json.load(f) != fp:
                raise SystemExit(f"{directory} holds {what} of a different study config (see "
                                 f"{fp_path}); delete it or set STUDY_DIR before re-running.")
    elif os.path.isdir(directory) and os.listdir(directory):
        raise SystemExit(f"{directory} holds {what} of unknown provenance; delete it first.")
    os.makedirs(directory, exist_ok=True)
    if not os.path.exists(fp_path):
        with open(fp_path, "w") as f:
            json.dump(fp, f)


def make_datasets(cfg, actions: int):
    """(train, val, test) PoseDatasets of scripts/accuracy_study.py:189-199."""
    from diff3dhpe_torch.data import PoseDataset, make_synthetic_h36m_like

    dataset, kp = make_synthetic_h36m_like(
        subjects=("S1", "S5", "S9"), actions=tuple(f"Act{i} 1" for i in range(actions)),
        n_frames=8 * cfg.number_of_frames, seed=0, motion="latent")
    return tuple(PoseDataset(cfg, dataset, "data", split, keypoints_data=kp)
                 for split in ("train", "val", "test"))


def x_t(key, rows: int, frames: int, joints: int) -> np.ndarray:
    """x_T of ``rows`` rows ([rows, frames, joints, 3], float32) from
    ``np.random.default_rng([NOISE_SEED, *key])``."""
    rng = np.random.default_rng([NOISE_SEED, *key])
    return rng.standard_normal((rows, frames, joints, 3), dtype=np.float32)


def _newest_checkpoint(checkpoint: str):
    """The checkpoint directory of ``checkpoint`` with the latest epoch, or None."""
    best, newest = None, -1
    for path in glob.glob(os.path.join(checkpoint, "*", "meta.json")):
        with open(path) as f:
            epoch = json.load(f)["epoch"]
        if epoch > newest:
            best, newest = os.path.dirname(path), epoch
    return best


def train(runner, cfg, train_ds, val_ds, reuse: bool) -> dict:
    """Trains through ``Runner.fit`` unless ``train_done.json`` marks a
    finished run (and ``reuse``), resuming from the newest checkpoint of a
    cut one, then loads the best validation epoch's weights into
    ``runner``. Returns the training record."""
    from diff3dhpe_torch.io.checkpoint import restore_checkpoint

    best = os.path.join(cfg.checkpoint, "best_epoch")
    done_path = os.path.join(cfg.checkpoint, "train_done.json")
    if reuse and os.path.isfile(done_path) and os.path.isdir(best):
        with open(done_path) as f:
            record = dict(json.load(f), reused=True)
        print(f"reused the finished training in {cfg.checkpoint}", flush=True)
    else:
        resume = _newest_checkpoint(cfg.checkpoint)
        done_before = 0
        if resume:
            with open(os.path.join(resume, "meta.json")) as f:
                done_before = json.load(f)["epoch"] + 1
            print(f"resuming the cut training from {resume}", flush=True)
        t0 = time.time()
        fit = runner.fit(train_ds, val_ds, resume=resume)
        record = dict(best_epoch=fit["best_epoch"], min_loss=float(fit["min_loss"]),
                      epochs_run=done_before + len(fit["losses_train"]),
                      epochs_this_run=len(fit["losses_train"]), train_s=time.time() - t0,
                      last_train_loss=fit["losses_train"][-1] if fit["losses_train"] else None,
                      reused=False)
        with open(done_path, "w") as f:
            json.dump(record, f)
        print(f"trained {record['epochs_run']} epochs, best val MPJPE "
              f"{record['min_loss']:.3f} mm at epoch {record['best_epoch']}", flush=True)
    state, meta = restore_checkpoint(best, field="best_epoch")
    runner.set_params(state["model_diffusion"])
    record["evaluated_epoch"] = meta["epoch"]
    return record


def evaluate_variant(cfg, params, test_ds, fixed, device, x_init=None, f32_prec=None):
    """e1, e2, e3, ev of ``Runner.evaluate`` with ``cfg`` (a variant's
    Config) on ``params``, and its predictions on the ``fixed`` batches
    (name -> Batch). x_T: ``x_init`` (batch index -> array), default the
    study's numpy draws. ``f32_prec``: the contraction mode of a float32
    ``fast_eval`` forward (every step's), in place of "highest"."""
    import dataclasses

    import torch

    from diff3dhpe_torch.engine.runner import Runner
    from diff3dhpe_torch.engine.steps import make_eval_step, make_fast_denoise_fn

    runner = Runner(cfg, test_ds.num_joints, test_ds.joints_left, test_ds.joints_right,
                    device=device)
    runner.set_params(params)
    if f32_prec is not None:
        if not (cfg.fast_eval and cfg.compute_dtype == "float32"):
            raise ValueError(f"f32_prec={f32_prec!r} sets a float32 fast_eval forward's mode")
        runner.eval_diffusion = dataclasses.replace(
            runner.diffusion, denoise_fn=make_fast_denoise_fn(runner.model, f32_prec=f32_prec))
        runner.eval_step = make_eval_step(
            runner.eval_diffusion, runner.joints_left, runner.joints_right,
            repeat_n=cfg.repeat_n, tta=cfg.test_time_augmentation, device=runner.device)
    rows = cfg.batch_size_eval * (2 if cfg.test_time_augmentation else 1) * cfg.repeat_n
    f_out = cfg.number_of_frames if cfg.out_all else 1
    if x_init is None:
        x_init = lambda i: x_t((0, i), rows, f_out, test_ds.num_joints)
    t0 = time.time()
    m = runner.evaluate(test_ds, x_init=x_init)
    out = dict(e1=m["e1"], e2=m["e2"], e3=m["e3"], ev=m["ev"], eval_s=time.time() - t0,
               frames_per_sec=m["frames_per_sec"])
    with torch.no_grad():
        for k, (split, b) in enumerate(sorted(fixed.items())):
            flip = b.input_2d_flip if b.input_2d_flip is not None else b.input_2d
            noise = x_t((1, k), 2 * len(b.input_2d) * cfg.repeat_n, f_out, test_ds.num_joints)
            pred = runner.eval_step(b.input_2d, flip, x_init=noise)
            out[f"preds_{split}"] = pred.cpu().numpy().astype(np.float64)
    return out


def deviations(raw_preds, test_ds, base_e1):
    """Raw per-prediction deviations from plain_f32 on each fixed batch
    (scripts/accuracy_study.py:368-401)."""
    out = {}
    to_mm = test_ds.reverse_norm_3d_pose
    for split, preds in raw_preds.items():
        base_p = preds[BASELINE]
        base_mm = to_mm(base_p) * 1000.0
        out[split] = dict(clip_frac_plain=round(float((np.abs(base_p) >= 0.999).mean()), 4))
        for name, p in preds.items():
            if name == BASELINE:
                continue
            d = to_mm(p) * 1000.0 - base_mm
            per_joint = np.linalg.norm(d, axis=-1)
            out[split][name] = dict(
                mean_joint_dev_mm=round(float(per_joint.mean()), 5),
                max_coord_dev_mm=round(float(np.abs(d).max()), 5),
                mean_joint_dev_pct_of_mpjpe=round(float(per_joint.mean()) / base_e1 * 100.0, 3),
                clip_frac=round(float((np.abs(p) >= 0.999).mean()), 4),
            )
    return out


def verdicts_beside_jax(gate, variants, jax_table=JAX_TABLE):
    """{variant: {"port": passes, "jax": JAX's passes for its counterpart,
    "agree": ...}} for the gated variants whose counterpart JAX's table
    gates."""
    with open(jax_table) as f:
        jax_paths = json.load(f)["gate"]["paths"]
    out = {}
    for name, _, jax in variants:
        if name in gate and jax in jax_paths:
            port, theirs = gate[name]["passes"], jax_paths[jax]["passes"]
            out[name] = dict(jax_variant=jax, port=port, jax=theirs, agree=port == theirs)
    return out


def main(env=None) -> dict:
    """Runs the study; writes and returns its table."""
    from diff3dhpe_torch.device import resolve_device
    from diff3dhpe_torch.engine.runner import Runner
    from diff3dhpe_torch.utils.profiling import card_info

    s = settings(env)
    resolve_device(s["device"])  # no card, no study: nothing falls back to the CPU
    out_json = os.path.join(s["out_dir"], f"accuracy_study_torch{s['suffix']}.json")
    ckpt_dir = os.path.join(s["out_dir"], f"study_ckpt_torch{s['suffix']}")
    npz_dir = os.path.join(s["out_dir"], f"study_out_torch{s['suffix']}")
    fp = fingerprint(s)
    cfg = study_config(s, ckpt_dir)
    # Stamp provenance before training, so that a cut run stays resumable.
    _guard(ckpt_dir, fp, "checkpoints")
    _guard(npz_dir, fp, "variant npz files")
    card = card_info(s["device"])

    train_ds, val_ds, test_ds = make_datasets(cfg, s["actions"])
    print(f"windows: train={len(train_ds)} val={len(val_ds)} test={len(test_ds)}", flush=True)
    runner = Runner(cfg, test_ds.num_joints, test_ds.joints_left, test_ds.joints_right,
                    device=s["device"])
    record = train(runner, cfg, train_ds, val_ds, s["reuse"])
    params = {k: v.detach().cpu().clone() for k, v in runner.model.state_dict().items()}
    del runner

    variants = [v for v in VARIANTS
                if not s["variants"] or v[0] in s["variants"] or v[0] == BASELINE]
    fixed = {"test": next(iter(test_ds.batches(s["batch"]))),
             "val": next(iter(val_ds.batches(s["batch"])))}
    eval_s = {}
    # Weights trained (or trained further) in this run make every cached
    # prediction stale.
    fresh = s["fresh"] or not record["reused"]
    for name, patch, _ in variants:
        path = os.path.join(npz_dir, f"{name}.npz")
        if not fresh and os.path.isfile(path):
            print(f"{name}: reusing {path}", flush=True)
            continue
        vcfg = cfg.replace(sampling_timesteps=s["ddim"], **patch)
        r = evaluate_variant(vcfg, params, test_ds, fixed, s["device"],
                             f32_prec=F32_PREC.get(name))
        eval_s[name] = r.pop("eval_s")
        print(f"{name}: MPJPE {r['e1']:.4f} mm  P-MPJPE {r['e2']:.4f} mm  N-MPJPE "
              f"{r['e3']:.4f} mm  MPJVE {r['ev']:.4f} mm ({eval_s[name]:.1f} s)", flush=True)
        np.savez(path, eval_s=eval_s[name], **r)

    results, raw_preds = {}, {split: {} for split in fixed}
    for name, _, _ in variants:
        z = np.load(os.path.join(npz_dir, f"{name}.npz"))
        results[name] = {m: float(z[m]) for m in GATED_METRICS}
        eval_s.setdefault(name, float(z["eval_s"]))
        for split in fixed:
            raw_preds[split][name] = z[f"preds_{split}"]
    base = results[BASELINE]
    gate = compute_gate(results, base)

    table = {
        "config": dict(
            frames=s["frames"], embed=s["embed"], depth=s["depth"], heads=s["heads"],
            epochs=s["epochs"], epochs_run=record["epochs_run"],
            epochs_cut=record["epochs_run"] < s["epochs"], ddim_eval=s["ddim"],
            best_val_mpjpe_mm=record["min_loss"], best_epoch=record["best_epoch"],
            evaluated_epoch=record["evaluated_epoch"], train_dtype=s["train_dtype"],
            train_attn_bwd=s["attn_bwd"],
            train_batch=s["batch"], eval_batch=cfg.batch_size_eval, actions=s["actions"],
            motion="latent", windows=dict(train=len(train_ds), val=len(val_ds),
                                          test=len(test_ds)),
            jax_best_val_mpjpe_mm=JAX_BEST_VAL_MPJPE_MM,
            jax_note="scripts/accuracy_study.json: 100 epochs, bf16 training, TPU v5e",
            noise=f"numpy default_rng([{NOISE_SEED}, 0, batch]) per test batch, "
                  f"[{NOISE_SEED}, 1, k] per fixed batch",
            device=s["device"], card=card["name"], power_limit=card["power_limit"],
            train_s=record.get("train_s"), training_reused=record["reused"],
            eval_s=eval_s,
        ),
        "results": results,
        "deltas_vs_plain_f32_mm": {k: results[k]["e1"] - base["e1"] for k in results},
        "gate": dict(abs_budget_mm=ABS_BUDGET_MM, rel_budget=REL_BUDGET,
                     gated_metrics=list(GATED_METRICS), baseline=BASELINE,
                     baseline_mpjpe_mm=round(base["e1"], 4),
                     baseline_metrics_mm={m: round(base[m], 4) for m in GATED_METRICS},
                     paths=gate),
        "raw_prediction_deviation_vs_plain_f32": deviations(raw_preds, test_ds, base["e1"]),
        "jax_counterparts": {name: jax for name, _, jax in variants},
        "f32_prec": {name: F32_PREC[name] for name, _, _ in variants if name in F32_PREC},
        "verdicts_beside_jax": verdicts_beside_jax(gate, variants),
    }
    with open(out_json, "w") as f:
        json.dump(table, f, indent=2)
    print(json.dumps(table["gate"], indent=2), flush=True)
    print(f"wrote {out_json}", flush=True)
    return table


if __name__ == "__main__":
    main()
