"""scripts/accuracy_study_torch.py, the port's accuracy study, on the CPU
at a tiny size: its copy of ``compute_gate`` against the JAX study's, the
table a run writes against the JAX study's layout, resume, the fingerprint
guard, the x_T draws reaching every batch, and its baseline (the plain f32
module) against JAX's ``Runner.evaluate`` on the same weights and x_T."""
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest

from diff3dhpe_tpu.config import Config as JaxConfig
from diff3dhpe_tpu.data import PoseDataset as JaxPoseDataset
from diff3dhpe_tpu.data import make_synthetic_h36m_like as jax_make_synthetic
from diff3dhpe_tpu.engine.runner import Runner as JaxRunner
from torch_port_helpers import jax_x_init, perturb
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
import accuracy_study as jax_study  # noqa: E402
import accuracy_study_torch as study  # noqa: E402

# Frames 9, embed 32, depth 1, 4 heads, 1 action; batch 3 makes the eval
# batch 12, so the 32 test windows end in a short batch of 8.
TINY = {"STUDY_FRAMES": "9", "STUDY_EMBED": "32", "STUDY_DEPTH": "1", "STUDY_HEADS": "4",
        "STUDY_EPOCHS": "2", "STUDY_ACTIONS": "1", "STUDY_DDIM": "2", "STUDY_BATCH": "3",
        "STUDY_DEVICE": "cpu"}


def _gate_cases():
    """JAX's own cases (tests/test_metrics.py::test_accuracy_gate_rule and
    ::test_accuracy_gate_all_metrics) and a table with rep rows and a float
    baseline. Baseline path named as in JAX; the port's is plain_f32."""
    base4 = {"e1": 10.0, "e2": 8.0, "e3": 9.5, "ev": 1.3}
    return {
        "abs_and_rel_30mm": ({"flax_f32": {"e1": 30.0}, "inside_both": {"e1": 30.05},
                              "abs_fail": {"e1": 30.12}, "both_fail": {"e1": 30.5}}, 30.0),
        "near_chance_954mm": ({"flax_f32": {"e1": 954.0}, "p": {"e1": 954.5}}, 954.0),
        "rep_not_gated": ({"flax_f32": {"e1": 30.0}, "fast_f32_rep4": {"e1": 29.0}}, 30.0),
        "all_metrics": ({"flax_f32": base4,
                         "good": {"e1": 10.01, "e2": 8.01, "e3": 9.49, "ev": 1.301},
                         "ev_blown": {"e1": 10.01, "e2": 8.01, "e3": 9.5, "ev": 3.2},
                         "e2_fail": {"e1": 10.0, "e2": 8.05, "e3": 9.5, "ev": 1.3}}, base4),
        "rep_rows_float_baseline": ({"flax_f32": {"e1": 7.8579, "e2": 6.73, "ev": 1.43},
                                     "fast_f32_rep4": {"e1": 7.83, "e2": 6.72},
                                     "rep2_mixed": {"e1": 7.9},
                                     "fast_mixed1": {"e1": 7.8580, "e2": 6.7301, "ev": 1.4296},
                                     "fast_bf16": {"e1": 8.0288, "e2": 6.871, "ev": 3.133},
                                     "only_e3": {"e3": 7.0}}, 7.8579),
    }


GATE_CASES = _gate_cases()


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_compute_gate_matches_jax(case):
    results, baseline = GATE_CASES[case]
    expected = jax_study.compute_gate(results, baseline)
    renamed = {("plain_f32" if k == "flax_f32" else k): v for k, v in results.items()}
    assert study.compute_gate(renamed, baseline) == expected
    assert (study.ABS_BUDGET_MM, study.REL_BUDGET, study.GATED_METRICS,
            study.NON_GATED_PREFIXES) == (jax_study.ABS_BUDGET_MM, jax_study.REL_BUDGET,
                                          jax_study.GATED_METRICS, jax_study.NON_GATED_PREFIXES)


def _jax_table_keys():
    """The keys of the table JAX's study writes (scripts/accuracy_study.py:417-440)."""
    with open(os.path.join(ROOT, "scripts", "accuracy_study.json")) as f:
        return json.load(f)


def test_tiny_study_writes_jax_keys_and_resumes(tmp_path, capsys):
    env = {**TINY, "STUDY_DIR": str(tmp_path)}
    table = study.main(env)
    path = tmp_path / "accuracy_study_torch_h4.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(table))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "accuracy_study_torch_h4.json", "study_ckpt_torch_h4", "study_out_torch_h4"]
    jax_table = _jax_table_keys()
    names = [v[0] for v in study.VARIANTS]
    # JAX's keys, under the port's baseline name, and the port's additions.
    assert set(jax_table["config"]) <= set(table["config"])
    assert set(table) == {"config", "results", "deltas_vs_plain_f32_mm", "gate",
                          "raw_prediction_deviation_vs_plain_f32", "jax_counterparts",
                          "f32_prec", "verdicts_beside_jax"}
    assert list(table["results"]) == list(table["deltas_vs_plain_f32_mm"]) == names
    assert all(set(r) == set(study.GATED_METRICS) and all(np.isfinite(list(r.values())))
               for r in table["results"].values())
    assert set(table["gate"]) == set(jax_table["gate"]) | {"baseline"}
    assert set(table["gate"]["paths"]) == set(names) - {"plain_f32", "fast_f32_rep4"}
    jax_row = jax_table["gate"]["paths"]["fast_mixed1_h3"]
    for row in table["gate"]["paths"].values():
        assert set(row) == set(jax_row)
        assert set(row["metrics"]) == set(jax_row["metrics"])
    for split in ("test", "val"):
        devs = table["raw_prediction_deviation_vs_plain_f32"][split]
        assert set(devs) == {"clip_frac_plain"} | set(names[1:])
        assert set(devs["fast_f32"]) == set(
            jax_table["raw_prediction_deviation_vs_flax_f32"][split]["fast_f32_mxhighest"])
    # JAX's "default" rows run (ROADMAP A.11): every step's f32 forward at
    # "default", and the mixed step's final one; each gated beside JAX's.
    assert {"fast_f32_mxdefault", "fast_mixed1_default"} <= set(table["gate"]["paths"])
    assert table["f32_prec"] == {"fast_f32_mxdefault": "default"}
    assert table["jax_counterparts"]["fast_mixed1_default"] == "fast_mixed1"
    assert table["jax_counterparts"]["fast_mixed1"] == "fast_mixed1_h3"
    verdicts = table["verdicts_beside_jax"]
    assert verdicts["fast_f32_mxdefault"]["jax"] is False and verdicts["fast_mixed1"]["jax"]
    assert all(v["agree"] == (v["port"] == v["jax"]) for v in verdicts.values())
    for k in (6, 4, 2):  # the float32 tails run, under JAX's names
        assert table["jax_counterparts"][f"fast_mixed1_h3_tail{k}"] == f"fast_mixed1_h3_tail{k}"
    cfg = table["config"]
    assert (cfg["epochs_run"], cfg["epochs_cut"], cfg["heads"], cfg["device"]) == (
        2, False, 4, "cpu")
    assert cfg["windows"] == dict(train=128, val=64, test=32)
    # The f32 eval paths agree on the CPU, where every kernel runs its plain version.
    assert table["gate"]["paths"]["fast_f32"]["passes"]
    assert table["gate"]["paths"]["pallas_f32"]["passes"]

    # A second run reuses the finished training and every variant's npz.
    capsys.readouterr()
    again = study.main(env)
    out = capsys.readouterr().out
    assert "reused the finished training" in out and out.count(": reusing ") == len(names)
    assert again["results"] == table["results"] and again["config"]["training_reused"]

    # Another study's shape in the same directory is refused before any work.
    with pytest.raises(SystemExit, match="different study config"):
        study.main({**env, "STUDY_EMBED": "64"})


def test_cut_training_resumes_from_its_newest_checkpoint(tmp_path):
    env = {**TINY, "STUDY_DIR": str(tmp_path), "STUDY_EPOCHS": "1", "STUDY_VARIANTS": "x"}
    first = study.main(env)
    ckpt = tmp_path / "study_ckpt_torch_h4"
    (ckpt / "train_done.json").unlink()  # as if the run had been cut after epoch 0
    resumed = study.main({**env, "STUDY_EPOCHS": "2"})
    assert list(first["results"]) == list(resumed["results"]) == ["plain_f32"]
    assert resumed["config"]["epochs_run"] == 2 and not resumed["config"]["training_reused"]
    # Weights trained in this run are evaluated anew, not read from the npz.
    assert resumed["results"] != first["results"]
    done = json.loads((ckpt / "train_done.json").read_text())
    assert (done["epochs_run"], done["epochs_this_run"]) == (2, 1)


def _tiny_setup():
    s = study.settings(TINY)
    cfg = study.study_config(s, checkpoint="unused")
    return s, cfg, study.make_datasets(cfg, s["actions"])


def test_x_init_reaches_every_batch_with_repeat_n():
    """``Runner.evaluate`` takes the study's draw for every batch, the
    short last one included, at 4 hypotheses (4x the rows): another draw
    for the last batch alone changes the result."""
    s, cfg, (_, _, test_ds) = _tiny_setup()
    vcfg = cfg.replace(sampling_timesteps=s["ddim"], fast_eval=True, compute_dtype="float32",
                       repeat_n=4)
    n_batches = len(list(test_ds.batches(vcfg.batch_size_eval)))
    rows_last = len(test_ds) - (n_batches - 1) * vcfg.batch_size_eval
    assert n_batches == 3 and 0 < rows_last < vcfg.batch_size_eval
    from diff3dhpe_torch.engine.runner import Runner

    params = Runner(vcfg, 17, test_ds.joints_left, test_ds.joints_right,
                    device="cpu").init_params()
    seen = []

    def draws(i, last_key=None):
        seen.append(i)
        key = (0, i) if (i < n_batches - 1 or last_key is None) else last_key
        x = study.x_t(key, 2 * vcfg.batch_size_eval * 4, 9, 17)
        assert x.shape == (96, 9, 17, 3)
        return x

    a = study.evaluate_variant(vcfg, params, test_ds, {}, "cpu", x_init=draws)
    assert seen == list(range(n_batches))
    b = study.evaluate_variant(vcfg, params, test_ds, {}, "cpu",
                               x_init=lambda i: draws(i, (7, 7)))
    assert a["e1"] != b["e1"]
    default = study.evaluate_variant(vcfg, params, test_ds, {}, "cpu")
    assert default["e1"] == a["e1"]  # the study's own draws are these


def test_plain_f32_matches_jax_evaluate():
    """The study's baseline, the plain f32 module, on JAX's converted
    weights and JAX's x_T draws equals JAX's ``Runner.evaluate`` of the
    flax_f32 variant (the bar of tests/test_torch_runner.py: rtol 1e-4,
    atol 1e-3 mm), batch by batch through a short last batch."""
    s, cfg, (_, _, test_ds) = _tiny_setup()
    patch = dict(study.VARIANTS[0][1])
    vcfg = cfg.replace(sampling_timesteps=s["ddim"], **patch)
    jax_kw = {f.name: getattr(vcfg, f.name) for f in dataclasses.fields(vcfg)}
    jax_cfg = JaxConfig(**{**jax_kw, "matmul_precision": "highest", "mesh_shape": "data:1"})
    jds, jkp = jax_make_synthetic(subjects=("S1", "S5", "S9"), actions=("Act0 1",),
                                  n_frames=8 * s["frames"], seed=0, motion="latent")
    jax_test_ds = JaxPoseDataset(jax_cfg, jds, "data", "test", keypoints_data=jkp)
    jax_runner = JaxRunner(jax_cfg, 17, jax_test_ds.joints_left, jax_test_ds.joints_right)
    x = np.zeros((1, s["frames"], 17, 5), np.float32)
    params = jax.jit(jax_runner.model.init)(jax.random.PRNGKey(0), x,
                                            np.zeros(1, np.float32))["params"]
    params = perturb(jax.tree.map(np.asarray, params), np.random.default_rng(3))
    jax_runner.set_params(params)
    key = jax.random.PRNGKey(11)
    expected = jax_runner.evaluate(jax_test_ds, key=key)

    subkeys = []
    for _ in test_ds.batches(vcfg.batch_size_eval):
        key, sub = jax.random.split(key)
        subkeys.append(sub)
    rows = 2 * vcfg.batch_size_eval
    got = study.evaluate_variant(  # the flax tree, converted by Runner.set_params
        vcfg, params, test_ds, {}, "cpu",
        x_init=lambda i: jax_x_init(subkeys[i], rows, (s["frames"], 17, 3)))
    assert len(subkeys) == 3
    for m in study.GATED_METRICS:
        assert np.isfinite(got[m])
        np.testing.assert_allclose(got[m], expected[m], rtol=1e-4, atol=1e-3, err_msg=m)
