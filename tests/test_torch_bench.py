"""The port's bench entry points on the CPU at a tiny size: bench_torch.py
(bench.py's protocol: flip-TTA DDIM eval steps, timed loops, one JSON
line) and scripts/train_bench_torch.py (scripts/train_bench.py's train-step
points), with the kernels' plain versions. Numbers from these runs are CPU
times and say nothing of the card; the tests check the lines' fields, the
refusals and the launch accounting."""
import json
import math
import os
import statistics
import sys

import pytest

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
import bench_torch  # noqa: E402
import train_bench_torch  # noqa: E402

TINY = dict(embed=32, depth=1)
TINY_ENV = {"BENCH_FRAMES": "9", "BENCH_HEADS": "4", "BENCH_DDIM": "2", "BENCH_ITERS": "2"}
DETAIL_FIELDS = {
    "frames_per_sec_per_chip", "seq_per_s_repeats", "seq_per_s_min", "seq_per_s_max",
    "spread_rel", "wall_s", "device", "card", "power_limit", "n_chips", "frames", "embed",
    "depth", "heads", "batch", "iters", "repeats", "dtype", "fast", "use_pallas",
    "temporal_mode", "mixed_f32_steps", "mixed_final_prec", "mixed_f32_tail_pairs", "repeat_n",
    "baseline_torch_cpu_seqs_per_sec", "baseline_note", "model_tflops_per_seq",
    "achieved_tflops", "peak_tflops", "peak_dtype", "mfu", "launches", "out_shape",
}
BENCH_CASES = {
    "mixed_rows": {},
    "float32": {"BENCH_DTYPE": "float32"},
    "bfloat16_cols": {"BENCH_DTYPE": "bfloat16", "BENCH_TMODE": "cols"},
    "mixed_two_f32_steps_highest": {"BENCH_MIXED_F32_STEPS": "2", "BENCH_FINAL_PREC": "highest"},
    "plain_module_use_pallas": {"BENCH_FAST": "0", "BENCH_PALLAS": "1", "BENCH_DTYPE": "float32"},
    "repeat_n": {"BENCH_REPEAT_N": "2", "BENCH_BATCH": "1", "BENCH_REPEATS": "4"},
}


@pytest.mark.parametrize("case", list(BENCH_CASES))
def test_bench_prints_one_line(case, capsys):
    env = {**TINY_ENV, **BENCH_CASES[case]}
    assert bench_torch.main(env, device="cpu", **TINY) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "pose_seqs_per_sec_per_chip_9f_ddim2_flipTTA"
    assert line["unit"] == "seq/s/chip" and line["vs_baseline"] == 0.0  # not the 243f protocol
    d = line["detail"]
    assert set(d) == DETAIL_FIELDS
    settings = bench_torch.settings_from_env(env)
    assert d["dtype"] == settings["dtype"] and d["temporal_mode"] == settings["tmode"]
    assert d["batch"] == settings["batch"] and d["repeat_n"] == settings["repeat_n"]
    assert len(d["seq_per_s_repeats"]) == len(d["wall_s"]) == settings["repeats"] >= 3
    assert line["value"] == round(statistics.median(d["seq_per_s_repeats"]), 3)
    assert d["seq_per_s_min"] <= line["value"] <= d["seq_per_s_max"]
    assert all(math.isfinite(v) and v > 0 for v in d["seq_per_s_repeats"] + d["wall_s"])
    assert d["out_shape"] == [settings["batch"], 9, 17, 3]
    # A CPU run names no card and no device metric.
    assert d["device"] == d["card"] == "cpu"
    assert d["power_limit"] is None and d["peak_tflops"] is None and d["mfu"] is None
    assert d["model_tflops_per_seq"] >= 0 and d["achieved_tflops"] >= 0
    assert d["launches"] == {}  # the plain versions ran: no kernel was launched


@pytest.mark.parametrize("knob,value", [
    ("BENCH_EXPORTED", "1"), ("BENCH_TAIL_PAIRS", "2"), ("BENCH_FINAL_PREC", "default"),
    ("BENCH_DTYPE", "float16"), ("BENCH_TMODE", "diagonal"), ("BENCH_REPEATS", "2"),
])
def test_bench_refuses(knob, value):
    with pytest.raises(ValueError, match=f"^{knob}="):
        bench_torch.settings_from_env({knob: value})
    with pytest.raises(ValueError, match=f"^{knob}="):
        bench_torch.main({**TINY_ENV, knob: value}, device="cpu", **TINY)


def test_bench_defaults_are_the_flagship_protocol():
    s = bench_torch.settings_from_env({})
    assert s == dict(frames=243, heads=8, dtype="mixed", batch=2, iters=16, repeats=3, ddim=9,
                     tmode="rows", use_pallas=False, fast=True, repeat_n=1, mixed_f32_steps=1,
                     final_prec="high3")
    assert bench_torch.settings_from_env({"BENCH_DTYPE": "bfloat16"})["batch"] == 4


TRAIN_FIELDS = {
    "variant", "batch", "frames", "embed", "depth", "heads", "device", "card", "power_limit",
    "ms_per_step", "step_ms_all", "step_ms_min", "step_ms_max", "spread_rel", "samples_per_s",
    "warmup_s", "peak_memory_gb", "useful_tflops_per_step", "achieved_tflops", "peak_tflops",
    "mfu", "hw_util_with_remat", "loss_first", "loss_last",
}


@pytest.mark.parametrize("variant", ["flax_f32", "flaxblk_bf16", "fast_f32", "fastblk_bf16",
                                     "fastpair_f32", "fastattn_bf16"])
def test_train_bench_point_prints_one_line(variant, capsys, monkeypatch):
    monkeypatch.setenv("TRAIN_ITERS", "3")
    assert train_bench_torch.main([variant, "2", "9"], device="cpu", heads=4, **TINY) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(row) == TRAIN_FIELDS
    assert (row["variant"], row["batch"], row["frames"]) == (variant, 2, 9)
    assert len(row["step_ms_all"]) == 3
    assert row["step_ms_min"] <= row["ms_per_step"] <= row["step_ms_max"]
    assert row["samples_per_s"] == pytest.approx(2 / row["ms_per_step"] * 1e3)
    assert math.isfinite(row["loss_first"]) and math.isfinite(row["loss_last"])
    assert row["device"] == row["card"] == "cpu"
    assert row["peak_memory_gb"] is None and row["mfu"] is None and row["power_limit"] is None


def test_train_bench_sweep_and_refusals(capsys, monkeypatch):
    monkeypatch.setenv("TRAIN_ITERS", "3")
    assert train_bench_torch.main(["sweep", "9"], device="cpu", batches=(2,), heads=4,
                                  **TINY) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [r["variant"] for r in rows] == list(train_bench_torch.VARIANTS)
    assert len(train_bench_torch.VARIANTS) == 12
    with pytest.raises(ValueError, match="variant"):
        train_bench_torch.measure("jit_f32", 2, 9, device="cpu", **TINY)
    with pytest.raises(ValueError, match="iters=2"):
        train_bench_torch.measure("fast_f32", 2, 9, iters=2, device="cpu", **TINY)
