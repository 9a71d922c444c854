#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (diff3dhpe_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc, holds each against its plain
PyTorch version on the card at the shapes of the main paths, runs one
full-width denoiser forward through the kernels against the plain module,
then drives the main paths at the flagship size (243 frames, 17 joints,
embed 512, depth 8, 8 heads, mlp_ratio 2, cosine T=1000), with weights from
the port's seeded init:

  eval   the flip-TTA DDIM-9 eval step (clip_denoised, logical batch 2), in
         f32 and in the JAX package's shipped "mixed" mode (bench.py: a bf16
         trunk with an f32 head for 8 steps, the f32 forward for the last),
         in both temporal layouts (rows: B1 for every block; cols: B2 for
         the temporal blocks);
  train  the f32 fast-train AdamW step (configs/h36m_gt_s2s_243f.json:
         clip_loss, lr 4e-5, lr_decay 0.99, batch 24; drop_path_rate 0.1),
         pair-boundary backward with the attention kernels (attn_bwd); then
         at bf16 (the compute_dtype of configs/h36m_gt_s2s_243f_tpu.json),
         8 and 4 heads, attn_bwd off and on, its drift from f32, one step of
         the monolithic backward and one of the remat module;
  cli    the evaluate entry point, diff3dhpe_torch.cli.run.main([--config
         <json> --synthetic --evaluate <seed-0 state dict .bin> ...]), on
         configs/h36m_gt_s2s_243f.json at DDIM-9 with batch 2: the plain
         module, the module with "use_pallas_attention" (B6 for the joints,
         B3 for the frames), --fast-eval at f32, the mixed mode and pure
         bf16, each printing the per-action report; then the file of the
         TPU-recommended config, configs/h36m_gt_s2s_243f_tpu.json (4 heads
         of head_dim 128, the mixed mode, remat, DDIM-5), on 4-head weights,
         held against the same file run as the plain module and as pure
         bf16;
  fit    the training entry point, diff3dhpe_torch.cli.run.main without
         --evaluate, on configs/h36m_gt_s2s_243f.json with fast_train,
         fast_train_attn_bwd and fast_eval: 2 epochs at batch 24 with
         per-epoch flip-TTA validation (DDIM-5, batch 8) and a checkpoint
         each epoch, then the run resumed from epoch_0, then --evaluate
         best_epoch, each held against the unbroken run; then the same on
         configs/h36m_gt_s2s_243f_tpu.json (bf16 training, remat, 4 heads,
         mixed validation) with fast_train_attn_bwd;
  bench  the port's bench, bench_torch.py, as a user runs it (a
         subprocess at the flagship protocol, BENCH_ITERS=4), at mixed and
         at float32;
  study  the accuracy study, scripts/accuracy_study_torch.py, into a
         temporary STUDY_DIR at full width cut to depth 2, 1 action and 1
         epoch: bf16 training through fit, then its eight eval variants on
         the same weights and x_T, gated against the plain f32 module;
  3dhp   the MPI-INF-3DHP entry point, diff3dhpe_torch.cli.run_3dhp.main,
         on configs/3dhp_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json
         as it stands (27 frames, embed 512, depth 8, 8 heads, DDIM-5, eval
         batch 512; TS1, TS2 of TS1-TS6) with --synthetic data and a seed-0 .bin: the
         plain module, --fast-eval at f32, mixed and pure bf16, each with
         its per-sequence report, PCK, AUC and inference_data.mat; then
         Runner.evaluate on two full batches of 512 windows, 3 times at f32
         and at mixed; then 2 epochs of --fast-train and --evaluate
         best_epoch;
  humaneva and custom  cli.run.main --dataset humaneva15 --synthetic on
         configs/h36m_gt_s2s_243f.json (15 joints) in the evaluate
         configurations, and on a 2D-only custom archive;
  tail   the mixed eval step whose final forward runs its last k block
         pairs and head at f32 (k = 2, 4, 6, 8), rows and cols;
  export the eval step exported through cli/export.py (mixed rows, fast
         f32) and io.export (mixed cols) from a seed-0 .bin, restored in a
         fresh process and run on the seed-0 and a seed-1 state dict, bit
         for bit as the live step; bench_torch.py with BENCH_EXPORTED=1;
         then --export-platforms cpu,cuda: artifacts exported on the card
         restored on the CPU and the other way round, against the live
         step on the device they run on;
  viz    cli/viz.py's model work (compute) on --synthetic data at
         repeat_n 1 and 2, and p_sample_loop over T = 1,000 steps through
         the use_pallas module;
  parallel  data parallelism (diff3dhpe_torch/parallel): "python -m
         torch.distributed.run --standalone --nproc-per-node 1" running
         cli.run.main with --mesh-shape data:1 over nccl (phase 11's
         training, 1 epoch), then --evaluate best_epoch in one process;
         then two ranks on the one card over gloo (nccl takes one rank a
         device): the f32 and mixed eval steps at global batch 4, one f32
         and three bf16 fast-train steps at global batch 8 (4 heads,
         attn_bwd), and the f32 step exported sharded and restored in both
         ranks, each against one process;
  tensor parallelism  the model axis of mesh_shape (diff3dhpe_torch/
         parallel/tensor.py) with gloo ranks on the one card: at
         "data:1,model:2" the plain module's f32 train step, the
         use_pallas eval step (B3 and B6 on 4 local heads of 64, and on 2
         local heads of 128) and the fused f32 and mixed evals on the
         gathered replica, each against this process alone; at
         "data:2,model:2" cli.run.main's training (1 epoch, a checkpoint),
         --evaluate best_epoch and the resume in this process alone;
  modes  the f32 contraction modes "high3" and "default" of the block
         kernels (JAX's f32_contract_mode): B1, B2 and B5 at the eval
         shapes and each of their kernels alone against its plain version,
         and the mixed step with its final forward at each mode (4b). The
         Runner's mixed final steps run at Config.eval_final_prec, "high3"
         by default, so every mixed path through the Runner runs them. The
         attention step under a mode is the tensor-core kernel of
         csrc/grand_attn_mode.cuh, also held alone in both layouts (21);
         B3, B4 and B6 at f32 under the session matmul precision "default"
         (Config.matmul_precision) against their plain versions (21b), the
         f32 fast-train step at "default", whose recompute runs B4 under
         "default" on the tensor cores (7h), and the TPU config, which sets
         it, through the CLI (11c).

Any failed check raises and the script exits non-zero.

Output: one line per phase (1 build; 2 B1 vs plain, with drop-path too,
at the eval and the train step's row counts, and at f32 with 4 heads of
head_dim 128 at both eval shapes; 2b B1 at bf16 vs plain, with 8 heads and
with 4; 2c B2 vs plain at f32 (with drop-path also at the train step's
rows) and bf16, with 8 heads and with 4; 2d the bf16 GEMM alone at the
block's four products; 2e the f32 GEMM alone at the block's four products, at the eval and the train
step's row counts; 2f the LayerNorm alone, f32 and bf16, with and without
the time add; 3 full-width forward; 4 the f32 eval step; 5 its profile; 4b
the mixed eval step in rows and cols, and the pure-bf16 one, then the
mixed rows and pure-bf16 evals of a 4-head model; 5b the mixed rows step's
profile; 6 B3 and B4 vs plain at the train shape with 8 heads (d = 64)
and 4 heads (d = 128), B4 twice with the same bits; 6b B3 at bf16 (the
tensor-core attention kernel alone) at both eval shapes, d = 64 and 128;
6c B4 at bf16 at the train shapes, alone and from B3's statistics, with
SDPA's backward; 7a the train
step's loss, gradients and launches vs the plain module at B=4, with 8
heads and with 4; 7b three timed AdamW steps at B=24; 7c their profile; 7d
the bf16 train step (8 and 4 heads, attn_bwd off and on); 7e its 20-step
drift from f32; 7f a monolithic-backward step and a remat step; 7g the
bf16 step's profile; 7h (after 7c) the f32 train step at the session
precision "default": at B=4 against the same step with its recompute's
attention in plain formulas and beside the plain module, then three timed
steps at B=24, their launches and B4's share of one step's profile; 8 B6 vs plain at the eval shape as qkv views and contiguous, at n
= 64, n = 27 and with 4 heads of head_dim 128, then at bf16 (views, 8 heads
and 4), all in device time, and B6 at bf16 as an op; 9 B5 vs plain at both eval
shapes, f32 and bf16 (also at head_dim 128), and its launches as an op; 10
the evaluate entry point in its configurations; 10b the profile of one
eval step of the use_pallas module; 11 the training entry point: each
epoch's loss, validation MPJPE and seconds, samples/s through fit, the
checkpoint's size and write seconds, peak memory, the launches of one
epoch, the resumed run and --evaluate best_epoch against the unbroken run,
and no host wait inside the train loop; 11c the same on the TPU config at
bf16 and the session matmul precision "default"; 12 bench_torch.py's JSON line at mixed and float32, with its launches;
13 the accuracy study's table, its gate and its launches; 9b B1 at groups
of 27 and 15, B2 with j_groups = 15 and B6 at n = 15, f32 and bf16, vs
plain; 14 the 3DHP entry point's runs, frames/s and launches; 15 HumanEva's
runs; 16 the custom archive's report; 17 (after 5b) the mixed step with a
float32 tail of 2, 4, 6, 8 pairs, rows and cols: launches by dtype, the
deviation beside 4b's, seq/s; 18 the export's seconds and bytes, the
restored step in a fresh process against the live one, bench_torch.py
with BENCH_EXPORTED=1; 19 cli/viz.py's compute and p_sample_loop; 20a
torchrun at world size 1 on nccl: the report, the launches, the train
loop's host waits, --evaluate in one process against it; 20b two gloo
ranks on the card against one process: the gathered predictions, the
step-1 gradients, the ranks' parameters, the launches of each rank, the
gradient all-reduce's seconds (gloo through host memory: no multi-GPU
figure), the sharded export), with what the profiler records before,
between and after; 22 tensor parallelism: (a) two gloo ranks at
"data:1,model:2" against one process (the train step's loss and
gradients, the use_pallas eval at 8 and 4 heads with each rank's B3 and B6
launches and rank 0's calls against their plain versions, the fused evals
on the gathered replica bit for bit, seconds per step and the all-reduces'
share), (b) four gloo ranks at "data:2,model:2" through cli.run.main
(training, the report against --evaluate best_epoch in one process, the
resume in one process); 21 (printed after 2f) the contraction modes (B1, B2,
B5 and each kernel alone at "high3" and "default", the tensor-core
attention at n = 17 and 243, 8 and 4 heads, rows and cols, with each one's
separation r from "highest", times, bounds and library times; after 4b the
mixed step at each final mode, its deviation, seq/s, launches by kind, and
its profile at "high3"); 21b B3 (with and without B4's statistics), B4
(its launches and scratch beside the CUDA-core path's) and B6 at f32 under
the session precision "default" vs plain; 24 (printed after 9b) head
widths other than 64 and 128: B1, B2, B5, B3 and B6 at head_dim 32 (16
heads at embed 512) and 96 (4 at 384) at every dtype and mode vs plain,
timed, each attention launch bit for bit its 64 or 128 instance on
zero-padded copies, and cli.run.main at --num-heads 16 (plain, fast-eval,
mixed, bf16; use_pallas at DDIM-3) held against the plain run; then a
JSON line with every kernel's numbers; the last line is {"ok": true,
"device": {...}}. Exits non-zero without a CUDA device, and where the
port's package is not beside this script.
"""
import contextlib
import copy
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import torch

FRAMES, JOINTS, EMBED, DEPTH, HEADS, MLP_RATIO = 243, 17, 512, 8, 8, 2.0
HEADS4 = 4  # num_heads of configs/h36m_gt_s2s_243f_tpu.json: head_dim 128 at embed 512
BATCH = 2  # logical sequences per eval step; flip-TTA doubles the rows
TIMESTEPS, DDIM_STEPS = 1000, 9
# The DDIM steps of the exports that are not the shipped mixed rows step
# (phase 18's cols and f32 artifacts and its bench_torch.py run, phase
# 20b's sharded export): a trace's seconds grow with the steps it unrolls,
# and these paths hold the export's mechanics, which three steps exercise
# as nine do (the first bf16 steps and the f32 final one of the mixed mode).
CUT_DDIM_STEPS = 3
JOINTS_LEFT, JOINTS_RIGHT = [4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]
KERNEL_REL_TOL = 1e-4   # kernel and forward vs the plain version, relative to max|plain|
# Eval-step bound: the output is an x0 estimate clipped to [-1, 1]. Each of
# the 9 forwards may differ from the plain one by up to the 1e-4 forward
# bar, and the DDIM update passes earlier differences on with gains below 1
# (x-gain 0.03..0.98, x0-gain 0.17..0.97 on this schedule), so 9 x 1e-4
# ~ 1e-3 absolute bounds the sum as long as the untrained net does not
# amplify its input differences by more than ~1 per step.
EVAL_ABS_BOUND = 1e-3
TRAIN_BATCH, CHECK_BATCH = 24, 4  # the config's batch; the batch of the plain-path check
LR, LR_DECAY, DROP_PATH = 4e-5, 0.99, 0.1
# Train-step check against the plain module under plain autograd (same dp,
# t and noise): the loss to 1e-5 relative; every parameter's gradient to
# max|dg| / max|g_plain| <= 1e-3. The kernel path's forward differs from
# the plain one by f32 rounding only (the recompute backward is the plain
# module's own autograd apart from B4), and eight pairs of depth pass those
# roundings on through the backward.
LOSS_REL_TOL, GRAD_REL_TOL = 1e-5, 1e-3
# bf16 kernels vs their plain versions, relative to max|plain|, compared in
# f32: both round at the same points, and f32 sums taken in another order
# flip single bf16 roundings (2^-8 relative each).
BF16_MAX_TOL, BF16_MEAN_TOL = 1e-2, 1e-3
COLS_VS_ROWS_BOUND = 1e-3  # the mixed eval in the two layouts, absolute
# --evaluate of the best checkpoint against the training run's own final
# report: the same weights, x_T from the same seed, the same kernels.
EVAL_REPORT_TOL_MM = 1e-3
# The f32 GEMM alone vs F.linear in f32, relative to max|plain|: both sum
# K <= 1024 products of order 1 exactly in f32, in other orders.
GEMM_F32_REL_TOL = 1e-5
SMALL_ATTN_ABS_TOL = 1e-5  # B6 vs its plain version, absolute (outputs of order 1)
# Kernels of one block call with the out-LN (csrc/fused_block.cu); at f32
# under the contraction modes "high3" and "default" 16: 8 splits, 4
# f32-output tensor-core GEMMs, the attention and 3 LNs. The Runner's mixed
# final steps contract at Config.eval_final_prec, "high3" by default (as
# in the JAX package), so every path through the Runner's mixed mode runs
# them; make_mixed_diffusion without f32_prec runs "highest".
PER_CALL, PER_CALL_MODE = 8, 16
# The f32 kernels under "high3" vs their plain versions, relative to
# max|plain|: both sum the same exact bf16 products in f32, in other
# orders; where the f32 values entering a split differ by a rounding, a lo
# half moves by 2^-17 of its value (one operand in ~2^7), and the LNs
# carry that on.
MODE_HIGH3_TOL = 2e-5
# "default", max and mean |kernel − plain| relative to max|plain|: both
# round the same values to bf16 and sum exact products, so they part only
# where an f32 sum taken in another order moves a value across a bf16
# rounding boundary (2^-8 of it). Measured on an H100 (PERF.md, phase 21):
# at most 4.1e-4 and 1.03e-5 (the blocks); the bars are 2.4 times that.
MODE_DEFAULT_MAX_TOL, MODE_DEFAULT_MEAN_TOL = 1e-3, 2.5e-5
# The mode's separation, r = mean|kernel − plain at the mode| / mean|plain
# at the mode − plain at "highest"|: a kernel that ran another mode, or
# skipped a rounding, sits at r >= 0.40 ("default" without rounding e) and
# r >= 0.66 ("high3" with its second product exact), r = 1 when it ran
# "highest" (tests/test_torch_contract_modes.py, on the plain versions).
# Held for the blocks, the GEMM alone and the attention alone in both
# modes. The three-pass GEMM sums hi·hi and the cross terms in two sets of
# accumulators (csrc/gemm_wgmma_f32.cuh): with one, the tensor cores'
# accumulation, which drops the bits below the accumulator's last place at
# each k-step, cost the cross terms their low bits and left the GEMM at r
# 0.55–1.11 and the blocks at 0.93 (measured on an H100 80GB HBM3 at 700 W).
MODE_SEPARATION = {"default": 0.1, "high3": 0.45}
# A train step at the session precision "default" against the same step on
# the attention kernels' plain versions, relative L2 over every gradient:
# each product of the recompute rounds its operands to bf16, so a float32
# difference of one ulp anywhere upstream turns such roundings, and a whole
# step's gradients part as a bf16 step's do (phase 20b's bf16 bar). Measured
# on an H100 80GB HBM3 at 700 W (phase 7h, PERF.md): about 1.3e-4; the step
# with B4's outputs moved one float32 ulp parts from it by about as much,
# and the step run again by 0. So the bar bounds the step, not B4, which
# phase 7h holds at the "default" bars on the step's own inputs.
DEFAULT_STEP_GRAD_TOL = 1e-2
ATTN_BLOCK_ABS_TOL = 1e-5  # B5 at f32 vs its plain version, absolute, beside KERNEL_REL_TOL
CLI_CONFIG = "configs/h36m_gt_s2s_243f.json"
TPU_CONFIG = "configs/h36m_gt_s2s_243f_tpu.json"  # 4 heads, mixed, remat: the TPU-recommended
# The mixed eval is held against the pure-bf16 one by their mean per-joint
# position error (the repo's MPJPE, in normalised units) from the plain f32
# eval: on this untrained net each forward carries bf16 rounding on to a
# few percent of its output, and the max over ~25k values is one outlier.

# Peaks used for bound_ms (NVIDIA data sheets, dense, full power limit):
# float32 outside the tensor cores, bf16 on the tensor cores, and
# device-memory bandwidth.
CARD_PEAKS = {  # name fragment -> (f32 FLOP/s, bf16 FLOP/s, bytes/s)
    "H100 PCIe": (51e12, 756e12, 2.0e12),
    "H100 NVL": (60e12, 835e12, 3.9e12),
    "H200": (67e12, 989e12, 4.8e12),
    "H100": (67e12, 989e12, 3.35e12),  # SXM
}


def ptxas_summary(log):
    """'kernel<template ints>: R regs, S B spilled' for each entry function
    of an nvcc -Xptxas=-v log (ptxas prints a function's properties, its
    spills, then its registers)."""
    out, name = [], None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = kernel_label(ln.split("Function properties for", 1)[1].strip())
        elif "spill stores" in ln and name is not None:
            spill = ln.split("bytes spill stores")[0].split(",")[-1].strip()
        elif "Used" in ln and "registers" in ln and name is not None:
            regs = ln.split("Used", 1)[1].split("registers")[0].strip()
            out.append(f"{name}: {regs} regs, {spill} B spilled")
            name = None
    return out


def kernel_label(sym):
    """The kernel's name and template arguments (integers, bools, float /
    bf16, also those of a class argument) from an Itanium-mangled symbol
    (the symbol itself where no '...kernel' name is found)."""
    import re

    i = 0
    while i < len(sym):
        digits = len(sym[i:]) - len(sym[i:].lstrip("0123456789"))
        if not digits:
            i += 1
            continue
        n, j = int(sym[i:i + digits]), i + digits
        ident = sym[j:j + n]
        if n and ident.endswith("kernel"):
            rest = sym[j + n:]
            args = []
            if rest.startswith("I"):
                region = rest[:rest.find("Ev")] if "Ev" in rest else rest
                for m in re.finditer(r"L[ib](\d+)E|13__nv_bfloat16|I(f)|(?<=E)(f)(?=L)", region):
                    args.append(m.group(1) or ("float" if m.group(2) or m.group(3) else "bf16"))
            return f"{ident}<{','.join(args)}>"
        i = j + max(n, 1)
    return sym


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


# Seconds since the script started at each phase's first printed line
# ("phase <name>"), printed before the kernels line.
STARTED = time.perf_counter()
PHASE_SECONDS = {}


def say(*parts):
    text = " ".join(str(p) for p in parts)
    if text.startswith("phase "):
        PHASE_SECONDS.setdefault(text.split()[1], round(time.perf_counter() - STARTED, 1))
    print(text, flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


PROFILES = [0]  # profiler sessions this process has opened (device_ms, profile_step)
PROFILER_FALLBACKS = []  # the profiler session after which device_ms took CUDA events
SENTINEL = "spin_kernel"  # the kernel of torch.cuda._sleep


@contextlib.contextmanager
def recording():
    """A profiler session over the CPU and the card whose first launches
    are sentinels (torch.cuda._sleep), waited for before the body runs:
    once the card has idled for some seconds, the profiler drops the first
    one to three kernels of each session (PERF.md §7), and these are what
    it drops; eight of them, as a session late in a long run may drop
    more. device_events leaves the sentinels out."""
    from torch.profiler import ProfilerActivity, profile

    PROFILES[0] += 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.002)
        yield prof


def device_events(prof):
    """{kernel name: (events, device time in us)} of a recording, without
    its sentinels."""
    return {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and SENTINEL not in e.key}


def kernel_events(fn, iters):
    """device_events of `iters` calls of fn()."""
    with recording() as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return device_events(prof)


def device_ms(fn, iters=20, tries=3, kernels=None):
    """Mean device time of fn() in ms from the profiler: for each kernel
    the mean device time of its events, times its launches a call. Unlike
    cuda_ms it leaves out the host's time between launches, which a short
    kernel called through Python does not hide. The profile must hold every
    launch but at most one (recording's sentinels take the launches the
    profiler drops at a session's start): each kernel's events within one
    of a whole number of `iters`, and `kernels` launches a call in all
    where given; else (and where a session recorded nothing) it is taken
    again, `tries` times in all. Where no session held every launch but
    one, the time is taken with CUDA events instead (cuda_ms, which also
    counts the host's time between launches, so it is no lower than the
    device's), said on a line of its own and counted in
    PROFILER_FALLBACKS; a session that recorded launches must still show
    `kernels` of them a call."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        got = kernel_events(fn, iters)
        per_call = {k: max(1, round(c / iters)) for k, (c, _) in got.items()}
        dropped = sum(per_call[k] * iters - c for k, (c, _) in got.items())
        if (got and all(c > 0 and t > 0 for c, t in got.values()) and 0 <= dropped <= 1
                and all(c <= per_call[k] * iters for k, (c, _) in got.items())
                and (kernels is None or sum(per_call.values()) == kernels)):
            return sum(per_call[k] * t / c for k, (c, t) in got.items()) / 1e3
    check(kernels is None or not got or sum(per_call.values()) == kernels,
          f"the profiler recorded {got} (events, us) over {iters} calls: not {kernels} "
          f"launches a call, profiler session {PROFILES[0]}")
    ms = cuda_ms(fn, iters)
    PROFILER_FALLBACKS.append(PROFILES[0])
    say(f"device_ms: the profiler recorded {got} (events, us) over {iters} calls in "
        f"each of {tries} sessions, more than one event dropped (profiler session "
        f"{PROFILES[0]}); timed with CUDA events instead: {ms:.4f} ms")
    return ms


def profiler_probe(label, iters=20):
    """Prints how many of `iters` launches of one small kernel (the split)
    the profiler records now, and how many profiler sessions this process
    has opened: where the profiler goes blind in a long run."""
    from diff3dhpe_torch.ops.fused_block import split_bf16

    x = torch.ones(4096, device="cuda")
    split_bf16(x)
    torch.cuda.synchronize()
    got = kernel_events(lambda: split_bf16(x), iters)
    n = sum(c for c, _ in got.values())
    say(f"profiler probe {label}: {n} of {iters} kernel events recorded, after "
        f"{PROFILES[0] - 1} profiler sessions in this process")
    return n == iters


def profile_step(label, fn, top_n=10, tries=3):
    """Profiles one fn() and prints its wall time, device busy time, idle
    share and the device time of the top kernels by name. Returns {name:
    device ms} of all kernels that ran. A profile that recorded no kernel (one
    session in ~60 once the card has idled; PERF.md §7) is taken again,
    `tries` times in all."""
    for _ in range(tries):
        with recording() as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0 and SENTINEL not in e.key]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        if busy_ms > 0:
            break
    check(busy_ms > 0, "the profiler saw no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_n]
    say(f"{label}: wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
        f"idle_share={1 - busy_ms / wall_ms:.4f}; by kernel: " + " | ".join(
            f"{e.key.replace('(anonymous namespace)::', '').split('(')[0][:60]} x{e.count} "
            f"{e.self_device_time_total / 1e3:.3f} ms "
            f"({e.self_device_time_total / 1e3 / busy_ms:.3f})" for e in top))
    return {e.key: e.self_device_time_total / 1e3 for e in kernels}


def mpjpe(pred, ref):
    """Mean over (sample, frame, joint) of the L2 distance of the xyz."""
    return (pred.float() - ref.float()).norm(dim=-1).mean().item()


def rel_err(out, ref):
    abs_err = (out - ref).abs().max().item()
    return abs_err, abs_err / ref.abs().max().item()


def bf16_errs(out, ref):
    """(max abs, max rel, mean rel) of a bf16 kernel against its plain
    version, in f32, relative to max|plain|."""
    diff, scale = (out.float() - ref.float()).abs(), ref.float().abs().max().item()
    return diff.max().item(), diff.max().item() / scale, diff.mean().item() / scale


def library_block(x, block, n, heads, t_rows, rows_per_item, out_ln):
    """The same block composed from PyTorch library calls (SDPA for the
    attention core): the yardstick of library_ms, never called by the port.
    Runs in x's dtype (block, out_ln and t_rows in it too)."""
    from torch.nn import functional as F

    r, c = x.shape
    x = x + t_rows.repeat_interleave(rows_per_item, dim=0)
    xn = F.layer_norm(x, (c,), block.norm1.weight, block.norm1.bias, block.norm1.eps)
    qkv = F.linear(xn, block.attn.qkv.weight, block.attn.qkv.bias)
    q, k, v = qkv.view(r // n, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    a = F.scaled_dot_product_attention(q, k, v) - v
    h1 = x + F.linear(a.transpose(1, 2).reshape(r, c), block.attn.proj.weight, block.attn.proj.bias)
    hn = F.layer_norm(h1, (c,), block.norm2.weight, block.norm2.bias, block.norm2.eps)
    mid = F.gelu(F.linear(hn, block.mlp.fc1.weight, block.mlp.fc1.bias))
    out = h1 + F.linear(mid, block.mlp.fc2.weight, block.mlp.fc2.bias)
    return F.layer_norm(out, (c,), out_ln.weight, out_ln.bias, out_ln.eps)


def library_attn_block(x, block, n, heads):
    """B5's function from PyTorch library calls, in x's dtype (block too)."""
    from torch.nn import functional as F

    r, c = x.shape
    xn = F.layer_norm(x, (c,), block.norm1.weight, block.norm1.bias, block.norm1.eps)
    qkv = F.linear(xn, block.attn.qkv.weight, block.attn.qkv.bias)
    q, k, v = qkv.view(r // n, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    a = F.scaled_dot_product_attention(q, k, v) - v
    return x + F.linear(a.transpose(1, 2).reshape(r, c), block.attn.proj.weight,
                        block.attn.proj.bias)


def library_cols(x, block, n, j_groups, heads, t_rows, out_ln):
    """B2's function from library calls: the transposes around
    ``library_block`` on frame-contiguous groups."""
    rows, cols = x.shape
    b, c = rows // n, cols // j_groups
    xt = x.view(b, n, j_groups, c).transpose(1, 2).reshape(-1, c)
    out = library_block(xt, block, n, heads, t_rows, n * j_groups, out_ln)
    return out.view(b, j_groups, n, c).transpose(1, 2).reshape(rows, cols)


def block_work(r, n, c, hidden, items, itemsize=4):
    """(FLOPs, bytes) one block call must do and move: the four GEMMs and
    the attention products; x, t_rows and the weights read once, the
    output written once, in storage of ``itemsize`` bytes (LN parameters
    and biases float32)."""
    flops = 2 * r * c * (3 * c + c + 2 * hidden) + 4 * r * n * c
    weights = 3 * c * c + c * c + c * hidden + hidden * c
    vectors = 3 * c + c + hidden + c + 6 * c
    return flops, itemsize * (2 * r * c + items * c + weights) + 4 * vectors


def attn_block_work(r, n, c, itemsize=4):
    """(FLOPs, bytes) of one B5 call: the qkv and proj GEMMs and the
    attention products; x and the weights read once, the output written
    once (LN parameters and biases float32)."""
    flops = 2 * r * c * 4 * c + 4 * r * n * c
    return flops, itemsize * (2 * r * c + 4 * c * c) + 4 * (2 * c + 3 * c + c)


def train_step_flops(b, hidden):
    """FLOPs one fast-train step needs at batch b: the block GEMMs of four
    forwards' worth (the fused forward, the recompute, and the backward's
    two products per GEMM), the attention products of the two forwards
    (4·n·C per row), and of the backward (10·n·C per row, the five N×N×d
    products of the GRAND backward)."""
    r = b * FRAMES * JOINTS
    gemm = 2 * r * EMBED * (3 * EMBED + EMBED + 2 * hidden) * 2 * DEPTH
    attn_fwd = 4 * r * EMBED * (JOINTS + FRAMES) * DEPTH
    return 4 * gemm + 2 * attn_fwd + 10 * attn_fwd // 4


THREEDHP_CONFIG = "configs/3dhp_gt_s2s_ConditionalDiffusionMixSTES2SGRANDLinLift.json"
HE_JOINTS, F_3DHP = 15, 27  # HumanEva's joints; the 3DHP config's frames
# Per-sequence report of cli/run_3dhp.py, and the per-action one of cli/run.py.
REPORT_3DHP = ("eval_frame:", "inference_speed:",  # and each sequence's "----TSn----"
               "Protocol #1 Error (MPJPE):", "e1 sequence-wise average:",
               "ev sequence-wise average:", "PCK@150mm:", "AUC:", "Saved raw predictions to")
REPORT_RUN = ("eval_frame:", "inference_speed:", "Protocol #1 Error (MPJPE):",
              "Velocity Error (MPJVE):", "Protocol #1   (MPJPE) action-wise average:")


def drive(fn, *args, **kwargs):
    """Runs fn(*args, **kwargs) as a driven path: every kernel wrapper's
    launch counts (the blocks' f32 GEMM and LN counts too) set to 0 just
    before it, read just after it (synchronised); its standard output
    captured; every Runner.evaluate result and every call of the module's
    plain attention recorded. Returns (fn's result, dict(launches=,
    inner=, records=, text=, wall_s=))."""
    from diff3dhpe_torch.engine.runner import Runner
    from diff3dhpe_torch.models import mixste
    from diff3dhpe_torch.ops import (
        fused_attention_block, fused_temporal_block_cols, fused_transformer_block, read_launches,
        reset_launches,
    )

    blocks = (fused_transformer_block, fused_temporal_block_cols, fused_attention_block)
    records, plain_calls = [], [0]
    evaluate, plain_attention = Runner.evaluate, mixste.grand_attention

    def recording_evaluate(self, test_ds, *a, **kw):
        m = evaluate(self, test_ds, *a, **kw)
        records.append(dict(m, scale=test_ds.scale))
        return m

    def counting_attention(*a, **kw):
        plain_calls[0] += 1
        return plain_attention(*a, **kw)

    torch.cuda.synchronize()
    reset_launches()
    reset_inner(blocks)
    text = io.StringIO()
    Runner.evaluate, mixste.grand_attention = recording_evaluate, counting_attention
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(text):
            result = fn(*args, **kwargs)
        torch.cuda.synchronize()
    finally:
        Runner.evaluate, mixste.grand_attention = evaluate, plain_attention
    wall = time.perf_counter() - t0
    launches = dict(read_launches(), plain_attention_calls=plain_calls[0])
    return result, dict(launches=launches, inner=count_inner(blocks), records=records,
                        text=text.getvalue(), wall_s=wall)


# The block wrappers' launch counts by kind (csrc/fused_block.cu,
# LaunchCount): the exact f32 GEMMs, the LNs, the splits, the f32-output
# tensor-core GEMMs of the contraction modes, and the attention's and the
# time add's LN instances under a mode.
INNER = {"gemm_f32": "launches_gemm_f32", "layer_norm": "launches_ln",
         "split": "launches_split", "gemm_mode": "launches_gemm_mode",
         "attn_mode": "launches_attn_mode", "ln_mode": "launches_ln_mode"}


def reset_inner(blocks):
    for b in blocks:
        for attr in INNER.values():
            setattr(b, attr, 0)


def count_inner(blocks):
    return {k: sum(getattr(b, attr) for b in blocks) for k, attr in INNER.items()}


def normalised_predictions(records):
    """The predictions of a run's Runner.evaluate calls, in normalised units."""
    return torch.cat([torch.from_numpy(r["predictions"] / r["scale"]) for r in records])


def check_group_sizes(make_block, timings, check_bf16, randn, peak_flops, peak_bf16):
    """Phase 9b: B1 (rows) at groups of 27 (the 3DHP config's frames, at
    its eval rows: 512 windows x2 flip x 27 frames x 17 joints) and of 15
    (HumanEva's joints, at the 243-frame eval rows: 2 x2 flip x 243 x 15),
    B2 with j_groups = 15, and B6 at n = 15, each at float32 and bfloat16
    with 8 heads, against its plain version with the bars of phases 2, 2b,
    2c and 8. Returns {kernel: {shape: numbers}} for the kernels line."""
    from torch.nn import functional as F

    from diff3dhpe_torch import (
        fused_temporal_block_cols, fused_temporal_block_cols_ref, fused_transformer_block,
        fused_transformer_block_ref, packed_grand_attention, packed_grand_attention_ref,
    )

    hidden = int(EMBED * MLP_RATIO)
    out = {"B1": {}, "B2": {}, "B6": {}}

    def errors(label, dt, got, ref, abs_tol=None):
        if dt == torch.bfloat16:
            abs_err, rel, mean_rel = check_bf16(label, got, ref)
            return abs_err, f"max_rel_err={rel:.3e} mean_rel_err={mean_rel:.3e} (tol " \
                            f"{BF16_MAX_TOL}, {BF16_MEAN_TOL})"
        check(torch.isfinite(got).all().item(), f"{label}: output not finite")
        abs_err, rel = rel_err(got, ref)
        if abs_tol is not None:
            check(abs_err <= abs_tol, f"{label}: abs err {abs_err:.3e} > {abs_tol}")
            return abs_err, f"(tol {abs_tol}), same bits twice"
        check(rel <= KERNEL_REL_TOL, f"{label}: rel err {rel:.3e} > {KERNEL_REL_TOL}")
        return abs_err, f"rel_err={rel:.3e} (tol {KERNEL_REL_TOL})"

    with torch.no_grad():
        block, out_ln = make_block(11)
        for dt in (torch.float32, torch.bfloat16):
            blk, oln = block, out_ln
            if dt == torch.bfloat16:
                blk = copy.deepcopy(block)
                for m in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                    m.weight.data = m.weight.data.bfloat16()
            lib_blk, lib_oln = copy.deepcopy(block).to(dt), copy.deepcopy(out_ln).to(dt)
            peak, suffix = (peak_flops, "") if dt == torch.float32 else (peak_bf16, "_bf16")
            for name, items, per_item, n in (("n27", 1024, F_3DHP * JOINTS, F_3DHP),
                                             ("n15", 2 * BATCH, FRAMES * HE_JOINTS, HE_JOINTS)):
                r = items * per_item
                x = randn(r, EMBED).to(dt)
                t_rows = randn(items, EMBED, scale=0.5).to(dt)
                kw = dict(t_rows=t_rows, rows_per_item=per_item, out_ln=oln)
                run = lambda: fused_transformer_block(x, blk, n, HEADS, **kw)
                plain = lambda: fused_transformer_block_ref(x, blk, n, HEADS, **kw)
                lib = lambda: library_block(x, lib_blk, n, HEADS, t_rows, per_item, lib_oln)
                label = f"B1 {name} {dt}"
                abs_err, errs = errors(label, dt, run(), plain())
                t = timings(run, plain, lib, *block_work(r, n, EMBED, hidden, items,
                                                         dt.itemsize), peak)
                out["B1"][name + suffix] = dict(abs_err=abs_err, **t)
                say(f"phase 9b fused_transformer_block {name} {dt}: R={r} n={n} heads={HEADS} "
                    f"max_abs_err={abs_err:.3e} {errs} ms={t['ms']:.4f} "
                    f"plain_ms={t['plain_ms']:.4f} library_ms={t['lib_ms']:.4f} "
                    f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
                del x, t_rows
            # B2 on HumanEva's cols layout: x [items*F, 15*C], groups of F frames.
            items = 2 * BATCH
            x = randn(items * FRAMES, HE_JOINTS * EMBED).to(dt)
            t_rows = randn(items, EMBED, scale=0.5).to(dt)
            kw = dict(t_rows=t_rows, out_ln=oln)
            run = lambda: fused_temporal_block_cols(x, blk, FRAMES, HE_JOINTS, HEADS, **kw)
            plain = lambda: fused_temporal_block_cols_ref(x, blk, FRAMES, HE_JOINTS, HEADS, **kw)
            lib = lambda: library_cols(x, lib_blk, FRAMES, HE_JOINTS, HEADS, t_rows, lib_oln)
            abs_err, errs = errors(f"B2 j_groups 15 {dt}", dt, run(), plain())
            r = items * FRAMES * HE_JOINTS
            t = timings(run, plain, lib, *block_work(r, FRAMES, EMBED, hidden, items,
                                                     dt.itemsize), peak)
            out["B2"]["j15" + suffix] = dict(abs_err=abs_err, **t)
            say(f"phase 9b fused_temporal_block_cols j_groups={HE_JOINTS} {dt}: x=[{items}*"
                f"{FRAMES}, {HE_JOINTS}*{EMBED}] max_abs_err={abs_err:.3e} {errs} "
                f"ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms={t['lib_ms']:.4f} "
                f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
            del x, t_rows, lib_blk, lib_oln
            # B6 at n = 15 on views of a qkv projection, in device time.
            b, hd = 2 * BATCH * FRAMES, EMBED // HEADS
            q, k, v = randn(b, HE_JOINTS, 3, HEADS, hd).to(dt).permute(2, 0, 3, 1, 4)
            run = lambda: packed_grand_attention(q, k, v)
            plain = lambda: packed_grand_attention_ref(q, k, v)
            lib = lambda: F.scaled_dot_product_attention(q, k, v) - v
            got = run()
            abs_err, errs = errors(f"B6 n15 {dt}", dt, got, plain(),
                                   SMALL_ATTN_ABS_TOL if dt == torch.float32 else None)
            if dt == torch.float32:
                check(torch.equal(got, run()), "B6 n15: two calls gave different bits")
            pairs = b * HEADS
            t = timings(run, plain, lib, 4 * pairs * HE_JOINTS ** 2 * hd,
                        4 * dt.itemsize * pairs * HE_JOINTS * hd, peak, device_ms)
            out["B6"]["n15" + suffix] = dict(abs_err=abs_err, **t)
            say(f"phase 9b packed_grand_attention n={HE_JOINTS} {dt}: [G={pairs}, N={HE_JOINTS}, "
                f"D={hd}] max_abs_err={abs_err:.3e} {errs} device ms={t['ms']:.4f} "
                f"plain_ms={t['plain_ms']:.4f} library_ms={t['lib_ms']:.4f} (SDPA - v) "
                f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
            del q, k, v, got
    torch.cuda.empty_cache()
    return out


def seed_weights(path, frames, joints, dev):
    """A seed-0 state dict of the full-width denoiser, as a reference .bin."""
    from diff3dhpe_torch import MixSTEDenoiser

    torch.save(MixSTEDenoiser(num_frame=frames, num_joints=joints, embed_dim=EMBED, depth=DEPTH,
                              num_heads=HEADS, mlp_ratio=MLP_RATIO, seed=0,
                              device=dev).state_dict(), path)


def mixed_b1(forwards, ddim, calls=2 * DEPTH):
    """(B1 launches, of them bf16) of ``forwards`` forwards of the Runner's
    mixed mode in DDIM-``ddim`` loops: all but the last step of a loop at
    bf16, the last at f32 under "high3" (``calls`` block calls a forward)."""
    loops = forwards // ddim
    bf16 = calls * PER_CALL * loops * (ddim - 1)
    return bf16 + calls * PER_CALL_MODE * loops, bf16


def eval_want(forwards, per_call, ddim=5):
    """The launches of each evaluate mode over ``forwards`` denoiser
    forwards: the plain module's attention calls, B1's (and its bf16 ones,
    all but the f32 final step of each DDIM-5 loop in the mixed mode, which
    runs at "high3"), and with use_pallas B6 for the joints and B3 for the
    frames."""
    zero = {"plain_attention_calls": 0, "fused_transformer_block": 0,
            "fused_transformer_block_bf16": 0, "packed_grand_attention": 0,
            "grand_attention_fullseq": 0}
    b1 = 2 * DEPTH * per_call * forwards
    b1_mixed, b1_mixed_bf16 = mixed_b1(forwards, ddim)
    return {
        "plain": dict(zero, plain_attention_calls=2 * DEPTH * forwards),
        "use_pallas": dict(zero, packed_grand_attention=DEPTH * forwards,
                           grand_attention_fullseq=DEPTH * forwards),
        "fast_eval": dict(zero, fused_transformer_block=b1),
        "mixed": dict(zero, fused_transformer_block=b1_mixed,
                      fused_transformer_block_bf16=b1_mixed_bf16),
        "bf16": dict(zero, fused_transformer_block=b1, fused_transformer_block_bf16=b1),
    }


EVAL_MODES = {  # the evaluate configurations of phases 14 and 15
    "plain": [],
    "fast_eval": ["--fast-eval"],
    "mixed": ["--fast-eval", "--compute-dtype", "bfloat16", "--eval-f32-head",
              "--eval-f32-final-steps", "1"],
    "bf16": ["--fast-eval", "--compute-dtype", "bfloat16"],
}


def hold_eval_modes(phase, runs, want):
    """Checks each evaluate run's launches against ``want`` (zero for every
    key not named there) and holds the kernel runs against the plain one:
    use_pallas and fast_eval within EVAL_ABS_BOUND, mixed no further in
    MPJPE than pure bf16. Prints one line a run."""
    plain = runs["plain"]["pred"]
    for name, r in runs.items():
        got = {k: r["launches"].get(k, 0) for k in want[name]}
        others = {k: v for k, v in r["launches"].items() if v and k not in want[name]}
        check(got == want[name] and not others,
              f"{phase} {name} launched {r['launches']}, expected {want[name]}")
        check(torch.isfinite(r["pred"]).all().item(), f"{phase} {name}: predictions not finite")
        r["dev"] = (r["pred"] - plain).abs().max().item()
        r["mpjpe"] = mpjpe(r["pred"], plain)
    for name in ("use_pallas", "fast_eval"):
        if name in runs:
            check(runs[name]["dev"] <= EVAL_ABS_BOUND, f"{phase} {name} deviates from the plain "
                  f"run by {runs[name]['dev']:.3e} > {EVAL_ABS_BOUND}")
    check(runs["mixed"]["mpjpe"] <= runs["bf16"]["mpjpe"], f"{phase} mixed mpjpe "
          f"{runs['mixed']['mpjpe']:.4e} > the bf16 run's {runs['bf16']['mpjpe']:.4e}")


def drive_3dhp(dev, per_call):
    """Phase 14: the MPI-INF-3DHP entry point, cli/run_3dhp.main, on the
    3DHP config as it stands (27 frames, embed 512, depth 8, 8 heads,
    DDIM-5, eval batch 512) but for its test sequences, cut from TS1-TS6
    to TS1 and TS2 (each pads to a batch of 512 windows),
    with --synthetic data (108 frames a
    sequence: 4 windows, one padded batch) and a seed-0 .bin through
    --evaluate, as the plain module, --fast-eval at f32, mixed and pure
    bf16; then Runner.evaluate on 1,024 windows of one sequence (two full
    batches) at f32 fast-eval and mixed, 3 times each; then training with
    --fast-train (and the attention kernels of the recompute) for 2 epochs
    of the config's batch 64 and --evaluate best_epoch on the same
    checkpoint directory. Returns ({path: launches}, {path: inner counts})."""
    import scipy.io

    from diff3dhpe_torch.cli.run_3dhp import main as main_3dhp
    from diff3dhpe_torch.config import load_config
    from diff3dhpe_torch.data import PoseDataset3DHP
    from diff3dhpe_torch.data.mpiinf3dhp import JOINTS_LEFT as JL, JOINTS_RIGHT as JR
    from diff3dhpe_torch.data.synthetic import make_synthetic_3dhp
    from diff3dhpe_torch.engine.runner import Runner
    from diff3dhpe_torch.io.checkpoint import load_torch_state_dict

    here = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(here, THREEDHP_CONFIG)
    with open(config) as f:
        params = json.load(f)["params"]
    seqs = params["subjects_test"].split(",")[:2]
    launches, inner = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "seed0_27f.bin")
        seed_weights(weights, F_3DHP, JOINTS, dev)
        runs = {}
        for name, extra in EVAL_MODES.items():
            out_dir = os.path.join(tmp, name)
            result, d = drive(main_3dhp, ["--config", config, "--synthetic", "-c", out_dir,
                                          "--evaluate", weights, "-ste", ",".join(seqs)] + extra)
            say(f"phase 14 cli_3dhp {name}: the report\n{d['text'].rstrip()}")
            check(all(line in d["text"] for line in REPORT_3DHP + tuple(
                f"----{q}----" for q in seqs)),
                  f"cli_3dhp {name}: a line of the report is missing")
            errs = result["errors"]
            check(all(len(v) == len(seqs) and all(math.isfinite(e) for e in v)
                      for v in errs.values()), f"cli_3dhp {name}: errors {errs}")
            check(0 <= result["pck"] <= 100 and 0 <= result["auc"] <= 100,
                  f"cli_3dhp {name}: PCK {result['pck']}, AUC {result['auc']}")
            mat = scipy.io.loadmat(os.path.join(out_dir, "inference_data.mat"))
            recs = d["records"]
            shapes = {s: tuple(mat[s].shape) for s in seqs}
            check(len(recs) == len(seqs) and all(
                shapes[s] == (3, JOINTS, r["n_frames"]) for s, r in zip(seqs, recs)),
                f"cli_3dhp {name}: inference_data.mat {shapes}, frames "
                f"{[r['n_frames'] for r in recs]}")
            frames = sum(r["n_frames"] for r in recs)
            runs[name] = dict(pred=normalised_predictions(recs), launches=d["launches"],
                              frames_per_s=frames / sum(r["model_time"] for r in recs))
            launches[f"cli_3dhp_{name}"], inner[f"cli_3dhp_{name}"] = d["launches"], d["inner"]
            say(f"phase 14 cli_3dhp {name}: per sequence "
                + " | ".join(f"{s} e1={errs['e1'][i]:.3f} e2={errs['e2'][i]:.3f} "
                             f"e3={errs['e3'][i]:.3f} ev={errs['ev'][i]:.3f}"
                             for i, s in enumerate(seqs))
                + f"; PCK@150={result['pck']:.4f} AUC={result['auc']:.4f}; frames={frames} "
                f"inference_speed_frames_per_s={runs[name]['frames_per_s']:.1f} "
                f"(padded batch of {params['batch_size_eval']} windows a sequence); "
                f"inference_data.mat {shapes}; B1 launches="
                f"{d['launches']['fused_transformer_block']} (bf16 "
                f"{d['launches']['fused_transformer_block_bf16']}); wall_s={d['wall_s']:.1f}")
        # A warm-up step and one timed step a sequence, DDIM-5 each.
        steps = params["sampling_timesteps"] * 2 * len(seqs)
        hold_eval_modes("cli_3dhp", runs, eval_want(steps, per_call))
        say(f"phase 14 cli_3dhp vs the plain run (normalised units): " + "; ".join(
            f"{k} max_abs_dev={r['dev']:.3e} mpjpe={r['mpjpe']:.4e}"
            for k, r in runs.items() if k != "plain"))

        # Runner.evaluate at two full batches of 512 windows, 3 times a mode.
        data = make_synthetic_3dhp(["S1"], ["TS1"], n_frames=1024 * F_3DHP, seed=0)
        state = load_torch_state_dict(weights)
        for name in ("fast_eval", "mixed"):
            mixed = name == "mixed"
            cfg = load_config(config, dict(
                fast_eval=True, compute_dtype="bfloat16" if mixed else "float32",
                eval_f32_head=mixed, eval_f32_final_steps=1 if mixed else 0,
                subjects_test="TS1"))
            ds = PoseDataset3DHP(cfg, data._test, data._pos_3d_min, data._pos_3d_max,
                                 split="test")
            check(len(ds) == 1024, f"3dhp evaluate: {len(ds)} windows")
            runner = Runner(cfg, JOINTS, JL, JR, device=dev)
            runner.set_params(state)
            ms, d = drive(lambda: [runner.evaluate(ds, unit_scale=1.0) for _ in range(3)])
            fps = [float(m["frames_per_sec"]) for m in ms]
            check(all(math.isfinite(m[k]) for m in ms for k in ("e1", "e2", "e3", "ev"))
                  and all(m["e1"] == ms[0]["e1"] for m in ms),
                  f"3dhp evaluate {name}: errors {[m['e1'] for m in ms]}")
            forwards = 3 * 3 * params["sampling_timesteps"]
            want = (mixed_b1(forwards, params["sampling_timesteps"])[0] if mixed
                    else forwards * 2 * DEPTH * per_call)
            check(d["launches"]["fused_transformer_block"] == want,
                  f"3dhp evaluate {name}: B1 launched {d['launches']}, expected {want}")
            launches[f"evaluate_3dhp_{name}"] = d["launches"]
            inner[f"evaluate_3dhp_{name}"] = d["inner"]
            say(f"phase 14 Runner.evaluate 3dhp {name}: {len(ds)} windows of {F_3DHP} frames "
                f"(batch {cfg.batch_size_eval} x2 flip, DDIM-{cfg.sampling_timesteps}), "
                f"{ms[0]['n_frames']} frames evaluated, 3 runs: frames_per_s median="
                f"{statistics.median(fps):.1f} min={min(fps):.1f} max={max(fps):.1f} "
                f"({[round(v, 1) for v in fps]}); e1_mm={ms[0]['e1']:.3f}; B1 launches="
                f"{d['launches']['fused_transformer_block']} (bf16 "
                f"{d['launches']['fused_transformer_block_bf16']})")
            del runner, ds
            torch.cuda.empty_cache()

        # Training: fast_train with the recompute's attention through the
        # kernels (B6 for the 17 joints and the 27 frames), fast-eval
        # validation, 2 epochs; the final evaluation and --evaluate
        # best_epoch on TS1 (cut from TS1-TS6) at eval batch 64 (cut from 512).
        train_config = os.path.join(tmp, "train_3dhp.json")
        with open(train_config, "w") as f:
            json.dump({"params": dict(params, fast_train_attn_bwd=True, fast_eval=True)}, f)
        run_dir = os.path.join(tmp, "train")
        common = ["--config", train_config, "--synthetic", "-ste", "TS1", "--batch-size-eval",
                  "64", "-c", run_dir]
        reports = {}
        for name, argv in (("train", common + ["--fast-train", "-e", "2"]),
                           ("train_evaluate", common + ["--evaluate", "best_epoch"])):
            result, d = drive(main_3dhp, argv)
            say(f"phase 14 cli_3dhp {name}: the log and report\n{d['text'].rstrip()}")
            reports[name] = result
            check(all(len(v) == 1 and math.isfinite(v[0]) for v in result["errors"].values()),
                  f"cli_3dhp {name}: errors {result['errors']}")
            launches[f"cli_3dhp_{name}"], inner[f"cli_3dhp_{name}"] = d["launches"], d["inner"]
            if name == "train":
                n_train = int(d["text"].split("INFO: Training on ")[1].split()[0])
                steps = 2 * (n_train // params["batch_size"])
                check(steps >= 2 and "Epoch: 1," in d["text"]
                      and os.path.isdir(os.path.join(run_dir, "best_epoch")),
                      f"cli_3dhp train: {n_train} windows, the epochs or best_epoch missing")
                # Each step's recompute: B6 for the 8 spatial and the 8
                # temporal attentions (n = 17 and 27), no B3 or B4.
                lc = d["launches"]
                check(lc["packed_grand_attention"] == 2 * DEPTH * steps
                      and lc["grand_attention_fullseq"] == lc["grand_attention_bwd"] == 0
                      and lc["fused_transformer_block"] > 0,
                      f"cli_3dhp train launched {lc}, expected B6 {2 * DEPTH * steps}")
            say(f"phase 14 cli_3dhp {name}: e1={result['errors']['e1'][0]:.4f} "
                f"PCK@150={result['pck']:.4f} AUC={result['auc']:.4f} wall_s={d['wall_s']:.1f} "
                f"launches={ {k: v for k, v in d['launches'].items() if v} }")
        dev_mm = max(abs(a[0] - b[0]) for a, b in zip(reports["train"]["errors"].values(),
                                                         reports["train_evaluate"]["errors"].values()))
        check(dev_mm <= EVAL_REPORT_TOL_MM, f"cli_3dhp --evaluate best_epoch differs from the "
              f"training run's report by {dev_mm:.3e} mm")
    torch.cuda.empty_cache()
    return launches, inner


def drive_humaneva_custom(dev, per_call):
    """Phase 15: cli.run.main --dataset humaneva15 --synthetic on
    configs/h36m_gt_s2s_243f.json (243 frames, 15 joints, embed 512, depth
    8; DDIM-5) with a seed-0 15-joint .bin, action Walking (12 windows,
    batch 2), as the plain module, with use_pallas (B6 for the 15 joints,
    B3 for the frames), --fast-eval at f32, mixed and pure bf16. Phase 16:
    cli.run.main on a 2D-only custom archive that it writes (the layout of
    tests/test_datasets.py), --fast-eval: the report prints its frames and
    NaN errors. Returns ({path: launches}, {path: inner counts})."""
    import numpy as np

    from diff3dhpe_torch.cli.run import main as cli_main

    here = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(here, CLI_CONFIG)
    with open(config) as f:
        params = json.load(f)["params"]
    launches, inner = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "seed0_15j.bin")
        seed_weights(weights, FRAMES, HE_JOINTS, dev)
        use_pallas = os.path.join(tmp, "use_pallas.json")
        with open(use_pallas, "w") as f:
            json.dump({"params": dict(params, use_pallas_attention=True)}, f)
        runs = {}
        for name, (cfg_path, extra) in {**{k: (config, v) for k, v in EVAL_MODES.items()},
                                        "use_pallas": (use_pallas, [])}.items():
            errors, d = drive(cli_main, [
                "--config", cfg_path, "--dataset", "humaneva15", "--synthetic", "-str",
                "Train/S1", "-ste", "Validate/S1", "-a", "Walking", "--batch-size-eval",
                str(BATCH), "-c", os.path.join(tmp, name), "--evaluate", weights] + extra)
            say(f"phase 15 cli_humaneva {name}: the report\n{d['text'].rstrip()}")
            check(all(line in d["text"] for line in REPORT_RUN + ("----Walking----",)),
                  f"cli_humaneva {name}: a line of the report is missing")
            check(all(len(v) == 1 and math.isfinite(v[0]) for v in errors.values()),
                  f"cli_humaneva {name}: errors {errors}")
            (rec,) = d["records"]
            runs[name] = dict(pred=normalised_predictions(d["records"]), launches=d["launches"],
                              frames_per_s=rec["n_frames"] / rec["model_time"])
            launches[f"cli_humaneva_{name}"] = d["launches"]
            inner[f"cli_humaneva_{name}"] = d["inner"]
            say(f"phase 15 cli_humaneva {name} B={BATCH} (x2 flip) DDIM-"
                f"{params['sampling_timesteps']}: frames={rec['n_frames']} "
                f"inference_speed_frames_per_s={runs[name]['frames_per_s']:.1f} "
                f"e1_mm={errors['e1'][0]:.4f} e2_mm={errors['e2'][0]:.4f} "
                f"e3_mm={errors['e3'][0]:.4f} ev_mm={errors['ev'][0]:.4f} launches="
                f"{ {k: v for k, v in d['launches'].items() if v} } wall_s={d['wall_s']:.1f}")
        # 3 cameras x 4 windows of Walking in batches of 2, and a warm-up step.
        windows = runs["plain"]["pred"].shape[0] // FRAMES
        check(windows == 12, f"cli_humaneva: {windows} windows")
        forwards = (windows // BATCH + 1) * params["sampling_timesteps"]
        hold_eval_modes("cli_humaneva", runs, eval_want(forwards, per_call))
        say(f"phase 15 cli_humaneva vs the plain run (normalised units): " + "; ".join(
            f"{k} max_abs_dev={r['dev']:.3e} mpjpe={r['mpjpe']:.4e}"
            for k, r in runs.items() if k != "plain"))

        # Phase 16: 2D detections of one 486-frame video, 17 joints.
        rng = np.random.default_rng(0)
        np.savez_compressed(
            os.path.join(tmp, "data_2d_custom_smoke.npz"),
            positions_2d={"video.mp4": {"custom": [
                rng.uniform(0, 1080, (2 * FRAMES, JOINTS, 2)).astype("float32")]}},
            metadata={"layout_name": "coco", "num_joints": JOINTS,
                      "keypoints_symmetry": [[1, 3, 5], [2, 4, 6]],
                      "video_metadata": {"video.mp4": {"w": 1920, "h": 1080}}})
        weights17 = os.path.join(tmp, "seed0.bin")
        seed_weights(weights17, FRAMES, JOINTS, dev)
        errors, d = drive(cli_main, [
            "--config", config, "--dataset", "custom", "--keypoints", "smoke", "--data-root", tmp,
            "-str", "video.mp4", "-ste", "video.mp4", "--batch-size-eval", str(BATCH),
            "-c", os.path.join(tmp, "custom"), "--fast-eval", "--evaluate", weights17])
        say(f"phase 16 cli_custom: the report\n{d['text'].rstrip()}")
        (rec,) = d["records"]
        want_b1 = 2 * params["sampling_timesteps"] * 2 * DEPTH * per_call  # warm-up + one step
        check(all(line in d["text"] for line in REPORT_RUN + ("----custom----",))
              and all(len(v) == 1 and math.isnan(v[0]) for v in errors.values())
              and rec["n_frames"] == 2 * FRAMES and np.isfinite(rec["predictions"]).all()
              and d["launches"]["fused_transformer_block"] == want_b1,
              f"cli_custom: errors {errors}, frames {rec['n_frames']}, launches {d['launches']}")
        launches["cli_custom"], inner["cli_custom"] = d["launches"], d["inner"]
        say(f"phase 16 cli_custom: {rec['n_frames']} frames of 2D detections, predictions finite, "
            f"errors NaN (no ground truth); inference_speed_frames_per_s="
            f"{rec['n_frames'] / rec['model_time']:.1f}; B1 launches="
            f"{d['launches']['fused_transformer_block']}")
    torch.cuda.empty_cache()
    return launches, inner

TAIL_PAIRS = (2, 4, 6, 8)  # phase 17's float32 tails of the mixed step's final forward


def drive_tail(model, kw, inputs, pred_plain, ref, per_call, dev, card):
    """Phase 17: the flagship mixed eval step (bench.py's "mixed": 8 bf16
    steps with an f32 head, then the final step) whose final forward runs
    its last k block pairs and head at float32 and the first 8 - k pairs at
    bf16 (``make_mixed_diffusion(f32_tail_pairs=k)``, JAX's precision tail),
    k = 2, 4, 6, 8, in rows and cols, on phase 4's weights and x_T. Each run:
    B1's (and B2's) launches by dtype as counted, finite predictions, the
    deviation from the plain f32 eval beside phase 4b's (``ref``: the mixed
    and pure-bf16 runs), with phase 4b's bound (MPJPE no more than pure
    bf16's), and one timed step (median of 3). Returns ({path: launches},
    {path: inner counts})."""
    from diff3dhpe_torch import make_eval_step, make_mixed_diffusion

    def timed(step):
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(*inputs[:2], x_init=inputs[2])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return statistics.median(secs)

    launches, inner = {}, {}
    for mode, spatial, temporal in (("rows", "fused_transformer_block", "fused_transformer_block"),
                                    ("cols", "fused_transformer_block",
                                     "fused_temporal_block_cols")):
        for k in TAIL_PAIRS:
            step = make_eval_step(make_mixed_diffusion(model, mode, f32_tail_pairs=k, **kw),
                                  JOINTS_LEFT, JOINTS_RIGHT, device=dev)
            out, d = drive(step, *inputs[:2], x_init=inputs[2])
            # 8 bf16 steps of 16 block calls; the final step's first 8 - k
            # pairs at bf16 and its last k at f32.
            want = {}
            for name in (spatial, temporal):
                calls = DEPTH if spatial != temporal else 2 * DEPTH
                bf16_calls = (DDIM_STEPS - 1) * calls + (DEPTH - k) * calls // DEPTH
                want[name] = DDIM_STEPS * calls * per_call
                want[f"{name}_bf16"] = bf16_calls * per_call
            got = {key: d["launches"][key] for key in want}
            others = {key: v for key, v in d["launches"].items() if v and key not in want}
            check(got == want and not others,
                  f"phase 17 tail {k} {mode} launched {d['launches']}, expected {want}")
            check(out.shape == pred_plain.shape and torch.isfinite(out).all().item(),
                  f"phase 17 tail {k} {mode}: predictions not finite")
            dev_abs, err = (out - pred_plain).abs().max().item(), mpjpe(out, pred_plain)
            step_s = timed(step)
            path = f"mixed_tail{k}_{mode}"
            launches[path], inner[path] = d["launches"], d["inner"]
            say(f"phase 17 mixed eval step {mode} with a float32 tail of {k} pairs B={BATCH} "
                f"(x2 flip) DDIM-{DDIM_STEPS}: vs plain f32 max_abs_dev={dev_abs:.3e} "
                f"mpjpe={err:.4e} (phase 4b: mixed {ref['mixed'][mode]['mpjpe']:.4e}, pure bf16 "
                f"{ref['bf16']['mpjpe']:.4e}, the bound) step_s={step_s:.4f} "
                f"seq_per_s={BATCH / step_s:.3f} ({card}) launches={got}")
            check(err <= ref["bf16"]["mpjpe"], f"phase 17 tail {k} {mode} mpjpe {err:.4e} > the "
                  f"bf16 eval's {ref['bf16']['mpjpe']:.4e}")
            del step, out
    torch.cuda.empty_cache()
    return launches, inner


# Runs in a fresh process (phase 18): restores each artifact, runs it on
# each state dict with the same inputs, counts launches and times a step.
RESTORE_CHILD = r"""
import json, statistics, sys, time
import torch
spec = json.load(open(sys.argv[1]))
sys.path.insert(0, spec["root"])
from diff3dhpe_torch.io.checkpoint import load_torch_state_dict
from diff3dhpe_torch.io.export import restore_eval_step
from diff3dhpe_torch.ops import read_launches, reset_launches
inputs = torch.load(spec["inputs"])
# Each state dict on the card once, as a server holds it between calls.
weights = {name: {k: v.cuda() for k, v in load_torch_state_dict(p).items()}
           for name, p in spec["weights"].items()}
results = {}
for name, path in spec["artifacts"].items():
    t0 = time.perf_counter()
    step = restore_eval_step(path)
    restore_s = time.perf_counter() - t0
    for wname, state in weights.items():
        run = lambda: step(state, inputs["x2d"], inputs["x2d_flip"], inputs["x_init"])
        torch.cuda.synchronize()
        reset_launches()
        out = run()
        torch.cuda.synchronize()
        launches = read_launches()
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        torch.save(out.cpu(), f"{spec['out']}/{name}_{wname}.pt")
        results[f"{name}/{wname}"] = dict(launches=launches, step_s=statistics.median(secs),
                                          restore_s=restore_s)
print(json.dumps(results))
"""


def drive_export(dev, per_call, card):
    """Phase 18: the serving export at the flagship shape (243 frames, embed
    512, depth 8, 8 heads, DDIM-9, batch 2 x2 flip) for the mixed mode in
    rows (through cli/export.py from a seed-0 .bin) and cols
    (``io.export.export_eval_step(temporal_mode="cols")``) and for fast f32
    (through cli/export.py): the export's seconds and the artifact's bytes;
    the artifact restored in a fresh process and run on the same x_T with
    the seed-0 weights and with a seed-1 state dict, each equal bit for bit
    to the live step (``Runner.eval_step``; in cols the same sampler in
    cols) on those weights, with the same launches by wrapper and dtype;
    then bench_torch.py with BENCH_EXPORTED=1 (mixed, rows, 4 steps a
    loop). The cols and f32 artifacts and the bench's run DDIM-CUT_DDIM_STEPS
    (the mixed rows one, the shipped mode, DDIM-9). Returns ({path:
    launches}, {path: inner counts})."""
    from diff3dhpe_torch.cli.args import args_to_overrides
    from diff3dhpe_torch.cli.export import build_export_parser
    from diff3dhpe_torch.cli.export import main as export_main
    from diff3dhpe_torch.config import load_config
    from diff3dhpe_torch.engine.runner import Runner
    from diff3dhpe_torch.io.checkpoint import load_torch_state_dict
    from diff3dhpe_torch.io.export import export_eval_step, live_eval_step

    here = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(here, CLI_CONFIG)
    mixed = ["--fast-eval", "--compute-dtype", "bfloat16", "--eval-f32-head",
             "--eval-f32-final-steps", "1"]
    modes = {"mixed_rows": (mixed, "rows", DDIM_STEPS),
             "mixed_cols": (mixed, "cols", CUT_DDIM_STEPS),
             "fast_f32": (["--fast-eval"], "rows", CUT_DDIM_STEPS)}
    launches, inner = {}, {}
    gen = torch.Generator(device=dev).manual_seed(18)
    inputs = dict(x2d=torch.rand(BATCH, FRAMES, JOINTS, 2, generator=gen, device=dev) * 2 - 1,
                  x_init=torch.randn(2 * BATCH, FRAMES, JOINTS, 3, generator=gen, device=dev))
    inputs["x2d_flip"] = inputs["x2d"].flip(-1)
    with tempfile.TemporaryDirectory() as tmp:
        weights = {"seed0": os.path.join(tmp, "seed0.bin"), "seed1": os.path.join(tmp, "seed1.bin")}
        seed_weights(weights["seed0"], FRAMES, JOINTS, dev)
        from diff3dhpe_torch import MixSTEDenoiser

        torch.save(MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED,
                                  depth=DEPTH, num_heads=HEADS, mlp_ratio=MLP_RATIO, seed=1,
                                  device=dev).state_dict(), weights["seed1"])
        torch.save({k: v.cpu() for k, v in inputs.items()}, os.path.join(tmp, "inputs.pt"))
        artifacts, live = {}, {}
        for name, (flags, tmode, ddim) in modes.items():
            path = os.path.join(tmp, f"{name}.pt2")
            argv = ["--config", config, "--sampling_timesteps", str(ddim),
                    "--evaluate", weights["seed0"], "--output", path,
                    "--export-batch-size", str(BATCH)] + flags
            args = build_export_parser().parse_args(argv)
            cfg = load_config(args.config, args_to_overrides(args))
            t0 = time.perf_counter()
            if tmode == "rows":
                with contextlib.redirect_stdout(io.StringIO()):
                    data = export_main(argv)
            else:
                runner = Runner(cfg, JOINTS, JOINTS_LEFT, JOINTS_RIGHT, device=dev)
                runner.set_params(load_torch_state_dict(weights["seed0"]))
                data = export_eval_step(runner, BATCH, path, temporal_mode=tmode)
                del runner
            export_s = time.perf_counter() - t0
            check(len(data) == os.path.getsize(path) > 0, f"phase 18 {name}: the artifact")
            artifacts[name] = path
            runner = Runner(cfg, JOINTS, JOINTS_LEFT, JOINTS_RIGHT, device=dev)
            for wname, wpath in weights.items():
                runner.set_params(load_torch_state_dict(wpath))
                step = runner.eval_step if tmode == "rows" else live_eval_step(runner, tmode)
                out, d = drive(step, inputs["x2d"], inputs["x2d_flip"], x_init=inputs["x_init"])
                secs = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    step(inputs["x2d"], inputs["x2d_flip"], x_init=inputs["x_init"])
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                live[f"{name}/{wname}"] = dict(out=out.cpu(), launches=d["launches"],
                                               step_s=statistics.median(secs))
                launches[f"export_live_{name}_{wname}"] = d["launches"]
                inner[f"export_live_{name}_{wname}"] = d["inner"]
            say(f"phase 18 export {name} ({tmode}) B={BATCH} (x2 flip) DDIM-{ddim}: "
                f"export_s={export_s:.2f} artifact_bytes={len(data)}")
            del runner
        torch.cuda.empty_cache()
        spec = dict(root=here, inputs=os.path.join(tmp, "inputs.pt"), weights=weights,
                    artifacts=artifacts, out=tmp)
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", RESTORE_CHILD, os.path.join(tmp, "spec.json")],
                              cwd=here, capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"phase 18 restore process exited {proc.returncode}:\n"
              f"{proc.stderr[-3000:]}")
        served = json.loads(proc.stdout.strip().splitlines()[-1])
        child_s = time.perf_counter() - t0
        for key, r in served.items():
            name, wname = key.split("/")
            got = torch.load(os.path.join(tmp, f"{name}_{wname}.pt"))
            want = live[key]
            check(torch.equal(got, want["out"]), f"phase 18 {key}: the restored artifact differs "
                  f"from the live step by {(got - want['out']).abs().max().item():.3e}")
            live_counts = {k: v for k, v in want["launches"].items() if k != "plain_attention_calls"}
            check(r["launches"] == live_counts and any(r["launches"].values()),
                  f"phase 18 {key}: launches {r['launches']}, live {live_counts}")
            check(torch.isfinite(got).all().item(), f"phase 18 {key}: not finite")
            say(f"phase 18 restored {key} in a fresh process: equals the live step bit for bit, "
                f"launches={ {k: v for k, v in r['launches'].items() if v} }, "
                f"restore_s={r['restore_s']:.2f} step_s={r['step_s']:.4f} "
                f"seq_per_s={BATCH / r['step_s']:.3f} (the live step in this run: "
                f"{BATCH / want['step_s']:.3f}) ({card})")
        check(not torch.equal(live["mixed_rows/seed0"]["out"], live["mixed_rows/seed1"]["out"]),
              "phase 18: two checkpoints gave the same prediction")
        say(f"phase 18 the fresh restore process took {child_s:.1f} s")
        cross_device(config, mixed, tmp, dev)

    # bench_torch.py times the restored artifact (mixed, rows): 3 loops of 4.
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(here, "bench_torch.py")], cwd=here,
                          env=dict(os.environ, BENCH_EXPORTED="1", BENCH_ITERS="4",
                                   BENCH_DDIM=str(CUT_DDIM_STEPS)),
                          capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"bench_torch.py BENCH_EXPORTED=1 exited {proc.returncode}:\n"
          f"{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    d = line["detail"]
    want = dict(zip(("fused_transformer_block", "fused_transformer_block_bf16"),
                    mixed_b1(3 * 4 * CUT_DDIM_STEPS, CUT_DDIM_STEPS)))
    check(d["exported_artifact"] and d["export"]["artifact_bytes"] > 0
          and d["card"] == torch.cuda.get_device_name(0)
          and math.isfinite(line["value"]) and line["value"] > 0 and d["launches"] == want,
          f"bench_torch.py BENCH_EXPORTED=1: {line}")
    launches["bench_torch_exported"] = dict(
        {k: 0 for k in next(iter(launches.values()))}, **d["launches"])
    say(f"phase 18 bench_torch.py BENCH_EXPORTED=1 BENCH_ITERS=4 BENCH_DDIM={CUT_DDIM_STEPS} "
        f"({time.perf_counter() - t0:.1f} s): {proc.stdout.strip().splitlines()[-1]}")
    return launches, inner


def cross_device(config, mixed, tmp, dev):
    """Phase 18, the export's platforms (ROADMAP A.13): an eval step
    exported through cli/export.py with --export-platforms cpu,cuda on the
    card and restored on the CPU, and one exported on the CPU and restored
    on the card (``restore_eval_step(device=...)``: move_to_device_pass),
    each held against the live step of a Runner on the device it runs on:
    bit for bit at f32 (fast-eval), the bf16 bars for mixed. At 27 frames,
    depth 1, DDIM-3, batch 2 (x2 flip): the CPU runs the plain versions."""
    from diff3dhpe_torch import MixSTEDenoiser
    from diff3dhpe_torch.cli.args import args_to_overrides
    from diff3dhpe_torch.cli.export import build_export_parser
    from diff3dhpe_torch.cli.export import main as export_main
    from diff3dhpe_torch.config import load_config
    from diff3dhpe_torch.engine.runner import Runner
    from diff3dhpe_torch.io.export import restore_eval_step

    frames, depth = 27, 1
    weights = os.path.join(tmp, "cross.bin")
    state = MixSTEDenoiser(num_frame=frames, num_joints=JOINTS, embed_dim=EMBED, depth=depth,
                           num_heads=HEADS, mlp_ratio=MLP_RATIO, seed=0, device="cpu").state_dict()
    torch.save(state, weights)
    gen = torch.Generator().manual_seed(180)
    x2d = torch.rand(BATCH, frames, JOINTS, 2, generator=gen) * 2 - 1
    x_init = torch.randn(2 * BATCH, frames, JOINTS, 3, generator=gen)
    lines = []
    for export_dev, run_dev in (("cuda", "cpu"), ("cpu", "cuda")):
        for name, flags in (("fast_f32", ["--fast-eval"]), ("mixed", mixed)):
            path = os.path.join(tmp, f"cross_{export_dev}_{name}.pt2")
            argv = ["--config", config, "--sampling_timesteps", "3", "-frame", str(frames),
                    "-s", str(frames), "--transformer_depth", str(depth), "--evaluate", weights,
                    "--output", path, "--export-batch-size", str(BATCH),
                    "--export-platforms", "cpu,cuda"] + flags
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                export_main(argv, device=export_dev)
            export_s = time.perf_counter() - t0
            step = restore_eval_step(path, device=run_dev)
            check(step.meta["platforms"] == ["cpu", "cuda"]
                  and step.meta["device"].startswith(export_dev),
                  f"phase 18 cross-device {name}: meta {step.meta}")
            cfg = load_config(config, args_to_overrides(build_export_parser().parse_args(argv)))
            runner = Runner(cfg, JOINTS, JOINTS_LEFT, JOINTS_RIGHT, device=run_dev)
            runner.set_params(state)
            inputs = [a.to(run_dev) for a in (x2d, x2d.flip(-1), x_init)]
            served = step(state, *inputs).float().cpu()
            live = runner.eval_step(inputs[0], inputs[1], x_init=inputs[2]).float().cpu()
            check(torch.isfinite(served).all().item(), f"phase 18 cross-device {name}: not finite")
            if name == "fast_f32":
                check(torch.equal(served, live), f"phase 18 {export_dev} artifact on {run_dev} "
                      f"{name}: differs from the live step by "
                      f"{(served - live).abs().max().item():.3e}")
                err = "bit for bit"
            else:
                _, max_rel, mean_rel = bf16_errs(served, live)
                check(max_rel <= BF16_MAX_TOL and mean_rel <= BF16_MEAN_TOL,
                      f"phase 18 {export_dev} artifact on {run_dev} {name}: max rel "
                      f"{max_rel:.3e}, mean {mean_rel:.3e}")
                err = f"max rel {max_rel:.3e}, mean rel {mean_rel:.3e}"
            lines.append(f"{name} exported on {export_dev} ({export_s:.1f} s, final_prec "
                         f"{step.meta['final_prec']}) restored on {run_dev}: {err} against the "
                         f"live {run_dev} step")
            del runner, step
    torch.cuda.empty_cache()
    say("phase 18 export platforms cpu,cuda (A.13), 27 frames, depth 1, DDIM-3: "
        + "; ".join(lines))


def drive_viz(dev, per_call, card):
    """Phase 19: the visualisation's model work, cli/viz.py::compute, on
    --synthetic data (S9, the first action, camera 0: 4 windows of 243
    frames) with configs/h36m_gt_s2s_243f.json (its DDIM-5, fast-eval at
    f32; the eval batch cut to 2, since a sequence pads its windows to a
    whole batch) at repeat_n 1 and 2: the predictions, the forward chain
    (20 snapshots), the reverse DDIM chain on the plain module, whose last
    state must equal the live DDIM sample on the same x_T bit for bit, and
    the hypotheses; then ``p_sample_loop`` over all T = 1,000 steps at batch
    1 through the module with use_pallas_attention (B6 for the joints, B3
    for the frames). Checks shapes, finite values, chain lengths and the
    launches; prints the seconds of each part. Returns ({path: launches},
    {path: inner counts})."""
    import numpy as np

    from diff3dhpe_torch import GaussianDiffusion, MixSTEDenoiser, make_denoise_fn
    from diff3dhpe_torch.cli.args import args_to_overrides
    from diff3dhpe_torch.cli.viz import build_viz_parser, compute
    from diff3dhpe_torch.config import load_config

    here = os.path.dirname(os.path.abspath(__file__))
    launches, inner = {}, {}
    gen = torch.Generator(device=dev).manual_seed(19)
    for repeat_n in (1, 2):
        args = build_viz_parser().parse_args([
            "--config", os.path.join(here, CLI_CONFIG), "--synthetic", "-str", "S1", "-ste", "S9",
            "--fast-eval", "--batch-size-eval", str(BATCH), "--repeat_n", str(repeat_n)])
        cfg = load_config(args.config, args_to_overrides(args))
        x_rev = torch.randn(1, FRAMES, JOINTS, 3, generator=gen, device=dev)
        out, d = drive(compute, cfg, args, dev, dict(reverse_x_init=x_rev))
        steps, samples = cfg.sampling_timesteps, args.viz_chain_samples
        shapes = dict(forward_chain=(FRAMES, JOINTS, 3, samples),
                      reverse_states=(FRAMES, JOINTS, 3, steps),
                      reverse_x0=(FRAMES, JOINTS, 3, steps),
                      predictions=(out["windows"] * FRAMES, JOINTS, 3))
        if repeat_n > 1:
            shapes["hypotheses"] = (repeat_n, FRAMES, JOINTS, 3)
        for key, shape in shapes.items():
            check(tuple(out[key].shape) == shape and bool(np.isfinite(out[key]).all()),
                  f"phase 19 repeat_n={repeat_n} {key}: shape {out[key].shape}, want {shape}")
        check(len(out["t_list"]) == samples and (out["hypotheses"] is None) == (repeat_n == 1),
              f"phase 19 repeat_n={repeat_n}: t_list {out['t_list']}")
        runner = out["runner"]
        sample = runner.diffusion.ddim_sample_loop(out["window_2d"], (1, FRAMES, JOINTS, 3),
                                                   x_init=x_rev)
        check(torch.equal(torch.from_numpy(out["reverse_states"][..., -1]), sample[0].cpu()),
              f"phase 19 repeat_n={repeat_n}: the chain's last state is not the DDIM sample")
        # Runner.evaluate: the batches and a warm-up step; the hypotheses one
        # sampling loop; each DDIM-5 loop 16 B1 calls a step. The reverse
        # chain runs the plain module: 16 attention calls a step.
        loops = -(-out["windows"] // BATCH) + 1 + (repeat_n > 1)
        want = dict(fused_transformer_block=loops * steps * 2 * DEPTH * per_call,
                    plain_attention_calls=steps * 2 * DEPTH)
        got = {k: v for k, v in d["launches"].items() if v}
        check(got == want, f"phase 19 repeat_n={repeat_n} launched {got}, expected {want}")
        path = f"viz_compute_repeat{repeat_n}"
        launches[path], inner[path] = d["launches"], d["inner"]
        say(f"phase 19 cli/viz.py compute repeat_n={repeat_n} ({out['windows']} windows, DDIM-"
            f"{steps}, fast-eval f32): {d['wall_s']:.1f} s; forward chain {shapes['forward_chain']},"
            f" reverse chain {shapes['reverse_states']} (last state = the DDIM sample, bit for "
            f"bit), hypotheses {shapes.get('hypotheses')}, e1_mm="
            f"{out['metrics']['e1']:.3f}; launches={got} ({card})")
        del out, runner, sample

    model = MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED, depth=DEPTH,
                           num_heads=HEADS, mlp_ratio=MLP_RATIO, use_pallas=True, seed=0,
                           device=dev).eval()
    diffusion = GaussianDiffusion.create(make_denoise_fn(model), timesteps=TIMESTEPS,
                                         beta_schedule="cosine")
    x_cond = torch.rand(1, FRAMES, JOINTS, 2, generator=gen, device=dev) * 2 - 1
    x_t = torch.randn(1, FRAMES, JOINTS, 3, generator=gen, device=dev)
    noises = torch.randn(TIMESTEPS, 1, FRAMES, JOINTS, 3, generator=gen, device=dev)
    x0, d = drive(diffusion.p_sample_loop, x_cond, (1, FRAMES, JOINTS, 3), x_init=x_t,
                  noises=noises)
    want = dict(grand_attention_fullseq=TIMESTEPS * DEPTH, packed_grand_attention=TIMESTEPS * DEPTH)
    got = {k: v for k, v in d["launches"].items() if v}
    check(got == want, f"phase 19 p_sample_loop launched {got}, expected {want}")
    check(x0.shape == (1, FRAMES, JOINTS, 3) and torch.isfinite(x0).all().item(),
          "phase 19 p_sample_loop: the sample")
    launches["p_sample_loop_use_pallas"], inner["p_sample_loop_use_pallas"] = (d["launches"],
                                                                              d["inner"])
    say(f"phase 19 p_sample_loop T={TIMESTEPS} B=1 through the use_pallas module: "
        f"{d['wall_s']:.2f} s per {TIMESTEPS} steps, |x0| max {x0.abs().max().item():.3f}, "
        f"launches={got} ({card})")
    del model, diffusion, noises
    torch.cuda.empty_cache()
    return launches, inner



# Phase 20 (a): cli.run.main as rank 0 of "torchrun --nproc-per-node 1"
# (nccl): every launch and the train loop's host waits counted as phase
# 11 counts them; rank 0 writes them to spec["out"].
LAUNCHED_RANK = r"""
import json, os, sys, warnings
import torch
spec = json.load(open(sys.argv[1]))
sys.path.insert(0, spec["root"])
from diff3dhpe_torch.cli.run import main
from diff3dhpe_torch.engine.runner import Runner
from diff3dhpe_torch.models import mixste
from diff3dhpe_torch.ops import (fused_attention_block, fused_temporal_block_cols,
                                 fused_transformer_block, read_launches, reset_launches)
fit, evaluate, plain_attention = Runner.fit, Runner.evaluate, mixste.grand_attention
record = dict(evals=[], sync_warnings=[], plain_attention_calls=0)

def watched(batches):
    def gen(*args, **kwargs):
        for b in batches(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("warn")  # the step's body: upload + train step
            try:
                yield b
            finally:
                torch.cuda.set_sync_debug_mode(0)
    return gen

def recording_fit(self, train_ds, val_ds, *args, **kwargs):
    train_ds.batches = watched(train_ds.batches)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result = fit(self, train_ds, val_ds, *args, **kwargs)
    record["sync_warnings"] += [str(w.message) for w in caught
                                if "called a synchronizing CUDA operation" in str(w.message)]
    del train_ds.batches
    record.update(mesh=repr(self.mesh), n_val=len(val_ds), losses_train=result["losses_train"],
                  losses_valid=[float(v) for v in result["losses_valid"]],
                  batches=sum(1 for _ in train_ds.batches(self.cfg.batch_size, shuffle=True,
                                                          drop_last=True)))
    return result

def recording_evaluate(self, test_ds, *args, **kwargs):
    m = evaluate(self, test_ds, *args, **kwargs)
    record["evals"].append(m["n_frames"])
    return m

def counting_attention(*args, **kwargs):
    record["plain_attention_calls"] += 1
    return plain_attention(*args, **kwargs)

Runner.fit, Runner.evaluate, mixste.grand_attention = (recording_fit, recording_evaluate,
                                                       counting_attention)
import chip_smoke
blocks = (fused_transformer_block, fused_temporal_block_cols, fused_attention_block)
reset_launches()
chip_smoke.reset_inner(blocks)
errors = main(spec["argv"])
torch.cuda.synchronize()
record.update(errors={k: [float(e) for e in v] for k, v in errors.items()},
              launches=dict(read_launches(), plain_attention_calls=record["plain_attention_calls"]),
              inner=chip_smoke.count_inner(blocks))
if int(os.environ["RANK"]) == 0:
    with open(spec["out"], "w") as f:
        json.dump(record, f)
"""

# Phase 20 (b): one of two gloo ranks on the one card.
GLOO_RANK = r"""
import json, sys
import torch
spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
sys.path.insert(0, spec["root"])
import chip_smoke
from diff3dhpe_torch.parallel import start_ranks
mesh = start_ranks("cuda:0", backend="gloo", init_method="file://" + spec["rendezvous"],
                   rank=rank, world_size=spec["world_size"], timeout=600)
try:
    torch.save(chip_smoke.parallel_cases(mesh.device, mesh, spec["artifact"]),
               f"{spec['out']}/rank{rank}.pt")
finally:
    torch.distributed.destroy_process_group()
"""

PAR_EVAL_BATCH, PAR_TRAIN_BATCH, PAR_TRAIN_STEPS = 4, 8, 3


def counted(fn, *args, **kwargs):
    """(fn's result, the launches of every kernel wrapper, the blocks'
    launches by kind) of one synchronised call."""
    from diff3dhpe_torch.ops import (
        fused_attention_block, fused_temporal_block_cols, fused_transformer_block, read_launches,
        reset_launches,
    )

    blocks = (fused_transformer_block, fused_temporal_block_cols, fused_attention_block)
    torch.cuda.synchronize()
    reset_launches()
    reset_inner(blocks)
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, read_launches(), count_inner(blocks)


def parallel_cases(dev, mesh=None, artifact=None):
    """Phase 20 (b)'s cases on ``mesh`` (a rank of the gloo group), or with
    ``mesh`` None in this process alone, at full width on seed-0 weights:
    the f32 fused and the mixed flip-TTA DDIM-9 eval steps at global batch
    PAR_EVAL_BATCH, x_T from a generator seeded alike; the fast-train step
    with attn_bwd at 4 heads (configs/h36m_gt_s2s_243f_tpu.json's
    geometry), one at f32 and PAR_TRAIN_STEPS at bf16, at global batch
    PAR_TRAIN_BATCH with t, noise and drop-path scales from a generator
    seeded alike; on a mesh, the f32 fused step exported sharded to
    ``artifact`` (rank 0 writes it) and restored in every rank. Returns
    CPU tensors, launches and seconds."""
    from diff3dhpe_torch import (
        GaussianDiffusion, MixSTEDenoiser, Runner, flip_pose, make_eval_step,
        make_fast_denoise_fn, make_fast_train_denoise_fn, make_mixed_diffusion, make_optimizer,
        make_train_step,
    )
    from diff3dhpe_torch.config import Config
    from diff3dhpe_torch.io.export import export_eval_step, restore_eval_step

    res = {}
    size = 1 if mesh is None else mesh.size
    gen = torch.Generator(device=dev).manual_seed(20)
    x2d = torch.rand(PAR_EVAL_BATCH, FRAMES, JOINTS, 2, generator=gen, device=dev) * 2 - 1
    x2d_flip = flip_pose(x2d, JOINTS_LEFT, JOINTS_RIGHT)
    model = MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED, depth=DEPTH,
                           num_heads=HEADS, mlp_ratio=MLP_RATIO, seed=0, device=dev).eval()
    kw = dict(timesteps=TIMESTEPS, sampling_timesteps=DDIM_STEPS, clip_denoised=True,
              beta_schedule="cosine")
    for name, diffusion in (("f32", GaussianDiffusion.create(make_fast_denoise_fn(model), **kw)),
                            ("mixed", make_mixed_diffusion(model, **kw))):
        step = make_eval_step(diffusion, JOINTS_LEFT, JOINTS_RIGHT, device=dev, mesh=mesh)
        step(x2d, x2d_flip, generator=torch.Generator(device=dev).manual_seed(1))  # warm-up
        t0 = time.perf_counter()
        pred, launches, inner = counted(step, x2d, x2d_flip,
                                        generator=torch.Generator(device=dev).manual_seed(22))
        res[f"eval_{name}"] = dict(pred=pred.cpu(), launches=launches, inner=inner,
                                   step_s=time.perf_counter() - t0)
    del model

    dkw = dict(timesteps=TIMESTEPS, sampling_timesteps=DDIM_STEPS, clip_denoised=True,
               clip_loss=True, beta_schedule="cosine")
    for name, dtype, steps in (("f32", torch.float32, 1),
                               ("bf16", torch.bfloat16, PAR_TRAIN_STEPS)):
        model = MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED, depth=DEPTH,
                               num_heads=HEADS4, mlp_ratio=MLP_RATIO, seed=0, device=dev).train()
        diffusion = GaussianDiffusion.create(make_fast_train_denoise_fn(
            model, DROP_PATH, attn_bwd=True, dtype=dtype), **dkw)
        optimizer, scheduler = make_optimizer(model.parameters(), LR, LR_DECAY, 1000)
        step = make_train_step(diffusion, optimizer, scheduler, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(23)
        gt = torch.randn(PAR_TRAIN_BATCH, FRAMES, JOINTS, 3, generator=gen, device=dev) * 0.3
        x2d_t = torch.rand(PAR_TRAIN_BATCH, FRAMES, JOINTS, 2, generator=gen, device=dev) * 2 - 1
        draws = torch.Generator(device=dev).manual_seed(24)
        reduce_s = []
        if mesh is not None:
            average = mesh.average_grads_

            def timed_average(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = average(*args, **kwargs)
                torch.cuda.synchronize()
                reduce_s.append(time.perf_counter() - t0)
                return out

            mesh.average_grads_ = timed_average
        losses, step_s = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            loss, launches, inner = counted(step, gt, x2d_t, generator=draws)
            step_s.append(time.perf_counter() - t0)
            losses.append(loss.item())
            if i == 0:
                grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
                res[f"train_{name}_launches"] = dict(launches=launches, inner=inner)
        if mesh is not None:
            del mesh.average_grads_
        res[f"train_{name}"] = dict(
            grads=grads, losses=losses, step_s=step_s, reduce_s=reduce_s,
            params={n: p.detach().cpu() for n, p in model.named_parameters()})
        del model, diffusion, optimizer, scheduler, step
        torch.cuda.empty_cache()

    if mesh is not None:
        # The f32 fused step of a data-parallel Runner, exported sharded
        # (rank 0 writes it), restored in every rank, against the live
        # step (phase 18 exports the mixed one; f32 traces in half its time,
        # and at DDIM-CUT_DDIM_STEPS in a third of that).
        cfg = Config(number_of_frames=FRAMES, embed_dim=EMBED, transformer_depth=DEPTH,
                     num_heads=HEADS, timesteps=TIMESTEPS, sampling_timesteps=CUT_DDIM_STEPS,
                     fast_eval=True, mesh_shape=f"data:{size}", seed=0)
        runner = Runner(cfg, JOINTS, JOINTS_LEFT, JOINTS_RIGHT, mesh=mesh)
        x_init = torch.randn(2 * PAR_EVAL_BATCH, FRAMES, JOINTS, 3, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(25))
        t0 = time.perf_counter()
        data = export_eval_step(runner, PAR_EVAL_BATCH, artifact, sharded=True)
        export_s = time.perf_counter() - t0
        served = restore_eval_step(artifact, mesh)
        out, launches, inner = counted(served, runner.model.state_dict(), x2d, x2d_flip, x_init)
        live, live_launches, _ = counted(runner.eval_step, x2d, x2d_flip, x_init=x_init)
        res["export"] = dict(served=out.cpu(), live=live.cpu(), launches=launches, inner=inner,
                             live_launches=live_launches, export_s=export_s,
                             bytes=None if data is None else len(data), meta=served.meta)
        del runner, served
        torch.cuda.empty_cache()
    return res


def want_fit(zero, per_step, fwd_b1, ddim, b_eval, batches, n_val, epochs, evals, depth=DEPTH):
    """The launches of a cli.run training run: per train step ``per_step``
    (B1's 2·depth calls, B3 and B6 once and B4 (2 kernels) once per block
    pair in the recompute); per validation batch and per evaluate batch (with each evaluate's
    warm-up batch) ``ddim`` fused forwards of ``fwd_b1`` B1 launches, and
    the validation loss's two plain-module forwards of 2·depth attention
    calls each."""
    steps = epochs * batches
    val_batches = -(-n_val // b_eval)
    eval_batches = sum(-(-(n // FRAMES) // b_eval) + 1 for n in evals)
    forwards = ddim * (epochs * val_batches + eval_batches)
    return dict(zero, fused_transformer_block=steps * per_step["fused_transformer_block"]
                + forwards * fwd_b1,
                grand_attention_fullseq=steps * per_step["grand_attention_fullseq"],
                grand_attention_bwd=steps * per_step["grand_attention_bwd"],
                packed_grand_attention=steps * per_step["packed_grand_attention"],
                plain_attention_calls=epochs * val_batches * 2 * 2 * depth)


def grad_rel_l2(got, ref):
    """sqrt(sum |got - ref|²) / sqrt(sum |ref|²) over every parameter."""
    num = sum(float((got[n] - g).double().pow(2).sum()) for n, g in ref.items())
    den = sum(float(g.double().pow(2).sum()) for g in ref.values())
    return math.sqrt(num / den)


def drive_parallel(dev, per_call, per_step, card):
    """Phase 20: data parallelism (diff3dhpe_torch/parallel). (a) NCCL at
    world size 1 through the real launcher: ``python -m
    torch.distributed.run --standalone --nproc-per-node 1`` runs
    cli.run.main with ``--mesh-shape data:1`` on phase 11's command line (1
    epoch, a checkpoint), its launches and its train loop's host waits
    counted in the rank; then --evaluate best_epoch in this process alone,
    its report against the launched run's. (b) Two ranks on the one card
    over gloo (NCCL refuses two ranks on one device; gloo moves CUDA
    tensors through host memory): ``parallel_cases`` in each, against the
    same cases in this process alone. Returns ({path: launches}, {path:
    inner counts})."""
    from diff3dhpe_torch.cli.run import main as cli_main

    here = os.path.dirname(os.path.abspath(__file__))
    launches, inner = {}, {}
    with open(os.path.join(here, CLI_CONFIG)) as f:
        config = json.load(f)
    config["params"].update(fast_train=True, fast_train_attn_bwd=True, fast_eval=True)
    ddim, b_eval = config["params"]["sampling_timesteps"], 8
    with tempfile.TemporaryDirectory() as tmp:
        # (a) torchrun, nccl, world size 1.
        train_config = os.path.join(tmp, "train.json")
        with open(train_config, "w") as f:
            json.dump(config, f)
        run_dir = os.path.join(tmp, "run")
        common = ["--config", train_config, "--synthetic", "-str", "S1,S5", "-ste", "S9", "-a", "*",
                  "--batch-size-eval", "8", "--checkpoint-frequency", "1", "-c", run_dir]
        spec = dict(root=here, argv=common + ["-e", "1", "--mesh-shape", "data:1"],
                    out=os.path.join(tmp, "launched.json"))
        for name, text in (("spec.json", json.dumps(spec)), ("rank.py", LAUNCHED_RANK)):
            with open(os.path.join(tmp, name), "w") as f:
                f.write(text)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc-per-node", "1", os.path.join(tmp, "rank.py"),
                               os.path.join(tmp, "spec.json")], cwd=here, capture_output=True,
                              text=True, timeout=900)
        launch_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"phase 20a torchrun exited {proc.returncode}:\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        with open(spec["out"]) as f:
            rec = json.load(f)
        check("DataMesh(rank=0, size=1, backend='nccl', device='cuda:0')" == rec["mesh"],
              f"phase 20a ran as {rec['mesh']}")
        check("INFO: data parallel: world size 1, backend nccl, rank 0 on device cuda:0"
              in proc.stdout, "phase 20a: no INFO line naming the ranks")
        single, d = drive(cli_main, common + ["--evaluate", "best_epoch"])
        report_dev = max(abs(a - b) for k in ("e1", "e2", "e3", "ev")
                         for a, b in zip(single[k], rec["errors"][k], strict=True))
        check(report_dev <= EVAL_REPORT_TOL_MM, f"phase 20a: --evaluate best_epoch in one process "
              f"deviates from the launched run's report by {report_dev:.3e} mm")
        check(not rec["sync_warnings"], f"phase 20a: the train loop made the host wait for the "
              f"card {len(rec['sync_warnings'])} times under nccl: {rec['sync_warnings'][:3]}")
        zero = {k: 0 for k in rec["launches"]}
        fwd_b1 = 2 * DEPTH * per_call
        want = want_fit(zero, per_step, fwd_b1, ddim, b_eval, rec["batches"], rec["n_val"], 1,
                        rec["evals"])
        single_evals = [r["n_frames"] for r in d["records"]]
        want_single = want_fit({k: 0 for k in d["launches"]}, per_step, fwd_b1, ddim, b_eval,
                               rec["batches"], rec["n_val"], 0, single_evals)
        check(rec["launches"] == want, f"phase 20a launched {rec['launches']}, expected {want}")
        check(d["launches"] == want_single, f"phase 20a --evaluate launched {d['launches']}, "
              f"expected {want_single}")
        launches["parallel_nccl_fit"], inner["parallel_nccl_fit"] = rec["launches"], rec["inner"]
        launches["parallel_nccl_evaluate"], inner["parallel_nccl_evaluate"] = (d["launches"],
                                                                               d["inner"])
        say(f"phase 20a torchrun --nproc-per-node 1 (backend nccl, world size 1, rank 0 on "
            f"cuda:0), cli.run.main --mesh-shape data:1 on {CLI_CONFIG} with fast_train, "
            f"fast_train_attn_bwd, fast_eval: {rec['batches']} steps of "
            f"{config['params']['batch_size']}, train loss {rec['losses_train']}, val MPJPE (m) "
            f"{rec['losses_valid']}, report {rec['errors']}; --evaluate best_epoch in one "
            f"process: max |d| {report_dev:.3e} mm; syncs in the train loop "
            f"{len(rec['sync_warnings'])}; launches (launched run) "
            f"{ {k: v for k, v in rec['launches'].items() if v} } as counted; wall_s "
            f"{launch_s:.1f} (launcher, rank start and build load included)")

        profiler_probe("after phase 20a")

        # (b) two gloo ranks on the one card, against this process alone.
        world = 2
        spec = dict(root=here, rendezvous=os.path.join(tmp, "rendezvous"), world_size=world,
                    out=tmp, artifact=os.path.join(tmp, "eval_sharded.pt2"))
        ranks_s = spawn_ranks(GLOO_RANK, spec, tmp, "phase 20b gloo", 900)
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
               for r in range(world)]
    torch.cuda.empty_cache()
    profiler_probe("after phase 20b's gloo ranks")
    ref = parallel_cases(dev)
    lines = []
    for name in ("f32", "mixed"):
        key = f"eval_{name}"
        out0, want_out = got[0][key]["pred"], ref[key]["pred"]
        check(torch.equal(out0, got[1][key]["pred"]), f"phase 20b {key}: the ranks' gathered "
              f"predictions differ")
        check(torch.isfinite(out0).all().item()
              and out0.shape == (PAR_EVAL_BATCH, FRAMES, JOINTS, 3),
              f"phase 20b {key}: shape {tuple(out0.shape)} or not finite")
        abs_err, rel = rel_err(out0, want_out)
        if name == "f32":
            check(rel <= 1e-5, f"phase 20b {key}: 2 ranks vs 1 max |d| {abs_err:.3e}, {rel:.3e} "
                  f"of max|out| > 1e-5")
        else:
            _, max_rel, mean_rel = bf16_errs(out0, want_out)
            check(max_rel <= BF16_MAX_TOL and mean_rel <= BF16_MEAN_TOL, f"phase 20b {key}: 2 "
                  f"ranks vs 1 max rel {max_rel:.3e}, mean rel {mean_rel:.3e}")
        for r in range(world):
            check(got[r][key]["launches"] == ref[key]["launches"], f"phase 20b {key} rank {r} "
                  f"launched {got[r][key]['launches']}, one process {ref[key]['launches']}")
            launches[f"parallel_gloo_{key}_rank{r}"] = got[r][key]["launches"]
            inner[f"parallel_gloo_{key}_rank{r}"] = got[r][key]["inner"]
        lines.append(f"{key} (global batch {PAR_EVAL_BATCH}, DDIM-{DDIM_STEPS}, flip-TTA) vs one "
                     f"process: max |d| {abs_err:.3e} ({rel:.3e} of max|out|), bit for bit "
                     f"{torch.equal(out0, want_out)}, step_s per rank "
                     f"{[round(g[key]['step_s'], 3) for g in got]} (one process "
                     f"{ref[key]['step_s']:.3f})")
    for name, bar in (("f32", 1e-5), ("bf16", 1e-2)):
        key = f"train_{name}"
        g0, g1 = got[0][key], got[1][key]
        rel = grad_rel_l2(g0["grads"], ref[key]["grads"])
        check(rel <= bar, f"phase 20b {key}: step-1 gradients of 2 ranks vs 1, relative L2 "
              f"{rel:.3e} > {bar}")
        same = all(torch.equal(g0["params"][n], g1["params"][n]) for n in g0["params"])
        check(same and g0["losses"] == g1["losses"], f"phase 20b {key}: the ranks' parameters "
              f"or losses differ after {len(g0['losses'])} steps")
        check(all(math.isfinite(v) for v in g0["losses"]), f"phase 20b {key}: {g0['losses']}")
        for r in range(world):
            counts = got[r][f"{key}_launches"]
            check(counts["launches"] == ref[f"{key}_launches"]["launches"], f"phase 20b {key} "
                  f"rank {r} launched {counts['launches']}, one process "
                  f"{ref[f'{key}_launches']['launches']}")
            launches[f"parallel_gloo_{key}_rank{r}"] = counts["launches"]
            inner[f"parallel_gloo_{key}_rank{r}"] = counts["inner"]
        lines.append(f"{key} (4 heads, attn_bwd, global batch {PAR_TRAIN_BATCH}, "
                     f"{len(g0['losses'])} steps): step-1 gradients vs one process relative L2 "
                     f"{rel:.3e} (bar {bar}), losses {g0['losses']} (one process "
                     f"{ref[key]['losses']}), parameters equal on both ranks {same}, step_s rank "
                     f"0 {[round(v, 3) for v in g0['step_s']]} (one process "
                     f"{[round(v, 3) for v in ref[key]['step_s']]}), gradient all-reduce s a step "
                     f"{[round(v, 4) for v in g0['reduce_s']]} (gloo through host memory on one "
                     f"card: no multi-GPU figure)")
    e0, e1 = got[0]["export"], got[1]["export"]
    for r, e in enumerate((e0, e1)):
        check(torch.equal(e["served"], e["live"]), f"phase 20b sharded export rank {r}: the "
              f"restored step differs from the live one by "
              f"{(e['served'] - e['live']).abs().max().item():.3e}")
        check(e["launches"] == e["live_launches"] and e["launches"]["fused_transformer_block"],
              f"phase 20b sharded export rank {r}: launches {e['launches']}, live "
              f"{e['live_launches']}")
        launches[f"parallel_gloo_export_rank{r}"], inner[f"parallel_gloo_export_rank{r}"] = (
            e["launches"], e["inner"])
    check(e0["bytes"] > 0 and e1["bytes"] is None and e0["meta"]["sharded"] == dict(
        world_size=world, data=world, model=1, global_batch=PAR_EVAL_BATCH),
        f"phase 20b sharded export: {e0['meta']}")
    lines.append(f"sharded export of the f32 fused step at DDIM-{CUT_DDIM_STEPS} (local batch "
                 f"{PAR_EVAL_BATCH // world} of "
                 f"{PAR_EVAL_BATCH}): {e0['bytes']} bytes in {e0['export_s']:.1f} s on rank 0, "
                 f"restored in both ranks bit for bit as the live step")
    say(f"phase 20b gloo, world size {world}, both ranks on cuda:0 ({card}), {ranks_s:.1f} s for "
        f"the ranks: " + "; ".join(lines))
    return launches, inner


# Phase 22 (a): one of two gloo ranks on the one card at "data:1,model:2".
TP_RANK = r"""
import json, sys
import torch
spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
sys.path.insert(0, spec["root"])
import chip_smoke
from diff3dhpe_torch.parallel import start_ranks
world = start_ranks("cuda:0", backend="gloo", init_method="file://" + spec["rendezvous"],
                    rank=rank, world_size=spec["world_size"], timeout=900)
try:
    torch.save(chip_smoke.tp_cases(world.device, world.with_model_axis(spec["world_size"])),
               f"{spec['out']}/rank{rank}.pt")
finally:
    torch.distributed.destroy_process_group()
"""

# Phase 22 (b): one of four gloo ranks on the one card running cli.run.main
# at "data:2,model:2", its launches counted as chip_smoke.drive counts them;
# then (d), the sharded export at "data:2,model:2" in the same ranks.
TP_CLI_RANK = r"""
import json, sys
import torch
spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
sys.path.insert(0, spec["root"])
import chip_smoke
from diff3dhpe_torch.cli.run import main
from diff3dhpe_torch.engine.runner import Runner
from diff3dhpe_torch.parallel import start_ranks
world = start_ranks("cuda:0", backend="gloo", init_method="file://" + spec["rendezvous"],
                    rank=rank, world_size=spec["world_size"], timeout=900)
fit, record = Runner.fit, {}

def recording_fit(self, train_ds, val_ds, *args, **kwargs):
    result = fit(self, train_ds, val_ds, *args, **kwargs)
    record.update(mesh=repr(self.mesh), n_val=len(val_ds), seconds=result["seconds"],
                  losses_train=result["losses_train"],
                  batches=sum(1 for _ in train_ds.batches(self.cfg.batch_size, shuffle=True,
                                                          drop_last=True)))
    return result

Runner.fit = recording_fit
try:
    errors, d = chip_smoke.drive(main, spec["argv"])
    record.update(errors={k: [float(e) for e in v] for k, v in errors.items()},
                  launches=d["launches"], inner=d["inner"], text=d["text"], wall_s=d["wall_s"],
                  evals=[r["n_frames"] for r in d["records"]],
                  model_time=[r["model_time"] for r in d["records"]])
    record["export"] = chip_smoke.tp_export_case(world.device, world, spec["artifact"])
    torch.save(record, f"{spec['out']}/cli_rank{rank}.pt")
finally:
    torch.distributed.destroy_process_group()
"""

TP_TRAIN_BATCH, TP_EVAL_BATCH, TP_DEPTH4, TP_EXPORT_BATCH = 4, 2, 2, 8
# The depth of phase 22's plain-module paths, whose every block product makes
# a gloo all-reduce through host memory (about 40 ms each): (a)'s train step
# and 8-head use_pallas eval, and (b)'s CLI run. The fused paths, which
# gather once, and (c) and (d) run the flagship depth.
TP_DEPTH = 4
# The tensor-parallel step against one process, JAX's own bar for its
# mesh layouts (tests/test_parallel.py:88-92): the loss to 1e-5 relative,
# each gradient to 2e-5 of max(max|g|, 1e-3); the eval to 1e-5 absolute
# (tests/test_parallel.py:158-159).
TP_LOSS_TOL, TP_GRAD_TOL, TP_EVAL_ABS_TOL = 1e-5, 2e-5, 1e-5


def timed_all_reduces(fn, *args, **kwargs):
    """(fn's result, its wall seconds, the seconds inside the model axis's
    all-reduces): each all-reduce synchronised before and after, so the
    run is slower than an untimed one and the share is an upper bound."""
    from diff3dhpe_torch.parallel import tensor

    spent, all_reduce = [0.0], tensor._all_reduce

    def timed(x, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = all_reduce(x, group)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    tensor._all_reduce = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, spent[0]
    finally:
        tensor._all_reduce = all_reduce


class HeldKernel:
    """A stand-in for an attention wrapper of ops/attention.py that holds
    each call against ``ref`` on the call's own inputs (max |d|, relative
    to max|ref| where ``rel``) and records it in ``errs``. The wrapper's
    launch counter is looked up by name, so this stand-in counts the call's
    launches and hands them to the wrapper's own."""

    def __init__(self, kernel, ref, rel, errs):
        self.kernel, self.ref, self.rel, self.errs = kernel, ref, rel, errs
        self.launches = self.launches_bf16 = 0
        self.__name__ = kernel.__name__

    def __call__(self, q, k, v, scale=None, matmul_precision="highest"):
        out = self.kernel(q, k, v, scale, matmul_precision)
        self.kernel.launches += self.launches
        if hasattr(self.kernel, "launches_bf16"):
            self.kernel.launches_bf16 += self.launches_bf16
        self.launches = self.launches_bf16 = 0
        want = self.ref(q, k, v, scale, matmul_precision)
        err = (out - want).abs().max() / (want.abs().max() if self.rel else 1.0)
        self.errs.append(err.item())
        return out


@contextlib.contextmanager
def holding_attention():
    """Every B3 and B6 call held against its plain version on the call's
    own inputs (``HeldKernel``): B3's max |d| relative to max|plain|, B6's
    absolute. Yields {"B3": [errors], "B6": [errors]}."""
    from diff3dhpe_torch.ops import attention

    errs = {"B3": [], "B6": []}
    saved = {}
    for key, name, ref, rel in (("B3", "grand_attention_fullseq",
                                 attention.grand_attention_fullseq_ref, True),
                                ("B6", "packed_grand_attention",
                                 attention.packed_grand_attention_ref, False)):
        saved[name] = getattr(attention, name)
        setattr(attention, name, HeldKernel(saved[name], ref, rel, errs[key]))
    try:
        yield errs
    finally:
        for name, fn in saved.items():
            setattr(attention, name, fn)


# A bf16 kernel call inside the fused training step, held against its plain
# version on the call's own inputs: mean |kernel - plain| at most a quarter
# of mean |plain - the plain version at float32| on the same inputs (the
# quarter bar of tests/test_torch_bf16_train.py, which holds the bf16
# forwards and B4 so), and at most BF16_MEAN_TOL of max|plain|. The max:
# B4's at BF16_MAX_TOL, as every other bf16 kernel check of the script; B1's
# at BF16_MAX_TOL plus the plain version's own max distance from B1's
# exact-sum oracle on the same inputs (``fused_transformer_block_exact``:
# float64 sums, each rounding to bf16 at JAX's points taken once), as phase
# 21b holds B4 under "default" (ROADMAP C.14). B1 rounds its residual to
# bf16 before the out-LN, which divides it by the row's standard deviation:
# in a row whose mean is large beside its spread, one rounding turned the
# other way by a float32 sum in another order moves an output by more than
# BF16_MAX_TOL of max|plain| (one call of 16 read 1.007e-2 at a mean of
# 2.85e-5 on an NVIDIA H100 80GB HBM3 at 700 W), and the plain version's
# own sums turn such roundings too. Each bf16 B1 call also runs the
# controlled test of that cause (``b1_controlled``): the plain version with
# the residual's rounding turned at the call's worst element.
BF16_QUARTER = 0.25


def b1_controlled(x, blk, n, heads, out, plain, kw):
    """One bf16 B1 call against its exact-sum oracle and the controlled run
    of ROADMAP C.16, on the call's own inputs (all relative to max|plain|):
    ``own`` and ``to_exact``, the max distance of the plain version and of
    the kernel from the oracle; at the element of the kernel's largest
    deviation from the plain version, that deviation (``kernel_dev``), the
    plain version's with its residual's rounding before the out-LN turned
    the other way there (``flip_dev``), what the kernel's output is left
    from that (``flip_gap``), and the kernel's and the plain version's
    distance from the oracle there."""
    from diff3dhpe_torch.ops import fused_block

    kw = {k: v for k, v in kw.items() if k != "f32_prec"}  # a bf16 call runs no float32 mode
    exact = fused_block.fused_transformer_block_exact(x, blk, n, heads, **kw).float()
    out, plain = out.float(), plain.float()
    scale = plain.abs().max()
    d = (out - plain).abs()
    i, j = divmod(d.argmax().item(), d.shape[1])
    flipped = fused_block.fused_transformer_block_flipped(x, blk, n, heads, i, j, **kw).float()
    rel = lambda a: (a / scale).item()
    return dict(own=rel((plain - exact).abs().max()), to_exact=rel((out - exact).abs().max()),
                at=(i, j), kernel_dev=rel(out[i, j] - plain[i, j]),
                flip_dev=rel(flipped[i, j] - plain[i, j]), flip_gap=rel(out[i, j] - flipped[i, j]),
                kernel_to_exact=rel(out[i, j] - exact[i, j]),
                plain_to_exact=rel(plain[i, j] - exact[i, j]))


@contextlib.contextmanager
def holding_train_kernels():
    """Every B1 call of the fused training forward and every B4 call of its
    recompute backward held against its plain version on the call's own
    inputs: (max |d|, mean |d|) relative to max|plain|, the worst of dq,
    dk and dv for B4, and at bf16 the quarter bar's ratio (BF16_QUARTER)
    and, for B1, ``b1_controlled``'s numbers. The kernels' outputs are what
    the step goes on with, and the wrappers count their launches as always.
    Yields {"B1": [(max, mean, ratio or None[, controlled])], "B4": [...]}."""
    from diff3dhpe_torch.models import fast_eval
    from diff3dhpe_torch.ops import attention, fused_block

    errs = {"B1": [], "B4": []}
    block, bwd = fast_eval.fused_transformer_block, attention._bwd
    up = lambda a: None if a is None else a.float()

    def errors(outs, plain, plain_f32=None):
        worst = [bf16_errs(o, r)[1:] for o, r in zip(outs, plain)]
        ratio = None
        if plain_f32 is not None:
            ratio = max((o.float() - r.float()).abs().mean().item()
                        / (r.float() - r32).abs().mean().item()
                        for o, r, r32 in zip(outs, plain, plain_f32))
        return max(w[0] for w in worst), max(w[1] for w in worst), ratio

    def held_block(x, blk, n, heads, **kw):
        out = block(x, blk, n, heads, **kw)
        ref = fused_block.fused_transformer_block_ref
        with torch.no_grad():
            plain = ref(x, blk, n, heads, **kw)
            f32 = None if x.dtype == torch.float32 else [ref(x.float(), blk, n, heads, **dict(
                kw, t_rows=up(kw.get("t_rows")), dp_scales=up(kw.get("dp_scales"))))]
            e = errors([out], [plain], f32)
            if f32 is not None:
                e += (b1_controlled(x, blk, n, heads, out, plain, kw),)
            errs["B1"].append(e)
        return out

    def held_bwd(q, k, v, do, scale, fwd=None, matmul_precision="highest"):
        out = bwd(q, k, v, do, scale, fwd, matmul_precision)
        ref = attention.grand_attention_bwd_ref
        f32 = None if q.dtype == torch.float32 else ref(
            *(a.float() for a in (q, k, v, do)), scale, matmul_precision)
        errs["B4"].append(errors(out, ref(q, k, v, do, scale, matmul_precision), f32))
        return out

    fast_eval.fused_transformer_block, attention._bwd = held_block, held_bwd
    try:
        yield errs
    finally:
        fast_eval.fused_transformer_block, attention._bwd = block, bwd


def held_train_ok(held, bf16):
    """Whether a fused train step held 2·DEPTH B1 calls and DEPTH B4 calls
    (the temporal groups, n > 64), each within its bar: at float32
    KERNEL_REL_TOL on the max; at bf16 BF16_MEAN_TOL on the mean,
    BF16_QUARTER on the quarter bar's ratio and on the max BF16_MAX_TOL,
    for B1 plus the plain version's own max from the oracle (BF16_QUARTER's
    comment)."""
    def ok(kind, e):
        if not bf16:
            return e[0] <= KERNEL_REL_TOL
        own = e[3]["own"] if kind == "B1" else 0.0
        return e[0] <= BF16_MAX_TOL + own and e[1] <= BF16_MEAN_TOL and e[2] <= BF16_QUARTER

    return (len(held["B1"]) == 2 * DEPTH and len(held["B4"]) == DEPTH
            and all(ok(k, e) for k in held for e in held[k]))


def tp_cases(dev, mesh=None):
    """Phase 22 (a)'s cases on ``mesh`` (a rank at "data:1,model:2"), or with
    ``mesh`` None in this process alone, at full width on seed-0 weights:
    the plain module's f32 train step at global batch TP_TRAIN_BATCH,
    TP_DEPTH deep (drop-path, lr 4e-5; step 1 held, step 2 timed, step 3
    with its all-reduces timed), the use_pallas DDIM-9 flip-TTA eval at
    batch TP_EVAL_BATCH with 8 heads (TP_DEPTH deep) and with 4
    (TP_DEPTH4 deep; one run counted,
    every B3 and B6 call held against its plain version, the all-reduces
    timed; in one process a clean timed run besides), and the Runner's
    fused f32 and mixed evals (on the gathered replica under the mesh).
    Phase 22 (c)'s: the fused training step at f32 and at bf16
    (``attn_bwd``, drop-path) on the train step's batch and draws, under
    the mesh on a whole replica loaded from the gathered shards
    (``WholeWeights``): step 1 counted with every B1 and B4 call held
    (``holding_train_kernels``), step 2 timed with its gather timed.
    Returns CPU tensors, launches and seconds."""
    from diff3dhpe_torch import (
        GaussianDiffusion, MixSTEDenoiser, Runner, flip_pose, make_denoise_fn, make_eval_step,
        make_fast_train_denoise_fn, make_optimizer, make_train_denoise_fn, make_train_step,
    )
    from diff3dhpe_torch.config import Config
    from diff3dhpe_torch.parallel import WholeWeights, gather_params, shard_model

    res = {}
    whole_of = lambda d: d if mesh is None else gather_params(d, mesh)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)

    def build(heads=HEADS, depth=DEPTH, use_pallas=False, shard=True):
        m = MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED, depth=depth,
                           num_heads=heads, mlp_ratio=MLP_RATIO, use_pallas=use_pallas, seed=0,
                           device=dev)
        return m if mesh is None or not shard else shard_model(m, mesh)

    model = build(depth=TP_DEPTH).train()
    dkw = dict(timesteps=TIMESTEPS, sampling_timesteps=DDIM_STEPS, clip_denoised=True,
               clip_loss=True, beta_schedule="cosine")
    optimizer, scheduler = make_optimizer(model.parameters(), LR, LR_DECAY, 1000)
    step = make_train_step(GaussianDiffusion.create(make_train_denoise_fn(model, DROP_PATH),
                                                    **dkw), optimizer, scheduler, mesh=mesh)
    g = gen(23)
    gt = torch.randn(TP_TRAIN_BATCH, FRAMES, JOINTS, 3, generator=g, device=dev) * 0.3
    x2d = torch.rand(TP_TRAIN_BATCH, FRAMES, JOINTS, 2, generator=g, device=dev) * 2 - 1
    draws = gen(24)
    loss, launches, _ = counted(step, gt, x2d, generator=draws)
    grads = {k: v.cpu() for k, v in whole_of(
        {n: p.grad for n, p in model.named_parameters()}).items()}
    _, step_s, reduce_s = timed_all_reduces(step, gt, x2d, generator=draws)
    res["train"] = dict(loss=loss.item(), grads=grads, launches=launches, step_s=step_s,
                        reduce_s=reduce_s, peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del model, optimizer, scheduler, step, grads
    torch.cuda.empty_cache()

    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = build().train()
        whole = None if mesh is None else WholeWeights(build(shard=False), model, mesh)
        fn = make_fast_train_denoise_fn(model if whole is None else whole.replica, DROP_PATH,
                                        attn_bwd=True, dtype=dtype)
        optimizer, scheduler = make_optimizer(model.parameters(), LR, LR_DECAY, 1000)
        step = make_train_step(GaussianDiffusion.create(fn, **dkw), optimizer, scheduler,
                               mesh=mesh, whole=whole)
        draws = gen(24)
        with holding_train_kernels() as held:
            loss, launches, inner = counted(step, gt, x2d, generator=draws)
        grads = {k: v.cpu() for k, v in whole_of(
            {n: p.grad for n, p in model.named_parameters()}).items()}
        params = {k: v.cpu() for k, v in whole_of(
            {n: p.detach() for n, p in model.named_parameters()}).items()}
        gather_s = []
        if whole is not None:
            load = whole.load

            def timed_load():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                load()
                torch.cuda.synchronize()
                gather_s.append(time.perf_counter() - t0)

            whole.load = timed_load
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(gt, x2d, generator=draws)
        torch.cuda.synchronize()
        res[f"fast_train_{name}"] = dict(
            loss=loss.item(), grads=grads, params=params, launches=launches, inner=inner,
            held=held, step_s=time.perf_counter() - t0, gather_s=sum(gather_s),
            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        del model, whole, fn, optimizer, scheduler, step, grads, params
        torch.cuda.empty_cache()

    x2d = torch.rand(TP_EVAL_BATCH, FRAMES, JOINTS, 2, generator=gen(20), device=dev) * 2 - 1
    x2d_flip = flip_pose(x2d, JOINTS_LEFT, JOINTS_RIGHT)
    ekw = dict(timesteps=TIMESTEPS, sampling_timesteps=DDIM_STEPS, clip_denoised=True,
               beta_schedule="cosine")
    for key, heads, depth in (("pallas", HEADS, TP_DEPTH), ("pallas_d128", HEADS4, TP_DEPTH4)):
        model = build(heads, depth, use_pallas=True).eval()
        step = make_eval_step(GaussianDiffusion.create(make_denoise_fn(model), **ekw),
                              JOINTS_LEFT, JOINTS_RIGHT, device=dev, mesh=mesh)
        with holding_attention() as held:
            (pred, launches, inner), step_s, reduce_s = timed_all_reduces(
                counted, step, x2d, x2d_flip, generator=gen(22))
        if mesh is None:  # one process's step without the holding
            _, step_s, _ = timed_all_reduces(step, x2d, x2d_flip, generator=gen(22))
        res[key] = dict(pred=pred.cpu(), launches=launches, inner=inner, step_s=step_s,
                        reduce_s=reduce_s, held=held, heads=heads, depth=depth)
        del model, step
        torch.cuda.empty_cache()

    x_init = torch.randn(2 * TP_EVAL_BATCH, FRAMES, JOINTS, 3, generator=gen(25), device=dev)
    for key, fields in (("fused_f32", {}), ("fused_mixed", dict(
            compute_dtype="bfloat16", eval_f32_final_steps=1, eval_f32_head=True))):
        cfg = Config(number_of_frames=FRAMES, embed_dim=EMBED, transformer_depth=DEPTH,
                     num_heads=HEADS, timesteps=TIMESTEPS, sampling_timesteps=DDIM_STEPS,
                     batch_size_eval=TP_EVAL_BATCH, fast_eval=True, seed=0,
                     mesh_shape=None if mesh is None else mesh.shape, **fields)
        runner = Runner(cfg, JOINTS, JOINTS_LEFT, JOINTS_RIGHT, device=dev, mesh=mesh)
        runner.eval_step(x2d, x2d_flip, x_init=x_init)  # warm-up
        t0 = time.perf_counter()
        pred, launches, inner = counted(runner.eval_step, x2d, x2d_flip, x_init=x_init)
        res[key] = dict(pred=pred.cpu(), launches=launches, inner=inner,
                        step_s=time.perf_counter() - t0)
        del runner
        torch.cuda.empty_cache()
    return res


def tp_export_case(dev, world, artifact):
    """Phase 22 (d) on a rank of four (``world``, laid out "data:4"): the
    Runner's mixed eval at "data:2,model:2" (global batch TP_EXPORT_BATCH,
    rows, x_T from a seeded generator) exported sharded to ``artifact``
    (rank 0 traces on the gathered weights and writes; the others wait),
    restored on its mesh and run on the whole weights (counted), against
    the live ``runner.eval_step``; then restored under ``world``'s own
    layout, which must be refused. Returns CPU tensors, launches, seconds
    and the refusal's text."""
    from diff3dhpe_torch import Runner, flip_pose
    from diff3dhpe_torch.config import Config
    from diff3dhpe_torch.io.export import export_eval_step, restore_eval_step

    cfg = Config(number_of_frames=FRAMES, embed_dim=EMBED, transformer_depth=DEPTH,
                 num_heads=HEADS, timesteps=TIMESTEPS, sampling_timesteps=DDIM_STEPS,
                 batch_size_eval=TP_EXPORT_BATCH, fast_eval=True, compute_dtype="bfloat16",
                 eval_f32_final_steps=1, eval_f32_head=True, seed=0, mesh_shape="data:2,model:2")
    runner = Runner(cfg, JOINTS, JOINTS_LEFT, JOINTS_RIGHT, device=dev, mesh=world)
    gen = torch.Generator(device=dev).manual_seed(26)
    x2d = torch.rand(TP_EXPORT_BATCH, FRAMES, JOINTS, 2, generator=gen, device=dev) * 2 - 1
    x2d_flip = flip_pose(x2d, JOINTS_LEFT, JOINTS_RIGHT)
    x_init = torch.randn(2 * TP_EXPORT_BATCH, FRAMES, JOINTS, 3, generator=gen, device=dev)
    t0 = time.perf_counter()
    data = export_eval_step(runner, TP_EXPORT_BATCH, artifact, sharded=True)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = restore_eval_step(artifact, runner.mesh)
    restore_s = time.perf_counter() - t0
    state = runner.full_state_dict()
    served, launches, inner = counted(step, state, x2d, x2d_flip, x_init)
    live, live_launches, _ = counted(runner.eval_step, x2d, x2d_flip, x_init=x_init)
    try:
        restore_eval_step(artifact, world)
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(served=served.cpu(), live=live.cpu(), launches=launches, inner=inner,
                live_launches=live_launches, export_s=export_s, restore_s=restore_s,
                bytes=None if data is None else len(data), meta=step.meta, refused=refused,
                mesh=repr(runner.mesh))


def spawn_ranks(script, spec, tmp, name, timeout):
    """Runs ``script`` in spec["world_size"] processes on the card (``python
    -c script spec.json rank``) and waits for them; each rank's output goes
    to a log, whose end a failed rank's check, naming ``name``, prints.
    Returns the seconds."""
    stem = os.path.join(tmp, name.replace(" ", "_"))
    with open(f"{stem}.json", "w") as f:
        json.dump(spec, f)
    logs = [f"{stem}{r}.log" for r in range(spec["world_size"])]
    t0 = time.perf_counter()
    procs = []
    try:
        for r, log_path in enumerate(logs):
            with open(log_path, "w") as log:
                procs.append(subprocess.Popen([sys.executable, "-c", script, f"{stem}.json",
                                               str(r)],
                                              cwd=spec["root"], stdout=log,
                                              stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(logs[r]) as log:
            check(p.returncode == 0, f"{name} rank {r} exited {p.returncode}:\n"
                  f"{log.read()[-4000:]}")
    return time.perf_counter() - t0


def drive_tensor_parallel(dev, per_call, card):
    """Phase 22: tensor parallelism (diff3dhpe_torch/parallel/tensor.py),
    the model axis of mesh_shape, with gloo ranks on the one card (NCCL
    refuses two ranks on one device; gloo moves CUDA tensors through host
    memory, so no figure here is a multi-GPU one). (a) Two ranks at
    "data:1,model:2": ``tp_cases`` in each against the same cases in this
    process alone, (c) among them: the fused training on whole weights
    gathered from the shards. (b) Four ranks at "data:2,model:2":
    cli.run.main on phase 11's command line cut to S1, Walking and depth
    TP_DEPTH (the
    plain module's training, as fast_train beside a data axis > 1 is
    refused, as in JAX; fast_eval's validation and evaluation on the
    gathered replica; global batch 8, 1 epoch, a checkpoint), then
    --evaluate best_epoch and --resume epoch_0 (1 more epoch) in this
    process alone; (d) in the same four ranks, the sharded export of the
    mixed eval (``tp_export_case``). Returns ({path: launches}, {path:
    inner counts})."""
    from diff3dhpe_torch.cli.run import main as cli_main

    here = os.path.dirname(os.path.abspath(__file__))
    launches, inner, lines = {}, {}, []
    with tempfile.TemporaryDirectory() as tmp:
        # (a) data:1,model:2.
        world = 2
        spec = dict(root=here, rendezvous=os.path.join(tmp, "rendezvous_a"), world_size=world,
                    out=tmp)
        ranks_s = spawn_ranks(TP_RANK, spec, tmp, "phase 22a tp", 600)
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
               for r in range(world)]

        # (b) data:2,model:2 through the CLI.
        with open(os.path.join(here, CLI_CONFIG)) as f:
            config = json.load(f)
        config["params"].update(fast_eval=True)
        ddim = config["params"]["sampling_timesteps"]
        train_config = os.path.join(tmp, "train.json")
        with open(train_config, "w") as f:
            json.dump(config, f)
        run_dir = os.path.join(tmp, "run")
        # Cut from phase 11's S1,S5 and every action (the plain module's
        # all-reduces through host memory cost seconds a step).
        common = ["--config", train_config, "--synthetic", "-str", "S1", "-ste", "S9", "-a",
                  "Walking", "-b", "8", "--batch-size-eval", "8", "--checkpoint-frequency", "1",
                  "--transformer_depth", str(TP_DEPTH), "-c", run_dir]
        spec = dict(root=here, rendezvous=os.path.join(tmp, "rendezvous_b"), world_size=4,
                    out=tmp, argv=common + ["-e", "1", "--mesh-shape", "data:2,model:2"],
                    artifact=os.path.join(tmp, "tp_export.pt2"))
        cli_s = spawn_ranks(TP_CLI_RANK, spec, tmp, "phase 22b tp_cli", 600)
        cli = [torch.load(os.path.join(tmp, f"cli_rank{r}.pt"), weights_only=False)
               for r in range(4)]
        single, d = drive(cli_main, common + ["--evaluate", "best_epoch"])
        shutil.copytree(os.path.join(run_dir, "epoch_0"), os.path.join(run_dir, "resume_from"))
        resumed, dr = drive(cli_main, common + ["-e", "2", "--resume", "resume_from"])
    torch.cuda.empty_cache()
    profiler_probe("after phase 22's gloo ranks")
    ref = tp_cases(dev)

    # (a) against this process alone.
    t0, t1 = got[0]["train"], got[1]["train"]
    loss_rel = abs(t0["loss"] - ref["train"]["loss"]) / abs(ref["train"]["loss"])
    grad_err = max(((t0["grads"][n] - g).abs().max() / max(g.abs().max().item(), 1e-3)).item()
                   for n, g in ref["train"]["grads"].items())
    check(t0["loss"] == t1["loss"] and all(torch.equal(t0["grads"][n], t1["grads"][n])
                                           for n in t0["grads"]),
          "phase 22a train: the ranks' losses or gathered gradients differ")
    check(math.isfinite(t0["loss"]) and loss_rel <= TP_LOSS_TOL and grad_err <= TP_GRAD_TOL,
          f"phase 22a train: loss rel {loss_rel:.3e} (tol {TP_LOSS_TOL}), gradients "
          f"{grad_err:.3e} of max(|g|, 1e-3) (tol {TP_GRAD_TOL}) from one process")
    for r in range(world):
        check(not any(got[r]["train"]["launches"].values()), f"phase 22a train rank {r}: the "
              f"plain module launched {got[r]['train']['launches']}")
    lines.append(
        f"train step (plain module, f32, depth {TP_DEPTH}, global batch {TP_TRAIN_BATCH}, "
        f"drop-path {DROP_PATH}) vs "
        f"one process: loss rel {loss_rel:.3e}, gradients {grad_err:.3e} of max(|g|, 1e-3); "
        f"step_s per rank (each all-reduce synchronised) "
        f"{[round(g['train']['step_s'], 3) for g in got]} (one process "
        f"{ref['train']['step_s']:.3f}), of it in the all-reduces "
        f"{[round(g['train']['reduce_s'], 3) for g in got]} s (share "
        f"{[round(g['train']['reduce_s'] / g['train']['step_s'], 3) for g in got]}); peak "
        f"GB per rank {[round(g['train']['peak_gb'], 2) for g in got]}")
    for key in ("pallas", "pallas_d128"):
        p0, want = got[0][key], ref[key]
        depth = p0["depth"]
        per_kernel = DDIM_STEPS * depth
        abs_err = (p0["pred"] - want["pred"]).abs().max().item()
        check(torch.equal(p0["pred"], got[1][key]["pred"]),
              f"phase 22a {key}: the ranks' predictions differ")
        check(torch.isfinite(p0["pred"]).all().item() and abs_err <= TP_EVAL_ABS_TOL,
              f"phase 22a {key} eval vs one process: max |d| {abs_err:.3e} (tol {TP_EVAL_ABS_TOL})")
        for r in range(world):
            n = got[r][key]["launches"]
            check(n["grand_attention_fullseq"] == n["packed_grand_attention"] == per_kernel
                  and n == want["launches"], f"phase 22a {key} rank {r}: launches {n}, expected "
                  f"B3 = B6 = {per_kernel} as one process's {want['launches']}")
            launches[f"tp_{key}_eval_rank{r}"] = n
            inner[f"tp_{key}_eval_rank{r}"] = got[r][key]["inner"]
        for k, tol in (("B3", KERNEL_REL_TOL), ("B6", SMALL_ATTN_ABS_TOL)):
            errs = p0["held"][k]
            check(len(errs) == per_kernel and max(errs) <= tol, f"phase 22a {key} rank 0: {k} "
                  f"calls held {len(errs)} (expected {per_kernel}), max err {max(errs):.3e} "
                  f"(tol {tol})")
        lines.append(
            f"use_pallas eval ({p0['heads']} heads, depth {depth}: {p0['heads'] // world} local "
            f"heads of {EMBED // p0['heads']}, DDIM-{DDIM_STEPS}, flip-TTA, batch "
            f"{TP_EVAL_BATCH}) vs one process: max |d| {abs_err:.3e}; launches per rank B3 "
            f"{per_kernel}, B6 {per_kernel}; rank 0's calls vs plain: B3 max rel "
            f"{max(p0['held']['B3']):.3e}, B6 max abs {max(p0['held']['B6']):.3e}; step_s per "
            f"rank (the calls held, each all-reduce synchronised) "
            f"{[round(g[key]['step_s'], 3) for g in got]} (one process "
            f"{want['step_s']:.3f}), all-reduce share "
            f"{[round(g[key]['reduce_s'] / g[key]['step_s'], 3) for g in got]}")
    for key in ("fused_f32", "fused_mixed"):
        same = all(torch.equal(g[key]["pred"], ref[key]["pred"]) for g in got)
        check(same, f"phase 22a {key}: the gathered replica's eval is not bit for bit this "
              f"process's (max |d| {(got[0][key]['pred'] - ref[key]['pred']).abs().max():.3e})")
        for r in range(world):
            check(got[r][key]["launches"] == ref[key]["launches"], f"phase 22a {key} rank {r}: "
                  f"launches {got[r][key]['launches']}, one process {ref[key]['launches']}")
            launches[f"tp_{key}_eval_rank{r}"] = got[r][key]["launches"]
            inner[f"tp_{key}_eval_rank{r}"] = got[r][key]["inner"]
        lines.append(f"{key} eval on the gathered replica: bit for bit one process's, B1 "
                     f"{got[0][key]['launches']['fused_transformer_block']} launches a rank, "
                     f"step_s per rank {[round(g[key]['step_s'], 3) for g in got]}")

    # (c) the fused training on the gathered weights, against this process.
    for name in ("f32", "bf16"):
        key = f"fast_train_{name}"
        want = ref[key]
        for r in range(world):
            g = got[r][key]
            diff = {n: (g["grads"][n] - v).abs().max().item() for n, v in want["grads"].items()
                    if not torch.equal(g["grads"][n], v)}
            moved = {n: (g["params"][n] - v).abs().max().item()
                     for n, v in want["params"].items() if not torch.equal(g["params"][n], v)}
            check(g["loss"] == want["loss"] and not diff and not moved
                  and list(g["grads"]) == list(want["grads"]),
                  f"phase 22c {key} rank {r}: not bit for bit one process's step: loss "
                  f"{g['loss']!r} vs {want['loss']!r}, gradients differing {diff}, updated "
                  f"weights differing {moved}")
            n = g["launches"]
            check(n == want["launches"] and g["inner"] == want["inner"]
                  and n["fused_transformer_block"] and n["grand_attention_bwd"]
                  and n["grand_attention_fullseq"] and n["packed_grand_attention"],
                  f"phase 22c {key} rank {r}: launches {n}, one process {want['launches']}")
            launches[f"tp_{key}_rank{r}"], inner[f"tp_{key}_rank{r}"] = n, g["inner"]
        held = got[0][key]["held"]
        worst = {k: [max(e[i] for e in held[k]) if held[k] and held[k][0][i] is not None
                     else None for i in range(3)] for k in held}
        check(held_train_ok(held, name == "bf16") and held_train_ok(want["held"], name == "bf16"),
              f"phase 22c {key}: held calls B1 {len(held['B1'])} (expected {2 * DEPTH}), B4 "
              f"{len(held['B4'])} (expected {DEPTH}); worst (max rel, mean rel, quarter ratio) "
              f"{worst}; one process {want['held']}")
        if name == "bf16":
            c16 = max(held["B1"], key=lambda e: e[0])
            ctl = c16[3]
            max_bar = {"B1": f"{BF16_MAX_TOL} + the plain version's own max from the oracle",
                       "B4": f"{BF16_MAX_TOL}"}
            held_text = "; ".join(
                f"{k} max rel {w[0]:.3e} (tol {max_bar[k]}), mean rel {w[1]:.3e} (tol "
                f"{BF16_MEAN_TOL}), quarter ratio {w[2]:.3e} (tol {BF16_QUARTER})"
                for k, w in worst.items())
            held_text += (
                f"; C.16, B1's worst call (max rel {c16[0]:.4e}, bar {BF16_MAX_TOL} + "
                f"{ctl['own']:.4e}): the plain version's own max from the exact-sum oracle "
                f"{ctl['own']:.4e}, the kernel's {ctl['to_exact']:.4e}; at its worst element "
                f"{ctl['at']} the kernel deviates {ctl['kernel_dev']:+.4e} from the plain version, "
                f"the plain version with the residual's bf16 rounding before the out-LN turned "
                f"there {ctl['flip_dev']:+.4e} (the kernel left {ctl['flip_gap']:+.4e} from it); "
                f"there the kernel is {ctl['kernel_to_exact']:+.4e} and the plain version "
                f"{ctl['plain_to_exact']:+.4e} from the oracle; own max of every call "
                f"{[round(e[3]['own'], 6) for e in held['B1']]}")
        else:
            held_text = "; ".join(f"{k} max rel {w[0]:.3e} (tol {KERNEL_REL_TOL})"
                                  for k, w in worst.items())
        n0 = got[0][key]["launches"]
        lines.append(
            f"(c) fused train step {name} (attn_bwd, global batch {TP_TRAIN_BATCH}, drop-path "
            f"{DROP_PATH}) on the gathered weights: loss, gradients and updated weights bit "
            f"for bit one process's on both ranks (bar: bit for bit); launches a rank B1 "
            f"{n0['fused_transformer_block']} ({n0['fused_transformer_block_bf16']} bf16), B3 "
            f"{n0['grand_attention_fullseq']}, B4 {n0['grand_attention_bwd']} "
            f"({n0['grand_attention_bwd_bf16']} bf16), B6 {n0['packed_grand_attention']} as one "
            f"process's; rank 0's calls vs plain, worst of each: {held_text}; step 2 s per rank {[round(g[key]['step_s'], 3) for g in got]} (one "
            f"process {want['step_s']:.3f}), of it the gather "
            f"{[round(g[key]['gather_s'], 3) for g in got]} s (share "
            f"{[round(g[key]['gather_s'] / g[key]['step_s'], 3) for g in got]}); peak GB per "
            f"rank {[round(g[key]['peak_gb'], 2) for g in got]}")

    # (b) four ranks through the CLI.
    c0 = cli[0]
    check(c0["mesh"] == "DataMesh(rank=0, size=4, backend='gloo', device='cuda:0', data=0/2, "
          "model=0/2)", f"phase 22b ran as {c0['mesh']}")
    report_dev = max(abs(a - b) for k in ("e1", "e2", "e3", "ev")
                     for a, b in zip(single[k], c0["errors"][k], strict=True))
    check(report_dev <= EVAL_REPORT_TOL_MM, f"phase 22b: --evaluate best_epoch in one process "
          f"deviates from the four ranks' report by {report_dev:.3e} mm")
    check(all(c["errors"] == c0["errors"] and c["launches"] == c0["launches"] for c in cli),
          "phase 22b: the ranks' reports or launches differ")
    check("Protocol #1   (MPJPE) action-wise average:" in c0["text"]
          and all(c["text"].strip().startswith("INFO: mesh data:2,model:2") for c in cli[1:]),
          "phase 22b: rank 0 alone prints the report")
    fwd_b1 = 2 * TP_DEPTH * per_call
    zero_steps = dict(fused_transformer_block=0, grand_attention_fullseq=0, grand_attention_bwd=0,
                      packed_grand_attention=0)
    want = want_fit({k: 0 for k in c0["launches"]}, zero_steps, fwd_b1, ddim, 8, c0["batches"],
                    c0["n_val"], 1, c0["evals"], depth=TP_DEPTH)
    want["plain_attention_calls"] += c0["batches"] * 2 * TP_DEPTH  # the plain module's training
    check(c0["launches"] == want, f"phase 22b launched {c0['launches']}, expected {want}")
    check(all(math.isfinite(v) for v in resumed["e1"]) and "Resumed from" in dr["text"],
          "phase 22b: the resume in one process")
    for r, c in enumerate(cli):
        launches[f"tp_cli_fit_rank{r}"], inner[f"tp_cli_fit_rank{r}"] = c["launches"], c["inner"]
    steps = c0["batches"]
    lines.append(
        f"cli.run.main at data:2,model:2 on {CLI_CONFIG} (S1, Walking, depth {TP_DEPTH}; plain "
        f"module training, "
        f"fast_eval on the replica, global batch 8, {steps} steps): train loss {c0['losses_train']}, train s a "
        f"step per rank {[round(c['seconds'][0]['train'] / steps, 3) for c in cli]}, validation "
        f"s {[round(c['seconds'][0]['validate'], 2) for c in cli]}, evaluate model s "
        f"{[round(sum(c['model_time']), 2) for c in cli]}; --evaluate best_epoch in one process: "
        f"max |d| {report_dev:.3e} mm; resumed in one process for epoch 1: report MPJPE "
        f"{[round(e, 3) for e in resumed['e1']][:3]}...; B1 launches a rank "
        f"{c0['launches']['fused_transformer_block']} as counted; {cli_s:.1f} s for the ranks")

    # (d) the sharded export at data:2,model:2, in the same four ranks.
    exports = [c["export"] for c in cli]
    e0 = exports[0]
    check(e0["mesh"] == "DataMesh(rank=0, size=4, backend='gloo', device='cuda:0', data=0/2, "
          "model=0/2)" and e0["bytes"] > 0 and all(e["bytes"] is None for e in exports[1:]),
          f"phase 22d: ran as {e0['mesh']}, bytes {[e['bytes'] for e in exports]}")
    meta_want = dict(world_size=4, data=2, model=2, global_batch=TP_EXPORT_BATCH)
    for r, e in enumerate(exports):
        check(e["meta"]["sharded"] == meta_want and e["meta"]["batch_size"] == TP_EXPORT_BATCH // 2,
              f"phase 22d rank {r}: meta {e['meta']['sharded']}, batch {e['meta']['batch_size']}")
        check(torch.equal(e["served"], e["live"]) and torch.isfinite(e["served"]).all().item()
              and e["served"].shape == (TP_EXPORT_BATCH, FRAMES, JOINTS, 3),
              f"phase 22d rank {r}: the restored step differs from the live one by "
              f"{(e['served'] - e['live']).abs().max().item():.3e}")
        check(e["launches"] == e["live_launches"] and e["launches"]["fused_transformer_block"],
              f"phase 22d rank {r}: launches {e['launches']}, live {e['live_launches']}")
        check(e["refused"] is not None and "'data:2,model:2'" in e["refused"]
              and "'data:4,model:1'" in e["refused"],
              f"phase 22d rank {r}: restored under data:4: {e['refused']!r}")
        launches[f"tp_export_mixed_rank{r}"], inner[f"tp_export_mixed_rank{r}"] = (e["launches"],
                                                                                  e["inner"])
    lines.append(
        f"(d) the mixed eval exported sharded at data:2,model:2 (global batch {TP_EXPORT_BATCH}, "
        f"local {TP_EXPORT_BATCH // 2}, DDIM-{DDIM_STEPS}, flip-TTA, rows): {e0['bytes']} bytes "
        f"in {e0['export_s']:.1f} s on rank 0, metadata {e0['meta']['sharded']}; restored in "
        f"every rank ({[round(e['restore_s'], 1) for e in exports]} s) and run on the whole "
        f"weights: bit for bit its live runner.eval_step on each (bar: bit for bit); B1 "
        f"{e0['launches']['fused_transformer_block']} launches a rank "
        f"({e0['launches']['fused_transformer_block_bf16']} bf16) as live; under data:4 "
        f"refused on every rank: {e0['refused']!r}")
    say(f"phase 22 tensor parallelism, gloo ranks on cuda:0 ({card}; gloo moves the all-reduces "
        f"through host memory: no multi-GPU or NVLink figure), (a) data:1,model:2 in "
        f"{ranks_s:.1f} s: " + "; ".join(lines))
    return launches, inner


DROP_RATE, ATTN_DROP_RATE = 0.1, 0.1  # phase 23 (a)'s dropout, beside drop-path DROP_PATH
QK_SCALE = 0.1  # phase 23 (b)'s attention scale (head_dim^-½ = 0.125 at 8 heads)


def drive_dropout_scale(dev, card):
    """Phase 23: the module's dropout (ROADMAP A.16) and the attention scale
    (A.17) at the flagship width (FRAMES frames, embed EMBED, HEADS heads,
    DEPTH deep).

    (a) The plain module's f32 train step at batch CHECK_BATCH with
    drop-path DROP_PATH and dropout DROP_RATE / ATTN_DROP_RATE, every draw
    from a CUDA generator: each mask site's kept share within 4σ of 1 −
    rate; all-kept masks at rate 0 (every dropout site and the attention's
    materialised branch run, dropping and scaling nothing) give the step
    without masks bit for bit; one seed gives one loss bit for bit, which
    the masks move; the step's seconds (three steps, each synchronised),
    and the masks' draw's.

    (b) At scale QK_SCALE, each against its plain version at the bars the
    script holds it to at its mode: B1 in rows at n = JOINTS and FRAMES
    (f32, bf16, "high3", "default"), B2 and B5 (f32, bf16), B3 and B6 (f32,
    bf16); B1 and B2 with scale=None bit for bit the call without it. Then
    the driven path: the use_pallas DDIM-CUT_DDIM_STEPS flip-TTA eval of a
    qk_scale QK_SCALE module (its launches counted, every B3 and B6 call
    held against its plain version on its own inputs) against the plain
    module's at EVAL_ABS_BOUND.

    (c) The fused eval, the fused training and the export refuse a module
    with qk_scale or a dropout rate, naming the field.

    Returns ({path: launches}, {path: inner counts})."""
    from diff3dhpe_torch import (
        GaussianDiffusion, MixSTEDenoiser, Runner, fast_forward_denoise, flip_pose,
        fused_attention_block, fused_attention_block_ref, fused_temporal_block_cols,
        fused_temporal_block_cols_ref, fused_transformer_block, fused_transformer_block_ref,
        grand_attention_fullseq, grand_attention_fullseq_ref, make_denoise_fn, make_eval_step,
        make_fast_train_denoise_fn, make_optimizer, make_train_denoise_fn, make_train_step,
        packed_grand_attention, packed_grand_attention_ref,
    )
    from diff3dhpe_torch.config import Config
    from diff3dhpe_torch.io.export import export_eval_step

    t0 = time.perf_counter()
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    rates = dict(drop_rate=DROP_RATE, attn_drop_rate=ATTN_DROP_RATE)

    def build(**kw):
        return MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED, depth=DEPTH,
                              num_heads=HEADS, mlp_ratio=MLP_RATIO, seed=0, device=dev, **kw)

    # (a) dropout in the plain module's f32 train step.
    dkw = dict(timesteps=TIMESTEPS, sampling_timesteps=DDIM_STEPS, clip_denoised=True,
               clip_loss=True, beta_schedule="cosine")
    g = gen(23)
    gt = torch.randn(CHECK_BATCH, FRAMES, JOINTS, 3, generator=g, device=dev) * 0.3
    x2d = torch.rand(CHECK_BATCH, FRAMES, JOINTS, 2, generator=g, device=dev) * 2 - 1

    def train_step(model):
        optimizer, scheduler = make_optimizer(model.parameters(), LR, LR_DECAY, 1000)
        fn = make_train_denoise_fn(model, DROP_PATH)
        return fn, make_train_step(GaussianDiffusion.create(fn, **dkw), optimizer, scheduler)

    def stepped(model, **kw):
        """(loss, gradients, launches) of one counted step of a fresh model."""
        _, step = train_step(model)
        loss, launches, _ = counted(step, gt, x2d, **kw)
        return loss, [p.grad.clone() for p in model.parameters()], launches

    torch.cuda.reset_peak_memory_stats(dev)
    fn, _ = train_step(build(**rates))
    torch.cuda.synchronize()
    t_draw = time.perf_counter()
    sp, tp, masks = fn.draw_dp_scales(gen(5), CHECK_BATCH, FRAMES, JOINTS)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t_draw
    shares = {}
    for name, kept in masks.items():
        p = 1.0 - (ATTN_DROP_RATE if name.startswith("attn") else DROP_RATE)
        share = kept.sum().item() / kept.numel()
        shares[name] = (share, (share - p) / (p * (1 - p) / kept.numel()) ** 0.5)
        check(abs(shares[name][1]) <= 4, f"phase 23a {name}: kept share {share:.6f}, "
              f"{shares[name][1]:+.2f} σ from {p}")
    check(len(masks) == 9, f"phase 23a: mask sites {sorted(masks)}")
    t = torch.randint(0, TIMESTEPS, (CHECK_BATCH,), generator=gen(6), device=dev)
    noise = torch.randn(gt.shape, generator=gen(7), device=dev)
    kept_all = {k: torch.ones_like(v) for k, v in masks.items()}
    del masks
    with_masks = stepped(build(), t=t, noise=noise, dp_scales=(sp, tp, kept_all))
    without = stepped(build(), t=t, noise=noise, dp_scales=(sp, tp))
    del kept_all
    check(torch.equal(with_masks[0], without[0])
          and all(torch.equal(a, b) for a, b in zip(with_masks[1], without[1])),
          f"phase 23a: all-kept masks at rate 0 moved the step: loss {with_masks[0].item()!r} vs "
          f"{without[0].item()!r}")
    runs = [stepped(build(**rates), generator=gen(8)) for _ in range(2)]
    no_drop = stepped(build(), generator=gen(8))
    check(torch.equal(runs[0][0], runs[1][0]) and math.isfinite(runs[0][0].item())
          and all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])),
          f"phase 23a: one seed, two losses {runs[0][0].item()!r}, {runs[1][0].item()!r}")
    check(runs[0][0].item() != no_drop[0].item(), "phase 23a: the masks did not move the loss")
    check(not any(runs[0][2].values()), f"phase 23a: the plain module launched {runs[0][2]}")
    del with_masks, without, runs
    step_s = {}
    for label, kw in (("dropout", rates), ("none", {})):
        _, step = train_step(build(**kw))
        step_s[label] = []
        for seed in (9, 10, 11):
            torch.cuda.synchronize()
            t_step = time.perf_counter()
            loss = step(gt, x2d, generator=gen(seed))
            torch.cuda.synchronize()
            step_s[label].append(time.perf_counter() - t_step)
            check(math.isfinite(loss.item()), f"phase 23a {label}: loss {loss.item()}")
        del step
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del fn
    torch.cuda.empty_cache()
    say(f"phase 23a dropout in the plain module's f32 train step ({card}; batch {CHECK_BATCH}, "
        f"depth {DEPTH}, drop_rate {DROP_RATE}, attn_drop_rate {ATTN_DROP_RATE}, drop-path "
        f"{DROP_PATH}): kept shares (share, σ from 1 − rate) "
        f"{ {k: (round(v[0], 6), round(v[1], 2)) for k, v in shares.items()} } (bar 4σ); "
        f"all-kept masks at rate 0 give the step without masks bit for bit (loss "
        f"{no_drop[0].item():.6f} without dropout); one seed, one loss "
        f"(bit for bit) and gradients; masks drawn in {draw_s * 1e3:.1f} ms; step s with "
        f"dropout {[round(s, 4) for s in step_s['dropout']]} (median "
        f"{sorted(step_s['dropout'])[1]:.4f}), the same step without "
        f"{[round(s, 4) for s in step_s['none']]} (median {sorted(step_s['none'])[1]:.4f}); "
        f"peak {peak_gb:.2f} GB")

    # (b) the attention scale on every kernel, then the use_pallas eval.
    model = build().eval()
    rg = gen(29)
    randn = lambda *shape: torch.randn(*shape, generator=rg, device=dev)
    rows, items = 2 * BATCH * FRAMES * JOINTS, 2 * BATCH
    x, t_rows = randn(rows, EMBED), randn(items, EMBED)
    cols = randn(items * FRAMES, JOINTS * EMBED)
    held, lines = {}, []

    def hold(label, out, ref, kind):
        """The bars of the kernel's mode: 'f32' (KERNEL_REL_TOL, and
        ATTN_BLOCK_ABS_TOL for B5), 'small' (SMALL_ATTN_ABS_TOL), 'bf16',
        'high3', 'default'."""
        check(torch.isfinite(out.float()).all().item(), f"phase 23b {label}: not finite")
        abs_err, rel, mean_rel = bf16_errs(out, ref)
        bars = {"f32": rel <= KERNEL_REL_TOL, "small": abs_err <= SMALL_ATTN_ABS_TOL,
                "b5": rel <= KERNEL_REL_TOL and abs_err <= ATTN_BLOCK_ABS_TOL,
                "bf16": rel <= BF16_MAX_TOL and mean_rel <= BF16_MEAN_TOL,
                "high3": rel <= MODE_HIGH3_TOL,
                "default": rel <= MODE_DEFAULT_MAX_TOL and mean_rel <= MODE_DEFAULT_MEAN_TOL}
        check(bars[kind], f"phase 23b {label} at scale {QK_SCALE}: max abs {abs_err:.3e}, max "
              f"rel {rel:.3e}, mean rel {mean_rel:.3e} ({kind} bars)")
        held[label] = (abs_err, rel, mean_rel)

    with torch.no_grad():
        for mode in ("highest", "bf16", "high3", "default"):
            dt = torch.bfloat16 if mode == "bf16" else torch.float32
            prec = "highest" if mode == "bf16" else mode
            kind = {"highest": "f32"}.get(mode, mode)
            for n, blk, out_ln in ((JOINTS, model.STEblocks[0], model.Spatial_norm),
                                   (FRAMES, model.TTEblocks[0], model.Temporal_norm)):
                kw = dict(t_rows=t_rows, rows_per_item=rows // items, out_ln=out_ln,
                          f32_prec=prec)
                xi = x.to(dt)
                out = fused_transformer_block(xi, blk, n, HEADS, scale=QK_SCALE, **kw)
                hold(f"B1 {mode} n={n}", out,
                     fused_transformer_block_ref(xi, blk, n, HEADS, scale=QK_SCALE, **kw), kind)
                ambient = fused_transformer_block(xi, blk, n, HEADS, **kw)
                check(torch.equal(fused_transformer_block(xi, blk, n, HEADS, scale=None, **kw),
                                  ambient), f"phase 23b B1 {mode} n={n}: scale=None is not the "
                      f"call without it")
                check((out.float() - ambient.float()).abs().max().item() > 1e-3,
                      f"phase 23b B1 {mode} n={n}: the scale did not reach the kernel")
        for dt, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            label = "f32" if dt == torch.float32 else "bf16"
            blk, kw = model.TTEblocks[0], dict(t_rows=t_rows, out_ln=model.Temporal_norm)
            ci = cols.to(dt)
            out = fused_temporal_block_cols(ci, blk, FRAMES, JOINTS, HEADS, scale=QK_SCALE, **kw)
            hold(f"B2 {label}", out, fused_temporal_block_cols_ref(
                ci, blk, FRAMES, JOINTS, HEADS, scale=QK_SCALE, **kw), kind)
            check(torch.equal(fused_temporal_block_cols(ci, blk, FRAMES, JOINTS, HEADS,
                                                        scale=None, **kw),
                              fused_temporal_block_cols(ci, blk, FRAMES, JOINTS, HEADS, **kw)),
                  f"phase 23b B2 {label}: scale=None is not the call without it")
            for n in (JOINTS, FRAMES):
                xi = x.to(dt)
                hold(f"B5 {label} n={n}",
                     fused_attention_block(xi, model.STEblocks[0], n, HEADS, scale=QK_SCALE),
                     fused_attention_block_ref(xi, model.STEblocks[0], n, HEADS, scale=QK_SCALE),
                     "b5" if dt == torch.float32 else "bf16")
            d = EMBED // HEADS
            for name, fn, ref, g_, n, small_kind in (
                    ("B3", grand_attention_fullseq, grand_attention_fullseq_ref,
                     2 * BATCH * JOINTS, FRAMES, "f32"),
                    ("B6", packed_grand_attention, packed_grand_attention_ref,
                     2 * BATCH * FRAMES, JOINTS, "small")):
                q, k, v = (randn(g_, HEADS, n, d).to(dt) for _ in range(3))
                hold(f"{name} {label}", fn(q, k, v, QK_SCALE), ref(q, k, v, QK_SCALE),
                     small_kind if dt == torch.float32 else "bf16")
    del x, cols
    lines.append("; ".join(f"{k} max rel {v[1]:.3e} (max abs {v[0]:.3e}, mean rel {v[2]:.3e})"
                           for k, v in held.items()))

    x2d = torch.rand(BATCH, FRAMES, JOINTS, 2, generator=gen(20), device=dev) * 2 - 1
    x2d_flip = flip_pose(x2d, JOINTS_LEFT, JOINTS_RIGHT)
    x_init = torch.randn(2 * BATCH, FRAMES, JOINTS, 3, generator=gen(25), device=dev)
    ekw = dict(timesteps=TIMESTEPS, sampling_timesteps=CUT_DDIM_STEPS, clip_denoised=True,
               beta_schedule="cosine")

    def eval_step(m):
        return make_eval_step(GaussianDiffusion.create(make_denoise_fn(m), **ekw), JOINTS_LEFT,
                              JOINTS_RIGHT, device=dev)

    scaled = build(qk_scale=QK_SCALE, use_pallas=True).eval()
    with holding_attention() as attn_held:
        pred, launches, inner = counted(eval_step(scaled), x2d, x2d_flip, x_init=x_init)
    plain = eval_step(build(qk_scale=QK_SCALE).eval())(x2d, x2d_flip, x_init=x_init)
    unscaled = eval_step(build().eval())(x2d, x2d_flip, x_init=x_init)
    err = (pred - plain).abs().max().item()
    want = CUT_DDIM_STEPS * DEPTH
    check(torch.isfinite(pred).all().item() and err <= EVAL_ABS_BOUND,
          f"phase 23b use_pallas eval at qk_scale {QK_SCALE} vs the plain module: max |d| "
          f"{err:.3e} (bound {EVAL_ABS_BOUND})")
    check(launches["grand_attention_fullseq"] == want and launches["packed_grand_attention"] == want
          and not launches["fused_transformer_block"] and not launches["grand_attention_bwd"],
          f"phase 23b use_pallas eval launched {launches}, expected B3 and B6 {want} each")
    check(len(attn_held["B3"]) == want and max(attn_held["B3"]) <= KERNEL_REL_TOL
          and len(attn_held["B6"]) == want and max(attn_held["B6"]) <= SMALL_ATTN_ABS_TOL,
          f"phase 23b use_pallas eval: held B3 {attn_held['B3']}, B6 {attn_held['B6']}")
    moved = (plain - unscaled).abs().max().item()
    check(moved > EVAL_ABS_BOUND, f"phase 23b: qk_scale moved the plain eval by {moved:.3e}")
    lines.append(
        f"use_pallas DDIM-{CUT_DDIM_STEPS} flip-TTA eval (batch {BATCH}) of a qk_scale "
        f"{QK_SCALE} module vs the plain module: max |d| {err:.3e} (bound {EVAL_ABS_BOUND}); "
        f"launches B3 {launches['grand_attention_fullseq']}, B6 "
        f"{launches['packed_grand_attention']} (expected {want} each); each call held: B3 max rel "
        f"{max(attn_held['B3']):.3e} (tol {KERNEL_REL_TOL}), B6 max abs "
        f"{max(attn_held['B6']):.3e} (tol {SMALL_ATTN_ABS_TOL}); the scale moved the plain "
        f"eval by {moved:.3e}")
    del scaled, model
    torch.cuda.empty_cache()
    say(f"phase 23b the attention scale {QK_SCALE} ({card}): " + "; ".join(lines))

    # (c) the fused paths refuse both fields.
    xs = torch.randn(BATCH, FRAMES, JOINTS, 5, generator=gen(30), device=dev)
    ts = torch.tensor([3.0, 700.0], device=dev)
    cfg = Config(number_of_frames=FRAMES, embed_dim=EMBED, transformer_depth=DEPTH,
                 num_heads=HEADS, timesteps=TIMESTEPS, sampling_timesteps=CUT_DDIM_STEPS,
                 batch_size_eval=BATCH, fast_eval=True, seed=0)
    runner = Runner(cfg, JOINTS, JOINTS_LEFT, JOINTS_RIGHT, device=dev)
    refusals = {}
    for field in ("qk_scale", "drop_rate", "attn_drop_rate"):
        m = build(**{field: 0.1})
        runner.model = m
        for path, call in (("fused eval", lambda: fast_forward_denoise(m, xs, ts)),
                           ("fused train", lambda: make_fast_train_denoise_fn(m, DROP_PATH)),
                           ("export", lambda: export_eval_step(runner, batch_size=BATCH))):
            try:
                call()
                refusals[f"{field} {path}"] = None
            except ValueError as e:
                refusals[f"{field} {path}"] = str(e)
        del m
    check(all(msg and msg.startswith(key.split()[0]) for key, msg in refusals.items()),
          f"phase 23c: {refusals}")
    del runner
    torch.cuda.empty_cache()
    say(f"phase 23c the fused eval, the fused training and the export each refuse qk_scale, "
        f"drop_rate and attn_drop_rate at 0.1 with a ValueError naming the field "
        f"({len(refusals)} refusals, e.g. {refusals['qk_scale fused eval']!r}); phase 23 took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"scale_pallas_eval": launches}, {"scale_pallas_eval": inner}


def mode_block_work(r, n, c, hidden, items, passes, gemms=4):
    """(FLOPs, bytes) of one f32 block call (``gemms`` 4, or 2 for B5) under
    a contraction mode of ``passes`` bf16 passes (3 "high3", 1 "default"):
    every product, the GEMMs' and the attention's, is of bf16 operands
    summed in f32, ``passes`` times, the work of the card's bf16 peak; x,
    t_rows and the f32 weights read once, the output written once."""
    macs = r * c * (3 * c + c + (2 * hidden if gemms == 4 else 0))
    weights = 4 * c * c + (2 * c * hidden if gemms == 4 else 0)
    nbytes = 4 * (2 * r * c + items * c + weights) + 4 * (3 * c + c + hidden + c + 6 * c)
    return (2 * macs + 4 * r * n * c) * passes, nbytes


def drive_modes(dev, card, peaks):
    """Phase 21: the float32 contraction modes "high3" and "default" of the
    block kernels (csrc/fused_block.cu, gemm_wgmma.cuh, grand_attn.cuh) at
    the eval shapes, each against its plain version: B1 in rows (the time
    add and the out-LN; groups of 17 and 243, 8 heads, and 4 heads of
    head_dim 128), B2 (n = 243, 8 and 4 heads) and B5 (n = 17 and 243);
    then each kernel alone: the split, the f32-output tensor-core GEMM at 1
    and 3 passes at the block's four products, the attention step in each
    mode, and the LN's time add. Bars: "high3" MODE_HIGH3_TOL of max|plain|
    (the split alone bit for bit, the GEMM alone GEMM_F32_REL_TOL),
    "default" MODE_DEFAULT_MAX_TOL and MODE_DEFAULT_MEAN_TOL; the
    separation from "highest" by MODE_SEPARATION; every time of the port's
    kernels and plain versions at least 0.95 of its bound. Returns the
    numbers for the kernels line."""
    from torch.nn import functional as F

    from diff3dhpe_torch import (
        fused_attention_block, fused_attention_block_ref, fused_temporal_block_cols,
        fused_temporal_block_cols_ref, fused_transformer_block, fused_transformer_block_ref,
    )
    from diff3dhpe_torch.models.mixste import Block, init_weights
    from diff3dhpe_torch.ops.fused_block import (
        _gemm_f32_ref, _gemm_wgmma_f32, _gemm_wgmma_f32_ref, block_attention,
        block_attention_ref, layer_norm_rows, layer_norm_rows_ref, split_bf16, split_bf16_ref,
    )

    _, peak_bf16, mem_rate = peaks
    gen = torch.Generator(device=dev).manual_seed(21)
    randn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device=dev) * scale
    rows, hidden, items = 2 * BATCH * FRAMES * JOINTS, int(EMBED * MLP_RATIO), 2 * BATCH
    passes = {"high3": 3, "default": 1}

    def errors(label, mode, out, ref, highest):
        """The kernel's distance from its plain version at the mode (the
        bars) and r, its separation from the plain "highest" result."""
        abs_err, rel, mean_rel = bf16_errs(out, ref)
        r = ((out - ref).abs().mean() / (ref - highest).abs().mean()).item()
        check(torch.isfinite(out).all().item(), f"phase 21 {label} {mode}: not finite")
        if mode == "high3":
            check(rel <= MODE_HIGH3_TOL, f"phase 21 {label} high3: rel err {rel:.3e} > "
                  f"{MODE_HIGH3_TOL}")
        else:
            check(rel <= MODE_DEFAULT_MAX_TOL and mean_rel <= MODE_DEFAULT_MEAN_TOL,
                  f"phase 21 {label} default: max rel {rel:.3e} (tol {MODE_DEFAULT_MAX_TOL}), "
                  f"mean {mean_rel:.3e} (tol {MODE_DEFAULT_MEAN_TOL})")
        check(r <= MODE_SEPARATION[mode], f"phase 21 {label} {mode}: r = {r:.3f} > "
              f"{MODE_SEPARATION[mode]}: the kernel is not nearer its mode's plain version "
              f"than the mode is to 'highest'")
        return dict(abs_err=abs_err, rel=rel, mean_rel=mean_rel, r=r)

    def bound(flops, nbytes):
        """The least time of the work: its products, of bf16 operands, at
        the card's bf16 peak, or its bytes at the memory rate."""
        ops_s = flops / peak_bf16
        return dict(bound_ms=max(ops_s, nbytes / mem_rate) * 1e3,
                    bound_by="operations" if ops_s >= nbytes / mem_rate else "bytes")

    def above_bound(label, r):
        for key in ("ms", "plain_ms"):
            check(r[key] >= 0.95 * r["bound_ms"], f"phase 21 {label}: {key} {r[key]:.4f} is "
                  f"below 0.95 of its bound {r['bound_ms']:.4f}: a partial measurement")

    def make_block(seed, heads):
        block = Block(EMBED, heads, MLP_RATIO, qkv_bias=True)
        init_weights(block, torch.Generator().manual_seed(seed))
        block = block.to(dev)
        out_ln = torch.nn.LayerNorm(EMBED, eps=1e-6).to(dev)
        with torch.no_grad():
            for ln in (block.norm1, block.norm2, out_ln):
                ln.weight.copy_(1.0 + randn(EMBED, scale=0.2))
                ln.bias.copy_(randn(EMBED, scale=0.2))
        return block, out_ln

    res = dict(blocks={}, split={}, gemm={}, attention={}, layer_norm={})
    lines = []
    with torch.no_grad():
        # The blocks in each mode.
        for heads in (HEADS, HEADS4):
            block, out_ln = make_block(21 + heads, heads)
            x, t_rows = randn(rows, EMBED), randn(items, EMBED, scale=0.5)
            x_cols = randn(items * FRAMES, JOINTS * EMBED)
            for mode in passes:
                kw = dict(t_rows=t_rows, rows_per_item=rows // items, out_ln=out_ln)
                cases = {f"B1 n={n} heads={heads}": (
                    lambda n=n: fused_transformer_block(x, block, n, heads, f32_prec=mode, **kw),
                    lambda n=n, m=mode: fused_transformer_block_ref(x, block, n, heads,
                                                                    f32_prec=m, **kw),
                    lambda n=n: library_block(x, block, n, heads, t_rows, rows // items, out_ln),
                    mode_block_work(rows, n, EMBED, hidden, items, passes[mode]))
                    for n in (JOINTS, FRAMES)}
                cols_kw = dict(t_rows=t_rows, out_ln=out_ln)
                cases[f"B2 n={FRAMES} heads={heads}"] = (
                    lambda: fused_temporal_block_cols(x_cols, block, FRAMES, JOINTS, heads,
                                                      f32_prec=mode, **cols_kw),
                    lambda m=mode: fused_temporal_block_cols_ref(x_cols, block, FRAMES, JOINTS,
                                                                 heads, f32_prec=m, **cols_kw),
                    lambda: library_cols(x_cols, block, FRAMES, JOINTS, heads, t_rows, out_ln),
                    mode_block_work(rows, FRAMES, EMBED, hidden, items, passes[mode]))
                if heads == HEADS:
                    for n in (JOINTS, FRAMES):
                        cases[f"B5 n={n} heads={heads}"] = (
                            lambda n=n: fused_attention_block(x, block, n, heads, f32_prec=mode),
                            lambda n=n, m=mode: fused_attention_block_ref(x, block, n, heads,
                                                                          f32_prec=m),
                            lambda n=n: library_attn_block(x, block, n, heads),
                            mode_block_work(rows, n, EMBED, hidden, 0, passes[mode], gemms=2))
                for label, (run, plain, lib, work) in cases.items():
                    r = errors(label, mode, run(), plain(), plain(m="highest"))
                    r.update(ms=cuda_ms(run), plain_ms=cuda_ms(plain), lib_ms=cuda_ms(lib),
                             **bound(*work), gflop=work[0] / 1e9)
                    above_bound(f"{label} {mode}", r)
                    res["blocks"][f"{label} {mode}"] = r
                    lines.append(f"{label} {mode}: max_abs_err={r['abs_err']:.3e} rel={r['rel']:.3e} "
                                 f"mean_rel={r['mean_rel']:.3e} r={r['r']:.4f} ms={r['ms']:.4f} "
                                 f"plain_ms={r['plain_ms']:.4f} library_ms(f32 library calls)="
                                 f"{r['lib_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
            del block, out_ln, x, x_cols

        # The split alone, at the widest activation of a block's products.
        x = randn(rows, hidden)
        for lo, name in ((True, "high3"), (False, "default")):
            hi, low = split_bf16(x, lo)
            ref_hi, ref_lo = split_bf16_ref(x, lo)
            check(torch.equal(hi, ref_hi) and (not lo or torch.equal(low, ref_lo)),
                  f"phase 21 split ({name}): not bit for bit its plain version")
            nbytes = x.numel() * (4 + (4 if lo else 2))
            r = dict(abs_err=0.0, ms=device_ms(lambda: split_bf16(x, lo), kernels=1),
                     plain_ms=device_ms(lambda: split_bf16_ref(x, lo)),
                     lib_ms=device_ms(lambda: x.to(torch.bfloat16)), **bound(0, nbytes))
            above_bound(f"split {name}", r)
            res["split"][name] = r
            lines.append(f"split_bf16 [{rows}, {hidden}] {'hi+lo' if lo else 'hi'}: bit for bit; "
                         f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms(x.to(bf16), "
                         f"hi alone)={r['lib_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                         f"GB/s={nbytes / r['ms'] / 1e6:.0f}")
        del x

        # The f32-output tensor-core GEMM alone at the block's four products.
        mm_out_dtype = True
        try:
            torch.mm(torch.ones(8, 8, device=dev, dtype=torch.bfloat16),
                     torch.ones(8, 8, device=dev, dtype=torch.bfloat16), out_dtype=torch.float32)
        except TypeError:
            mm_out_dtype = False
        for label, n, k, epi in (("qkv", 3 * EMBED, EMBED, "bias"),
                                 ("proj", EMBED, EMBED, "residual"),
                                 ("fc1", hidden, EMBED, "gelu"),
                                 ("fc2", EMBED, hidden, "residual")):
            a, w = randn(rows, k), randn(n, k, scale=k ** -0.5)
            bias = randn(n, scale=0.1)
            res_t = randn(rows, n) if epi == "residual" else None
            rscale = ((torch.rand(rows, 2, generator=gen, device=dev) < 0.9) / 0.9).float() \
                if epi == "residual" else None
            (a_hi, a_lo), (w_hi, w_lo) = split_bf16(a), split_bf16(w)
            exact = _gemm_f32_ref(a, w, bias, epi, res_t, rscale)  # "highest" on a and w
            for mode in passes:
                args = (a_hi, a_lo, w_hi, w_lo) if mode == "high3" else (a_hi, None, w_hi, None)
                run = lambda: _gemm_wgmma_f32(*args, bias, epi, res_t, rscale)
                plain = lambda: _gemm_wgmma_f32_ref(*args, bias, epi, res_t, rscale)
                out, ref = run(), plain()
                abs_err, rel = rel_err(out, ref)
                sep = ((out - ref).abs().mean() / (ref - exact).abs().mean()).item()
                check(rel <= GEMM_F32_REL_TOL, f"phase 21 wgmma f32 GEMM {label} {mode}: rel err "
                      f"{rel:.3e} > {GEMM_F32_REL_TOL}")
                check(sep <= MODE_SEPARATION[mode], f"phase 21 wgmma f32 GEMM {label} {mode}: "
                      f"r = {sep:.3f} > {MODE_SEPARATION[mode]}")
                if mode == "default":
                    lib = ((lambda: torch.mm(a_hi, w_hi.t(), out_dtype=torch.float32))
                           if mm_out_dtype else (lambda: F.linear(a_hi, w_hi)))
                    lib_name = ("torch.mm(bf16, bf16, out_dtype=float32)" if mm_out_dtype
                                else "F.linear at bf16 (bf16 output)")
                else:
                    lib, lib_name = (lambda: torch.addmm(bias, a, w.t()),
                                     "no single call computes bf16x3; torch.addmm at f32")
                flops = 2 * rows * n * k * passes[mode]
                nbytes = ((4 if mode == "high3" else 2) * (rows * k + n * k)
                          + 4 * rows * n * (2 if res_t is not None else 1) + 4 * n)
                r = dict(abs_err=abs_err, rel=rel, r=sep, ms=cuda_ms(run), plain_ms=cuda_ms(plain),
                         lib_ms=cuda_ms(lib), lib_name=lib_name, **bound(flops, nbytes))
                above_bound(f"wgmma f32 GEMM {label} {mode}", r)
                res["gemm"][f"{label} {mode}"] = r
                lines.append(f"gemm_f32out_wgmma_kernel<{passes[mode]}> {label} M={rows} "
                             f"N={n} K={k}: rel_err={rel:.3e} r={sep:.4f} ms={r['ms']:.4f} "
                             f"plain_ms={r['plain_ms']:.4f} library_ms={r['lib_ms']:.4f} "
                             f"({lib_name}) bound_ms={r['bound_ms']:.4f} "
                             f"TFLOP/s={flops / r['ms'] / 1e9:.1f}")
            del a, w, a_hi, a_lo, w_hi, w_lo, res_t, exact, out, ref

        # The attention step alone in each mode, on a qkv projection: the
        # tensor-core kernel of csrc/grand_attn_mode.cuh in the rows layout
        # (groups of 17 and 243) and in B2's cols layout (the groups (b, j)
        # of 243 frames, kOuter), 8 heads of 64 and 4 of 128. Beside each:
        # its bound and SDPA − v on the same q, k, v.
        for heads, n, cols in ((HEADS, JOINTS, False), (HEADS, FRAMES, False),
                               (HEADS4, JOINTS, False), (HEADS4, FRAMES, False),
                               (HEADS, FRAMES, True), (HEADS4, FRAMES, True)):
            qkv = randn(rows, 3 * EMBED)
            d = EMBED // heads
            j = JOINTS if cols else 0
            if cols:  # the temporal groups of the spatial-major rows
                q, k, v = qkv.view(rows // (n * j), n, j, 3, heads, d).permute(
                    3, 0, 2, 4, 1, 5).reshape(3, rows // n, heads, n, d)
            else:
                q, k, v = qkv.view(rows // n, n, 3, heads, d).permute(2, 0, 3, 1, 4)
            label = f"{'cols ' if cols else ''}n={n} heads={heads}"
            for mode in passes:
                run = lambda: block_attention(qkv, n, heads, f32_prec=mode, j_groups=j)
                plain = lambda: block_attention_ref(qkv, n, heads, f32_prec=mode, j_groups=j)
                r = errors(f"attention {label}", mode, run(), plain(),
                           block_attention_ref(qkv, n, heads, j_groups=j))
                r.update(ms=device_ms(run, kernels=1), plain_ms=device_ms(plain),
                         lib_ms=device_ms(lambda: F.scaled_dot_product_attention(q, k, v) - v),
                         **bound(4 * rows * n * EMBED * passes[mode], 4 * rows * 4 * EMBED))
                above_bound(f"attention {label} {mode}", r)
                res["attention"][f"{label} {mode}"] = r
                lines.append(f"grand_attn_mode_kernel {label} {mode}: rel={r['rel']:.3e} "
                             f"mean_rel={r['mean_rel']:.3e} r={r['r']:.4f} ms={r['ms']:.4f} "
                             f"plain_ms={r['plain_ms']:.4f} library_ms(SDPA f32 - v)="
                             f"{r['lib_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                             f"({r['bound_by']})")
            del qkv, q, k, v

        # The LN with the time add under each mode; each timed call reads
        # the next of 6 copies of x (cold, as phase 2f), the median of 3.
        xs_cold = [randn(rows, EMBED) for _ in range(6)]
        x, t = xs_cold[0], randn(items, EMBED, scale=0.5)
        w, b = 1.0 + randn(EMBED, scale=0.2), randn(EMBED, scale=0.2)
        turn = [0]

        def cold(fn, kernels=None):
            def call():
                turn[0] += 1
                return fn(xs_cold[turn[0] % 6])
            return statistics.median(device_ms(call, kernels=kernels) for _ in range(3))

        xs_highest = layer_norm_rows_ref(x, w, b, t_rows=t, rows_per_item=rows // items)[1]

        for mode in passes:
            kw = dict(t_rows=t, rows_per_item=rows // items, f32_prec=mode)
            (y, xs), (ry, rxs) = layer_norm_rows(x, w, b, **kw), layer_norm_rows_ref(x, w, b, **kw)
            abs_err, rel = rel_err(y, ry)
            check(torch.equal(xs, rxs) and rel <= GEMM_F32_REL_TOL, f"phase 21 LN time add "
                  f"{mode}: xs bit for bit {torch.equal(xs, rxs)}, y rel err {rel:.3e}")
            check(not torch.equal(xs, xs_highest), f"phase 21 LN time add {mode}: xs equals the "
                  f"time add at 'highest'")
            r = dict(abs_err=abs_err, ms=cold(lambda a: layer_norm_rows(a, w, b, **kw), 1),
                     plain_ms=cold(lambda a: layer_norm_rows_ref(a, w, b, **kw)),
                     lib_ms=cold(lambda a: F.layer_norm(a, (EMBED,), w, b, 1e-6)),
                     **bound(0, 4 * (3 * rows * EMBED + items * EMBED + 2 * EMBED)))
            above_bound(f"LN time add {mode}", r)
            res["layer_norm"][mode] = r
            lines.append(f"ln_rows_kernel time add {mode} R={rows}: xs bit for bit, "
                         f"y rel={rel:.3e} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                         f"library_ms(F.layer_norm, no add)={r['lib_ms']:.4f} "
                         f"bound_ms={r['bound_ms']:.4f}")
        del xs_cold, xs_highest
    torch.cuda.empty_cache()
    say(f"phase 21 contraction modes ({card}): " + "; ".join(lines))
    return res


def drive_session_default(dev, card, peaks):
    """Phase 21b (printed after phase 21): the session matmul precision
    "default" (Config.matmul_precision) on B3, B4 and B6 at f32, each
    kernel's one-bf16-pass instance (B3 and B6: the tensor-core kernel of
    csrc/grand_attn_mode.cuh; B4: the rounding of q, k, v and of dO, then
    the bf16 B4's tensor-core passes with f32 outputs) against
    its plain version at "default", at the "default" bars
    (MODE_DEFAULT_MAX_TOL, MODE_DEFAULT_MEAN_TOL) and r <=
    MODE_SEPARATION["default"] from the plain version at "highest" (B4's
    max bar against the plain formulas with S and dP summed exactly, its
    mean and r bars against both): B3 and
    B4 at phase 6's train shape ([B*J = 408, H, 243, d] qkv views, 8 heads
    of 64 and 4 of 128), B6 at phase 8's eval shape ([3888, 8, 17, 64]
    views). B3 also with B4's statistics: the same bits, and each row's
    maximum and 1/l against the plain ones. Device times beside the bound
    (the products of bf16 operands at the bf16 peak, or the bytes) and
    SDPA − v (B4: SDPA's f32 backward). Returns the numbers for the kernels
    line."""
    from torch.nn import functional as F

    from diff3dhpe_torch import (
        grand_attention_bwd, grand_attention_bwd_ref, grand_attention_fullseq,
        grand_attention_fullseq_ref, packed_grand_attention, packed_grand_attention_ref,
    )
    from diff3dhpe_torch.ops.attention import _bwd_stats, _fullseq
    from diff3dhpe_torch.utils.mode_attn_profile import b4_default_exact

    _, peak_bf16, mem_rate = peaks
    gen = torch.Generator(device=dev).manual_seed(23)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    prec = dict(matmul_precision="default")
    res, lines = {}, []

    def hold(label, outs, refs, highs, max_bar=True):
        abs_err = rel = mean_rel = r = 0.0
        for out, ref, high in zip(outs, refs, highs):
            a, b, c = bf16_errs(out, ref)
            sep = ((out - ref).abs().mean() / (ref - high).abs().mean()).item()
            check(torch.isfinite(out).all().item() and (b <= MODE_DEFAULT_MAX_TOL or not max_bar)
                  and c <= MODE_DEFAULT_MEAN_TOL and sep <= MODE_SEPARATION["default"],
                  f"phase 21b {label} at default: max rel {b:.3e} (tol {MODE_DEFAULT_MAX_TOL}), "
                  f"mean {c:.3e} (tol {MODE_DEFAULT_MEAN_TOL}), r {sep:.4f} (bar "
                  f"{MODE_SEPARATION['default']})")
            abs_err, rel, mean_rel, r = max(abs_err, a), max(rel, b), max(mean_rel, c), max(r, sep)
        return dict(abs_err=abs_err, rel=rel, mean_rel=mean_rel, r=r)

    def timed(label, r, run, plain, lib, flops, nbytes, kernels):
        ops_s = flops / peak_bf16
        r.update(ms=device_ms(run, kernels=kernels), plain_ms=device_ms(plain),
                 lib_ms=device_ms(lib), bound_ms=max(ops_s, nbytes / mem_rate) * 1e3,
                 bound_by="operations" if ops_s >= nbytes / mem_rate else "bytes")
        check(min(r["ms"], r["plain_ms"]) >= 0.95 * r["bound_ms"], f"phase 21b {label}: a time "
              f"below 0.95 of its bound {r['bound_ms']:.4f}: a partial measurement")
        lines.append(f"{label} at default: rel={r['rel']:.3e} mean_rel={r['mean_rel']:.3e} "
                     f"r={r['r']:.4f} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                     f"library_ms={r['lib_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                     f"({r['bound_by']})")
        return r

    wrappers = (grand_attention_fullseq, grand_attention_bwd, packed_grand_attention)
    before = [w.launches for w in wrappers]
    held_launches = [0, 0, 0]
    groups = TRAIN_BATCH * JOINTS
    with torch.no_grad():
        for heads in (HEADS, HEADS4):
            d = EMBED // heads
            q, k, v = randn(groups, FRAMES, 3, heads, d).permute(2, 0, 3, 1, 4)
            do = randn(groups, FRAMES, heads, d).transpose(1, 2)
            g, n = groups * heads, FRAMES
            elems = g * n * d
            out = grand_attention_fullseq(q, k, v, **prec)
            r = hold(f"B3 d={d}", [out], [grand_attention_fullseq_ref(q, k, v, **prec)],
                     [grand_attention_fullseq_ref(q, k, v)])
            stats = _bwd_stats(q)
            check(torch.equal(_fullseq(q, k, v, None, stats, "default"), out),
                  f"phase 21b B3 d={d}: with B4's statistics not the same bits")
            logits = (torch.matmul(q.bfloat16().float(), k.bfloat16().float().transpose(-1, -2))
                      * d ** -0.5)
            m = logits.amax(-1)
            inv = 1.0 / torch.exp(logits - m[..., None]).sum(-1)
            planes = stats.view(2, g, -1)[:, :, :n]
            stat_err = max((planes[0] - m.reshape(g, n)).abs().max().item(),
                           ((planes[1] - inv.reshape(g, n)).abs() / inv.reshape(g, n)).max().item())
            check(stat_err <= 1e-4, f"phase 21b B3 d={d}: the statistics part from the plain "
                  f"rows' maximum and 1/l by {stat_err:.3e}")
            del logits, m, inv
            r["stats_err"] = stat_err
            r["stats_ms"] = device_ms(lambda: _fullseq(q, k, v, None, stats, "default"), kernels=1)
            held_launches[0] += 2
            res[f"B3 d={d}"] = timed(
                f"grand_attention_fullseq [B*H={g}, N={n}, D={d}]", r,
                lambda: grand_attention_fullseq(q, k, v, **prec),
                lambda: grand_attention_fullseq_ref(q, k, v, **prec),
                lambda: F.scaled_dot_product_attention(q, k, v) - v, 4 * g * n * n * d,
                4 * 4 * elems, 1)
            lines[-1] += (f"; with B4's statistics the same bits, ms={r['stats_ms']:.4f}, "
                          f"statistics err {stat_err:.2e}")
            del out, stats
            # B4: dS and P reach bf16 roundings, so S and dP summed in two
            # float32 orders turn single roundings the other way, 2^-8 of a
            # term of dq or dk. At this shape the plain version's own
            # cuBLAS sums part from exact ones by more than
            # MODE_DEFAULT_MAX_TOL at d = 128 (PERF.md, ROADMAP C.14). So
            # the max bar holds B4 against b4_default_exact, the plain
            # formulas with S and dP summed exactly; the mean and r bars
            # hold it against both; the max from the plain version is held
            # at MODE_DEFAULT_MAX_TOL + px, px the plain version's own max
            # from the oracle at the same draws (the triangle inequality:
            # a fault that shows only against the plain version fails).
            got = grand_attention_bwd(q, k, v, do, **prec)
            plain, highest = grand_attention_bwd_ref(q, k, v, do, **prec), \
                grand_attention_bwd_ref(q, k, v, do)
            r = hold(f"B4 d={d}", got, plain, highest, max_bar=False)
            exact = b4_default_exact(q, k, v, do)
            rx = hold(f"B4 d={d} from the exact-sum oracle", got, exact, highest)
            px = max(bf16_errs(a, b)[1] for a, b in zip(plain, exact))
            plain_bar = MODE_DEFAULT_MAX_TOL + px
            check(r["rel"] <= plain_bar, f"phase 21b B4 d={d} at default: max rel {r['rel']:.3e} "
                  f"from the plain version > {plain_bar:.3e} (MODE_DEFAULT_MAX_TOL + the plain "
                  f"version's own {px:.3e} from the exact-sum oracle)")
            del plain, highest, exact
            held_launches[1] += 4
            # Scratch beyond inputs and outputs: the CUDA-core passes' P and
            # dS planes [2, B·H, n64, n64] f32 (the path before), against the
            # bf16 planes of q, k, v and dO and the tensor-core passes'
            # statistics (192 floats a 64-query tile).
            n64 = -(-n // 64) * 64
            r["scratch_bytes"] = 4 * g * n * d * 2 + g * (n64 // 64) * 192 * 4
            r["scratch_bytes_before"] = 2 * g * n64 * n64 * 4
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            with torch.enable_grad():
                lib_out = F.scaled_dot_product_attention(qg, kg, vg) - vg
            res[f"B4 d={d}"] = timed(
                f"grand_attention_bwd [B*H={g}, N={n}, D={d}]", r,
                lambda: grand_attention_bwd(q, k, v, do, **prec),
                lambda: grand_attention_bwd_ref(q, k, v, do, **prec),
                lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do, retain_graph=True),
                10 * g * n * n * d, 7 * 4 * elems, 4)
            lines[-1] += (f"; from the exact-sum oracle rel={rx['rel']:.3e} (tol "
                          f"{MODE_DEFAULT_MAX_TOL}) mean_rel={rx['mean_rel']:.3e} r={rx['r']:.4f}"
                          f", the plain version's own rel={px:.3e}; from the plain version "
                          f"rel={r['rel']:.3e} (bar {plain_bar:.3e})")
            lines[-1] += (f"; launches 4 (2 roundings, 2 passes); scratch "
                          f"{r['scratch_bytes'] / 1e9:.3f} GB (the CUDA-core path's P and dS: "
                          f"{r['scratch_bytes_before'] / 1e9:.3f} GB)")
            del got, lib_out, qg, kg, vg, q, k, v, do
            torch.cuda.empty_cache()
        heads, d, n = HEADS, EMBED // HEADS, JOINTS
        b = 2 * BATCH * FRAMES
        q, k, v = randn(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        out = packed_grand_attention(q, k, v, **prec)
        r = hold(f"B6 d={d}", [out], [packed_grand_attention_ref(q, k, v, **prec)],
                 [packed_grand_attention_ref(q, k, v)])
        held_launches[2] += 1
        res["B6"] = timed(f"packed_grand_attention [B*H={b * heads}, N={n}, D={d}]", r,
                          lambda: packed_grand_attention(q, k, v, **prec),
                          lambda: packed_grand_attention_ref(q, k, v, **prec),
                          lambda: F.scaled_dot_product_attention(q, k, v) - v,
                          4 * b * heads * n * n * d, 4 * 4 * b * heads * n * d, 1)
        del q, k, v, out
    torch.cuda.empty_cache()
    # Each wrapper counted its held calls (the timed ones besides).
    check(all(w.launches - b0 >= h for w, b0, h in zip(wrappers, before, held_launches)),
          f"phase 21b: the wrappers counted {[w.launches - b0 for w, b0 in zip(wrappers, before)]}"
          f" launches, at least {held_launches} expected")
    say(f"phase 21b the session matmul precision 'default' on B3, B4 and B6 at f32 ({card}): "
        + "; ".join(lines))
    return res


def one_call(r):
    """A phase's numbers of one call in the kernels line's keys."""
    return {"max_abs_err": r["abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["lib_ms"]}


def kernel_part(name, source, replaces, by_path_counts, numbers, work):
    """A kernel's entry of the kernels line, its launches summed over paths."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path_counts.values()), "launches_by_path": by_path_counts,
            **numbers, "work": work}


def sum_numbers(items):
    """The kernels line's numbers of several calls, summed (the largest error)."""
    tot = lambda key: sum(g[key] for g in items)
    return {"max_abs_err": max(g["max_abs_err"] for g in items), "ms": tot("ms"),
            "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
            "bound_by": "operations" if all(g["bound_by"] == "operations" for g in items)
            else "bytes", "library_ms": tot("library_ms")}


def check_inner(inner_by_path, b1_by_path, b2_by_path, b1_bf16_by_path, b2_bf16_by_path,
                b5_launches, per_call):
    """The launches by kind the block wrappers counted on each path
    (inner_by_path), held against the blocks' structure: a B1 or B2 call
    of per_call kernels launches 3 LNs and 4 GEMMs, f32 ones in an f32
    call; under "high3" or "default" PER_CALL_MODE kernels, of them 3 LNs
    (the first the time add's instance under the mode), 8 splits, 4
    f32-output tensor-core GEMMs and the attention's instance under the
    mode; a B5 call 1 LN and 2 GEMMs. The B1 and B2 totals of each path are
    held by its phase. Returns {kind: {path: launches}}, paths without a
    kind's launches left out of the modes' kinds."""
    for path, got in inner_by_path.items():
        b12, b12_bf16 = (b1_by_path.get(path, 0) + b2_by_path.get(path, 0),
                         b1_bf16_by_path.get(path, 0) + b2_bf16_by_path.get(path, 0))
        b5, b5_bf16 = b5_launches if path == "b5_op" else (0, 0)
        calls = got["attn_mode"]  # block calls under a contraction mode, one attention each
        exact = b12 - PER_CALL_MODE * calls
        want = {"gemm_f32": 4 * (exact - b12_bf16) // per_call + 2 * (b5 - b5_bf16) // 4,
                "layer_norm": 3 * exact // per_call + 3 * calls + b5 // 4,
                "split": 8 * calls, "gemm_mode": 4 * calls, "attn_mode": calls,
                "ln_mode": calls}
        check(got == want and exact >= b12_bf16, f"{path}: the blocks launched {got} by kind, "
              f"expected {want}")
    return {kind: {k: v[kind] for k, v in inner_by_path.items()
                   if v[kind] or kind in ("gemm_f32", "layer_norm")} for kind in INNER}


def mode_kernel_parts(mode_res, by_kind, rows, hidden):
    """The kernels line's numbers of the contraction modes (phase 21's
    ``mode_res``): B1's, B2's and B5's "f32_modes" entries, B1's with the
    split, the f32-output GEMM, the attention and the LN under the modes
    ("parts" too), each launched on every path whose f32 blocks ran at
    "high3" or "default" (the Runner's mixed final steps; phase 4b's mixed
    steps), as the block wrappers counted them (``by_kind``): 8 splits, 4
    tensor-core GEMMs, one attention step and one LN with the time add a
    block call, each counted where it launches. The "high3" numbers at the
    top level, "default"'s beside."""
    mb = mode_res["blocks"]
    split_by_path, gemm_mode_by_path = by_kind["split"], by_kind["gemm_mode"]
    mode_calls = by_kind["attn_mode"]  # block calls under a mode: one attention launch each

    def mode_pair(mode, heads=HEADS, kind="B1"):
        return sum_numbers([one_call(mb[f"{kind} n={n} heads={heads} {mode}"])
                            for n in (JOINTS, FRAMES)])

    def by_mode(numbers_of, **extra):
        return dict(numbers_of("high3"), default=numbers_of("default"), **extra)

    gemms_mode = {m: [dict(one_call(v), product=k.split()[0], library=v["lib_name"])
                      for k, v in mode_res["gemm"].items() if k.endswith(m)]
                  for m in ("high3", "default")}
    split_part = kernel_part(
        "split_bf16_kernel", "diff3dhpe_torch/csrc/fused_block.cu",
        "diff3dhpe_tpu/ops/fused_block.py:137 (_dot_f32_3pass's hi/lo casts; _dot_f32's "
        "one bf16 pass at default, :154)", split_by_path,
        by_mode(lambda m: one_call(mode_res["split"][m])),
        f"one call on [{rows}, {hidden}] f32: hi and lo (high3), hi alone (default); library: "
        f"x.to(bfloat16), the hi half alone (launches: 8 a block call under a mode)")
    gemm_mode_part = kernel_part(
        "gemm_f32out_wgmma_kernel<EPI, 3 or 1>", "diff3dhpe_torch/csrc/gemm_wgmma_f32.cuh",
        "diff3dhpe_tpu/ops/fused_block.py:127 (_dot_f32_3pass) and :147 (_dot_f32 at default)",
        gemm_mode_by_path, by_mode(lambda m: sum_numbers(gemms_mode[m])),
        f"the four products of an f32 block at M={rows} from split operands: 3 passes (high3) "
        f"or 1 (default) (launches: 4 a block call under a mode)")
    gemm_mode_part["products"] = gemms_mode
    ma = mode_res["attention"]
    attention = lambda m, heads, cols="": sum_numbers([
        one_call(ma[f"{cols}n={n} heads={heads} {m}"]) for n in ((FRAMES,) if cols else
                                                               (JOINTS, FRAMES))])
    attn_mode_part = kernel_part(
        "grand_attn_mode_kernel<D, KT16, kOuter, kMode>",
        "diff3dhpe_torch/csrc/grand_attn_mode.cuh",
        "diff3dhpe_tpu/ops/attention.py:52 (grand_attend_tile contracting through "
        "_dot_f32 / _dot_f32_3pass, fused_block.py:127-164; and B3's and B6's f32 tiles at the "
        "session precision 'default', attention.py:103)",
        by_kind["attn_mode"], by_mode(
            lambda m: attention(m, HEADS), d128=by_mode(lambda m: attention(m, HEADS4)),
            **{f"n{n}": by_mode(lambda m, n=n: one_call(ma[f"n={n} heads={HEADS} {m}"]))
               for n in (JOINTS, FRAMES)},
            cols=by_mode(lambda m: attention(m, HEADS, "cols "),
                         d128=by_mode(lambda m: attention(m, HEADS4, "cols "))),
            r={k: v["r"] for k, v in ma.items()}),
        f"one call at n={JOINTS} + one at n={FRAMES} on a qkv [{rows}, {3 * EMBED}], f32, "
        f"device time; n{JOINTS} and n{FRAMES} each alone; cols: B2's layout at n={FRAMES} "
        f"(launches: 1 a block call under a mode)")
    ln_mode_part = kernel_part(
        "ln_rows_kernel<float, kPL, kMode>", "diff3dhpe_torch/csrc/fused_block.cu",
        "diff3dhpe_tpu/ops/fused_block.py:271 (the one-hot time gather through _dot_f32)",
        by_kind["ln_mode"], by_mode(lambda m: one_call(mode_res["layer_norm"][m])),
        f"one call with the time add at R={rows}, C={EMBED}, f32, device time, input cold "
        f"(launches: 1 a block call under a mode, its first LN)")
    parts = [split_part, gemm_mode_part, attn_mode_part, ln_mode_part]
    b1 = dict(
        by_mode(mode_pair), d128=by_mode(lambda m: mode_pair(m, HEADS4)),
        launches=sum(PER_CALL_MODE * c for c in mode_calls.values()),
        launches_by_path={k: PER_CALL_MODE * c for k, c in mode_calls.items()},
        split=split_part, gemm_mode=gemm_mode_part, attention=attn_mode_part,
        layer_norm=ln_mode_part,
        work=f"one spatial (n={JOINTS}) + one temporal (n={FRAMES}) call at f32 under high3 "
             f"(default beside it), R={rows}, C={EMBED}; library: the f32 block from library "
             f"calls; launches: B1 and B2 calls under a mode, {PER_CALL_MODE} kernels each")
    b2 = by_mode(lambda m: one_call(mb[f"B2 n={FRAMES} heads={HEADS} {m}"]),
                 d128=by_mode(lambda m: one_call(mb[f"B2 n={FRAMES} heads={HEADS4} {m}"])))
    return {"B1": b1, "B2": b2, "B5": by_mode(lambda m: mode_pair(m, kind="B5")),
            "parts": parts, "attention": attn_mode_part}


def hold_train_default(card, model, dkw, diff_d, diff_plain, params, batch, gen, randn,
                       counters, per_step_d):
    """Phase 7h (a): one f32 fast-train step at the session precision
    "default" (``diff_d``) at B = CHECK_BATCH on one draw. (1) B4 on the
    step's own inputs: each of its calls, recorded as the step makes it,
    held at phase 21b's bars (the max against b4_default_exact, the mean
    and r against it and against the plain version), beside two controls
    on the same inputs that must miss them: B4's outputs rounded to bf16,
    and B4 at "highest". (2) The whole step against the same step with the
    recompute's attention through B3's, B6's and B4's plain versions, its
    gradients at relative L2 DEFAULT_STEP_GRAD_TOL; the fused forward, and
    so the loss, is the same in both (LOSS_REL_TOL: the premise of the
    comparison). Every product of the recompute rounds its operands to
    bf16, so any change to B4's outputs, one float32 ulp included, turns
    roundings downstream and moves the step's gradients by about as much as
    B4's plain version does: printed beside the step run again and the step
    with B4's outputs moved by one ulp. The gradients cannot tell a B4 that
    misses its bars from one that holds them; (1) does. (3) Beside the
    plain module at "default" r = Σ|g − g_plain| / Σ|g_plain − g_plain at
    "highest"| is printed and held at r < 1: the fused forward's blocks
    stay exact f32 under a session precision (f32_prec "highest", as the
    port's Runner runs them) and B3 and B6 round the unnormalised
    exponentials where the module's formulas round P, so the step parts
    from the plain module by a share of the mode's own effect."""
    from diff3dhpe_torch import (
        GaussianDiffusion, draw_drop_path_scales, grand_attention_bwd, grand_attention_bwd_ref,
        grand_attention_fullseq_ref, make_train_denoise_fn,
    )
    from diff3dhpe_torch.ops import attention as attention_ops
    from diff3dhpe_torch.utils.mode_attn_profile import b4_default_exact, errs

    gt4, x2d4 = batch
    inject = dict(t=torch.randint(0, TIMESTEPS, (CHECK_BATCH,), generator=gen, device=gt4.device),
                  noise=randn(CHECK_BATCH, FRAMES, JOINTS, 3),
                  dp_scales=draw_drop_path_scales(gen, CHECK_BATCH, DEPTH, DROP_PATH, FRAMES,
                                                  JOINTS))

    def loss_grads(fn_diffusion, **swaps):
        """The loss and gradients of one step, with the functions of
        ops/attention.py named in ``swaps`` swapped for the ones given."""
        saved = {name: getattr(attention_ops, name) for name in swaps}
        for name, fn in swaps.items():
            setattr(attention_ops, name, fn)
        try:
            loss = fn_diffusion.training_loss(gt4, x2d4, **inject)
            return loss.item(), torch.autograd.grad(loss, params)
        finally:
            for name, fn in saved.items():
                setattr(attention_ops, name, fn)

    def rel_l2(got, ref):
        return math.sqrt(sum(float((a - b).double().pow(2).sum()) for a, b in zip(got, ref))
                         / sum(float(b.double().pow(2).sum()) for b in ref))

    # The swaps of _bwd, the launch behind grand_attention_bwd, leave the
    # wrapper's own count with it.
    launch, calls = attention_ops._bwd, []

    def recording(q, k, v, do, scale, fwd=None, matmul_precision="highest"):
        out = launch(q, k, v, do, scale, fwd, matmul_precision)
        calls.append(((q, k, v, do, scale), out))
        return out

    for c in counters:
        c.launches = 0
    loss_k, g_k = loss_grads(diff_d, _bwd=recording)
    torch.cuda.synchronize()
    got = {c.__name__: c.launches for c in counters}
    check(got == per_step_d, f"phase 7h train check launched {got}, expected {per_step_d}")

    # (1) B4 on the step's own inputs.
    check(len(calls) == DEPTH, f"phase 7h: the step called B4 {len(calls)} times, not {DEPTH}")
    names = ("kernel", "outputs rounded to bf16", "B4 at 'highest'")
    worst = {name: dict(rel=0.0, mean_rel=0.0, r=0.0) for name in names}
    with torch.no_grad():
        for args, out in calls:
            plain = grand_attention_bwd_ref(*args, matmul_precision="default")
            high = grand_attention_bwd_ref(*args)
            exact = b4_default_exact(*args)
            outs = (out, tuple(t.bfloat16().float() for t in out),
                    launch(*args, None, "highest"))
            for name, o in zip(names, outs):
                e_x, e_p = errs(o, exact, high), errs(o, plain, high)
                w = worst[name]
                w.update(rel=max(w["rel"], e_x["rel"]),
                         mean_rel=max(w["mean_rel"], e_x["mean_rel"], e_p["mean_rel"]),
                         r=max(w["r"], e_x["r"], e_p["r"]))
    del calls
    held = {name: w["rel"] <= MODE_DEFAULT_MAX_TOL and w["mean_rel"] <= MODE_DEFAULT_MEAN_TOL
            and w["r"] <= MODE_SEPARATION["default"] for name, w in worst.items()}
    check(held["kernel"] and not any(held[name] for name in names[1:]), f"phase 7h: B4 on the "
          f"step's inputs {worst} (bars: max {MODE_DEFAULT_MAX_TOL}, mean "
          f"{MODE_DEFAULT_MEAN_TOL}, r {MODE_SEPARATION['default']}); held {held}: the kernel "
          "must hold them and each control miss them")

    # (2) The whole step.
    b4_launches = grand_attention_bwd.launches
    loss_c, g_c = loss_grads(diff_d, fused_grand_attention=grand_attention_fullseq_ref,
                             grand_attention_bwd=grand_attention_bwd_ref)
    check(grand_attention_bwd.launches == b4_launches, "phase 7h: the plain reference launched B4")
    loss_rel = abs(loss_k - loss_c) / abs(loss_c)
    g_max = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(g_k, g_c))
    g_mean = max(((a - b).abs().mean() / b.abs().max()).item() for a, b in zip(g_k, g_c))
    g_l2 = rel_l2(g_k, g_c)
    check(loss_rel <= LOSS_REL_TOL and g_l2 <= DEFAULT_STEP_GRAD_TOL, f"phase 7h train check at "
          f"default: loss rel {loss_rel:.3e} (tol {LOSS_REL_TOL}), grads relative L2 {g_l2:.3e} "
          f"(tol {DEFAULT_STEP_GRAD_TOL})")
    del g_c
    one_ulp = lambda *a, **kw: tuple(torch.nextafter(t, torch.full_like(t, math.inf))
                                     for t in launch(*a, **kw))
    spread = {"the step again": rel_l2(loss_grads(diff_d)[1], g_k),
              "B4's outputs one ulp up": rel_l2(loss_grads(diff_d, _bwd=one_ulp)[1], g_k),
              "B4 on its plain version": rel_l2(
                  loss_grads(diff_d, grand_attention_bwd=grand_attention_bwd_ref)[1], g_k)}

    # (3) Beside the plain module.
    loss_p, g_p = loss_grads(GaussianDiffusion.create(
        make_train_denoise_fn(model, DROP_PATH, matmul_precision="default"), **dkw))
    loss_h, g_h = loss_grads(diff_plain)
    r_plain = (sum((a - b).abs().sum().item() for a, b in zip(g_k, g_p))
               / sum((b - h).abs().sum().item() for b, h in zip(g_p, g_h)))
    p_max = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(g_k, g_p))
    p_mean = max(((a - b).abs().mean() / b.abs().max()).item() for a, b in zip(g_k, g_p))
    check(r_plain < 1, f"phase 7h: the step at default is no nearer the plain module at default "
          f"than that is to 'highest' (r {r_plain:.3f})")
    fmt = lambda w: f"max_rel={w['rel']:.3e} mean_rel={w['mean_rel']:.3e} r={w['r']:.4f}"
    say(f"phase 7h train check at matmul_precision 'default' B={CHECK_BATCH} ({card}): B4 on the "
        f"step's inputs ({DEPTH} calls; bars max {MODE_DEFAULT_MAX_TOL}, mean "
        f"{MODE_DEFAULT_MEAN_TOL}, r {MODE_SEPARATION['default']}): "
        + "; ".join(f"{name} {fmt(w)}" for name, w in worst.items())
        + f"; against the same step on the attention's plain versions: loss_rel_err="
        f"{loss_rel:.3e} (the same forward; tol {LOSS_REL_TOL}) grads rel_l2={g_l2:.3e} (tol "
        f"{DEFAULT_STEP_GRAD_TOL}) max_rel={g_max:.3e} mean_rel={g_mean:.3e}; grads rel_l2 from "
        f"this step: " + ", ".join(f"{label} {v:.3e}" for label, v in spread.items())
        + f"; against the plain module at default: loss={loss_k:.6f} plain_loss={loss_p:.6f} "
        f"(at highest {loss_h:.6f}) grads max_rel={p_max:.3e} mean_rel={p_mean:.3e} "
        f"r={r_plain:.4f} (bar < 1); launches={got}")
    del g_k, g_p, g_h
    torch.cuda.empty_cache()
    return dict(b4=worst, rel_l2=g_l2, spread=spread, r_plain=r_plain)


# Phase 24's head widths: head_dim -> (embed_dim, num_heads). 32 is
# --num-heads 16 at the flagship's embed 512; 96 is 4 heads at embed 384.
# The attention kernels are compiled for 64 and 128, and a width runs on
# the next of them with its columns past head_dim zero-filled.
WIDTHS = {32: (EMBED, 16), 96: (384, 4)}
WIDTH_CLI_HEADS = 16  # phase 24 (c)'s --num-heads at embed EMBED (head_dim 32)
HEAD_WIDTHS_WORK = {  # the work of the kernels line's "head_widths" entries (phase 24)
    "pair": f"d32: 16 heads of 32 at C={EMBED}, d96: 4 heads of 96 at C=384 (f32, and _bf16); "
            f"one call with n={JOINTS} + one with n={FRAMES}, R={2 * BATCH * FRAMES * JOINTS}",
    "B2": f"d32 (C={EMBED}, 16 heads) and d96 (C=384, 4 heads), f32 and _bf16; one call, "
          f"x=[{2 * BATCH}*{FRAMES}, {JOINTS}*C] (n={FRAMES})",
    "B3": f"d32 and d96, f32 and _bf16: one call, [{2 * BATCH * JOINTS}, H, {FRAMES}, d] qkv "
          f"views, H = 16 and 4",
    "B6": f"d32 and d96, f32 and _bf16: one call, [{2 * BATCH * FRAMES}, H, {JOINTS}, d] qkv "
          f"views, H = 16 and 4, device time",
}


def drive_head_widths(dev, card, peaks, per_call):
    """Phase 24: the attention kernels at head widths other than 64 and 128
    (ROADMAP A.19), on the serving path.

    (a) For head_dim 32 (embed 512, 16 heads) and 96 (embed 384, 4 heads):
    B1 in rows at R = 2·BATCH·FRAMES·JOINTS rows in groups of JOINTS and
    FRAMES, B2 (FRAMES frames of JOINTS joints, the cols layout) and B5 (n =
    JOINTS and FRAMES) at f32 ("highest", "high3", "default") and bf16; B3
    at [2·BATCH·JOINTS, H, FRAMES, d] and B6 at [2·BATCH·FRAMES, H, JOINTS,
    d] as qkv views at f32, under the session "default" and at bf16: each
    against its plain version at the bars it meets at 64 and 128
    (KERNEL_REL_TOL, with ATTN_BLOCK_ABS_TOL for B5 and SMALL_ATTN_ABS_TOL
    for B6; the bf16 bars; MODE_HIGH3_TOL; the "default" bars). At f32
    ("highest") and bf16 each is timed beside its plain version and its
    library yardstick (the block from library calls; SDPA − v), its bound
    at the true head_dim (B1, B2 and B5 by block_work / attn_block_work at
    the width's C; B3 4·G·N²·d FLOP; B6 its bytes).

    (b) The attention step each of them runs, bit for bit its compiled
    instance's output on copies zero-padded to 64 or 128 with the same scale
    d^-½: the blocks' step (block_attention) in rows at n = JOINTS and
    FRAMES (B1, B5) and in cols (B2) at f32 under each mode and at bf16,
    and B3 and B6 themselves at f32, "default" and bf16.

    (c) cli.run.main --synthetic --evaluate on CLI_CONFIG with --num-heads
    WIDTH_CLI_HEADS (FRAMES frames, embed EMBED, depth DEPTH; S9 Walking,
    16 windows, batch BATCH) on seed-0 16-head weights: the plain module,
    --fast-eval at f32, the mixed mode (its final step at "high3") and pure
    bf16 at DDIM-DDIM_STEPS, held by hold_eval_modes (f32 within
    EVAL_ABS_BOUND of the plain run, mixed MPJPE from it no more than pure
    bf16's); then the plain module and use_pallas_attention at
    DDIM-CUT_DDIM_STEPS (use_pallas within EVAL_ABS_BOUND). Each run's
    launches counted from 0.

    Returns ({path: launches}, {path: inner counts}, {kernel: {width key:
    numbers}}) for the kernels line."""
    from torch.nn import functional as F

    from diff3dhpe_torch import (
        MixSTEDenoiser, fused_attention_block, fused_attention_block_ref,
        fused_temporal_block_cols, fused_temporal_block_cols_ref, fused_transformer_block,
        fused_transformer_block_ref, grand_attention_fullseq, grand_attention_fullseq_ref,
        packed_grand_attention, packed_grand_attention_ref,
    )
    from diff3dhpe_torch.cli.run import main as cli_main
    from diff3dhpe_torch.models.mixste import Block, init_weights
    from diff3dhpe_torch.ops.fused_block import block_attention, block_attention_ref

    t0 = time.perf_counter()
    peak_flops, peak_bf16, mem_rate = peaks
    gen = torch.Generator(device=dev).manual_seed(24)
    randn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device=dev) * scale
    rows, items = 2 * BATCH * FRAMES * JOINTS, 2 * BATCH
    held, timed, numbers, padded = {}, {}, {}, []

    def hold(label, out, ref, kind):
        """The bars of the kernel at its dtype and mode: 'f32'
        (KERNEL_REL_TOL), 'b5' (and ATTN_BLOCK_ABS_TOL), 'small'
        (SMALL_ATTN_ABS_TOL), 'bf16', 'high3', 'default'."""
        check(torch.isfinite(out.float()).all().item() and out.shape == ref.shape
              and out.dtype == ref.dtype, f"phase 24 {label}: not finite, or shape or dtype")
        abs_err, rel, mean_rel = bf16_errs(out, ref)
        bars = {"f32": rel <= KERNEL_REL_TOL, "small": abs_err <= SMALL_ATTN_ABS_TOL,
                "b5": rel <= KERNEL_REL_TOL and abs_err <= ATTN_BLOCK_ABS_TOL,
                "bf16": rel <= BF16_MAX_TOL and mean_rel <= BF16_MEAN_TOL,
                "high3": rel <= MODE_HIGH3_TOL,
                "default": rel <= MODE_DEFAULT_MAX_TOL and mean_rel <= MODE_DEFAULT_MEAN_TOL}
        check(bars[kind], f"phase 24 {label}: max abs {abs_err:.3e}, max rel {rel:.3e}, mean "
              f"rel {mean_rel:.3e} ({kind} bars)")
        held[label] = (abs_err, rel, mean_rel)
        return abs_err

    def kind(dt, mode, f32_kind="f32"):
        """hold's bars for a call at dt and mode ("highest": f32_kind)."""
        if dt == torch.bfloat16:
            return "bf16"
        return f32_kind if mode == "highest" else mode

    def tag(d, dt, mode):
        return f"d={d} {'bf16' if dt == torch.bfloat16 else mode}"

    def times(key, run, plain, lib, work, peak, timer, abs_err):
        """Kernel, plain and library times by `timer`, the bound from work."""
        flops, nbytes = work
        timed[key] = dict(abs_err=abs_err, ms=timer(run), plain_ms=timer(plain),
                          lib_ms=timer(lib), flops=flops, bytes=nbytes)

    def summed(keys, peak):
        """The kernels line's numbers of the calls under keys, summed."""
        parts = [timed[k] for k in keys]
        tot = lambda name: sum(p[name] for p in parts)
        flops, nbytes = tot("flops"), tot("bytes")
        return {"max_abs_err": max(p["abs_err"] for p in parts), "ms": tot("ms"),
                "plain_ms": tot("plain_ms"), "bound_ms": max(flops / peak, nbytes / mem_rate) * 1e3,
                "bound_by": "operations" if flops / peak >= nbytes / mem_rate else "bytes",
                "library_ms": tot("lib_ms")}

    def pad_heads(t, d, width):
        """[..., H·d] or [..., d] zero-padded per head to width (a copy)."""
        return F.pad(t.unflatten(-1, (-1, d)), (0, width - d)).flatten(-2)

    def same_as_padded(label, out, run_padded, d, width):
        """out equals, bit for bit, the instance's output on padded copies."""
        wide = run_padded()
        narrow = wide.unflatten(-1, (-1, width))[..., :d].flatten(-2)
        check(torch.equal(out, narrow), f"phase 24 {label}: not bit for bit the {width} "
              f"instance on zero-padded copies (max |d| "
              f"{(out.float() - narrow.float()).abs().max().item():.3e})")
        padded.append(label)

    with torch.no_grad():
        for d, (c, heads) in WIDTHS.items():
            width, scale = (64 if d <= 64 else 128), d ** -0.5
            hidden = int(c * MLP_RATIO)
            block = Block(c, heads, MLP_RATIO, qkv_bias=True)
            init_weights(block, torch.Generator().manual_seed(d))
            block = block.to(dev)
            out_ln = torch.nn.LayerNorm(c, eps=1e-6).to(dev)
            for ln in (block.norm1, block.norm2, out_ln):
                ln.weight.copy_(1.0 + randn(c, scale=0.2))
                ln.bias.copy_(randn(c, scale=0.2))
            block_bf = copy.deepcopy(block)
            for m in (block_bf.attn.qkv, block_bf.attn.proj, block_bf.mlp.fc1, block_bf.mlp.fc2):
                m.weight.data = m.weight.data.bfloat16()
            x32, t32 = randn(rows, c), randn(items, c, scale=0.5)
            cols32 = randn(items * FRAMES, JOINTS * c)
            for dt in (torch.float32, torch.bfloat16):
                f32 = dt == torch.float32
                blk = block if f32 else block_bf
                lib_blk, lib_oln = copy.deepcopy(block).to(dt), copy.deepcopy(out_ln).to(dt)
                x, t_rows, cols = x32.to(dt), t32.to(dt), cols32.to(dt)
                modes = ("highest", "high3", "default") if f32 else ("highest",)
                peak = peak_flops if f32 else peak_bf16
                # B1 in rows, B5, at both group sizes.
                for n in (JOINTS, FRAMES):
                    kw = dict(t_rows=t_rows, rows_per_item=rows // items, out_ln=out_ln)
                    for mode in modes:
                        out = fused_transformer_block(x, blk, n, heads, f32_prec=mode, **kw)
                        err = hold(f"B1 {tag(d, dt, mode)} n={n}", out, fused_transformer_block_ref(
                            x, blk, n, heads, f32_prec=mode, **kw), kind(dt, mode))
                        if mode == "highest":
                            times(f"B1 {tag(d, dt, mode)} n={n}",
                                  lambda: fused_transformer_block(x, blk, n, heads, **kw),
                                  lambda: fused_transformer_block_ref(x, blk, n, heads, **kw),
                                  lambda: library_block(x, lib_blk, n, heads, t_rows,
                                                        rows // items, lib_oln),
                                  block_work(rows, n, c, hidden, items, dt.itemsize), peak,
                                  cuda_ms, err)
                        out = fused_attention_block(x, blk, n, heads, f32_prec=mode)
                        err = hold(f"B5 {tag(d, dt, mode)} n={n}", out, fused_attention_block_ref(
                            x, blk, n, heads, f32_prec=mode), kind(dt, mode, "b5"))
                        if mode == "highest":
                            times(f"B5 {tag(d, dt, mode)} n={n}",
                                  lambda: fused_attention_block(x, blk, n, heads),
                                  lambda: fused_attention_block_ref(x, blk, n, heads),
                                  lambda: library_attn_block(x, lib_blk, n, heads),
                                  attn_block_work(rows, n, c, dt.itemsize), peak, cuda_ms, err)
                # B2 in cols.
                kw = dict(t_rows=t_rows, out_ln=out_ln)
                for mode in modes:
                    out = fused_temporal_block_cols(cols, blk, FRAMES, JOINTS, heads,
                                                    f32_prec=mode, **kw)
                    err = hold(f"B2 {tag(d, dt, mode)}", out, fused_temporal_block_cols_ref(
                        cols, blk, FRAMES, JOINTS, heads, f32_prec=mode, **kw), kind(dt, mode))
                    if mode == "highest":
                        times(f"B2 {tag(d, dt, mode)}",
                              lambda: fused_temporal_block_cols(cols, blk, FRAMES, JOINTS, heads,
                                                                **kw),
                              lambda: fused_temporal_block_cols_ref(cols, blk, FRAMES, JOINTS,
                                                                    heads, **kw),
                              lambda: library_cols(cols, lib_blk, FRAMES, JOINTS, heads, t_rows,
                                                   lib_oln),
                              block_work(rows, FRAMES, c, hidden, items, dt.itemsize), peak,
                              cuda_ms, err)
                del x, t_rows, cols, lib_blk, lib_oln
                # (b) the blocks' attention step against its instance.
                for label, n, j in (("rows", JOINTS, 0), ("rows", FRAMES, 0),
                                    ("cols", FRAMES, JOINTS)):
                    qkv = randn(rows, 3 * c).to(dt)
                    wide = pad_heads(qkv, d, width)
                    for mode in modes:
                        out = block_attention(qkv, n, heads, f32_prec=mode, j_groups=j)
                        hold(f"block attention {label} {tag(d, dt, mode)} n={n}", out,
                             block_attention_ref(qkv, n, heads, f32_prec=mode, j_groups=j),
                             kind(dt, mode))
                        same_as_padded(f"block attention {label} {tag(d, dt, mode)} n={n}", out,
                                       lambda: block_attention(wide, n, heads, f32_prec=mode,
                                                               j_groups=j, scale=scale),
                                       d, width)
                    del qkv, wide
                # B3 and B6 on qkv views, at f32 (and the session "default") and bf16.
                for name, fn, ref, b, n, f32_kind, timer in (
                        ("B3", grand_attention_fullseq, grand_attention_fullseq_ref,
                         2 * BATCH * JOINTS, FRAMES, "f32", cuda_ms if f32 else device_ms),
                        ("B6", packed_grand_attention, packed_grand_attention_ref,
                         2 * BATCH * FRAMES, JOINTS, "small", device_ms)):
                    q, k, v = randn(b, n, 3, heads, d).to(dt).permute(2, 0, 3, 1, 4)
                    wide = [F.pad(t, (0, width - d)) for t in (q, k, v)]
                    for prec in (("highest", "default") if f32 else ("highest",)):
                        out = fn(q, k, v, matmul_precision=prec)
                        label = f"{name} {tag(d, dt, prec)}"
                        err = hold(label, out, ref(q, k, v, matmul_precision=prec),
                                   kind(dt, prec, f32_kind))
                        same_as_padded(label, out.transpose(1, 2),
                                       lambda: fn(*wide, scale, matmul_precision=prec)
                                       .transpose(1, 2), d, width)
                        if prec == "highest":
                            elems = b * heads * n * d
                            flops = 4 * elems * n
                            times(label, lambda: fn(q, k, v), lambda: ref(q, k, v),
                                  lambda: F.scaled_dot_product_attention(q, k, v) - v,
                                  (flops, 4 * dt.itemsize * elems), peak, timer, err)
                    del q, k, v, wide
            del block, block_bf, out_ln, x32, t32, cols32
            torch.cuda.empty_cache()
            pair = (f"n={JOINTS}", f"n={FRAMES}")
            for name, keys in (("B1", pair), ("B5", pair),
                               ("B2", ("",)), ("B3", ("",)), ("B6", ("",))):
                for dt_key, tag_key, peak in (("", "highest", peak_flops),
                                              ("_bf16", "bf16", peak_bf16)):
                    ks = [f"{name} d={d} {tag_key}" + (f" {k}" if k else "") for k in keys]
                    numbers.setdefault(name, {})[f"d{d}{dt_key}"] = summed(ks, peak)
    lines = [f"{k} max rel {v[1]:.3e} (max abs {v[0]:.3e}, mean rel {v[2]:.3e})"
             for k, v in held.items()]
    lines.append(f"{len(padded)} attention launches bit for bit their instance on "
                 f"zero-padded copies")
    lines += [f"{k}: ms {v['ms']:.4f} plain_ms {v['plain_ms']:.4f} library_ms "
              f"{v['lib_ms']:.4f}" for k, v in timed.items()]
    say(f"phase 24a,b head widths {sorted(WIDTHS)} ({card}): " + "; ".join(lines))
    say(f"phase 24a kernels line numbers: {json.dumps(numbers)}")

    # (c) the CLI at --num-heads 16.
    here = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(here, CLI_CONFIG)
    with open(config) as f:
        params = json.load(f)["params"]
    launches, inner, runs, cut = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "seed0_heads16.bin")
        torch.save(MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED,
                                  depth=DEPTH, num_heads=WIDTH_CLI_HEADS, mlp_ratio=MLP_RATIO,
                                  seed=0, device=dev).state_dict(), weights)
        use_pallas = os.path.join(tmp, "use_pallas.json")
        with open(use_pallas, "w") as f:
            json.dump({"params": dict(params, use_pallas_attention=True)}, f)
        for name, cfg_path, extra, ddim in (
                *((k, config, v, DDIM_STEPS) for k, v in EVAL_MODES.items()),
                ("plain_cut", config, [], CUT_DDIM_STEPS),
                ("use_pallas", use_pallas, [], CUT_DDIM_STEPS)):
            errors, dr = drive(cli_main, [
                "--config", cfg_path, "--synthetic", "-str", "S1", "-ste", "S9", "-a", "Walking",
                "--num-heads", str(WIDTH_CLI_HEADS), "--sampling_timesteps", str(ddim),
                "--batch-size-eval", str(BATCH), "-c", os.path.join(tmp, name),
                "--evaluate", weights] + extra)
            check(all(line in dr["text"] for line in REPORT_RUN + ("----Walking----",))
                  and all(len(v) == 1 and math.isfinite(v[0]) for v in errors.values()),
                  f"phase 24c cli {name}: a line of the report is missing, or errors {errors}")
            (rec,) = dr["records"]
            run = dict(pred=normalised_predictions(dr["records"]), launches=dr["launches"],
                       frames_per_s=rec["n_frames"] / rec["model_time"], errors=errors,
                       wall_s=dr["wall_s"])
            (cut if ddim == CUT_DDIM_STEPS else runs)[name.replace("_cut", "")] = run
            launches[f"cli_heads16_{name}"], inner[f"cli_heads16_{name}"] = (dr["launches"],
                                                                              dr["inner"])
        windows = runs["plain"]["pred"].shape[0] // FRAMES
        check(windows == 16, f"phase 24c: {windows} windows")
        steps = windows // BATCH + 1  # and the warm-up step
        hold_eval_modes("phase 24c cli", runs, eval_want(steps * DDIM_STEPS, per_call,
                                                         DDIM_STEPS))
        want_cut = eval_want(steps * CUT_DDIM_STEPS, per_call, CUT_DDIM_STEPS)
        for name, r in cut.items():
            got = {k: r["launches"].get(k, 0) for k in want_cut[name]}
            check(got == want_cut[name] and not any(
                v for k, v in r["launches"].items() if k not in want_cut[name]),
                f"phase 24c cli {name} DDIM-{CUT_DDIM_STEPS} launched {r['launches']}, "
                f"expected {want_cut[name]}")
        cut["use_pallas"]["dev"] = (cut["use_pallas"]["pred"] - cut["plain"]["pred"]).abs().max(
        ).item()
        check(torch.isfinite(cut["use_pallas"]["pred"]).all().item()
              and cut["use_pallas"]["dev"] <= EVAL_ABS_BOUND,
              f"phase 24c use_pallas DDIM-{CUT_DDIM_STEPS} deviates from the plain run by "
              f"{cut['use_pallas']['dev']:.3e} > {EVAL_ABS_BOUND}")
    say(f"phase 24c cli at --num-heads {WIDTH_CLI_HEADS} (head_dim {EMBED // WIDTH_CLI_HEADS}; "
        f"{FRAMES} frames, embed {EMBED}, depth {DEPTH}; S9 Walking, {windows} windows, batch "
        f"{BATCH} x2 flip; {card}): " + "; ".join(
            f"{k} DDIM-{DDIM_STEPS if k in runs and r is runs[k] else CUT_DDIM_STEPS} "
            f"frames/s {r['frames_per_s']:.1f} e1_mm {r['errors']['e1'][0]:.4f}"
            + (f" max_abs_dev {r['dev']:.3e} mpjpe {r['mpjpe']:.4e}" if "mpjpe" in r else "")
            + (f" max_abs_dev {r['dev']:.3e}" if "dev" in r and "mpjpe" not in r else "")
            + f" launches { {a: b for a, b in r['launches'].items() if b} } wall_s "
              f"{r['wall_s']:.1f}"
            for k, r in [*runs.items(), *((f"{k} (cut)", v) for k, v in cut.items())])
        + f"; phase 24 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return launches, inner, numbers


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from torch.nn import functional as F

    from diff3dhpe_torch import (
        GaussianDiffusion, MixSTEDenoiser, Runner, draw_drop_path_scales, fast_forward_denoise,
        flip_pose, fused_attention_block, fused_attention_block_ref, fused_grand_attention,
        fused_temporal_block_cols, fused_temporal_block_cols_ref, fused_transformer_block,
        fused_transformer_block_ref, grand_attention_bwd, grand_attention_bwd_ref,
        grand_attention_fullseq, grand_attention_fullseq_ref, make_denoise_fn, make_eval_step,
        make_fast_denoise_fn, make_fast_train_denoise_fn, make_mixed_diffusion, make_optimizer,
        make_train_denoise_fn, make_train_step, packed_grand_attention, packed_grand_attention_ref,
    )
    from diff3dhpe_torch.cli.run import main as cli_main
    from diff3dhpe_torch.models import mixste
    from diff3dhpe_torch.models.mixste import Block, init_weights
    from diff3dhpe_torch.ops import attention as attention_ops
    from diff3dhpe_torch.ops import read_launches, reset_launches
    from diff3dhpe_torch.ops._build import SOURCES, build_all
    from diff3dhpe_torch.ops.attention import _bwd, _bwd_stats, _bwd_stats_bf16, _fullseq
    from diff3dhpe_torch.ops.fused_block import (
        _gemm_bf16, _gemm_bf16_ref, _gemm_f32, _gemm_f32_ref, layer_norm_rows, layer_norm_rows_ref,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    peak_flops, peak_bf16, mem_rate = next(v for k, v in CARD_PEAKS.items() if k in kind)

    # Phase 1: build every kernel source from the checkout.
    t0 = time.perf_counter()
    reports = build_all()
    regs = [f"{name}.cu {entry}" for name, log in reports.items() for entry in ptxas_summary(log)]
    say(f"phase 1 build: {time.perf_counter() - t0:.3f} s for {list(SOURCES)}; "
        f"{len(reports)} built now; ptxas: {' | '.join(regs)}")
    # The wrappers' and the runner's mirrors of the libraries' limits.
    from diff3dhpe_torch.ops._build import load_library
    from diff3dhpe_torch.ops.attention import MAX_N, takes_head_dim

    libs = {name: load_library(name) for name in SOURCES}
    limits = {"diff3dhpe_grand_max_n": libs["grand_attention"].diff3dhpe_grand_max_n(),
              "diff3dhpe_attn_max_n": libs["fused_block"].diff3dhpe_attn_max_n()}
    rule = {name: [d for d in range(260) if fn(d)] for name, fn in (
        ("diff3dhpe_grand_takes_head_dim", libs["grand_attention"].diff3dhpe_grand_takes_head_dim),
        ("diff3dhpe_attn_takes_head_dim", libs["fused_block"].diff3dhpe_attn_takes_head_dim))}
    check(all(v == MAX_N for v in limits.values())
          and all(v == [d for d in range(260) if takes_head_dim(d)] for v in rule.values()),
          f"phase 1: the libraries' limits {limits} and head widths {rule} are not the Python "
          f"mirrors' (MAX_N {MAX_N}, takes_head_dim)")
    say(f"phase 1 limits: {limits} (MAX_N {MAX_N}); head widths the forward kernels take: "
        f"{rule['diff3dhpe_grand_takes_head_dim']} (takes_head_dim agrees); B4: "
        f"{[d for d in range(260) if libs['grand_attention'].diff3dhpe_grand_bwd_takes_head_dim(d)]}")

    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device=dev) * scale
    rows = 2 * BATCH * FRAMES * JOINTS
    hidden = int(EMBED * MLP_RATIO)

    # The f32 GEMM and the LayerNorm run inside B1, B2 and B5, whose
    # wrappers count their launches by kind (csrc/fused_block.cu,
    # LaunchCount). Each driven path sets these counts to 0 with the
    # others and records them after its run in inner_by_path.
    blocks = (fused_transformer_block, fused_temporal_block_cols, fused_attention_block)
    inner_by_path = {}

    def zero_inner():
        reset_inner(blocks)

    def inner():
        return count_inner(blocks)

    # Phase 2: the block kernel against its plain version at both main-path shapes.
    per_shape = {}
    with torch.no_grad():
        for shape, n in (("spatial", JOINTS), ("temporal", FRAMES)):
            block = Block(EMBED, HEADS, MLP_RATIO, qkv_bias=True)
            init_weights(block, torch.Generator().manual_seed(1))
            block = block.to(dev)
            out_ln = torch.nn.LayerNorm(EMBED, eps=1e-6).to(dev)
            for ln in (block.norm1, block.norm2, out_ln):
                ln.weight.copy_(1.0 + randn(EMBED, scale=0.2))
                ln.bias.copy_(randn(EMBED, scale=0.2))
            x = randn(rows, EMBED)
            t_rows = randn(2 * BATCH, EMBED, scale=0.5)
            kw = dict(t_rows=t_rows, rows_per_item=rows // (2 * BATCH), out_ln=out_ln)
            run = lambda: fused_transformer_block(x, block, n, HEADS, **kw)
            plain = lambda: fused_transformer_block_ref(x, block, n, HEADS, **kw)
            lib = lambda: library_block(x, block, n, HEADS, out_ln=out_ln, t_rows=t_rows,
                                        rows_per_item=rows // (2 * BATCH))
            out, ref = run(), plain()
            torch.cuda.synchronize()
            abs_err, rel = rel_err(out, ref)
            lib_abs, _ = rel_err(lib(), ref)
            check(torch.isfinite(out).all().item(), f"{shape} kernel output not finite")
            check(rel <= KERNEL_REL_TOL, f"{shape} kernel rel err {rel:.3e} > {KERNEL_REL_TOL}")
            # Drop-path: per-row branch scales of 0 or 1/keep (keep 0.9).
            dp = (torch.rand(rows, 2, generator=gen, device=dev) < 0.9).float() / 0.9
            dp_abs, dp_rel = rel_err(fused_transformer_block(x, block, n, HEADS, dp_scales=dp, **kw),
                                     fused_transformer_block_ref(x, block, n, HEADS, dp_scales=dp,
                                                                 **kw))
            check(dp_rel <= KERNEL_REL_TOL,
                  f"{shape} kernel with drop-path rel err {dp_rel:.3e} > {KERNEL_REL_TOL}")
            # The train step's row count, R = 24·243·17, with per-row
            # drop-path scales, the time add and the out-LN, as its 16 block
            # calls run B1.
            r_train = TRAIN_BATCH * FRAMES * JOINTS
            x_train = randn(r_train, EMBED)
            kw_train = dict(t_rows=randn(TRAIN_BATCH, EMBED, scale=0.5),
                            rows_per_item=FRAMES * JOINTS, out_ln=out_ln,
                            dp_scales=(torch.rand(r_train, 2, generator=gen, device=dev)
                                       < 0.9).float() / 0.9)
            tr_abs, tr_rel = rel_err(
                fused_transformer_block(x_train, block, n, HEADS, **kw_train),
                fused_transformer_block_ref(x_train, block, n, HEADS, **kw_train))
            check(tr_rel <= KERNEL_REL_TOL, f"{shape} kernel with drop-path at R={r_train} "
                  f"rel err {tr_rel:.3e} > {KERNEL_REL_TOL}")
            del x_train, kw_train
            abs_err = max(abs_err, dp_abs, tr_abs)
            ms, plain_ms, lib_ms = cuda_ms(run), cuda_ms(plain), cuda_ms(lib)
            flops, nbytes = block_work(rows, n, EMBED, hidden, 2 * BATCH)
            per_shape[shape] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                                    flops=flops, bytes=nbytes)
            bound_ms = max(flops / peak_flops, nbytes / mem_rate) * 1e3
            say(f"phase 2 fused_transformer_block {shape}: R={rows} n={n} C={EMBED} "
                f"hidden={hidden} max_abs_err={abs_err:.3e} rel_err={rel:.3e} "
                f"(tol {KERNEL_REL_TOL}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} (library vs plain max_abs {lib_abs:.3e}) "
                f"drop-path rel_err={dp_rel:.3e} "
                f"drop-path at train R={r_train} rel_err={tr_rel:.3e} max_abs_err={tr_abs:.3e} "
                f"bound_ms={bound_ms:.4f} GFLOP={flops / 1e9:.2f} "
                f"achieved_TFLOPs={flops / ms / 1e9:.2f}")
            del block, out_ln, x, out, ref, dp

    # Phase 2, head_dim 128: B1 at f32 with 4 heads (the width of the
    # configs with num_heads 4 at embed 512) at both eval shapes, with the
    # time add, the out-LN and drop-path, against its plain version.
    per_shape_hd128 = {}
    with torch.no_grad():
        for shape, n in (("spatial", JOINTS), ("temporal", FRAMES)):
            block = Block(EMBED, HEADS4, MLP_RATIO, qkv_bias=True)
            init_weights(block, torch.Generator().manual_seed(4))
            block = block.to(dev)
            out_ln = torch.nn.LayerNorm(EMBED, eps=1e-6).to(dev)
            x = randn(rows, EMBED)
            t_rows = randn(2 * BATCH, EMBED, scale=0.5)
            dp = (torch.rand(rows, 2, generator=gen, device=dev) < 0.9).float() / 0.9
            kw = dict(t_rows=t_rows, rows_per_item=rows // (2 * BATCH), out_ln=out_ln)
            run = lambda: fused_transformer_block(x, block, n, HEADS4, **kw)
            plain = lambda: fused_transformer_block_ref(x, block, n, HEADS4, **kw)
            lib = lambda: library_block(x, block, n, HEADS4, t_rows, rows // (2 * BATCH), out_ln)
            abs_err, rel = rel_err(run(), plain())
            dp_abs, dp_rel = rel_err(fused_transformer_block(x, block, n, HEADS4, dp_scales=dp, **kw),
                                     fused_transformer_block_ref(x, block, n, HEADS4, dp_scales=dp,
                                                                 **kw))
            check(max(rel, dp_rel) <= KERNEL_REL_TOL,
                  f"{shape} kernel at head_dim 128 rel err {max(rel, dp_rel):.3e} > {KERNEL_REL_TOL}")
            ms, plain_ms, lib_ms = cuda_ms(run), cuda_ms(plain), cuda_ms(lib)
            flops, nbytes = block_work(rows, n, EMBED, hidden, 2 * BATCH)
            per_shape_hd128[shape] = dict(abs_err=max(abs_err, dp_abs), ms=ms, plain_ms=plain_ms,
                                          lib_ms=lib_ms, flops=flops, bytes=nbytes)
            say(f"phase 2 fused_transformer_block {shape} head_dim 128: R={rows} n={n} C={EMBED} "
                f"heads={HEADS4} max_abs_err={max(abs_err, dp_abs):.3e} rel_err={rel:.3e} "
                f"drop-path rel_err={dp_rel:.3e} (tol {KERNEL_REL_TOL}) ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={max(flops / peak_flops, nbytes / mem_rate) * 1e3:.4f}")
            del block, out_ln, x, dp

    def timings(run, plain, lib, flops, nbytes, peak, timer=cuda_ms):
        """The kernel's, the plain version's and the library's times, all
        three by `timer`: CUDA events around a loop of calls, or the
        profiler's device time where a kernel is shorter than the host's
        time between calls."""
        ms, plain_ms, lib_ms = timer(run), timer(plain), timer(lib)
        by_ops = flops / peak >= nbytes / mem_rate
        return dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, flops=flops, bytes=nbytes,
                    bound_ms=max(flops / peak, nbytes / mem_rate) * 1e3,
                    bound_by="operations" if by_ops else "bytes")

    def make_block(seed, heads=HEADS):
        """A block and an out-LN with random weights and non-trivial LNs."""
        block = Block(EMBED, heads, MLP_RATIO, qkv_bias=True)
        init_weights(block, torch.Generator().manual_seed(seed))
        block = block.to(dev)
        out_ln = torch.nn.LayerNorm(EMBED, eps=1e-6).to(dev)
        with torch.no_grad():
            for ln in (block.norm1, block.norm2, out_ln):
                ln.weight.copy_(1.0 + randn(EMBED, scale=0.2))
                ln.bias.copy_(randn(EMBED, scale=0.2))
        return block, out_ln

    def check_bf16(label, out, ref):
        abs_err, rel, mean_rel = bf16_errs(out, ref)
        check(out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all().item(),
              f"{label}: output not finite bf16")
        check(rel <= BF16_MAX_TOL and mean_rel <= BF16_MEAN_TOL,
              f"{label}: max rel err {rel:.3e} (tol {BF16_MAX_TOL}), mean {mean_rel:.3e} "
              f"(tol {BF16_MEAN_TOL})")
        return abs_err, rel, mean_rel

    # Phase 2b: B1 at bf16 against its plain version at both eval shapes,
    # with the time add and the out-LN; weights made bf16 once (as the bf16
    # denoise_fn's snapshot holds them); with 8 heads and with 4 (head_dim
    # 128, the tensor-core attention's second instance). The library
    # yardstick is the same block in bf16 from F.layer_norm/F.linear/SDPA.
    per_shape_bf16, per_shape_bf16_hd128 = {}, {}
    with torch.no_grad():
        for heads, results in ((HEADS, per_shape_bf16), (HEADS4, per_shape_bf16_hd128)):
            for shape, n in (("spatial", JOINTS), ("temporal", FRAMES)):
                block, out_ln = make_block(1, heads)
                block_bf = copy.deepcopy(block)
                for m in (block_bf.attn.qkv, block_bf.attn.proj, block_bf.mlp.fc1,
                          block_bf.mlp.fc2):
                    m.weight.data = m.weight.data.bfloat16()
                block_lib = copy.deepcopy(block).bfloat16()
                out_ln_lib = copy.deepcopy(out_ln).bfloat16()
                x = randn(rows, EMBED).bfloat16()
                t_rows = randn(2 * BATCH, EMBED, scale=0.5).bfloat16()
                kw = dict(t_rows=t_rows, rows_per_item=rows // (2 * BATCH), out_ln=out_ln)
                run = lambda: fused_transformer_block(x, block_bf, n, heads, **kw)
                plain = lambda: fused_transformer_block_ref(x, block_bf, n, heads, **kw)
                lib = lambda: library_block(x, block_lib, n, heads, t_rows, rows // (2 * BATCH),
                                            out_ln_lib)
                label = f"{shape} bf16 kernel head_dim {EMBED // heads}"
                abs_err, rel, mean_rel = check_bf16(label, run(), plain())
                lib_abs, _, _ = bf16_errs(lib(), plain())
                t = timings(run, plain, lib, *block_work(rows, n, EMBED, hidden, 2 * BATCH, 2),
                            peak_bf16)
                results[shape] = dict(abs_err=abs_err, **t)
                say(f"phase 2b fused_transformer_block bf16 {shape} heads={heads} "
                    f"(head_dim {EMBED // heads}): R={rows} n={n} "
                    f"max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} (tol {BF16_MAX_TOL}) "
                    f"mean_rel_err={mean_rel:.3e} (tol {BF16_MEAN_TOL}) ms={t['ms']:.4f} "
                    f"plain_ms={t['plain_ms']:.4f} library_ms={t['lib_ms']:.4f} "
                    f"(library vs plain max_abs {lib_abs:.3e}) bound_ms={t['bound_ms']:.4f} "
                    f"({t['bound_by']}) achieved_TFLOPs={t['flops'] / t['ms'] / 1e9:.2f}")
                del block, block_bf, block_lib, out_ln, out_ln_lib, x

    # Phase 2c: B2 against its plain version at the eval shape, x [B*F, J*C]
    # with per-sample time rows, the out-LN and per-group drop-path, at f32
    # and bf16 (8 heads, and 4 of head_dim 128); then at f32 at the train
    # step's R = 24·243·17 rows.
    cols_res = {}
    with torch.no_grad():
        block, out_ln = make_block(2)
        items = 2 * BATCH
        for name, dt, heads in (("f32", torch.float32, HEADS), ("bf16", torch.bfloat16, HEADS),
                                ("bf16_d128", torch.bfloat16, HEADS4)):
            base, oln = (block, out_ln) if heads == HEADS else make_block(6, heads)
            blk = base
            if dt == torch.bfloat16:
                blk = copy.deepcopy(base)
                for m in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                    m.weight.data = m.weight.data.bfloat16()
            lib_blk, lib_oln = copy.deepcopy(base).to(dt), copy.deepcopy(oln).to(dt)
            x = randn(items * FRAMES, JOINTS * EMBED).to(dt)
            t_rows = randn(items, EMBED, scale=0.5).to(dt)
            dp = (torch.rand(items * JOINTS, 2, generator=gen, device=dev) < 0.9).float() / 0.9
            kw = dict(t_rows=t_rows, out_ln=oln)
            run = lambda: fused_temporal_block_cols(x, blk, FRAMES, JOINTS, heads, **kw)
            plain = lambda: fused_temporal_block_cols_ref(x, blk, FRAMES, JOINTS, heads, **kw)
            lib = lambda: library_cols(x, lib_blk, FRAMES, JOINTS, heads, t_rows, lib_oln)
            out, ref = run(), plain()
            out_dp = fused_temporal_block_cols(x, blk, FRAMES, JOINTS, heads, dp_scales=dp, **kw)
            ref_dp = fused_temporal_block_cols_ref(x, blk, FRAMES, JOINTS, heads, dp_scales=dp,
                                                   **kw)
            torch.cuda.synchronize()
            if dt == torch.float32:
                abs_err, rel = rel_err(out, ref)
                dp_abs, dp_rel = rel_err(out_dp, ref_dp)
                check(torch.isfinite(out).all().item(), "B2 f32 output not finite")
                check(max(rel, dp_rel) <= KERNEL_REL_TOL,
                      f"B2 f32 rel err {max(rel, dp_rel):.3e} > {KERNEL_REL_TOL}")
                errs = f"rel_err={rel:.3e} drop-path rel_err={dp_rel:.3e} (tol {KERNEL_REL_TOL})"
            else:
                abs_err, rel, mean_rel = check_bf16(f"B2 {name}", out, ref)
                dp_abs, dp_rel, dp_mean = check_bf16(f"B2 {name} with drop-path", out_dp, ref_dp)
                errs = (f"max_rel_err={rel:.3e} mean_rel_err={mean_rel:.3e} drop-path "
                        f"max_rel_err={dp_rel:.3e} mean_rel_err={dp_mean:.3e} "
                        f"(tol {BF16_MAX_TOL}, {BF16_MEAN_TOL})")
            lib_abs = (lib().float() - ref.float()).abs().max().item()
            t = timings(run, plain, lib, *block_work(rows, FRAMES, EMBED, hidden, items,
                                                     dt.itemsize),
                        peak_flops if dt == torch.float32 else peak_bf16)
            cols_res[name] = dict(abs_err=max(abs_err, dp_abs), **t)
            say(f"phase 2c fused_temporal_block_cols {name}: x=[{items}*{FRAMES}, "
                f"{JOINTS}*{EMBED}] heads={heads} max_abs_err={max(abs_err, dp_abs):.3e} {errs} "
                f"ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms={t['lib_ms']:.4f} "
                f"(library vs plain max_abs {lib_abs:.3e}) bound_ms={t['bound_ms']:.4f} "
                f"({t['bound_by']}) achieved_TFLOPs={t['flops'] / t['ms'] / 1e9:.2f}")
            del out, ref, out_dp, ref_dp, x, lib_blk, lib_oln
        # The train step's rows, with per-group drop-path, at f32.
        x = randn(TRAIN_BATCH * FRAMES, JOINTS * EMBED)
        kw = dict(t_rows=randn(TRAIN_BATCH, EMBED, scale=0.5), out_ln=out_ln,
                  dp_scales=(torch.rand(TRAIN_BATCH * JOINTS, 2, generator=gen, device=dev)
                             < 0.9).float() / 0.9)
        tr_abs, tr_rel = rel_err(fused_temporal_block_cols(x, block, FRAMES, JOINTS, HEADS, **kw),
                                 fused_temporal_block_cols_ref(x, block, FRAMES, JOINTS, HEADS,
                                                               **kw))
        check(tr_rel <= KERNEL_REL_TOL, f"B2 with drop-path at R={x.numel() // EMBED} rel err "
              f"{tr_rel:.3e} > {KERNEL_REL_TOL}")
        cols_res["f32"]["abs_err"] = max(cols_res["f32"]["abs_err"], tr_abs)
        say(f"phase 2c fused_temporal_block_cols f32 with drop-path at train "
            f"R={x.numel() // EMBED}: max_abs_err={tr_abs:.3e} rel_err={tr_rel:.3e} "
            f"(tol {KERNEL_REL_TOL})")
        del x, kw, block, out_ln
    torch.cuda.empty_cache()

    # Phase 2d: the bf16 GEMM of the block kernels alone, at the four
    # products of a bf16 block call (M = R rows) with their epilogues. The
    # library yardstick is F.linear (cuBLAS) on the same operands, which
    # adds the bias and no more. Bound: 2·M·N·K FLOPs on the tensor cores
    # against A, W, the bias, the residual and the output moved once.
    gemms = []
    with torch.no_grad():
        for label, n_out, k_in, epilogue in (("qkv", 3 * EMBED, EMBED, "bias"),
                                             ("proj", EMBED, EMBED, "residual"),
                                             ("fc1", hidden, EMBED, "gelu"),
                                             ("fc2", EMBED, hidden, "residual")):
            a = randn(rows, k_in).bfloat16()
            w = randn(n_out, k_in, scale=k_in ** -0.5).bfloat16()
            bias, bias_bf = randn(n_out), randn(n_out).bfloat16()
            res = rscale = None
            if epilogue == "residual":
                res = randn(rows, n_out).bfloat16()
                rscale = (torch.rand(rows, 2, generator=gen, device=dev) < 0.9).float() / 0.9
            run = lambda: _gemm_bf16(a, w, bias, epilogue, res, rscale)
            plain = lambda: _gemm_bf16_ref(a, w, bias, epilogue, res, rscale)
            lib = lambda: F.linear(a, w, bias_bf)
            abs_err, rel, mean_rel = check_bf16(f"bf16 GEMM {label}", run(), plain())
            flops = 2 * rows * n_out * k_in
            nbytes = 2 * (rows * k_in + n_out * k_in + rows * n_out * (1 if res is None else 2)) \
                + 4 * n_out + (0 if rscale is None else 4 * rows)
            t = timings(run, plain, lib, flops, nbytes, peak_bf16)
            gemms.append(dict(name=label, M=rows, N=n_out, K=k_in, epilogue=epilogue,
                              max_abs_err=abs_err, ms=t["ms"], plain_ms=t["plain_ms"],
                              bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                              library_ms=t["lib_ms"]))
            say(f"phase 2d bf16 GEMM {label}: M={rows} N={n_out} K={k_in} epilogue={epilogue} "
                f"max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} (tol {BF16_MAX_TOL}) "
                f"mean_rel_err={mean_rel:.3e} (tol {BF16_MEAN_TOL}) ms={t['ms']:.4f} "
                f"TFLOPs={flops / t['ms'] / 1e9:.1f} plain_ms={t['plain_ms']:.4f} "
                f"F.linear_ms={t['lib_ms']:.4f} ({flops / t['lib_ms'] / 1e9:.1f} TFLOP/s) "
                f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
            del a, w, res, rscale
    say(f"phase 2d bf16 GEMM: the four products of a block {sum(g['ms'] for g in gemms):.4f} ms, "
        f"F.linear {sum(g['library_ms'] for g in gemms):.4f} ms")
    torch.cuda.empty_cache()

    # Phase 2e: the f32 GEMM of the block kernels alone (exact f32 FMAs on
    # the CUDA cores), at the four products of an f32 block call with their
    # epilogues, at the eval step's R rows and the train step's. The library
    # yardstick is one torch.matmul family call in f32 with TF32 off plus
    # the epilogue (torch.addmm for the bias, F.gelu after it, and
    # torch.addmm into the residual for the residual products). Bound:
    # 2·M·N·K FLOPs at the f32 FMA rate against A, W, the bias, the
    # residual and the output moved once.
    gemms_f32 = {}
    with torch.no_grad():
        for m_rows in (rows, TRAIN_BATCH * FRAMES * JOINTS):
            products = []
            for label, n_out, k_in, epilogue in (("qkv", 3 * EMBED, EMBED, "bias"),
                                                 ("proj", EMBED, EMBED, "residual"),
                                                 ("fc1", hidden, EMBED, "gelu"),
                                                 ("fc2", EMBED, hidden, "residual")):
                a = randn(m_rows, k_in)
                w = randn(n_out, k_in, scale=k_in ** -0.5)
                bias = randn(n_out)
                res = rscale = None
                if epilogue == "residual":
                    res = randn(m_rows, n_out)
                    rscale = (torch.rand(m_rows, 2, generator=gen, device=dev) < 0.9).float() / 0.9
                run = lambda: _gemm_f32(a, w, bias, epilogue, res, rscale)
                plain = lambda: _gemm_f32_ref(a, w, bias, epilogue, res, rscale)
                if epilogue == "residual":
                    s_col = rscale[:, 0:1]
                    lib = lambda: res + s_col * torch.addmm(bias, a, w.t())
                elif epilogue == "gelu":
                    lib = lambda: F.gelu(torch.addmm(bias, a, w.t()))
                else:
                    lib = lambda: torch.addmm(bias, a, w.t())
                out, ref = run(), plain()
                abs_err, rel = rel_err(out, ref)
                lib_abs, _ = rel_err(lib(), ref)
                check(torch.isfinite(out).all().item() and rel <= GEMM_F32_REL_TOL,
                      f"f32 GEMM {label} at M={m_rows}: rel err {rel:.3e} > {GEMM_F32_REL_TOL}")
                flops = 2 * m_rows * n_out * k_in
                nbytes = 4 * (m_rows * k_in + n_out * k_in + n_out
                              + m_rows * n_out * (1 if res is None else 2)
                              + (0 if rscale is None else 2 * m_rows))
                t = timings(run, plain, lib, flops, nbytes, peak_flops)
                products.append(dict(name=label, M=m_rows, N=n_out, K=k_in, epilogue=epilogue,
                                     max_abs_err=abs_err, ms=t["ms"], plain_ms=t["plain_ms"],
                                     bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                                     library_ms=t["lib_ms"]))
                say(f"phase 2e f32 GEMM {label}: M={m_rows} N={n_out} K={k_in} "
                    f"epilogue={epilogue} max_abs_err={abs_err:.3e} rel_err={rel:.3e} "
                    f"(tol {GEMM_F32_REL_TOL}) ms={t['ms']:.4f} "
                    f"TFLOPs={flops / t['ms'] / 1e9:.2f} (of {peak_flops / 1e12:.0f}) "
                    f"plain_ms={t['plain_ms']:.4f} library_ms={t['lib_ms']:.4f} "
                    f"({flops / t['lib_ms'] / 1e9:.2f} TFLOP/s; library vs plain max_abs "
                    f"{lib_abs:.3e}) bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
                del a, w, res, rscale, out, ref
            tot = lambda key: sum(g[key] for g in products)
            flops = sum(2 * g["M"] * g["N"] * g["K"] for g in products)
            gemms_f32[m_rows] = products
            say(f"phase 2e f32 GEMM: the four products of a block at M={m_rows} "
                f"{tot('ms'):.4f} ms ({flops / tot('ms') / 1e9:.2f} TFLOP/s), library "
                f"{tot('library_ms'):.4f} ms, bound {tot('bound_ms'):.4f} ms "
                f"({flops / 1e9:.2f} GFLOP at {peak_flops / 1e12:.0f} TFLOP/s)")
    torch.cuda.empty_cache()

    # Phase 2f: the LayerNorm of the block kernels alone at R rows of C, f32
    # and bf16, with and without the time add (which also writes xs), against
    # its plain version and F.layer_norm in the same dtype (the library
    # yardstick; it does no time add). Bound: x (and t) read once, y (and
    # xs) written once, at the card's memory rate. All three are timed by
    # the profiler's device time (one call through the Python wrapper takes
    # longer on the host than the kernel on the card), each call on the
    # next of LN_COPIES copies of x, so that x comes from device memory as
    # on the main path, not from the 50 MB L2 that one 34 MB input fits.
    LN_COPIES = 6
    layer_norms = []
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            for with_t in (False, True):
                x = (randn(rows, EMBED, scale=2.0) + 0.5).to(dt)
                copies, turn = [x] + [x.clone() for _ in range(LN_COPIES - 1)], [0]

                def next_x():
                    turn[0] += 1
                    return copies[turn[0] % LN_COPIES]

                w_ln, b_ln = 1.0 + randn(EMBED, scale=0.2), randn(EMBED, scale=0.2)
                kw = dict(t_rows=randn(2 * BATCH, EMBED), rows_per_item=rows // (2 * BATCH)) \
                    if with_t else {}
                run = lambda: layer_norm_rows(next_x(), w_ln, b_ln, 1e-6, **kw)
                plain = lambda: layer_norm_rows_ref(next_x(), w_ln, b_ln, 1e-6, **kw)
                w_lib, b_lib = w_ln.to(dt), b_ln.to(dt)
                lib = lambda: F.layer_norm(next_x(), (EMBED,), w_lib, b_lib, 1e-6)
                (y, xs), (y_ref, xs_ref) = run(), plain()
                check(torch.equal(xs, xs_ref), f"LN {dt} time add: xs differs from the plain")
                name = "f32" if dt == torch.float32 else "bf16"
                if dt == torch.float32:
                    abs_err, rel = rel_err(y, y_ref)
                    check(rel <= KERNEL_REL_TOL, f"LN f32 rel err {rel:.3e} > {KERNEL_REL_TOL}")
                    errs = f"rel_err={rel:.3e} (tol {KERNEL_REL_TOL})"
                else:
                    abs_err, rel, mean_rel = check_bf16(f"LN bf16 t={with_t}", y, y_ref)
                    errs = (f"max_rel_err={rel:.3e} (tol {BF16_MAX_TOL}) "
                            f"mean_rel_err={mean_rel:.3e} (tol {BF16_MEAN_TOL})")
                nbytes = x.element_size() * rows * EMBED * (3 if with_t else 2) + 8 * EMBED \
                    + (4 * 2 * BATCH * EMBED if with_t else 0)
                t = timings(run, plain, lib, 8 * rows * EMBED, nbytes, peak_flops, device_ms)
                call_ms = cuda_ms(run)
                layer_norms.append(dict(name=f"{name}{'_time_add' if with_t else ''}", R=rows,
                                        C=EMBED, max_abs_err=abs_err, ms=t["ms"],
                                        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                                        bound_by=t["bound_by"], library_ms=t["lib_ms"],
                                        call_ms=call_ms))
                say(f"phase 2f layer_norm_rows {name} time_add={with_t}: R={rows} C={EMBED} "
                    f"max_abs_err={abs_err:.3e} {errs} xs equal to the plain version "
                    f"device ms={t['ms']:.4f} (one call through Python {call_ms:.4f}) "
                    f"GB_per_s={nbytes / t['ms'] / 1e6:.1f} (of "
                    f"{mem_rate / 1e9:.0f}) bound_share={t['bound_ms'] / t['ms']:.3f} "
                    f"plain_ms={t['plain_ms']:.4f} F.layer_norm_ms={t['lib_ms']:.4f} "
                    f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
                del x, copies, y, xs, y_ref, xs_ref
    torch.cuda.empty_cache()

    # Phase 21 (printed here, beside the other kernels alone): the float32
    # contraction modes of the block kernels. Its device times come from
    # the profiler, which device_ms holds to every launch; after phase 20 a
    # profile of this process once recorded no kernel, and profiler_probe
    # reads what it records before, within and after that phase.
    mode_res = drive_modes(dev, card, (peak_flops, peak_bf16, mem_rate))
    session_res = drive_session_default(dev, card, (peak_flops, peak_bf16, mem_rate))

    # Phase 3: one full-width denoiser forward, kernel path vs plain module.
    model = MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED, depth=DEPTH,
                           num_heads=HEADS, mlp_ratio=MLP_RATIO, seed=0, device=dev).eval()
    x_in = randn(2 * BATCH, FRAMES, JOINTS, 5)
    t_in = torch.tensor([999.0, 887.0, 443.0, 0.0], device=dev)
    with torch.no_grad():
        fast = fast_forward_denoise(model, x_in, t_in)
        plain = model(x_in, t_in)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(fast, plain)
    check(fast.shape == (2 * BATCH, FRAMES, JOINTS, 3), f"forward shape {tuple(fast.shape)}")
    check(torch.isfinite(fast).all().item(), "forward output not finite")
    check(rel <= KERNEL_REL_TOL, f"forward rel err {rel:.3e} > {KERNEL_REL_TOL}")
    with torch.no_grad():
        fast_bf16 = fast_forward_denoise(model, x_in, t_in, dtype=torch.bfloat16)
    check(torch.isfinite(fast_bf16.float()).all().item(), "bf16 forward output not finite")
    bf16_abs, bf16_rel = rel_err(fast_bf16.float(), plain)
    say(f"phase 3 forward B={2 * BATCH} F={FRAMES} J={JOINTS} C={EMBED} depth={DEPTH}: "
        f"max_abs_err={abs_err:.3e} rel_err={rel:.3e} (tol {KERNEL_REL_TOL}); the bf16 forward "
        f"vs the plain f32 module: max_abs_dev={bf16_abs:.3e} rel_dev={bf16_rel:.3e}")

    # Phase 4: the main path, the flip-TTA DDIM eval step.
    kw = dict(timesteps=TIMESTEPS, sampling_timesteps=DDIM_STEPS, clip_denoised=True,
              beta_schedule="cosine")
    step_fast = make_eval_step(GaussianDiffusion.create(make_fast_denoise_fn(model), **kw),
                               JOINTS_LEFT, JOINTS_RIGHT, device=dev)
    step_plain = make_eval_step(GaussianDiffusion.create(make_denoise_fn(model), **kw),
                                JOINTS_LEFT, JOINTS_RIGHT, device=dev)
    x2d = torch.rand(BATCH, FRAMES, JOINTS, 2, generator=gen, device=dev) * 2 - 1
    x2d_flip = flip_pose(x2d, JOINTS_LEFT, JOINTS_RIGHT)
    x_init = randn(2 * BATCH, FRAMES, JOINTS, 3)

    fused_transformer_block.launches = 0
    zero_inner()
    pred = step_fast(x2d, x2d_flip, x_init=x_init)
    torch.cuda.synchronize()
    launches = fused_transformer_block.launches
    inner_by_path["eval_step"] = inner()
    per_call = 8  # kernels per block call with the out-LN (csrc/fused_block.cu)
    expected = 2 * DEPTH * DDIM_STEPS * per_call
    check(launches == expected, f"main path launched {launches} kernels, expected {expected}")
    pred_plain = step_plain(x2d, x2d_flip, x_init=x_init)
    torch.cuda.synchronize()
    dev_abs = (pred - pred_plain).abs().max().item()
    finite = torch.isfinite(pred).all().item()
    check(pred.shape == (BATCH, FRAMES, JOINTS, 3), f"eval shape {tuple(pred.shape)}")
    check(finite, "eval output not finite")
    check(dev_abs <= EVAL_ABS_BOUND, f"eval deviation {dev_abs:.3e} > {EVAL_ABS_BOUND}")

    def timed(step, reps=3):
        secs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            step(x2d, x2d_flip, x_init=x_init)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return statistics.median(secs)

    fast_s, plain_s = timed(step_fast), timed(step_plain)
    say(f"phase 4 eval step B={BATCH} (x2 flip) DDIM-{DDIM_STEPS}: shape={tuple(pred.shape)} "
        f"finite={finite} max_abs_dev_vs_plain={dev_abs:.3e} (bound {EVAL_ABS_BOUND}) "
        f"launches={launches} (= 16 block calls x {DDIM_STEPS} forwards x {per_call} kernels) "
        f"step_s={fast_s:.4f} seq_per_s={BATCH / fast_s:.3f} "
        f"plain_step_s={plain_s:.4f} plain_seq_per_s={BATCH / plain_s:.3f}")

    # Phase 5: where one eval step's device time goes, by kernel name.
    profile_step("phase 5 profile of one eval step",
                 lambda: step_fast(x2d, x2d_flip, x_init=x_init))
    eval_launches = launches

    # Phase 4b: the shipped "mixed" eval (bench.py:101-135) in both layouts,
    # held against the plain f32 eval of phase 4 on the same x_T, then the
    # pure-bf16 eval (bench.py's opt-in "bfloat16") once. Counts per path:
    # 16 block calls x 8 kernels per forward; rows runs B1 for all 16, cols
    # B1 for the 8 spatial blocks and B2 for the 8 temporal ones; 8 of the
    # 9 forwards are bf16.
    counters = (fused_transformer_block, fused_temporal_block_cols)

    def drive(step, path=None):
        for c in counters:
            c.launches = c.launches_bf16 = 0
        zero_inner()
        out = step(x2d, x2d_flip, x_init=x_init)
        torch.cuda.synchronize()
        if path:
            inner_by_path[path] = inner()
        return out, {f"{c.__name__}{suffix}": getattr(c, "launches" + suffix)
                     for c in counters for suffix in ("", "_bf16")}

    def counts(b1_calls, b2_calls, bf16_steps):
        per_fwd = {"fused_transformer_block": b1_calls, "fused_temporal_block_cols": b2_calls}
        return {f"{k}{suffix}": v * per_call * (DDIM_STEPS if suffix == "" else bf16_steps)
                for k, v in per_fwd.items() for suffix in ("", "_bf16")}

    mixed = {}
    for mode, b1_calls, b2_calls in (("rows", 2 * DEPTH, 0), ("cols", DEPTH, DEPTH)):
        step = make_eval_step(make_mixed_diffusion(model, mode, **kw), JOINTS_LEFT, JOINTS_RIGHT,
                              device=dev)
        out, got = drive(step, f"mixed_eval_{mode}")
        want = counts(b1_calls, b2_calls, DDIM_STEPS - 1)
        check(got == want, f"mixed {mode} eval launched {got}, expected {want}")
        check(out.shape == pred_plain.shape and out.dtype == torch.float32
              and torch.isfinite(out).all().item(), f"mixed {mode} eval output")
        secs = timed(step)
        mixed[mode] = dict(out=out, launches=got, dev=(out - pred_plain).abs().max().item(),
                           mpjpe=mpjpe(out, pred_plain), step_s=secs, step=step)
    step_bf16 = make_eval_step(GaussianDiffusion.create(
        make_fast_denoise_fn(model, torch.bfloat16), **kw), JOINTS_LEFT, JOINTS_RIGHT, device=dev)
    pred_bf16, bf16_launches = drive(step_bf16, "bf16_eval_rows")
    want = counts(2 * DEPTH, 0, DDIM_STEPS)
    check(bf16_launches == want, f"bf16 eval launched {bf16_launches}, expected {want}")
    check(torch.isfinite(pred_bf16).all().item(), "bf16 eval output not finite")
    bf16_dev, bf16_mpjpe = (pred_bf16 - pred_plain).abs().max().item(), mpjpe(pred_bf16, pred_plain)
    bf16_s = timed(step_bf16, reps=1)
    cols_vs_rows = (mixed["cols"]["out"] - mixed["rows"]["out"]).abs().max().item()
    for mode, m in mixed.items():
        say(f"phase 4b mixed eval step {mode} B={BATCH} (x2 flip) DDIM-{DDIM_STEPS}: "
            f"vs plain f32 max_abs_dev={m['dev']:.3e} mpjpe={m['mpjpe']:.4e} (bound: the bf16 "
            f"eval's mpjpe {bf16_mpjpe:.4e}) step_s={m['step_s']:.4f} "
            f"seq_per_s={BATCH / m['step_s']:.3f} launches={m['launches']}")
    say(f"phase 4b bf16 eval step rows: vs plain f32 max_abs_dev={bf16_dev:.3e} "
        f"mpjpe={bf16_mpjpe:.4e} step_s={bf16_s:.4f} seq_per_s={BATCH / bf16_s:.3f} "
        f"launches={bf16_launches}; mixed cols vs rows max_abs={cols_vs_rows:.3e} "
        f"(bound {COLS_VS_ROWS_BOUND})")
    for mode, m in mixed.items():
        check(m["mpjpe"] <= bf16_mpjpe, f"mixed {mode} mpjpe {m['mpjpe']:.4e} > the bf16 "
              f"eval's {bf16_mpjpe:.4e}")
    check(cols_vs_rows <= COLS_VS_ROWS_BOUND,
          f"mixed cols vs rows {cols_vs_rows:.3e} > {COLS_VS_ROWS_BOUND}")

    # Phase 4b under the contraction modes: the mixed rows step with its
    # final forward at "high3" (the Runner's default eval_final_prec) and
    # at "default", beside the "highest" one above. The final forward's 16
    # block calls run 8 splits and 4 f32-output tensor-core GEMMs each in
    # place of 4 gemm_nt_kernel launches; the bf16 steps are unchanged.
    mixed_modes = {}
    for fmode in ("high3", "default"):
        step = make_eval_step(make_mixed_diffusion(model, "rows", f32_prec=fmode, **kw),
                              JOINTS_LEFT, JOINTS_RIGHT, device=dev)
        path = f"mixed_eval_rows_{fmode}"
        out, got = drive(step, path)
        want = counts(2 * DEPTH, 0, DDIM_STEPS - 1)
        want["fused_transformer_block"] += 2 * DEPTH * (PER_CALL_MODE - per_call)
        want_inner = {"gemm_f32": 0, "layer_norm": 3 * 2 * DEPTH * DDIM_STEPS,
                      "split": 8 * 2 * DEPTH, "gemm_mode": 4 * 2 * DEPTH,
                      "attn_mode": 2 * DEPTH, "ln_mode": 2 * DEPTH}
        check(got == want and inner_by_path[path] == want_inner,
              f"mixed rows eval at {fmode} launched {got}, {inner_by_path[path]}; expected "
              f"{want}, {want_inner}")
        check(torch.isfinite(out).all().item(), f"mixed rows eval at {fmode}: not finite")
        mixed_modes[fmode] = dict(
            launches=got, inner=inner_by_path[path], dev=(out - pred_plain).abs().max().item(),
            mpjpe=mpjpe(out, pred_plain), step_s=timed(step), step=step,
            vs_highest=(out - mixed["rows"]["out"]).abs().max().item())
        say(f"phase 4b mixed eval step rows, final step at {fmode}: vs plain f32 "
            f"max_abs_dev={mixed_modes[fmode]['dev']:.3e} mpjpe={mixed_modes[fmode]['mpjpe']:.4e} "
            f"(final step at highest: {mixed['rows']['dev']:.3e}, {mixed['rows']['mpjpe']:.4e}; "
            f"pure bf16: {bf16_dev:.3e}, {bf16_mpjpe:.4e}); vs the highest-final step "
            f"max_abs={mixed_modes[fmode]['vs_highest']:.3e}; "
            f"step_s={mixed_modes[fmode]['step_s']:.4f} "
            f"seq_per_s={BATCH / mixed_modes[fmode]['step_s']:.3f} (highest-final "
            f"{BATCH / mixed['rows']['step_s']:.3f}); launches={got} by kind "
            f"{inner_by_path[path]}")
    check(mixed_modes["high3"]["mpjpe"] <= bf16_mpjpe, f"mixed at high3 mpjpe "
          f"{mixed_modes['high3']['mpjpe']:.4e} > the bf16 eval's {bf16_mpjpe:.4e}")

    # Phase 4b at 4 heads (head_dim 128, the TPU-recommended config's
    # width): the mixed rows eval and the pure-bf16 eval of a seed-0 4-head
    # model, held against its plain f32 eval on the same x_T by MPJPE.
    model4 = MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED, depth=DEPTH,
                            num_heads=HEADS4, mlp_ratio=MLP_RATIO, seed=0, device=dev).eval()
    ref4 = make_eval_step(GaussianDiffusion.create(make_denoise_fn(model4), **kw), JOINTS_LEFT,
                          JOINTS_RIGHT, device=dev)(x2d, x2d_flip, x_init=x_init)
    step4 = make_eval_step(make_mixed_diffusion(model4, "rows", **kw), JOINTS_LEFT, JOINTS_RIGHT,
                           device=dev)
    out4, got4 = drive(step4, "mixed_eval_rows_heads4")
    check(got4 == counts(2 * DEPTH, 0, DDIM_STEPS - 1),
          f"mixed eval at {HEADS4} heads launched {got4}")
    bf16_4, _ = drive(make_eval_step(GaussianDiffusion.create(
        make_fast_denoise_fn(model4, torch.bfloat16), **kw), JOINTS_LEFT, JOINTS_RIGHT, device=dev))
    check(torch.isfinite(out4).all().item() and torch.isfinite(bf16_4).all().item(),
          f"the evals at {HEADS4} heads are not finite")
    mixed4 = dict(mpjpe=mpjpe(out4, ref4), bf16_mpjpe=mpjpe(bf16_4, ref4), step_s=timed(step4),
                  launches=got4)
    say(f"phase 4b mixed eval step rows at {HEADS4} heads (head_dim {EMBED // HEADS4}) "
        f"B={BATCH} (x2 flip) DDIM-{DDIM_STEPS}: vs its plain f32 eval "
        f"max_abs_dev={(out4 - ref4).abs().max().item():.3e} mpjpe={mixed4['mpjpe']:.4e} "
        f"(bound: the bf16 eval's mpjpe {mixed4['bf16_mpjpe']:.4e}) "
        f"step_s={mixed4['step_s']:.4f} seq_per_s={BATCH / mixed4['step_s']:.3f} launches={got4}")
    check(mixed4["mpjpe"] <= mixed4["bf16_mpjpe"], f"mixed at {HEADS4} heads mpjpe "
          f"{mixed4['mpjpe']:.4e} > the bf16 eval's {mixed4['bf16_mpjpe']:.4e}")
    mixed_launches_h4 = {"mixed_eval_rows_heads4": got4}
    del model4, step4, ref4, out4, bf16_4

    # Phase 5b: where one mixed rows eval step's device time goes.
    names = profile_step("phase 5b profile of one mixed rows eval step",
                         lambda: mixed["rows"]["step"](x2d, x2d_flip, x_init=x_init), top_n=14)
    for kernel in ("grand_attn_bf16_kernel", "gemm_bf16_wgmma_kernel"):
        check(any(kernel in name for name in names), f"the mixed step ran no {kernel}")
    # Phase 5b under "high3": the mixed rows step whose final forward runs
    # the split and the f32-output tensor-core GEMM, and no gemm_nt_kernel.
    names = profile_step("phase 5b profile of one mixed rows eval step, final step at high3",
                         lambda: mixed_modes["high3"]["step"](x2d, x2d_flip, x_init=x_init),
                         top_n=16)
    check(any("split_bf16_kernel" in n for n in names)
          and any("gemm_f32out_wgmma_kernel" in n for n in names)
          and not any("gemm_nt_kernel" in n for n in names),
          "the mixed step at high3 ran no split or f32-output wgmma GEMM, or a gemm_nt_kernel")
    mixed_launches = {f"mixed_eval_{mode}": m["launches"] for mode, m in mixed.items()}
    mixed_launches.update({f"mixed_eval_rows_{m}": r["launches"] for m, r in mixed_modes.items()})
    mixed_launches["bf16_eval_rows"] = bf16_launches
    mixed_launches.update(mixed_launches_h4)

    # Phase 17: the mixed step with a float32 tail of k block pairs in its
    # final forward, k = 2, 4, 6, 8, rows and cols, held as phase 4b's.
    tail_launches, tail_inner = drive_tail(
        model, kw, (x2d, x2d_flip, x_init), pred_plain,
        dict(mixed=mixed, bf16=dict(mpjpe=bf16_mpjpe)), per_call, dev, card)
    mixed_launches.update(tail_launches)
    inner_by_path.update(tail_inner)
    del step_fast, step_plain, step_bf16, step, out, model, pred, pred_plain, pred_bf16, mixed
    del mixed_modes
    torch.cuda.empty_cache()

    # Phase 6: the attention kernels B3 and B4 against their plain versions
    # at the train path's shape and layout: q, k, v are views of one
    # [B*J, F, 3, H, d] qkv projection, dO is [B*J, F, H, d] seen as
    # [B*J, H, F, d], as the temporal blocks of the recompute hand them over;
    # at 8 heads (d = 64) and at 4 heads (d = 128). B4 is called twice and
    # must give the same bits (no atomics).
    groups = TRAIN_BATCH * JOINTS
    attn_by_heads = {}
    for heads in (HEADS, HEADS4):
        hd = EMBED // heads
        qkv = randn(groups, FRAMES, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        do = randn(groups, FRAMES, heads, hd).transpose(1, 2)
        g_all, n, elems = groups * heads, FRAMES, groups * heads * FRAMES * hd
        attn = attn_by_heads[heads] = {}
        with torch.no_grad():
            for name, run, plain, work, nbytes in (
                ("grand_attention_fullseq", lambda: (grand_attention_fullseq(q, k, v),),
                 lambda: (grand_attention_fullseq_ref(q, k, v),), 4 * g_all * n * n * hd,
                 4 * 4 * elems),
                ("grand_attention_bwd", lambda: grand_attention_bwd(q, k, v, do),
                 lambda: grand_attention_bwd_ref(q, k, v, do), 10 * g_all * n * n * hd,
                 7 * 4 * elems),
            ):
                outs, refs = run(), plain()
                torch.cuda.synchronize()
                refs_bwd = refs
                errs = [rel_err(a, b) for a, b in zip(outs, refs)]
                abs_err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
                check(all(torch.isfinite(a).all().item() for a in outs), f"{name} not finite")
                check(rel <= KERNEL_REL_TOL, f"{name} d={hd} rel err {rel:.3e} > {KERNEL_REL_TOL}")
                if name == "grand_attention_bwd":
                    check(all(torch.equal(a, b) for a, b in zip(outs, run())),
                          f"grand_attention_bwd d={hd}: two calls gave different bits")
                del outs, refs
                attn[name] = dict(abs_err=abs_err, rel=rel, ms=cuda_ms(run),
                                  plain_ms=cuda_ms(plain), flops=work, bytes=nbytes, g=g_all, d=hd)
            # B4 as the train step calls it: from B3's output and the row
            # statistics B3's launch wrote (its dq pass skips the forward sweep).
            fwd_stats = _bwd_stats(q)
            fwd_out = _fullseq(q, k, v, None, fwd_stats)
            train_form = lambda: _bwd(q, k, v, do, None, (fwd_out, fwd_stats))
            t_abs, t_rel = max((rel_err(a, b) for a, b in zip(train_form(), refs_bwd)),
                               key=lambda e: e[1])
            check(t_rel <= KERNEL_REL_TOL, f"grand_attention_bwd from B3's statistics d={hd} rel "
                  f"err {t_rel:.3e} > {KERNEL_REL_TOL}")
            attn["grand_attention_bwd"].update(train_ms=cuda_ms(train_form), train_abs_err=t_abs)
            del fwd_out, fwd_stats, refs_bwd
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(qg, kg, vg) - vg
        attn["grand_attention_fullseq"]["lib_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v) - v)
        attn["grand_attention_bwd"]["lib_ms"] = cuda_ms(
            lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do, retain_graph=True))
        del lib_out, qg, kg, vg, qkv, q, k, v, do
        for name, a in attn.items():
            a["bound_ms"] = max(a["flops"] / peak_flops, a["bytes"] / mem_rate) * 1e3
            a["bound_by"] = ("operations" if a["flops"] / peak_flops >= a["bytes"] / mem_rate
                             else "bytes")
            say(f"phase 6 {name}: [B*H={g_all}, N={n}, D={hd}] max_abs_err={a['abs_err']:.3e} "
                f"rel_err={a['rel']:.3e} (tol {KERNEL_REL_TOL}) ms={a['ms']:.4f} "
                f"plain_ms={a['plain_ms']:.4f} library_ms={a['lib_ms']:.4f} "
                f"bound_ms={a['bound_ms']:.4f} ({a['bound_by']}) GFLOP={a['flops'] / 1e9:.2f} "
                f"achieved_TFLOPs={a['flops'] / a['ms'] / 1e9:.2f}"
                + (f" same bits in two calls; from B3's statistics (the train step's call) "
                   f"ms={a['train_ms']:.4f} max_abs_err={a['train_abs_err']:.3e}"
                   if name == "grand_attention_bwd" else ""))
        torch.cuda.empty_cache()
    attn, hd = attn_by_heads[HEADS], EMBED // HEADS

    # Phase 6b: B3 at bf16, the tensor-core attention kernel that B1, B2 and
    # B5 run for their attention step, alone: q, k, v as views of one
    # [G, n, 3, H, d] bf16 qkv projection at both eval shapes (68 temporal
    # groups of 243 frames, 972 spatial groups of 17 joints), with 8 heads
    # of 64 and 4 of 128. The library yardstick is SDPA − v at bf16. All
    # three times are device times from the profiler (at n = 17 the call
    # through Python takes longer on the host than the kernel on the card).
    attn_bf16, attn_bf16_hd128 = {}, {}
    with torch.no_grad():
        for heads, results in ((HEADS, attn_bf16), (HEADS4, attn_bf16_hd128)):
            hdim = EMBED // heads
            for label, b, n in (("temporal", 2 * BATCH * JOINTS, FRAMES),
                                ("spatial", 2 * BATCH * FRAMES, JOINTS)):
                q, k, v = randn(b, n, 3, heads, hdim).bfloat16().permute(2, 0, 3, 1, 4)
                run = lambda: grand_attention_fullseq(q, k, v)
                plain = lambda: grand_attention_fullseq_ref(q, k, v)
                lib = lambda: F.scaled_dot_product_attention(q, k, v) - v
                out = run()
                check(out.shape == q.shape, f"B3 bf16 {label} output shape {tuple(out.shape)}")
                abs_err, rel, mean_rel = check_bf16(f"B3 bf16 {label} d={hdim}", out, plain())
                lib_abs, _, _ = bf16_errs(lib(), plain())
                elems = b * heads * n * hdim
                t = timings(run, plain, lib, 4 * elems * n, 4 * 2 * elems, peak_bf16, device_ms)
                results[label] = dict(abs_err=abs_err, **t)
                say(f"phase 6b grand_attention_fullseq bf16 {label}: [B={b}, H={heads}, N={n}, "
                    f"D={hdim}] as qkv views max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} "
                    f"(tol {BF16_MAX_TOL}) mean_rel_err={mean_rel:.3e} (tol {BF16_MEAN_TOL}) "
                    f"ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms={t['lib_ms']:.4f} "
                    f"(library vs plain max_abs {lib_abs:.3e}) bound_ms={t['bound_ms']:.4f} "
                    f"({t['bound_by']}) GFLOP={t['flops'] / 1e9:.2f} "
                    f"GB_per_s={t['bytes'] / t['ms'] / 1e6:.1f}")
                del q, k, v, out
    torch.cuda.empty_cache()

    # Phase 6c: B4 at bf16 (the wgmma backward) against its plain version
    # at the bf16 train path's shapes and layout, as phase 6 holds the f32
    # one: q, k, v views of one [B*J, F, 3, H, d] bf16 qkv projection, dO
    # [B*J, H, F, d] as a transposed view, with 8 heads (d = 64) and 4 (d =
    # 128); two calls give the same bits. Timed alone (its dq pass forms the
    # rows' softmax statistics) and as the train step calls it, from the
    # statistics that B3's launch in the trainable forward wrote, which must
    # give the same bits. The library yardstick is SDPA's backward at bf16
    # on the same operands. Bound: q, k, v, dO read and dq, dk, dv written
    # once (bf16) against the formulas' 10·G·N²·d FLOP on the tensor cores;
    # the kernels issue 14·G·N²·d on the tiles' padded rows (the dq pass's
    # 64-query tiles against 128 or 256 keys, the dk/dv pass's 128-key
    # blocks against 64-query tiles).
    def b4_bf16_issued(g, n, d):
        pad = lambda m: -(-n // m) * m
        return g * d * (6 * pad(64) * (128 if n <= 128 else 256) + 8 * pad(128) * pad(64))

    attn_bwd_bf16 = {}
    for heads in (HEADS, HEADS4):
        hd = EMBED // heads
        qkv = randn(groups, FRAMES, 3, heads, hd).bfloat16()
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        do = randn(groups, FRAMES, heads, hd).bfloat16().transpose(1, 2)
        g_all, elems = groups * heads, groups * heads * FRAMES * hd
        with torch.no_grad():
            run = lambda: grand_attention_bwd(q, k, v, do)
            plain = lambda: grand_attention_bwd_ref(q, k, v, do)
            before = grand_attention_bwd.launches_bf16
            outs = run()
            check(grand_attention_bwd.launches_bf16 - before == 2,
                  "B4 at bf16 did not launch its two wgmma kernels")
            errs = [check_bf16(f"B4 bf16 d={hd} {name}", a, b)
                    for name, a, b in zip(("dq", "dk", "dv"), outs, plain())]
            check(all(torch.equal(a, b) for a, b in zip(outs, run())),
                  f"B4 bf16 d={hd}: two calls gave different bits")
            fwd_stats = _bwd_stats_bf16(q)
            fwd_out = _fullseq(q, k, v, None, fwd_stats)
            train_form = lambda: _bwd(q, k, v, do, None, (fwd_stats,))
            before = grand_attention_bwd.launches_bf16
            check(all(torch.equal(a, b) for a, b in zip(outs, train_form())),
                  f"B4 bf16 d={hd}: the call from B3's statistics gave other bits than alone")
            check(grand_attention_bwd.launches_bf16 - before == 2,
                  "B4 at bf16 from B3's statistics did not launch its two wgmma kernels")
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(qg, kg, vg) - vg
        lib = lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do, retain_graph=True)
        t = timings(run, plain, lib, 10 * g_all * FRAMES * FRAMES * hd, 7 * 2 * elems, peak_bf16)
        t["train_ms"] = cuda_ms(train_form)
        issued = b4_bf16_issued(g_all, FRAMES, hd)
        attn_bwd_bf16[heads] = dict(abs_err=max(e[0] for e in errs), g=g_all, d=hd, **t)
        say(f"phase 6c grand_attention_bwd bf16: [B*H={g_all}, N={FRAMES}, D={hd}] as qkv views "
            f"max_abs_err={max(e[0] for e in errs):.3e} max_rel_err={max(e[1] for e in errs):.3e} "
            f"(tol {BF16_MAX_TOL}) mean_rel_err={max(e[2] for e in errs):.3e} (tol "
            f"{BF16_MEAN_TOL}) same bits in two calls and from B3's statistics; "
            f"ms={t['ms']:.4f} (alone) train_ms={t['train_ms']:.4f} (from B3's statistics) "
            f"library_ms={t['lib_ms']:.4f} (SDPA backward) plain_ms={t['plain_ms']:.4f} "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) GFLOP={t['flops'] / 1e9:.2f} "
            f"(formulas) achieved_TFLOPs={t['flops'] / t['ms'] / 1e9:.2f} / "
            f"{t['flops'] / t['train_ms'] / 1e9:.2f}; issued GFLOP={issued / 1e9:.2f} "
            f"issued_TFLOPs={issued / t['ms'] / 1e9:.2f} / {issued / t['train_ms'] / 1e9:.2f} "
            f"(alone / from B3's statistics)")
        del lib_out, qg, kg, vg, qkv, q, k, v, do, outs, fwd_stats, fwd_out
        torch.cuda.empty_cache()

    # Phase 7: the train main path.
    model = MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED, depth=DEPTH,
                           num_heads=HEADS, mlp_ratio=MLP_RATIO, seed=0, device=dev).train()
    params = list(model.parameters())
    dkw = dict(timesteps=TIMESTEPS, sampling_timesteps=DDIM_STEPS, clip_denoised=True,
               clip_loss=True, beta_schedule="cosine")
    diff_fast = GaussianDiffusion.create(
        make_fast_train_denoise_fn(model, DROP_PATH, attn_bwd=True), **dkw)
    diff_plain = GaussianDiffusion.create(make_train_denoise_fn(model, DROP_PATH), **dkw)
    counters = (fused_transformer_block, grand_attention_fullseq, grand_attention_bwd,
                packed_grand_attention)
    # Per step: 16 block calls x 8 kernels; in the recompute B3 once and B4
    # (2 kernels) once for each temporal block (n = 243 > 64), and B6 once
    # for each spatial block (n = 17; its backward is the plain formulas).
    per_step = {"fused_transformer_block": 2 * DEPTH * per_call,
                "grand_attention_fullseq": DEPTH, "grand_attention_bwd": 2 * DEPTH,
                "packed_grand_attention": DEPTH}

    def batch(b):
        gt = randn(b, FRAMES, JOINTS, 3, scale=0.3)
        x2d = torch.rand(b, FRAMES, JOINTS, 2, generator=gen, device=dev) * 2 - 1
        return gt, x2d

    # (a) B=4: kernel path against the plain module on the same dp, t, noise;
    # at 8 heads and, on a second seed-0 model, at 4 heads (head_dim 128).
    def train_check(fast, plain, ps, label):
        gt, x2d = batch(CHECK_BATCH)
        inject = dict(t=torch.randint(0, TIMESTEPS, (CHECK_BATCH,), generator=gen, device=dev),
                      noise=randn(CHECK_BATCH, FRAMES, JOINTS, 3),
                      dp_scales=draw_drop_path_scales(gen, CHECK_BATCH, DEPTH, DROP_PATH, FRAMES,
                                                      JOINTS))
        for c in counters:
            c.launches = 0
        loss_fast = fast.training_loss(gt, x2d, **inject)
        grads_fast = torch.autograd.grad(loss_fast, ps)
        torch.cuda.synchronize()
        got = {c.__name__: c.launches for c in counters}
        loss_plain = plain.training_loss(gt, x2d, **inject)
        grads_plain = torch.autograd.grad(loss_plain, ps)
        loss_rel = abs(loss_fast.item() - loss_plain.item()) / abs(loss_plain.item())
        grad_rel = max(((a - b).abs().max() / b.abs().max()).item()
                       for a, b in zip(grads_fast, grads_plain))
        check(got == per_step, f"train check {label} launched {got}, expected {per_step}")
        check(loss_rel <= LOSS_REL_TOL, f"train {label} loss rel err {loss_rel:.3e} > "
              f"{LOSS_REL_TOL}")
        check(grad_rel <= GRAD_REL_TOL, f"train {label} grad rel err {grad_rel:.3e} > "
              f"{GRAD_REL_TOL}")
        say(f"phase 7a train check {label} B={CHECK_BATCH}: loss={loss_fast.item():.6f} "
            f"plain_loss={loss_plain.item():.6f} loss_rel_err={loss_rel:.3e} (tol {LOSS_REL_TOL}) "
            f"max_param_grad_rel_err={grad_rel:.3e} (tol {GRAD_REL_TOL}, over {len(ps)} "
            f"parameters) launches={got}")
        torch.cuda.empty_cache()
        return got

    train_check(diff_fast, diff_plain, params, f"heads {HEADS}")
    model4 = MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED, depth=DEPTH,
                            num_heads=HEADS4, mlp_ratio=MLP_RATIO, seed=0, device=dev).train()
    train_check(
        GaussianDiffusion.create(make_fast_train_denoise_fn(model4, DROP_PATH, attn_bwd=True),
                                 **dkw),
        GaussianDiffusion.create(make_train_denoise_fn(model4, DROP_PATH), **dkw),
        list(model4.parameters()), f"heads {HEADS4} (head_dim {EMBED // HEADS4})")
    del model4

    # (b) B=24: the train step as a user calls it, t/noise/dp drawn from gen.
    optimizer, scheduler = make_optimizer(params, LR, LR_DECAY, steps_per_epoch=1000)
    train_step = make_train_step(diff_fast, optimizer, scheduler)
    gt, x2d = batch(TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    zero_inner()
    train_step(gt, x2d, generator=gen)  # warm-up
    torch.cuda.synchronize()
    train_launches = {c.__name__: c.launches for c in counters}
    inner_by_path["train_step"] = inner()
    check(train_launches == per_step, f"train step launched {train_launches}, expected {per_step}")
    before = [p.detach().clone() for p in params]
    secs, losses = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(train_step(gt, x2d, generator=gen).item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(params, before))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(v) for v in losses), f"train losses {losses}")
    check(moved > 0, "no parameter moved")
    step_s = statistics.median(secs)
    step_flops = train_step_flops(TRAIN_BATCH, hidden)
    say(f"phase 7b train step B={TRAIN_BATCH}: step_s={[round(s, 4) for s in secs]} "
        f"median_step_s={step_s:.4f} samples_per_s={TRAIN_BATCH / step_s:.3f} "
        f"TFLOP_per_step={step_flops / 1e12:.3f} f32_bound_s={step_flops / peak_flops:.4f} "
        f"bound_share={step_flops / peak_flops / step_s:.3f} losses={losses} "
        f"max_param_change={moved:.3e} max_memory_allocated_GB={peak_gb:.3f} "
        f"launches_per_step={train_launches}")
    del before

    # (c) where one train step's device time goes.
    profile_step("phase 7c profile of one train step", lambda: train_step(gt, x2d, generator=gen),
                 top_n=20)

    # Phase 7h (printed after 7c): the f32 fast-train step at the session
    # precision "default" (Config.matmul_precision), the call a config that
    # sets it makes at float32: the recompute's attention runs B3 and B6 on
    # the tensor-core mode kernel and B4 under "default" (q, k, v rounded by
    # one kernel and dO by another, then the bf16 B4's two tensor-core
    # passes with f32 outputs). (a) B=4 on one draw (hold_train_default).
    # (b) B=24: a warm-up and 3 timed steps, samples/s beside 7b's, the
    # launches of one step, and B4's share of one step's device time.
    prec_d = dict(matmul_precision="default")
    diff_d = GaussianDiffusion.create(
        make_fast_train_denoise_fn(model, DROP_PATH, attn_bwd=True, **prec_d), **dkw)
    per_step_d = dict(per_step, grand_attention_bwd=4 * DEPTH)  # + the two roundings a call
    hold_train_default(card, model, dkw, diff_d, diff_plain, params, batch(CHECK_BATCH), gen,
                       randn, counters, per_step_d)
    opt_d, sched_d = make_optimizer(params, LR, LR_DECAY, steps_per_epoch=1000)
    step_d = make_train_step(diff_d, opt_d, sched_d)
    for c in counters:
        c.launches = 0
    step_d(gt, x2d, generator=gen)  # warm-up
    torch.cuda.synchronize()
    train_default_launches = {c.__name__: c.launches for c in counters}
    check(train_default_launches == per_step_d, f"phase 7h train step launched "
          f"{train_default_launches}, expected {per_step_d}")
    secs_d, losses_d = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        losses_d.append(step_d(gt, x2d, generator=gen).item())
        torch.cuda.synchronize()
        secs_d.append(time.perf_counter() - t0)
    check(all(math.isfinite(v) for v in losses_d), f"phase 7h train losses {losses_d}")
    step_d_s = statistics.median(secs_d)
    say(f"phase 7h train step at matmul_precision 'default' B={TRAIN_BATCH} ({card}): step_s="
        f"{[round(v, 4) for v in secs_d]} median_step_s={step_d_s:.4f} samples_per_s="
        f"{TRAIN_BATCH / step_d_s:.3f} (f32 'highest' step of phase 7b: {TRAIN_BATCH / step_s:.3f})"
        f" losses={losses_d} launches_per_step={train_default_launches}")
    prof_d = profile_step("phase 7h profile of one train step at 'default'",
                          lambda: step_d(gt, x2d, generator=gen), top_n=20)
    b4_ms = sum(ms for k, ms in prof_d.items()
                if "grand_attn_bwd_" in k or "round_heads_kernel" in k)
    check(any("grand_attn_bwd_dq_wgmma_kernel" in k for k in prof_d)
          and not any("grand_attn_bwd_dq_kernel" in k for k in prof_d),
          "phase 7h: the step at default ran no tensor-core B4, or the CUDA-core one")
    say(f"phase 7h B4 at 'default' (rounding kernels and both passes): {b4_ms:.3f} ms of "
        f"{sum(prof_d.values()):.3f} ms device busy, share {b4_ms / sum(prof_d.values()):.4f}")
    del step_d, opt_d, sched_d, diff_d, prof_d

    del train_step, optimizer, scheduler, diff_fast, diff_plain, model, params, gt, x2d
    torch.cuda.empty_cache()

    # Phase 7d: bf16 training at full width and batch 24 (the compute_dtype
    # of configs/h36m_gt_s2s_243f_tpu.json, ROADMAP A.5): the fast-train
    # AdamW step with the fused forward and the pair recompute at bf16, the
    # parameters float32, with 8 heads and with 4 (head_dim 128), attn_bwd
    # off and on; 3 timed steps after a warm-up, peak memory and the
    # launches of one step. With attn_bwd a step runs B1 at bf16 (16 calls),
    # and in the recompute B3 and B4 (2 kernels) at bf16 for each temporal
    # block and B6 at bf16 for each spatial block; without it B1 only.
    def bf16_counts():
        got = {c.__name__: c.launches for c in counters}
        got.update(fused_transformer_block_bf16=fused_transformer_block.launches_bf16,
                   grand_attention_bwd_bf16=grand_attention_bwd.launches_bf16,
                   packed_grand_attention_bf16=packed_grand_attention.launches_bf16)
        return got

    def zero_counts():
        for c in counters:
            c.launches = 0
        fused_transformer_block.launches_bf16 = grand_attention_bwd.launches_bf16 = 0
        packed_grand_attention.launches_bf16 = 0

    b1_step = 2 * DEPTH * per_call
    per_step_bf16 = {
        False: dict(fused_transformer_block=b1_step, grand_attention_fullseq=0,
                    grand_attention_bwd=0, packed_grand_attention=0,
                    fused_transformer_block_bf16=b1_step, grand_attention_bwd_bf16=0,
                    packed_grand_attention_bf16=0),
        True: dict(fused_transformer_block=b1_step, grand_attention_fullseq=DEPTH,
                   grand_attention_bwd=2 * DEPTH, packed_grand_attention=DEPTH,
                   fused_transformer_block_bf16=b1_step, grand_attention_bwd_bf16=2 * DEPTH,
                   packed_grand_attention_bf16=DEPTH),
    }
    train_bf16 = {}
    for heads in (HEADS, HEADS4):
        for attn_bwd in (False, True):
            model = MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED,
                                   depth=DEPTH, num_heads=heads, mlp_ratio=MLP_RATIO, seed=0,
                                   device=dev).train()
            diff16 = GaussianDiffusion.create(make_fast_train_denoise_fn(
                model, DROP_PATH, attn_bwd=attn_bwd, dtype=torch.bfloat16), **dkw)
            optimizer, scheduler = make_optimizer(model.parameters(), LR, LR_DECAY, 1000)
            step16 = make_train_step(diff16, optimizer, scheduler)
            gt, x2d = batch(TRAIN_BATCH)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            step16(gt, x2d, generator=gen)  # warm-up
            torch.cuda.synchronize()
            got = bf16_counts()
            check(got == per_step_bf16[attn_bwd], f"bf16 train step heads={heads} "
                  f"attn_bwd={attn_bwd} launched {got}, expected {per_step_bf16[attn_bwd]}")
            secs, losses = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                losses.append(step16(gt, x2d, generator=gen).item())
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            check(all(math.isfinite(v) for v in losses), f"bf16 train losses {losses}")
            label = f"heads {heads}, attn_bwd {attn_bwd}"
            r = train_bf16[label] = dict(
                step_s=statistics.median(secs), secs=secs, losses=losses, launches=got,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            say(f"phase 7d bf16 train step B={TRAIN_BATCH} {label} (head_dim {EMBED // heads}): "
                f"step_s={[round(v, 4) for v in secs]} median_step_s={r['step_s']:.4f} "
                f"samples_per_s={TRAIN_BATCH / r['step_s']:.3f} (f32 step of phase 7b: "
                f"{TRAIN_BATCH / step_s:.3f}) losses={losses} max_memory_allocated_GB="
                f"{r['peak_gb']:.3f} launches_per_step={ {k: v for k, v in got.items() if v} }")
            if heads == HEADS4 and attn_bwd:
                # Phase 7g: where one bf16 step (the TPU config's geometry) goes.
                profile_step(f"phase 7g profile of one bf16 train step ({label})",
                             lambda: step16(gt, x2d, generator=gen), top_n=20)
            del model, diff16, optimizer, scheduler, step16
            torch.cuda.empty_cache()

    # Phase 7e: the drift of bf16 training from f32 (the port's copy of JAX's
    # tests/test_fast_train.py::test_bf16_training_drift_bounded at full
    # width): 20 AdamW steps of the fast-train path (4 heads, attn_bwd,
    # drop-path 0, lr 4e-5) from one seed-0 init on 20 fixed batches of 24,
    # t and noise from one seed in both runs. JAX's bounds: 5% per step, 3%
    # at the end.
    drift_batches = [batch(TRAIN_BATCH) for _ in range(20)]

    def drift_run(dtype):
        model = MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED, depth=DEPTH,
                               num_heads=HEADS4, mlp_ratio=MLP_RATIO, seed=0, device=dev).train()
        diffusion = GaussianDiffusion.create(make_fast_train_denoise_fn(
            model, 0.0, attn_bwd=True, dtype=dtype), **dkw)
        optimizer, scheduler = make_optimizer(model.parameters(), LR, LR_DECAY, 1000)
        step = make_train_step(diffusion, optimizer, scheduler)
        g = torch.Generator(device=dev).manual_seed(7)
        losses = torch.stack([step(a, b, generator=g) for a, b in drift_batches]).tolist()
        del model, diffusion, optimizer, scheduler, step
        torch.cuda.empty_cache()
        return losses

    l32, l16 = drift_run(torch.float32), drift_run(torch.bfloat16)
    drift = [abs(a - b) / abs(a) for a, b in zip(l32, l16)]
    drift_end = abs(l32[-1] - l16[-1]) / abs(l32[-1])
    check(all(math.isfinite(v) for v in l32 + l16), f"drift losses {l32} {l16}")
    check(max(drift) < 0.05 and drift_end < 0.03, f"bf16 drift from f32: max per step "
          f"{max(drift):.4f} (bound 0.05), at the end {drift_end:.4f} (bound 0.03)")
    say(f"phase 7e bf16 vs f32 drift, 20 steps B={TRAIN_BATCH} heads={HEADS4}: max per step "
        f"{max(drift):.5f} (bound 0.05), at the end {drift_end:.5f} (bound 0.03); f32 losses "
        f"{[round(v, 6) for v in l32]}; bf16 {[round(v, 6) for v in l16]}")
    del drift_batches

    # Phase 7f: the monolithic backward (fast_train_pair_vjp=False) at bf16
    # for one step at B = 8, against the pair backward on the same t, noise
    # and drop-path (the two recompute from other bf16 boundaries, so they
    # differ by bf16 rounding: bar 5e-2 of max|g| per parameter); and the
    # bf16 module with remat_blocks for one step at B = 4, against the same
    # module without it (the recompute runs the same kernels: bar 1e-6).
    def model4(**kw):
        return MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED, depth=DEPTH,
                              num_heads=HEADS4, mlp_ratio=MLP_RATIO, seed=0, device=dev,
                              **kw).train()

    def grads_of(denoise_fn, params, inject, label):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gt, x2d = inject["data"]
        diffusion = GaussianDiffusion.create(denoise_fn, **dkw)
        loss = diffusion.training_loss(gt, x2d, **{k: v for k, v in inject.items() if k != "data"})
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        check(math.isfinite(loss.item()) and all(torch.isfinite(g).all().item() for g in grads),
              f"{label}: loss or gradients not finite")
        return loss.item(), grads, torch.cuda.max_memory_allocated() / 1e9

    def draws(b):
        return dict(data=batch(b),
                    t=torch.randint(0, TIMESTEPS, (b,), generator=gen, device=dev),
                    noise=randn(b, FRAMES, JOINTS, 3),
                    dp_scales=draw_drop_path_scales(gen, b, DEPTH, DROP_PATH, FRAMES, JOINTS))

    def max_rel(a, b):
        return max(((x - y).abs().max() / y.abs().max()).item() for x, y in zip(a, b))

    model = model4()
    inject = draws(8)
    zero_counts()
    mono = grads_of(make_fast_train_denoise_fn(model, DROP_PATH, attn_bwd=True,
                                               dtype=torch.bfloat16, pair_vjp=False),
                    list(model.parameters()), inject, "monolithic bf16")
    mono_launches = bf16_counts()
    pairs = grads_of(make_fast_train_denoise_fn(model, DROP_PATH, attn_bwd=True,
                                                dtype=torch.bfloat16),
                     list(model.parameters()), inject, "pairs bf16")
    mono_rel = max_rel(mono[1], pairs[1])
    check(mono_rel <= 5e-2, f"monolithic vs pair backward at bf16: {mono_rel:.3e} > 5e-2")
    check(mono_launches == per_step_bf16[True],
          f"monolithic step launched {mono_launches}, expected {per_step_bf16[True]}")
    say(f"phase 7f monolithic backward bf16 B=8 heads={HEADS4}: loss={mono[0]:.6f} (pairs "
        f"{pairs[0]:.6f}) max_param_grad_rel_dev_from_pairs={mono_rel:.3e} (bar 5e-2) "
        f"max_memory_allocated_GB={mono[2]:.3f} (pairs {pairs[2]:.3f}) launches="
        f"{ {k: v for k, v in mono_launches.items() if v} }")
    del model, mono, pairs
    inject = draws(CHECK_BATCH)
    plain_model, remat_model = model4(dtype=torch.bfloat16), model4(dtype=torch.bfloat16,
                                                                    remat_blocks=True)
    plain16 = grads_of(make_train_denoise_fn(plain_model, DROP_PATH),
                       list(plain_model.parameters()), inject, "bf16 module")
    remat16 = grads_of(make_train_denoise_fn(remat_model, DROP_PATH),
                       list(remat_model.parameters()), inject, "bf16 module with remat_blocks")
    remat_rel = max_rel(remat16[1], plain16[1])
    check(remat_rel <= 1e-6, f"remat_blocks changed the gradients by {remat_rel:.3e}")
    say(f"phase 7f bf16 module with remat_blocks B={CHECK_BATCH} heads={HEADS4}: loss="
        f"{remat16[0]:.6f} (without {plain16[0]:.6f}) max_param_grad_rel_dev={remat_rel:.3e} "
        f"(bar 1e-6) max_memory_allocated_GB={remat16[2]:.3f} (without {plain16[2]:.3f})")
    del plain_model, remat_model, plain16, remat16, inject
    torch.cuda.empty_cache()

    # Phase 8: B6 against its plain version at the use_pallas eval path's
    # shape, 4·243 joint groups x 8 heads of n = 17: as views of one
    # [972, 17, 3, 8, 64] qkv projection (what the module hands over) and
    # as contiguous [7776, 17, 64] operands; then at n = 64, at an odd n, and
    # with 4 heads of head_dim 128 ([3888, 17, 128] as qkv views); then at
    # bf16 (B3's tensor-core kernel) at [7776, 17, 64] and [3888, 17, 128] as
    # qkv views. The library yardstick is SDPA - v. The kernel, the plain
    # version and the library are all timed by the profiler's device time:
    # the kernel runs for less than a call through Python takes on the host.
    # Bound: q, k, v read and the output written once at the memory rate.
    # Then B6 at bf16 as an op (its only path; the use_pallas module is
    # float32): the dispatcher on each bf16 input, counts set to 0 before.
    small, small_bf16 = {}, {}
    with torch.no_grad():
        bf16_inputs = []
        for label, b, h, n, strided, dt in (
                ("qkv_views", 2 * BATCH * FRAMES, HEADS, JOINTS, True, torch.float32),
                ("contiguous", 2 * BATCH * FRAMES * HEADS, 1, JOINTS, False, torch.float32),
                ("n64", 243, HEADS, 64, True, torch.float32),
                ("n27", 101, HEADS, 27, True, torch.float32),
                ("d128", 2 * BATCH * FRAMES, HEADS4, JOINTS, True, torch.float32),
                ("qkv_views", 2 * BATCH * FRAMES, HEADS, JOINTS, True, torch.bfloat16),
                ("d128", 2 * BATCH * FRAMES, HEADS4, JOINTS, True, torch.bfloat16)):
            hd = EMBED // (HEADS4 if label == "d128" else HEADS)
            if strided:
                q, k, v = randn(b, n, 3, h, hd).to(dt).permute(2, 0, 3, 1, 4)
            else:
                q, k, v = (randn(b, n, hd).to(dt) for _ in range(3))
            run = lambda: packed_grand_attention(q, k, v)
            plain = lambda: packed_grand_attention_ref(q, k, v)
            lib = lambda: F.scaled_dot_product_attention(q, k, v) - v
            out, ref = run(), plain()
            torch.cuda.synchronize()
            check(out.shape == q.shape and out.dtype == dt
                  and torch.isfinite(out.float()).all().item(),
                  f"B6 {label} {dt} output shape, dtype or values")
            pairs = b * h
            if dt == torch.float32:
                abs_err, _ = rel_err(out, ref)
                lib_abs, _ = rel_err(lib(), ref)
                check(abs_err <= SMALL_ATTN_ABS_TOL,
                      f"B6 {label} abs err {abs_err:.3e} > {SMALL_ATTN_ABS_TOL}")
                check(torch.equal(out, run()), f"B6 {label}: two calls gave different bits")
                errs = f"max_abs_err={abs_err:.3e} (tol {SMALL_ATTN_ABS_TOL}) same bits twice"
                results, peak = small, peak_flops
            else:
                abs_err, rel, mean_rel = check_bf16(f"B6 bf16 {label}", out, ref)
                lib_abs, _, _ = bf16_errs(lib(), ref)
                errs = (f"max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} (tol {BF16_MAX_TOL}) "
                        f"mean_rel_err={mean_rel:.3e} (tol {BF16_MEAN_TOL})")
                results, peak = small_bf16, peak_bf16
                bf16_inputs.append((q, k, v))
            t = timings(run, plain, lib, 4 * pairs * n * n * hd, 4 * dt.itemsize * pairs * n * hd,
                        peak, device_ms)
            results[label] = dict(abs_err=abs_err, **t)
            say(f"phase 8 packed_grand_attention {'f32' if dt == torch.float32 else 'bf16'} "
                f"{label}: [G={pairs}, N={n}, D={hd}] {errs} device ms={t['ms']:.4f} "
                f"plain_ms={t['plain_ms']:.4f} library_ms={t['lib_ms']:.4f} (SDPA - v; vs plain "
                f"max_abs {lib_abs:.3e}) bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) "
                f"bound_share={t['bound_ms'] / t['ms']:.3f} "
                f"GB_per_s={t['bytes'] / t['ms'] / 1e6:.1f} (of {mem_rate / 1e9:.0f})")
            del out, ref
        packed_grand_attention.launches = packed_grand_attention.launches_bf16 = 0
        for q, k, v in bf16_inputs:
            check(torch.isfinite(fused_grand_attention(q, k, v).float()).all().item(),
                  "B6 bf16 op output not finite")
        torch.cuda.synchronize()
        b6_bf16_launches = (packed_grand_attention.launches, packed_grand_attention.launches_bf16)
        check(b6_bf16_launches == (len(bf16_inputs),) * 2,
              f"B6 bf16 op launched {b6_bf16_launches}, expected {(len(bf16_inputs),) * 2}")
        say(f"phase 8 packed_grand_attention bf16 as an op (fused_grand_attention): "
            f"{len(bf16_inputs)} calls, launches={b6_bf16_launches[0]} "
            f"(bf16 {b6_bf16_launches[1]})")
        del bf16_inputs, q, k, v
    torch.cuda.empty_cache()

    # Phase 9: B5 against its plain version at both eval shapes (R rows in
    # groups of 17 joints and of 243 frames), at f32 and at bf16 (weights
    # made bf16 once, as a bf16 snapshot holds them). The library yardstick
    # is F.layer_norm / F.linear / SDPA - v / F.linear in the same dtype.
    attn_block = {"f32": {}, "bf16": {}, "bf16_d128": {}}
    with torch.no_grad():
        block, _ = make_block(3)
        block4, _ = make_block(5, HEADS4)
        block_bf, block4_bf = copy.deepcopy(block), copy.deepcopy(block4)
        for m in (block_bf.attn.qkv, block_bf.attn.proj, block4_bf.attn.qkv, block4_bf.attn.proj):
            m.weight.data = m.weight.data.bfloat16()
        block_lib_bf = copy.deepcopy(block).bfloat16()
        block4_lib_bf = copy.deepcopy(block4).bfloat16()
        drive = []
        for shape, n in (("spatial", JOINTS), ("temporal", FRAMES)):
            for name, dt, blk, lib_blk, peak, heads in (
                    ("f32", torch.float32, block, block, peak_flops, HEADS),
                    ("bf16", torch.bfloat16, block_bf, block_lib_bf, peak_bf16, HEADS),
                    ("bf16_d128", torch.bfloat16, block4_bf, block4_lib_bf, peak_bf16, HEADS4)):
                x = randn(rows, EMBED).to(dt)
                run = lambda: fused_attention_block(x, blk, n, heads)
                plain = lambda: fused_attention_block_ref(x, blk, n, heads)
                lib = lambda: library_attn_block(x, lib_blk, n, heads)
                out, ref = run(), plain()
                torch.cuda.synchronize()
                if dt == torch.float32:
                    abs_err, rel = rel_err(out, ref)
                    check(torch.isfinite(out).all().item(), f"B5 f32 {shape} output not finite")
                    check(rel <= KERNEL_REL_TOL and abs_err <= ATTN_BLOCK_ABS_TOL,
                          f"B5 f32 {shape} abs err {abs_err:.3e} (tol {ATTN_BLOCK_ABS_TOL}), "
                          f"rel {rel:.3e} (tol {KERNEL_REL_TOL})")
                    errs = (f"max_abs_err={abs_err:.3e} (tol {ATTN_BLOCK_ABS_TOL}) "
                            f"rel_err={rel:.3e} (tol {KERNEL_REL_TOL})")
                else:
                    abs_err, rel, mean_rel = check_bf16(f"B5 {name} {shape}", out, ref)
                    errs = (f"max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} (tol {BF16_MAX_TOL}) "
                            f"mean_rel_err={mean_rel:.3e} (tol {BF16_MEAN_TOL})")
                lib_abs = (lib().float() - ref.float()).abs().max().item()
                t = timings(run, plain, lib, *attn_block_work(rows, n, EMBED, dt.itemsize), peak)
                attn_block[name][shape] = dict(abs_err=abs_err, **t)
                say(f"phase 9 fused_attention_block {name} {shape}: R={rows} n={n} C={EMBED} "
                    f"heads={heads} {errs} "
                    f"ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms={t['lib_ms']:.4f} "
                    f"(library vs plain max_abs {lib_abs:.3e}) bound_ms={t['bound_ms']:.4f} "
                    f"({t['bound_by']}) GFLOP={t['flops'] / 1e9:.2f} "
                    f"achieved_TFLOPs={t['flops'] / t['ms'] / 1e9:.2f}")
                drive.append((x, blk, n, heads))
                del out, ref
        # B5 has no caller in the model: its path is the op itself. One call
        # per shape, dtype and head width with the counts set to 0 just
        # before: 6 calls x 4 kernels, 4 of the calls bf16.
        fused_attention_block.launches = fused_attention_block.launches_bf16 = 0
        zero_inner()
        for x, blk, n, heads in drive:
            check(torch.isfinite(fused_attention_block(x, blk, n, heads).float()).all().item(),
                  "B5 op output not finite")
        torch.cuda.synchronize()
        b5_launches = (fused_attention_block.launches, fused_attention_block.launches_bf16)
        inner_by_path["b5_op"] = inner()
        check(b5_launches == (24, 16), f"B5 op launched {b5_launches}, expected (24, 16)")
        say(f"phase 9 fused_attention_block as an op: {len(drive)} calls, "
            f"launches={b5_launches[0]} (bf16 {b5_launches[1]})")
        del drive, x, block, block_bf, block_lib_bf, block4, block4_bf, block4_lib_bf
    torch.cuda.empty_cache()

    # Phase 9b: B1, B2 and B6 at the group sizes of the 3DHP and HumanEva
    # paths (phases 14 and 15).
    group_sizes = check_group_sizes(make_block, timings, check_bf16, randn, peak_flops, peak_bf16)

    # Phase 24: head widths other than 64 and 128 on the serving path (B1,
    # B2, B5, B3, B6 at head_dim 32 and 96; the CLI at --num-heads 16).
    head_width_launches, head_width_inner, head_widths = drive_head_widths(
        dev, card, (peak_flops, peak_bf16, mem_rate), per_call)

    # Phase 10: the evaluate entry point, as a user calls it: a config JSON,
    # --synthetic data (subject S9, action Walking: 4 cameras x 972 frames =
    # 16 windows of 243 frames), a seed-0 state dict in a reference .bin,
    # DDIM-9, flip-TTA, batch 2 (8 timed eval steps after one warm-up step).
    # Configurations: the plain module; the module with
    # "use_pallas_attention" in the config JSON (B6 and B3); --fast-eval at
    # f32 (B1); the mixed mode (B1 bf16 and f32, rows); and pure bf16, the
    # yardstick of the mixed mode's bar as in phase 4b. Every run draws x_T
    # from a generator seeded with the config's seed, so their predictions
    # are comparable.
    kernel_counters = (fused_transformer_block, fused_temporal_block_cols, grand_attention_fullseq,
                       grand_attention_bwd, packed_grand_attention, fused_attention_block)
    records, plain_calls = [], [0]
    evaluate, plain_attention = Runner.evaluate, mixste.grand_attention

    def recording_evaluate(self, test_ds, *args, **kwargs):
        m = evaluate(self, test_ds, *args, **kwargs)
        records.append(dict(m, scale=test_ds.scale))
        return m

    def counting_attention(*args, **kwargs):
        plain_calls[0] += 1
        return plain_attention(*args, **kwargs)

    here = os.path.dirname(os.path.abspath(__file__))
    report_lines = ("----Walking----", "eval_frame:", "inference_speed:", "Protocol #1 Error (MPJPE):",
                    "Protocol #2 Error (P-MPJPE):", "Protocol #3 Error (N-MPJPE):",
                    "Velocity Error (MPJVE):", "Protocol #1   (MPJPE) action-wise average:")
    bf16_args = ["--fast-eval", "--compute-dtype", "bfloat16"]
    cli = {}
    ddim_steps = dict.fromkeys(("plain", "use_pallas", "fast_eval", "mixed", "bf16"), DDIM_STEPS)
    with open(os.path.join(here, TPU_CONFIG)) as f:
        tpu = json.load(f)
    ddim_steps.update(dict.fromkeys(("tpu_config", "tpu_plain", "tpu_bf16"),
                                    tpu["params"]["sampling_timesteps"]))
    with tempfile.TemporaryDirectory() as tmp:
        weights, weights4 = os.path.join(tmp, "seed0.bin"), os.path.join(tmp, "seed0_heads4.bin")
        for path, heads in ((weights, HEADS), (weights4, HEADS4)):
            torch.save(MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED,
                                      depth=DEPTH, num_heads=heads, mlp_ratio=MLP_RATIO, seed=0,
                                      device=dev).state_dict(), path)
        with open(os.path.join(here, CLI_CONFIG)) as f:
            config = json.load(f)
        config["params"]["use_pallas_attention"] = True
        use_pallas_config = os.path.join(tmp, "use_pallas.json")
        with open(use_pallas_config, "w") as f:
            json.dump(config, f)
        # The TPU config's yardsticks: the same file as the plain f32 module,
        # and as pure bf16 (no f32 head, no f32 final step).
        tpu_paths = {}
        for name, changes in (("tpu_plain", dict(fast_eval=False, compute_dtype="float32")),
                              ("tpu_bf16", dict(eval_f32_final_steps=0, eval_f32_head=False))):
            tpu_paths[name] = os.path.join(tmp, f"{name}.json")
            with open(tpu_paths[name], "w") as f:
                json.dump({**tpu, "params": {**tpu["params"], **changes}}, f)
        Runner.evaluate, mixste.grand_attention = recording_evaluate, counting_attention
        try:
            ddim = ["--sampling_timesteps", str(DDIM_STEPS)]
            for name, config_path, extra in (
                ("plain", os.path.join(here, CLI_CONFIG), ddim),
                ("use_pallas", use_pallas_config, ddim),
                ("fast_eval", os.path.join(here, CLI_CONFIG), ddim + ["--fast-eval"]),
                ("mixed", os.path.join(here, CLI_CONFIG),
                 ddim + bf16_args + ["--eval-f32-head", "--eval-f32-final-steps", "1"]),
                ("bf16", os.path.join(here, CLI_CONFIG), ddim + bf16_args),
                # The TPU-recommended config file as it stands (4 heads, the
                # mixed mode, remat, its own DDIM steps), on 4-head weights,
                # then as the plain module and as pure bf16 on the same.
                ("tpu_config", os.path.join(here, TPU_CONFIG), []),
                ("tpu_plain", tpu_paths["tpu_plain"], []),
                ("tpu_bf16", tpu_paths["tpu_bf16"], []),
            ):
                records.clear()
                plain_calls[0] = 0
                for c in kernel_counters:
                    c.launches = 0
                    if hasattr(c, "launches_bf16"):
                        c.launches_bf16 = 0
                zero_inner()
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    errors = cli_main(
                        ["--config", config_path, "--synthetic", "-str", "S1", "-ste", "S9",
                         "-a", "Walking", "--batch-size-eval", str(BATCH),
                         "-c", os.path.join(tmp, name),
                         "--evaluate", weights4 if name.startswith("tpu") else weights] + extra)
                torch.cuda.synchronize()
                inner_by_path[f"cli_{name}"] = inner()
                say(f"phase 10 cli {name}: the report\n{text.getvalue().rstrip()}")
                check(all(line in text.getvalue() for line in report_lines),
                      f"cli {name}: a line of the report is missing")
                check(all(len(v) == 1 and math.isfinite(v[0]) for v in errors.values()),
                      f"cli {name}: errors {errors}")
                check(len(records) == 1 and records[0]["n_frames"] == 16 * FRAMES,
                      f"cli {name}: evaluated {[r['n_frames'] for r in records]} frames")
                rec = records[0]
                got = {c.__name__: c.launches for c in kernel_counters}
                got["fused_transformer_block_bf16"] = fused_transformer_block.launches_bf16
                got["plain_attention_calls"] = plain_calls[0]
                cli[name] = dict(
                    pred=torch.from_numpy(rec["predictions"] / rec["scale"]), launches=got,
                    errors={k: v[0] for k, v in errors.items()},
                    frames_per_s=rec["n_frames"] / rec["model_time"],
                    seq_per_s=rec["n_frames"] / rec["model_time"] / FRAMES)
        finally:
            Runner.evaluate, mixste.grand_attention = evaluate, plain_attention
    steps = 16 // BATCH + 1  # the timed eval steps and the warm-up step
    zero = {c.__name__: 0 for c in kernel_counters}
    zero.update(fused_transformer_block_bf16=0, plain_attention_calls=0)
    forwards = {name: steps * k for name, k in ddim_steps.items()}
    b1 = {name: 2 * DEPTH * per_call * f for name, f in forwards.items()}
    for name in ("mixed", "tpu_config"):  # the final steps at "high3"
        b1[name] = mixed_b1(forwards[name], ddim_steps[name])[0]
    mixed_bf16 = lambda name: mixed_b1(forwards[name], ddim_steps[name])[1]
    want = {
        "plain": dict(zero, plain_attention_calls=2 * DEPTH * forwards["plain"]),
        "use_pallas": dict(zero, packed_grand_attention=DEPTH * forwards["use_pallas"],
                           grand_attention_fullseq=DEPTH * forwards["use_pallas"]),
        "fast_eval": dict(zero, fused_transformer_block=b1["fast_eval"]),
        "mixed": dict(zero, fused_transformer_block=b1["mixed"],
                      fused_transformer_block_bf16=mixed_bf16("mixed")),
        "bf16": dict(zero, fused_transformer_block=b1["bf16"],
                     fused_transformer_block_bf16=b1["bf16"]),
        "tpu_config": dict(zero, fused_transformer_block=b1["tpu_config"],
                           fused_transformer_block_bf16=mixed_bf16("tpu_config")),
        "tpu_plain": dict(zero, plain_attention_calls=2 * DEPTH * forwards["tpu_plain"]),
        "tpu_bf16": dict(zero, fused_transformer_block=b1["tpu_bf16"],
                         fused_transformer_block_bf16=b1["tpu_bf16"]),
    }
    for name, c in cli.items():
        check(c["launches"] == want[name], f"cli {name} launched {c['launches']}, expected "
              f"{want[name]}")
        # Each run is held against the plain run on its weights (the TPU
        # config's runs have 4 heads).
        vs_plain = ""
        ref = "tpu_plain" if name.startswith("tpu") else "plain"
        if name != ref:
            c["dev"] = (c["pred"] - cli[ref]["pred"]).abs().max().item()
            c["mpjpe"] = mpjpe(c["pred"], cli[ref]["pred"])
            vs_plain = (f" vs the cli {ref} run (normalised units): max_abs_dev={c['dev']:.3e} "
                        f"mpjpe={c['mpjpe']:.4e}")
        check(torch.isfinite(c["pred"]).all().item(), f"cli {name}: predictions not finite")
        say(f"phase 10 cli {name} B={BATCH} (x2 flip) DDIM-{ddim_steps[name]}, {steps - 1} timed "
            f"steps: inference_speed_frames_per_s={c['frames_per_s']:.1f} "
            f"seq_per_s={c['seq_per_s']:.3f} e1_mm={c['errors']['e1']:.4f} "
            f"e2_mm={c['errors']['e2']:.4f} e3_mm={c['errors']['e3']:.4f} "
            f"ev_mm={c['errors']['ev']:.4f}{vs_plain} "
            f"launches={ {k: v for k, v in c['launches'].items() if v} }")
    for name in ("use_pallas", "fast_eval"):
        check(cli[name]["dev"] <= EVAL_ABS_BOUND, f"cli {name} deviates from the plain run by "
              f"{cli[name]['dev']:.3e} > {EVAL_ABS_BOUND}")
    for mixed_run, bf16_run in (("mixed", "bf16"), ("tpu_config", "tpu_bf16")):
        check(cli[mixed_run]["mpjpe"] <= cli[bf16_run]["mpjpe"], f"cli {mixed_run} mpjpe "
              f"{cli[mixed_run]['mpjpe']:.4e} > the {bf16_run} run's "
              f"{cli[bf16_run]['mpjpe']:.4e}")
    cli_launches = {f"cli_{name}": c["launches"] for name, c in cli.items()}
    cli_launches.update(head_width_launches)
    inner_by_path.update(head_width_inner)

    # Phase 10b: where one eval step of the use_pallas module goes.
    model = MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED, depth=DEPTH,
                           num_heads=HEADS, mlp_ratio=MLP_RATIO, use_pallas=True, seed=0,
                           device=dev).eval()
    step = make_eval_step(
        GaussianDiffusion.create(make_denoise_fn(model), timesteps=TIMESTEPS,
                                 sampling_timesteps=DDIM_STEPS, clip_denoised=True,
                                 beta_schedule="cosine"), JOINTS_LEFT, JOINTS_RIGHT, device=dev)
    pose_2d = torch.rand(BATCH, FRAMES, JOINTS, 2, generator=gen, device=dev) * 2 - 1
    pose_2d_flip = flip_pose(pose_2d, JOINTS_LEFT, JOINTS_RIGHT)
    step(pose_2d, pose_2d_flip, generator=gen)  # warm-up
    profile_step("phase 10b profile of one use_pallas eval step",
                 lambda: step(pose_2d, pose_2d_flip, generator=gen))
    del model, step

    # Phase 11: the training entry point, as a user calls it: cli.run.main
    # without --evaluate on a copy of CLI_CONFIG with fast_train,
    # fast_train_attn_bwd and fast_eval, a checkpoint every epoch, on
    # --synthetic data (train S1 and S5, validation on their val split, test
    # S9, every action), 2 epochs at the config's batch and DDIM steps,
    # validation batch 8, at full width. Then the same command resumed from
    # epoch_0 (copied into a fresh directory), and --evaluate best_epoch
    # alone. Inside the train loop the sync debug mode of torch.cuda warns
    # of any call that makes the host wait for the card.
    fits, fit, sync_warnings = [], Runner.fit, []

    def watched_batches(batches):
        def gen(*args, **kwargs):
            for b in batches(*args, **kwargs):
                torch.cuda.set_sync_debug_mode("warn")  # the step's body: upload + train step
                try:
                    yield b
                finally:
                    torch.cuda.set_sync_debug_mode(0)   # the next batch's assembly is host work
        return gen

    def recording_fit(self, train_ds, val_ds, *args, **kwargs):
        train_ds.batches = watched_batches(train_ds.batches)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            result = fit(self, train_ds, val_ds, *args, **kwargs)
        sync_warnings.extend(str(w.message) for w in caught
                             if "called a synchronizing CUDA operation" in str(w.message))
        del train_ds.batches
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in train_ds.batches(self.cfg.batch_size, shuffle=True,
                                                    drop_last=True))
        fits.append(dict(result, n_train=len(train_ds), n_val=len(val_ds), batches=n_batches,
                         host_batch_s=time.perf_counter() - t0, cfg=self.cfg, runner=self,
                         val_ds=val_ds))
        return result

    with open(os.path.join(here, CLI_CONFIG)) as f:
        config = json.load(f)
    config["params"].update(fast_train=True, fast_train_attn_bwd=True, fast_eval=True)
    train_cli = {}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train_config = os.path.join(tmp, "train.json")
        with open(train_config, "w") as f:
            json.dump(config, f)
        # --checkpoint-frequency: the flag's default (40) overrides the JSON.
        common = ["--config", train_config, "--synthetic", "-str", "S1,S5", "-ste", "S9", "-a", "*",
                  "--batch-size-eval", "8", "--checkpoint-frequency", "1"]
        run_dir, resume_dir = os.path.join(tmp, "run"), os.path.join(tmp, "resumed")
        Runner.evaluate, Runner.fit = recording_evaluate, recording_fit
        mixste.grand_attention = counting_attention
        try:
            for name, argv in (
                ("train", common + ["-e", "2", "-c", run_dir]),
                ("train_resume", common + ["-e", "2", "-c", resume_dir, "--resume", "epoch_0"]),
                ("train_evaluate", common + ["-c", run_dir, "--evaluate", "best_epoch"]),
            ):
                if name == "train_resume":
                    shutil.copytree(os.path.join(run_dir, "epoch_0"),
                                    os.path.join(resume_dir, "epoch_0"))
                records.clear()
                plain_calls[0] = 0
                for c in kernel_counters:
                    c.launches = 0
                    if hasattr(c, "launches_bf16"):
                        c.launches_bf16 = 0
                zero_inner()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                text = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(text):
                    errors = cli_main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                inner_by_path[f"cli_{name}"] = inner()
                got = {c.__name__: c.launches for c in kernel_counters}
                got["fused_transformer_block_bf16"] = fused_transformer_block.launches_bf16
                got["plain_attention_calls"] = plain_calls[0]
                out = text.getvalue()
                say(f"phase 11 cli {name}: the log and report\n{out.rstrip()}")
                check(all(v and all(math.isfinite(e) for e in v) for v in errors.values()),
                      f"cli {name}: errors {errors}")
                train_cli[name] = dict(errors={k: [float(e) for e in v] for k, v in errors.items()},
                                       launches=got,
                                       wall_s=wall, out=out,
                                       peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                                       evals=[r["n_frames"] for r in records])
                if name == "train":
                    ckpt = os.path.join(run_dir, "epoch_0")
                    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f))
                                     for f in os.listdir(ckpt))
                    saved = sorted(d for d in os.listdir(run_dir) if os.path.isdir(
                        os.path.join(run_dir, d)))
                    check({"epoch_0", "epoch_1", "best_epoch"} <= set(saved),
                          f"cli train saved {saved}")
        finally:
            Runner.evaluate, Runner.fit, mixste.grand_attention = evaluate, fit, plain_attention
            torch.cuda.set_sync_debug_mode(0)
    check(len(fits) == 2, f"fit ran {len(fits)} times")
    run, resumed = fits
    for line in ("Epoch: 0, Time(mins):", "Epoch: 1, Time(mins):", "Train/_pose_loss:",
                 "Valid/_mpjpe_mm:", "Valid/_pose_loss:", "Saved checkpoint to",
                 "save best checkpoint", "Training finished! Total time:",
                 "Loaded the best model from", "Protocol #1   (MPJPE) action-wise average:"):
        check(line in train_cli["train"]["out"], f"cli train: no line {line!r}")
    check("Resumed from" in train_cli["train_resume"]["out"], "cli train_resume did not resume")
    losses = run["losses_train"] + run["losses_valid"] + resumed["losses_train"]
    check(len(run["losses_train"]) == 2 and len(resumed["losses_train"]) == 1
          and all(math.isfinite(v) for v in losses), f"cli train losses {losses}")
    resume_rel = abs(resumed["losses_train"][0] - run["losses_train"][1]) / abs(
        run["losses_train"][1])
    check(resume_rel <= LOSS_REL_TOL, f"resumed epoch-1 train loss {resumed['losses_train'][0]} "
          f"vs {run['losses_train'][1]}: rel {resume_rel:.3e} > {LOSS_REL_TOL}")
    report_dev = max(abs(a - b) for k in ("e1", "e2", "e3", "ev") for a, b in zip(
        train_cli["train_evaluate"]["errors"][k], train_cli["train"]["errors"][k], strict=True))
    check(report_dev <= EVAL_REPORT_TOL_MM, f"--evaluate best_epoch deviates from the fit run's "
          f"report by {report_dev:.3e} mm > {EVAL_REPORT_TOL_MM}")
    check(not sync_warnings, f"the train loop made the host wait for the card "
          f"{len(sync_warnings)} times: {sync_warnings[:3]}")

    # The launches each run must show (want_fit).
    ddim, b_eval = config["params"]["sampling_timesteps"], 8
    fwd_b1 = 2 * DEPTH * per_call
    val_batches = -(-run["n_val"] // b_eval)

    def want_train(f, epochs, evals):
        return want_fit(zero, per_step, fwd_b1, ddim, b_eval, f["batches"], f["n_val"], epochs,
                        evals)

    want = {"train": want_train(run, 2, train_cli["train"]["evals"]),
            "train_resume": want_train(resumed, 1, train_cli["train_resume"]["evals"]),
            "train_evaluate": want_train(run, 0, train_cli["train_evaluate"]["evals"])}
    for name, c in train_cli.items():
        check(c["launches"] == want[name], f"cli {name} launched {c['launches']}, expected "
              f"{want[name]}")
        cli_launches[f"cli_{name}"] = c["launches"]
    epoch_launches = {k: v // 2 for k, v in want_train(run, 2, []).items() if v}
    for e, (loss, secs) in enumerate(zip(run["losses_train"], run["seconds"])):
        say(f"phase 11 cli train epoch {e}: train_loss={loss:.8f} "
            f"val_mpjpe_mm={run['losses_valid'][e] * 1000:.4f} train_s={secs['train']:.3f} "
            f"validate_s={secs['validate']:.3f} checkpoint_write_s={secs['save']:.3f} "
            f"samples_per_s={run['batches'] * run['cfg'].batch_size / secs['train']:.3f}")
    train_s = statistics.median(s["train"] for s in run["seconds"] + resumed["seconds"])
    say(f"phase 11 cli train at full width (embed {EMBED}, depth {DEPTH}, {FRAMES} frames, "
        f"batch {run['cfg'].batch_size}, DDIM-{ddim}): {run['n_train']} train windows "
        f"({run['batches']} steps an epoch), {run['n_val']} val windows ({val_batches} batches "
        f"of {b_eval}); samples_per_s through fit (median of 3 epochs)="
        f"{run['batches'] * run['cfg'].batch_size / train_s:.3f} beside phase 7b's "
        f"{TRAIN_BATCH / step_s:.3f}; host batch assembly {run['host_batch_s']:.3f} s an epoch "
        f"({run['host_batch_s'] / train_s:.3f} of the train seconds); validate_s="
        f"{[round(s['validate'], 3) for s in run['seconds']]}; checkpoint {ckpt_bytes / 1e6:.1f} "
        f"MB a directory, written in {[round(s['save'], 3) for s in run['seconds']]} s an epoch "
        f"(epoch_n and best_epoch); resumed epoch-1 train loss {resumed['losses_train'][0]:.8f} "
        f"vs {run['losses_train'][1]:.8f} (rel {resume_rel:.3e}, bit for bit "
        f"{resumed['losses_train'][0] == run['losses_train'][1]}); --evaluate best_epoch vs the "
        f"fit run's report: max |d| {report_dev:.3e} mm over e1..ev of each action "
        f"{train_cli['train']['errors']}; max_memory_allocated_GB "
        f"{ {k: round(c['peak_gb'], 3) for k, c in train_cli.items()} }; wall_s "
        f"{ {k: round(c['wall_s'], 1) for k, c in train_cli.items()} }; syncs in the train loop "
        f"{len(sync_warnings)}; launches in one epoch's training {epoch_launches}; per run "
        f"{ {k: {n: v for n, v in c['launches'].items() if v} for k, c in train_cli.items()} }")

    # Phase 11b: where one validation batch's time goes: the flip-TTA DDIM
    # sampling through the fused forward, and the loss of both orientations
    # through the plain module, each timed alone, then the whole val step
    # profiled.
    runner, b = run["runner"], next(run["val_ds"].batches(b_eval))
    x2d, x2d_flip, gt = (torch.as_tensor(a, device=dev) for a in (b.input_2d, b.input_2d_flip,
                                                                   b.gt_3d_norm))
    gen11 = torch.Generator(device=dev).manual_seed(0)

    def val_loss():
        with torch.no_grad():
            return runner.diffusion.training_loss(gt, x2d, generator=gen11)

    parts = {"sampling": lambda: runner.eval_step(x2d, x2d_flip, generator=gen11),
             "loss_one_orientation": val_loss,
             "val_step": lambda: runner.val_step(gt, x2d, x2d_flip, generator=gen11)}
    part_s = {}
    for name, part in parts.items():
        part()  # warm
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            part()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        part_s[name] = statistics.median(secs)
    say(f"phase 11b one validation batch ({b_eval} windows x2 flip, DDIM-{ddim}), median of 3 "
        f"(s): {', '.join(f'{k}={v:.4f}' for k, v in part_s.items())}")
    profile_step("phase 11b profile of one validation batch", parts["val_step"], top_n=12)
    del runner, b, x2d, x2d_flip, gt, run, resumed
    torch.cuda.empty_cache()

    # Phase 11c: the training entry point on the TPU-recommended config:
    # cli.run.main without --evaluate on a copy of TPU_CONFIG (bf16
    # fast_train, remat, 4 heads of 128, the mixed fast eval, the session
    # matmul precision "default": the float32 products outside the fused
    # blocks, in the validation's and evaluation's f32 head and final step,
    # in one bf16 pass) with
    # fast_train_attn_bwd on, on phase 11's data, epochs and flags: 2 epochs
    # with a checkpoint each, the run resumed from a copy of epoch_0 (its
    # epoch-1 loss equal to the unbroken run's bit for bit), then --evaluate
    # best_epoch (its report equal to the fit run's).
    with open(os.path.join(here, TPU_CONFIG)) as f:
        tpu_config = json.load(f)
    tpu_config["params"].update(fast_train_attn_bwd=True)
    tpu_cli = {}
    fits.clear()
    syncs_before = len(sync_warnings)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train_config = os.path.join(tmp, "train_tpu.json")
        with open(train_config, "w") as f:
            json.dump(tpu_config, f)
        common = ["--config", train_config, "--synthetic", "-str", "S1,S5", "-ste", "S9", "-a", "*",
                  "--batch-size-eval", "8", "--checkpoint-frequency", "1"]
        run_dir, resume_dir = os.path.join(tmp, "run"), os.path.join(tmp, "resumed")
        Runner.evaluate, Runner.fit = recording_evaluate, recording_fit
        mixste.grand_attention = counting_attention
        try:
            for name, argv in (
                ("tpu_train", common + ["-e", "2", "-c", run_dir]),
                ("tpu_train_resume", common + ["-e", "2", "-c", resume_dir, "--resume", "epoch_0"]),
                ("tpu_train_evaluate", common + ["-c", run_dir, "--evaluate", "best_epoch"]),
            ):
                if name == "tpu_train_resume":
                    shutil.copytree(os.path.join(run_dir, "epoch_0"),
                                    os.path.join(resume_dir, "epoch_0"))
                records.clear()
                plain_calls[0] = 0
                for c in kernel_counters:
                    c.launches = 0
                    if hasattr(c, "launches_bf16"):
                        c.launches_bf16 = 0
                zero_inner()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                text = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(text):
                    errors = cli_main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                inner_by_path[f"cli_{name}"] = inner()
                got = {c.__name__: c.launches for c in kernel_counters}
                got.update(fused_transformer_block_bf16=fused_transformer_block.launches_bf16,
                           grand_attention_bwd_bf16=grand_attention_bwd.launches_bf16,
                           packed_grand_attention_bf16=packed_grand_attention.launches_bf16,
                           plain_attention_calls=plain_calls[0])
                out = text.getvalue()
                say(f"phase 11c cli {name}: the log and report\n{out.rstrip()}")
                check(all(v and all(math.isfinite(e) for e in v) for v in errors.values()),
                      f"cli {name}: errors {errors}")
                tpu_cli[name] = dict(errors={k: [float(e) for e in v] for k, v in errors.items()},
                                     launches=got, wall_s=wall, out=out,
                                     peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                                     evals=[r["n_frames"] for r in records])
        finally:
            Runner.evaluate, Runner.fit, mixste.grand_attention = evaluate, fit, plain_attention
            torch.cuda.set_sync_debug_mode(0)
    check(len(fits) == 2, f"fit ran {len(fits)} times on the TPU config")
    run_tpu, resumed_tpu = fits
    cfg_tpu = run_tpu["cfg"]
    check((cfg_tpu.compute_dtype, cfg_tpu.remat, cfg_tpu.num_heads, cfg_tpu.fast_train_attn_bwd,
           cfg_tpu.matmul_precision) == ("bfloat16", True, HEADS4, True, "default"),
          f"the TPU config ran as {cfg_tpu}")
    for line in ("Epoch: 1, Time(mins):", "Saved checkpoint to", "Loaded the best model from",
                 "Protocol #1   (MPJPE) action-wise average:"):
        check(line in tpu_cli["tpu_train"]["out"], f"cli tpu_train: no line {line!r}")
    check("Resumed from" in tpu_cli["tpu_train_resume"]["out"], "cli tpu_train_resume did not resume")
    check(resumed_tpu["losses_train"][0] == run_tpu["losses_train"][1],
          f"TPU config: resumed epoch-1 train loss {resumed_tpu['losses_train'][0]} vs "
          f"{run_tpu['losses_train'][1]}, not bit for bit")
    tpu_report_dev = max(abs(a - b) for k in ("e1", "e2", "e3", "ev") for a, b in zip(
        tpu_cli["tpu_train_evaluate"]["errors"][k], tpu_cli["tpu_train"]["errors"][k],
        strict=True))
    check(tpu_report_dev <= EVAL_REPORT_TOL_MM, f"TPU config: --evaluate best_epoch deviates "
          f"from the fit run's report by {tpu_report_dev:.3e} mm > {EVAL_REPORT_TOL_MM}")
    tpu_syncs = sync_warnings[syncs_before:]
    check(not tpu_syncs, f"the bf16 train loop made the host wait for the card "
          f"{len(tpu_syncs)} times: {tpu_syncs[:3]}")
    # The launches each run must show: per train step phase 7d's bf16 step
    # with attn_bwd; per validation and evaluate batch DDIM-steps fused
    # forwards, all but the last bf16, and per validation batch the loss's
    # two bf16 module forwards (plain attention).
    ddim_tpu = tpu_config["params"]["sampling_timesteps"]
    val_batches_tpu = -(-run_tpu["n_val"] // b_eval)

    def want_tpu(f, epochs, evals):
        steps = epochs * f["batches"]
        eval_batches = sum(-(-(n // FRAMES) // b_eval) + 1 for n in evals)
        batches_fwd = epochs * val_batches_tpu + eval_batches
        want = {c.__name__: 0 for c in kernel_counters}
        want.update({k: steps * v for k, v in per_step_bf16[True].items()})
        b1, b1_bf16 = mixed_b1(batches_fwd * ddim_tpu, ddim_tpu)
        want["fused_transformer_block"] += b1
        want["fused_transformer_block_bf16"] += b1_bf16
        want["plain_attention_calls"] = epochs * val_batches_tpu * 2 * 2 * DEPTH
        return want

    want = {"tpu_train": want_tpu(run_tpu, 2, tpu_cli["tpu_train"]["evals"]),
            "tpu_train_resume": want_tpu(resumed_tpu, 1, tpu_cli["tpu_train_resume"]["evals"]),
            "tpu_train_evaluate": want_tpu(run_tpu, 0, tpu_cli["tpu_train_evaluate"]["evals"])}
    for name, c in tpu_cli.items():
        check(c["launches"] == want[name], f"cli {name} launched {c['launches']}, expected "
              f"{want[name]}")
        cli_launches[f"cli_{name}"] = c["launches"]
    tpu_train_s = statistics.median(s["train"] for s in run_tpu["seconds"] + resumed_tpu["seconds"])
    tpu_step = train_bf16[f"heads {HEADS4}, attn_bwd True"]["step_s"]
    for e, (loss, secs) in enumerate(zip(run_tpu["losses_train"], run_tpu["seconds"])):
        say(f"phase 11c cli tpu_train epoch {e}: train_loss={loss:.8f} "
            f"val_mpjpe_mm={run_tpu['losses_valid'][e] * 1000:.4f} train_s={secs['train']:.3f} "
            f"validate_s={secs['validate']:.3f} checkpoint_write_s={secs['save']:.3f}")
    say(f"phase 11c cli train on {TPU_CONFIG} with fast_train_attn_bwd (bf16, remat, {HEADS4} "
        f"heads, batch {cfg_tpu.batch_size}, DDIM-{ddim_tpu} mixed validation, matmul_precision "
        f"{cfg_tpu.matmul_precision!r}): samples_per_s "
        f"through fit (median of 3 epochs)={run_tpu['batches'] * cfg_tpu.batch_size / tpu_train_s:.3f}"
        f" beside phase 7d's {TRAIN_BATCH / tpu_step:.3f}; validate_s="
        f"{[round(s['validate'], 3) for s in run_tpu['seconds']]}; resumed epoch-1 train loss "
        f"{resumed_tpu['losses_train'][0]:.8f} equal to the unbroken run's bit for bit; "
        f"--evaluate best_epoch vs the fit run's report: max |d| {tpu_report_dev:.3e} mm; "
        f"syncs in the train loop {len(tpu_syncs)}; "
        f"max_memory_allocated_GB { {k: round(c['peak_gb'], 3) for k, c in tpu_cli.items()} }; "
        f"wall_s { {k: round(c['wall_s'], 1) for k, c in tpu_cli.items()} }; per run "
        f"{ {k: {n: v for n, v in c['launches'].items() if v} for k, c in tpu_cli.items()} }")
    del run_tpu, resumed_tpu
    fits.clear()
    torch.cuda.empty_cache()

    # Phase 12: the port's bench, bench_torch.py, as a user runs it: a
    # subprocess (it supervises its own child) at the flagship protocol
    # (243 frames, DDIM-9, flip-TTA, batch 2, seed-0 weights) with
    # BENCH_ITERS=4, at mixed and at float32. Each prints one JSON line,
    # whose numbers must be finite and whose card must be this one; its
    # launches, counted by the wrappers in the bench's own process around
    # its 3 timed loops of 4 steps, must be those of 12 eval steps.
    bench_steps = 3 * 4
    for dtype in ("mixed", "float32"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(here, "bench_torch.py")], cwd=here,
                              env=dict(os.environ, BENCH_DTYPE=dtype, BENCH_ITERS="4"),
                              capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"bench_torch.py at {dtype} exited {proc.returncode}:\n"
              f"{proc.stderr[-3000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        d = line["detail"]
        numbers = [line["value"], d["frames_per_sec_per_chip"], d["achieved_tflops"], d["mfu"],
                   d["model_tflops_per_seq"], *d["seq_per_s_repeats"], *d["wall_s"]]
        check(all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0 for v in numbers),
              f"bench_torch.py at {dtype}: numbers {numbers}")
        check(d["card"] == kind and d["power_limit"] and d["device"] == "cuda"
              and d["dtype"] == dtype and d["out_shape"] == [BATCH, FRAMES, JOINTS, 3],
              f"bench_torch.py at {dtype}: {d}")
        b1 = bench_steps * DDIM_STEPS * 2 * DEPTH * per_call
        want = {"fused_transformer_block": b1}
        if dtype == "mixed":  # BENCH_FINAL_PREC=high3
            want = dict(zip(("fused_transformer_block", "fused_transformer_block_bf16"),
                            mixed_b1(bench_steps * DDIM_STEPS, DDIM_STEPS)))
        check(d["launches"] == want, f"bench_torch.py at {dtype} launched {d['launches']}, "
              f"expected {want}")
        cli_launches[f"bench_torch_{dtype}"] = {c.__name__: 0 for c in kernel_counters} | {
            "fused_transformer_block_bf16": 0, "plain_attention_calls": 0} | d["launches"]
        say(f"phase 12 bench_torch.py BENCH_DTYPE={dtype} BENCH_ITERS=4 "
            f"({time.perf_counter() - t0:.1f} s): {proc.stdout.strip().splitlines()[-1]}")

    # Phase 13: the accuracy study, scripts/accuracy_study_torch.py, at full
    # width (243 frames, embed 512, 8 heads) cut to depth 2, 1 action and 1
    # epoch, into a temporary STUDY_DIR: training through Runner.fit (bf16,
    # fast_train with the attention backward kernels, bf16 validation),
    # then the eight variants on the same weights and x_T. The
    # table must have the JAX study's layout, every variant finite, and
    # fast_f32 must pass the gate against plain_f32.
    sys.path.insert(0, os.path.join(here, "scripts"))
    import accuracy_study_torch as study

    reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            table = study.main({"STUDY_DIR": tmp, "STUDY_DEPTH": "2", "STUDY_ACTIONS": "1",
                                "STUDY_EPOCHS": "1"})
        torch.cuda.synchronize()
        study_files = sorted(os.listdir(tmp))
    study_s = time.perf_counter() - t0
    study_launches = read_launches()
    cli_launches["accuracy_study"] = dict(study_launches, plain_attention_calls=0)
    names = [v[0] for v in study.VARIANTS]
    check(set(table) == {"config", "results", "deltas_vs_plain_f32_mm", "gate",
                         "raw_prediction_deviation_vs_plain_f32", "jax_counterparts",
                         "f32_prec", "verdicts_beside_jax"} and list(table["results"]) == names
          and set(table["gate"]["paths"]) == {n for n in names if study.is_gated(n)} - {
              study.BASELINE}
          and {"fast_f32_mxdefault", "fast_mixed1_default"} <= set(table["verdicts_beside_jax"])
          and study_files == ["accuracy_study_torch.json", "study_ckpt_torch", "study_out_torch"],
          f"accuracy study: the table's layout {sorted(table)}, results {list(table['results'])},"
          f" files {study_files}")
    check(all(math.isfinite(v) for r in table["results"].values() for v in r.values()),
          f"accuracy study: results {table['results']}")
    check(table["config"]["card"] == kind and table["config"]["epochs_run"] == 1,
          f"accuracy study: config {table['config']}")
    check(table["gate"]["paths"]["fast_f32"]["passes"],
          f"accuracy study: fast_f32 fails the gate: {table['gate']['paths']['fast_f32']}")
    check(all(study_launches[k] > 0 for k in (
        "fused_transformer_block", "fused_transformer_block_bf16", "grand_attention_fullseq",
        "grand_attention_bwd_bf16", "packed_grand_attention", "packed_grand_attention_bf16")),
          f"accuracy study: a kernel of its paths was launched no time: {study_launches}")
    say(f"phase 13 accuracy study at embed {EMBED}, {HEADS} heads, {FRAMES} frames, depth 2, "
        f"1 action, 1 epoch ({study_s:.1f} s): windows {table['config']['windows']}; "
        f"best val MPJPE {table['config']['best_val_mpjpe_mm']:.3f} mm; results "
        f"{ {k: {m: round(v, 4) for m, v in r.items()} for k, r in table['results'].items()} }; "
        f"gate passes { {k: g['passes'] for k, g in table['gate']['paths'].items()} }; "
        f"beside JAX's (scripts/accuracy_study.json, 100 epochs at depth 8: another operating "
        f"point) { {k: (v['port'], v['jax']) for k, v in table['verdicts_beside_jax'].items()} }; "
        f"eval_s { {k: round(v, 2) for k, v in table['config']['eval_s'].items()} }; "
        f"launches { {k: v for k, v in study_launches.items() if v} }")
    del table
    torch.cuda.empty_cache()

    # Phases 14-16: the MPI-INF-3DHP entry point, HumanEva and custom footage.
    for launches, inner_counts in (drive_3dhp(dev, per_call), drive_humaneva_custom(dev, per_call)):
        cli_launches.update(launches)
        inner_by_path.update(inner_counts)

    # Phase 18: the serving export, restored in a fresh process; phase 19:
    # the visualisation's model work and the ancestral DDPM loop; phase 20:
    # data parallelism, nccl at world size 1 through torchrun, then two
    # gloo ranks on the card, with the profiler probed before, between and
    # after.
    for launches, inner_counts in (drive_export(dev, per_call, card),
                                   drive_viz(dev, per_call, card)):
        cli_launches.update(launches)
        inner_by_path.update(inner_counts)
    profiler_probe("before phase 20")
    launches, inner_counts = drive_parallel(dev, per_call, per_step, card)
    profiler_probe("after phase 20")
    cli_launches.update(launches)
    inner_by_path.update(inner_counts)
    # Phase 22: tensor parallelism, gloo ranks on the card.
    launches, inner_counts = drive_tensor_parallel(dev, per_call, card)
    profiler_probe("after phase 22")
    cli_launches.update(launches)
    inner_by_path.update(inner_counts)
    # Phase 23: the module's dropout and the attention scale.
    launches, inner_counts = drive_dropout_scale(dev, card)
    cli_launches.update(launches)
    inner_by_path.update(inner_counts)

    # One entry per kernel. B1's work is one spatial + one temporal call at
    # the eval shape, the pair each depth level of a forward runs (f32, and
    # under "bf16" the same at bf16); B2's one call at the eval shape; B3
    # and B4 are one call at the train shape; B5's is B1's pair of shapes;
    # B6's one call at the eval shape on qkv views. "launches" sums the
    # counts read after each driven path (launches_by_path).
    def pair_numbers(shapes, peak):
        tot = lambda key: sum(v[key] for v in shapes.values())
        flops, nbytes = tot("flops"), tot("bytes")
        return {"max_abs_err": max(v["abs_err"] for v in shapes.values()), "ms": tot("ms"),
                "plain_ms": tot("plain_ms"),
                "bound_ms": max(flops / peak, nbytes / mem_rate) * 1e3,
                "bound_by": "operations" if flops / peak >= nbytes / mem_rate else "bytes",
                "library_ms": tot("lib_ms")}

    def by_path(name, eval_step=0, train_step=0, mixed_key=None):
        return {"eval_step": eval_step, "train_step": train_step,
                **{k: v[mixed_key] if mixed_key else 0 for k, v in mixed_launches.items()},
                **{k: v[name] for k, v in cli_launches.items()}}

    b1_by_path = by_path("fused_transformer_block", eval_launches,
                         train_launches["fused_transformer_block"], "fused_transformer_block")
    b2_by_path = by_path("fused_temporal_block_cols", mixed_key="fused_temporal_block_cols")
    b1_bf16_by_path = {k: v["fused_transformer_block_bf16"]
                       for k, v in {**mixed_launches, **cli_launches}.items()}
    b2_bf16_by_path = {k: v.get("fused_temporal_block_cols_bf16", 0)
                       for k, v in {**mixed_launches, **cli_launches}.items()}
    by_kind = check_inner(inner_by_path, b1_by_path, b2_by_path, b1_bf16_by_path,
                          b2_bf16_by_path, b5_launches, per_call)
    gemm_f32_by_path, ln_by_path = by_kind["gemm_f32"], by_kind["layer_norm"]

    gemm_part = kernel_part(
        "gemm_nt_kernel", "diff3dhpe_torch/csrc/fused_block.cu",
        "diff3dhpe_tpu/ops/fused_block.py:147 (_dot_f32 inside the block kernel)",
        gemm_f32_by_path, sum_numbers(gemms_f32[rows]),
        f"the four products of an f32 block at M={rows} (launches: counted by the block "
        f"wrappers, 4 a B1 or B2 call at f32, 2 a B5 call)")
    gemm_part["products"] = [g for m_rows in gemms_f32 for g in gemms_f32[m_rows]]
    ln_part = kernel_part(
        "ln_rows_kernel", "diff3dhpe_torch/csrc/fused_block.cu",
        "diff3dhpe_tpu/ops/fused_block.py:175 (_layernorm_rows inside the block kernel)",
        ln_by_path, sum_numbers(layer_norms[:1]),
        f"one f32 call at R={rows}, C={EMBED}, input cold (launches: counted by the block "
        f"wrappers, 3 a B1 or B2 call, 1 a B5 call, f32 or bf16)")
    ln_part["calls"] = layer_norms

    f32_modes = mode_kernel_parts(mode_res, by_kind, rows, hidden)
    entries = [{
        "name": "fused_transformer_block",
        "route": "cuda",
        "source": "diff3dhpe_torch/csrc/fused_block.cu",
        "replaces": "diff3dhpe_tpu/ops/fused_block.py:231",
        "launches": sum(b1_by_path.values()),
        "launches_by_path": b1_by_path,
        "launches_bf16_by_path": b1_bf16_by_path,
        **pair_numbers(per_shape, peak_flops),
        "bf16": pair_numbers(per_shape_bf16, peak_bf16),
        "d128": dict(pair_numbers(per_shape_hd128, peak_flops),
                     work=f"the same pair of calls with {HEADS4} heads (head_dim 128), f32"),
        "bf16_d128": dict(pair_numbers(per_shape_bf16_hd128, peak_bf16),
                          work=f"the same pair of calls with {HEADS4} heads (head_dim 128), bf16"),
        "bf16_gemm": gemms,
        "group_sizes": {k: one_call(v) for k, v in group_sizes["B1"].items()},
        "gemm_f32": gemm_part,
        "layer_norm": ln_part,
        "f32_modes": f32_modes["B1"],
        "head_widths": dict(head_widths["B1"], work=HEAD_WIDTHS_WORK["pair"]),
        "work": f"one spatial (n={JOINTS}) + one temporal (n={FRAMES}) call, R={rows}, C={EMBED}",
    }, {
        "name": "fused_temporal_block_cols",
        "route": "cuda",
        "source": "diff3dhpe_torch/csrc/fused_block.cu",
        "replaces": "diff3dhpe_tpu/ops/fused_block.py:642",
        "launches": sum(b2_by_path.values()),
        "launches_by_path": b2_by_path,
        "launches_bf16_by_path": b2_bf16_by_path,
        **one_call(cols_res["f32"]),
        "bf16": one_call(cols_res["bf16"]),
        "bf16_d128": dict(one_call(cols_res["bf16_d128"]),
                          work=f"the same call with {HEADS4} heads (head_dim 128), bf16"),
        "group_sizes": {k: one_call(v) for k, v in group_sizes["B2"].items()},
        "f32_modes": f32_modes["B2"],
        "head_widths": dict(head_widths["B2"], work=HEAD_WIDTHS_WORK["B2"]),
        "work": f"one call, x=[{2 * BATCH}*{FRAMES}, {JOINTS}*{EMBED}] (n={FRAMES}), f32",
    }]
    for name, replaces in (("grand_attention_fullseq", "diff3dhpe_tpu/ops/attention.py:185"),
                           ("grand_attention_bwd", "diff3dhpe_tpu/ops/attention.py:303")):
        a = attn[name]
        paths = dict(by_path(name, train_step=train_launches[name]),
                     train_step_default=train_default_launches[name])
        entries.append({
            "name": name, "route": "cuda", "source": "diff3dhpe_torch/csrc/grand_attention.cu",
            "replaces": replaces, "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": a["abs_err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"], "library_ms": a["lib_ms"],
            **({"train_step_form_ms": a["train_ms"]} if "train_ms" in a else {}),
            "work": f"one call, [B*H={a['g']}, N={FRAMES}, D={a['d']}] f32",
            "d128": dict(one_call(attn_by_heads[HEADS4][name]),
                         work=f"one call, [B*H={attn_by_heads[HEADS4][name]['g']}, N={FRAMES}, "
                              f"D={EMBED // HEADS4}] f32"),
        })
    # B4's bf16 instance (csrc/grand_attn_bwd_bf16.cuh): its launches on the
    # bf16 train paths (phase 7d's steps, phase 11c's CLI runs).
    b4_bf16_by_path = {f"train_step_bf16 {label}": r["launches"]["grand_attention_bwd_bf16"]
                       for label, r in train_bf16.items()}
    b4_bf16_by_path.update({k: v.get("grand_attention_bwd_bf16", 0)
                            for k, v in cli_launches.items()})
    b4_bf16 = attn_bwd_bf16[HEADS]
    entries[-1]["bf16"] = dict(
        one_call(b4_bf16), train_step_form_ms=b4_bf16["train_ms"],
        launches=sum(b4_bf16_by_path.values()),
        launches_by_path=b4_bf16_by_path,
        source="diff3dhpe_torch/csrc/grand_attention.cu (grand_attn_bwd_bf16.cuh)",
        work=f"one call, [B*H={b4_bf16['g']}, N={FRAMES}, D={b4_bf16['d']}] bf16 qkv views",
        d128=dict(one_call(attn_bwd_bf16[HEADS4]),
                  train_step_form_ms=attn_bwd_bf16[HEADS4]["train_ms"],
                  work=f"one call, [B*H={attn_bwd_bf16[HEADS4]['g']}, N={FRAMES}, "
                       f"D={EMBED // HEADS4}] bf16 qkv views"))
    entries[2]["bf16"] = dict(
        pair_numbers(attn_bf16, peak_bf16),
        work=f"one call at [{2 * BATCH * JOINTS}, {HEADS}, {FRAMES}, {EMBED // HEADS}] + one at "
             f"[{2 * BATCH * FRAMES}, {HEADS}, {JOINTS}, {EMBED // HEADS}], bf16 qkv views")
    entries[2]["head_widths"] = dict(head_widths["B3"], work=HEAD_WIDTHS_WORK["B3"])
    entries[2]["bf16_d128"] = dict(
        pair_numbers(attn_bf16_hd128, peak_bf16),
        work=f"one call at [{2 * BATCH * JOINTS}, {HEADS4}, {FRAMES}, {EMBED // HEADS4}] + one at "
             f"[{2 * BATCH * FRAMES}, {HEADS4}, {JOINTS}, {EMBED // HEADS4}], bf16 qkv views")
    entries.append({
        "name": "fused_attention_block",
        "route": "cuda",
        "source": "diff3dhpe_torch/csrc/fused_block.cu",
        "replaces": "diff3dhpe_tpu/ops/fused_block.py:184",
        "launches": b5_launches[0],
        "launches_by_path": {**by_path("fused_attention_block"), "op": b5_launches[0]},
        "launches_bf16_by_path": {"op": b5_launches[1]},
        **pair_numbers(attn_block["f32"], peak_flops),
        "bf16": pair_numbers(attn_block["bf16"], peak_bf16),
        "bf16_d128": dict(pair_numbers(attn_block["bf16_d128"], peak_bf16),
                          work=f"the same pair of calls with {HEADS4} heads (head_dim 128), bf16"),
        "f32_modes": f32_modes["B5"],
        "head_widths": dict(head_widths["B5"], work=HEAD_WIDTHS_WORK["pair"]),
        "work": f"one call with n={JOINTS} + one with n={FRAMES}, R={rows}, C={EMBED}",
    })
    # The session matmul precision "default" (phase 21b): B3's, B4's and
    # B6's one-bf16-pass instances, held and timed there alone.
    for entry, key in ((entries[2], "B3"), (entries[3], "B4")):
        entry["session_default"] = dict(
            one_call(session_res[f"{key} d={EMBED // HEADS}"]),
            d128=one_call(session_res[f"{key} d={EMBED // HEADS4}"]),
            launches=train_default_launches[entry["name"]],
            work=f"one call at phase 6's shape, f32 at matmul_precision 'default' (phase 21b); "
                 f"launches: phase 7h's train step")
    entries[3]["session_default"].update(
        scratch_bytes=session_res[f"B4 d={EMBED // HEADS}"]["scratch_bytes"],
        scratch_bytes_before=session_res[f"B4 d={EMBED // HEADS}"]["scratch_bytes_before"])
    entries[2]["session_default"]["with_stats_ms"] = session_res[f"B3 d={EMBED // HEADS}"]["stats_ms"]
    paths = dict(by_path("packed_grand_attention",
                         train_step=train_launches["packed_grand_attention"]),
                 train_step_default=train_default_launches["packed_grand_attention"])
    b6_bf16_train = {f"train_step_bf16 {label}": r["launches"]["packed_grand_attention_bf16"]
                     for label, r in train_bf16.items()}
    b6_bf16_train.update({k: v["packed_grand_attention_bf16"] for k, v in cli_launches.items()
                          if "packed_grand_attention_bf16" in v})
    entries.append({
        "name": "packed_grand_attention",
        "route": "cuda",
        "source": "diff3dhpe_torch/csrc/grand_attention.cu",
        "replaces": "diff3dhpe_tpu/ops/attention.py:120",
        "launches": sum(paths.values()),
        "launches_by_path": paths,
        **one_call(small["qkv_views"]),
        "max_abs_err": max(v["abs_err"] for v in small.values()),
        "other_shapes": {k: one_call(v) for k, v in small.items() if k != "qkv_views"},
        "group_sizes": {k: one_call(v) for k, v in group_sizes["B6"].items()},
        "head_widths": dict(head_widths["B6"], work=HEAD_WIDTHS_WORK["B6"]),
        "work": f"one call, [G={2 * BATCH * FRAMES * HEADS}, N={JOINTS}, D={EMBED // HEADS}] "
                f"f32 as views of a qkv projection, device time",
        "session_default": dict(one_call(session_res["B6"]), work="one call at the eval shape, "
                                "f32 at matmul_precision 'default' (phase 21b)"),
        "bf16": dict(
            one_call(small_bf16["qkv_views"]),
            launches=b6_bf16_launches[1] + sum(b6_bf16_train.values()),
            launches_by_path={"op": b6_bf16_launches[1], **b6_bf16_train},
            max_abs_err=max(v["abs_err"] for v in small_bf16.values()),
            other_shapes={k: one_call(v) for k, v in small_bf16.items() if k != "qkv_views"},
            source="diff3dhpe_torch/csrc/grand_attention.cu (grand_attn_bf16.cuh)",
            work=f"one call, [G={2 * BATCH * FRAMES * HEADS}, N={JOINTS}, D={EMBED // HEADS}] "
                 f"bf16 as views of a qkv projection, device time"),
    })
    entries.append(f32_modes["attention"])
    check(len(entries) == 7 and all(e["launches"] > 0 for e in entries + [
              gemm_part, ln_part, *f32_modes["parts"]])
          and entries[5]["bf16"]["launches"] > 0 and entries[3]["bf16"]["launches"] > 0,
          f"a kernel was launched no time: { {e['name']: e['launches'] for e in entries} }, "
          f"f32 GEMM {gemm_part['launches']}, LN {ln_part['launches']}")
    say(f"seconds since the start at each phase's first line: {PHASE_SECONDS}; now "
        f"{time.perf_counter() - STARTED:.1f}")
    say(f"profiler: {len(PROFILER_FALLBACKS)} device_ms calls timed with CUDA events "
        f"instead (after profiler sessions {PROFILER_FALLBACKS}) of {PROFILES[0]} sessions")
    say(json.dumps({"kernels": entries}))
    check(all(math.isfinite(e["ms"]) for e in entries), "timing failed")
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
