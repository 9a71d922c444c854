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
         the same weights and x_T, gated against the plain f32 module.

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
bf16 step's profile; 8 B6 vs plain at the eval shape as qkv views and contiguous, at n
= 64, n = 27 and with 4 heads of head_dim 128, then at bf16 (views, 8 heads
and 4), all in device time, and B6 at bf16 as an op; 9 B5 vs plain at both eval
shapes, f32 and bf16 (also at head_dim 128), and its launches as an op; 10
the evaluate entry point in its configurations; 10b the profile of one
eval step of the use_pallas module; 11 the training entry point: each
epoch's loss, validation MPJPE and seconds, samples/s through fit, the
checkpoint's size and write seconds, peak memory, the launches of one
epoch, the resumed run and --evaluate best_epoch against the unbroken run,
and no host wait inside the train loop; 11c the same on the TPU config at
bf16; 12 bench_torch.py's JSON line at mixed and float32, with its launches;
13 the accuracy study's table, its gate and its launches); then a JSON line with every kernel's
numbers; the last line is {"ok": true, "device": {...}}. Exits non-zero
without a CUDA device, and where the port's package is not beside this
script.
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
                for m in re.finditer(r"L[ib](\d+)E|13__nv_bfloat16|I(f)", region):
                    args.append(m.group(1) or ("float" if m.group(2) else "bf16"))
            return f"{ident}<{','.join(args)}>"
        i = j + max(n, 1)
    return sym


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def say(*parts):
    print(*parts, flush=True)


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


def device_ms(fn, iters=20, tries=3):
    """Mean device time of fn() in ms: the sum of every kernel's own device
    time over `iters` calls, from the profiler. Unlike cuda_ms it leaves out
    the host's time between launches, which a short kernel called through
    Python does not hide. A profile that records no kernel is taken again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / iters
    check(False, "the profiler saw no device time")


def profile_step(label, fn, top_n=10):
    """Profiles one fn() and prints its wall time, device busy time, idle
    share and the device time of the top kernels by name. Returns the names
    of all kernels that ran."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_n]
    say(f"{label}: wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
        f"idle_share={1 - busy_ms / wall_ms:.4f}; by kernel: " + " | ".join(
            f"{e.key.replace('(anonymous namespace)::', '').split('(')[0][:60]} x{e.count} "
            f"{e.self_device_time_total / 1e3:.3f} ms "
            f"({e.self_device_time_total / 1e3 / busy_ms:.3f})" for e in top))
    return [e.key for e in kernels]


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
    say(smi.stdout.strip().splitlines()[0])
    peak_flops, peak_bf16, mem_rate = next(v for k, v in CARD_PEAKS.items() if k in kind)

    # Phase 1: build every kernel source from the checkout.
    t0 = time.perf_counter()
    reports = build_all()
    regs = [f"{name}.cu {entry}" for name, log in reports.items() for entry in ptxas_summary(log)]
    say(f"phase 1 build: {time.perf_counter() - t0:.3f} s for {list(SOURCES)}; "
        f"{len(reports)} built now; ptxas: {' | '.join(regs)}")

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
        for b in blocks:
            b.launches_gemm_f32 = b.launches_ln = 0

    def inner():
        return {"gemm_f32": sum(b.launches_gemm_f32 for b in blocks),
                "layer_norm": sum(b.launches_ln for b in blocks)}

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
    mixed_launches = {f"mixed_eval_{mode}": m["launches"] for mode, m in mixed.items()}
    mixed_launches["bf16_eval_rows"] = bf16_launches
    mixed_launches.update(mixed_launches_h4)
    del step_fast, step_plain, step_bf16, step, out, model, pred, pred_plain, pred_bf16, mixed
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
    mixed_bf16 = lambda name: b1[name] * (ddim_steps[name] - 1) // ddim_steps[name]
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

    # The launches each run must show: per train step B1's 2·DEPTH calls, B3
    # and B6 once and B4 (2 kernels) once per block pair in the recompute;
    # per validation batch and per evaluate batch (with each evaluate's
    # warm-up batch) DDIM-steps fused forwards of 2·DEPTH B1 calls, and the
    # validation loss's two plain-module forwards.
    ddim, b_eval = config["params"]["sampling_timesteps"], 8
    fwd_b1 = 2 * DEPTH * per_call
    val_batches = -(-run["n_val"] // b_eval)

    def want_train(f, epochs, evals):
        steps = epochs * f["batches"]
        eval_batches = sum(-(-(n // FRAMES) // b_eval) + 1 for n in evals)  # + warm-up
        forwards = ddim * (epochs * val_batches + eval_batches)
        return dict(zero, fused_transformer_block=steps * per_step["fused_transformer_block"]
                    + forwards * fwd_b1,
                    grand_attention_fullseq=steps * per_step["grand_attention_fullseq"],
                    grand_attention_bwd=steps * per_step["grand_attention_bwd"],
                    packed_grand_attention=steps * per_step["packed_grand_attention"],
                    plain_attention_calls=epochs * val_batches * 2 * 2 * DEPTH)

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
    # fast_train, remat, 4 heads of 128, the mixed fast eval) with
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
    check((cfg_tpu.compute_dtype, cfg_tpu.remat, cfg_tpu.num_heads, cfg_tpu.fast_train_attn_bwd)
          == ("bfloat16", True, HEADS4, True), f"the TPU config ran as {cfg_tpu}")
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
        want["fused_transformer_block"] += batches_fwd * ddim_tpu * fwd_b1
        want["fused_transformer_block_bf16"] += batches_fwd * (ddim_tpu - 1) * fwd_b1
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
        f"heads, batch {cfg_tpu.batch_size}, DDIM-{ddim_tpu} mixed validation): samples_per_s "
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
        if dtype == "mixed":
            want["fused_transformer_block_bf16"] = b1 * (DDIM_STEPS - 1) // DDIM_STEPS
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
                         "not_ported"} and list(table["results"]) == names
          and set(table["gate"]["paths"]) == {n for n in names if study.is_gated(n)} - {
              study.BASELINE}
          and len(table["not_ported"]) == len(study.NOT_PORTED)
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
        f"eval_s { {k: round(v, 2) for k, v in table['config']['eval_s'].items()} }; "
        f"launches { {k: v for k, v in study_launches.items() if v} }")
    del table
    torch.cuda.empty_cache()

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

    def one_call(r):
        return {"max_abs_err": r["abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["lib_ms"]}

    def by_path(name, eval_step=0, train_step=0, mixed_key=None):
        return {"eval_step": eval_step, "train_step": train_step,
                **{k: v[mixed_key] if mixed_key else 0 for k, v in mixed_launches.items()},
                **{k: v[name] for k, v in cli_launches.items()}}

    b1_by_path = by_path("fused_transformer_block", eval_launches,
                         train_launches["fused_transformer_block"], "fused_transformer_block")
    b2_by_path = by_path("fused_temporal_block_cols", mixed_key="fused_temporal_block_cols")
    b1_bf16_by_path = {k: v["fused_transformer_block_bf16"]
                       for k, v in {**mixed_launches, **cli_launches}.items()}
    b2_bf16_by_path = {k: v["fused_temporal_block_cols_bf16"] for k, v in mixed_launches.items()}
    # The f32 GEMM and LN launches the block wrappers counted on each path
    # (inner_by_path), held against the blocks' structure: a B1 or B2 call
    # of per_call kernels launches 3 LNs and 4 GEMMs, f32 ones in an f32
    # call; a B5 call 1 LN and 2 GEMMs.
    for path, got in inner_by_path.items():
        b12, b12_bf16 = (b1_by_path.get(path, 0) + b2_by_path.get(path, 0),
                         b1_bf16_by_path.get(path, 0) + b2_bf16_by_path.get(path, 0))
        b5, b5_bf16 = b5_launches if path == "b5_op" else (0, 0)
        want = {"gemm_f32": 4 * (b12 - b12_bf16) // per_call + 2 * (b5 - b5_bf16) // 4,
                "layer_norm": 3 * b12 // per_call + b5 // 4}
        check(got == want, f"{path}: the blocks launched {got} f32 GEMMs and LNs, expected "
              f"{want}")
    gemm_f32_by_path = {k: v["gemm_f32"] for k, v in inner_by_path.items()}
    ln_by_path = {k: v["layer_norm"] for k, v in inner_by_path.items()}

    def part(name, source, replaces, by_path_counts, numbers, work):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path_counts.values()), "launches_by_path": by_path_counts,
                **numbers, "work": work}

    def sum_numbers(items):
        tot = lambda key: sum(g[key] for g in items)
        return {"max_abs_err": max(g["max_abs_err"] for g in items), "ms": tot("ms"),
                "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
                "bound_by": "operations" if all(g["bound_by"] == "operations" for g in items)
                else "bytes", "library_ms": tot("library_ms")}

    gemm_part = part(
        "gemm_nt_kernel", "diff3dhpe_torch/csrc/fused_block.cu",
        "diff3dhpe_tpu/ops/fused_block.py:147 (_dot_f32 inside the block kernel)",
        gemm_f32_by_path, sum_numbers(gemms_f32[rows]),
        f"the four products of an f32 block at M={rows} (launches: counted by the block "
        f"wrappers, 4 a B1 or B2 call at f32, 2 a B5 call)")
    gemm_part["products"] = [g for m_rows in gemms_f32 for g in gemms_f32[m_rows]]
    ln_part = part(
        "ln_rows_kernel", "diff3dhpe_torch/csrc/fused_block.cu",
        "diff3dhpe_tpu/ops/fused_block.py:175 (_layernorm_rows inside the block kernel)",
        ln_by_path, sum_numbers(layer_norms[:1]),
        f"one f32 call at R={rows}, C={EMBED}, input cold (launches: counted by the block "
        f"wrappers, 3 a B1 or B2 call, 1 a B5 call, f32 or bf16)")
    ln_part["calls"] = layer_norms
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
        "gemm_f32": gemm_part,
        "layer_norm": ln_part,
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
        "work": f"one call, x=[{2 * BATCH}*{FRAMES}, {JOINTS}*{EMBED}] (n={FRAMES}), f32",
    }]
    for name, replaces in (("grand_attention_fullseq", "diff3dhpe_tpu/ops/attention.py:185"),
                           ("grand_attention_bwd", "diff3dhpe_tpu/ops/attention.py:303")):
        a = attn[name]
        paths = by_path(name, train_step=train_launches[name])
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
        "work": f"one call with n={JOINTS} + one with n={FRAMES}, R={rows}, C={EMBED}",
    })
    paths = by_path("packed_grand_attention",
                    train_step=train_launches["packed_grand_attention"])
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
        "work": f"one call, [G={2 * BATCH * FRAMES * HEADS}, N={JOINTS}, D={EMBED // HEADS}] "
                f"f32 as views of a qkv projection, device time",
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
    check(len(entries) == 6 and all(e["launches"] > 0 for e in entries + [gemm_part, ln_part])
          and entries[-1]["bf16"]["launches"] > 0 and entries[3]["bf16"]["launches"] > 0,
          f"a kernel was launched no time: { {e['name']: e['launches'] for e in entries} }, "
          f"f32 GEMM {gemm_part['launches']}, LN {ln_part['launches']}")
    say(json.dumps({"kernels": entries}))
    check(all(math.isfinite(e["ms"]) for e in entries), "timing failed")
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
