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
         pair-boundary backward with the attention kernels (attn_bwd);
  cli    the evaluate entry point, diff3dhpe_torch.cli.run.main([--config
         <json> --synthetic --evaluate <seed-0 state dict .bin> ...]), on
         configs/h36m_gt_s2s_243f.json at DDIM-9 with batch 2: the plain
         module, the module with "use_pallas_attention" (B6 for the joints,
         B3 for the frames), --fast-eval at f32, the mixed mode and pure
         bf16, each printing the per-action report.

Any failed check raises and the script exits non-zero.

Output: one line per phase (1 build; 2 B1 vs plain, with drop-path too,
at the eval and the train step's row counts; 2b B1 at bf16 vs plain; 2c
B2 vs plain at f32 (with drop-path also at the train step's rows) and
bf16; 3 full-width forward; 4 the f32 eval step; 5 its profile; 4b the
mixed eval step in rows and cols, and the pure-bf16 one; 5b the mixed rows
step's profile; 6 B3 and B4 vs plain at the train shape; 7a the train
step's loss, gradients and launches vs the plain module at B=4; 7b three
timed AdamW steps at B=24; 7c their profile; 8 B6 vs plain at the eval
shape as qkv views and contiguous, at n = 64 and n = 27; 9 B5 vs plain at
both eval shapes, f32 and bf16, and its launches as an op; 10 the evaluate
entry point in its configurations; 10b the profile of one eval step of
the use_pallas module); then a JSON line with every kernel's numbers; the last line is {"ok": true, "device": {...}}. Exits
non-zero without a CUDA device, and where the port's package is not
beside this script.
"""
import contextlib
import copy
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

FRAMES, JOINTS, EMBED, DEPTH, HEADS, MLP_RATIO = 243, 17, 512, 8, 8, 2.0
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
SMALL_ATTN_ABS_TOL = 1e-5  # B6 vs its plain version, absolute (outputs of order 1)
ATTN_BLOCK_ABS_TOL = 1e-5  # B5 at f32 vs its plain version, absolute, beside KERNEL_REL_TOL
CLI_CONFIG = "configs/h36m_gt_s2s_243f.json"
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


def profile_step(label, fn, top_n=10):
    """Profiles one fn() and prints its wall time, device busy time, idle
    share and the device time of the top kernels by name."""
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
        flip_pose, fused_attention_block, fused_attention_block_ref, fused_temporal_block_cols,
        fused_temporal_block_cols_ref, fused_transformer_block, fused_transformer_block_ref,
        grand_attention_bwd, grand_attention_bwd_ref, grand_attention_fullseq,
        grand_attention_fullseq_ref, make_denoise_fn, make_eval_step, make_fast_denoise_fn,
        make_fast_train_denoise_fn, make_mixed_diffusion, make_optimizer, make_train_denoise_fn,
        make_train_step, packed_grand_attention, packed_grand_attention_ref,
    )
    from diff3dhpe_torch.cli.run import main as cli_main
    from diff3dhpe_torch.models import mixste
    from diff3dhpe_torch.models.mixste import Block, init_weights
    from diff3dhpe_torch.ops._build import SOURCES, build_all

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
    regs = [ln.strip() for log in reports.values() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    say(f"phase 1 build: {time.perf_counter() - t0:.3f} s for {list(SOURCES)}; "
        f"{len(reports)} built now; ptxas: {' | '.join(regs)}")

    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device=dev) * scale
    rows = 2 * BATCH * FRAMES * JOINTS
    hidden = int(EMBED * MLP_RATIO)

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

    def timings(run, plain, lib, flops, nbytes, peak):
        ms, plain_ms, lib_ms = cuda_ms(run), cuda_ms(plain), cuda_ms(lib)
        by_ops = flops / peak >= nbytes / mem_rate
        return dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, flops=flops, bytes=nbytes,
                    bound_ms=max(flops / peak, nbytes / mem_rate) * 1e3,
                    bound_by="operations" if by_ops else "bytes")

    def make_block(seed):
        """A block and an out-LN with random weights and non-trivial LNs."""
        block = Block(EMBED, HEADS, MLP_RATIO, qkv_bias=True)
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
    # denoise_fn's snapshot holds them). The library yardstick is the same
    # block in bf16 from F.layer_norm/F.linear/SDPA.
    per_shape_bf16 = {}
    with torch.no_grad():
        for shape, n in (("spatial", JOINTS), ("temporal", FRAMES)):
            block, out_ln = make_block(1)
            block_bf = copy.deepcopy(block)
            for m in (block_bf.attn.qkv, block_bf.attn.proj, block_bf.mlp.fc1, block_bf.mlp.fc2):
                m.weight.data = m.weight.data.bfloat16()
            block_lib, out_ln_lib = copy.deepcopy(block).bfloat16(), copy.deepcopy(out_ln).bfloat16()
            x = randn(rows, EMBED).bfloat16()
            t_rows = randn(2 * BATCH, EMBED, scale=0.5).bfloat16()
            kw = dict(t_rows=t_rows, rows_per_item=rows // (2 * BATCH), out_ln=out_ln)
            run = lambda: fused_transformer_block(x, block_bf, n, HEADS, **kw)
            plain = lambda: fused_transformer_block_ref(x, block_bf, n, HEADS, **kw)
            lib = lambda: library_block(x, block_lib, n, HEADS, t_rows, rows // (2 * BATCH),
                                        out_ln_lib)
            abs_err, rel, mean_rel = check_bf16(f"{shape} bf16 kernel", run(), plain())
            lib_abs, _, _ = bf16_errs(lib(), plain())
            t = timings(run, plain, lib, *block_work(rows, n, EMBED, hidden, 2 * BATCH, 2),
                        peak_bf16)
            per_shape_bf16[shape] = dict(abs_err=abs_err, **t)
            say(f"phase 2b fused_transformer_block bf16 {shape}: R={rows} n={n} "
                f"max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} (tol {BF16_MAX_TOL}) "
                f"mean_rel_err={mean_rel:.3e} (tol {BF16_MEAN_TOL}) ms={t['ms']:.4f} "
                f"plain_ms={t['plain_ms']:.4f} library_ms={t['lib_ms']:.4f} "
                f"(library vs plain max_abs {lib_abs:.3e}) bound_ms={t['bound_ms']:.4f} "
                f"({t['bound_by']}) achieved_TFLOPs={t['flops'] / t['ms'] / 1e9:.2f}")
            del block, block_bf, block_lib, out_ln, out_ln_lib, x

    # Phase 2c: B2 against its plain version at the eval shape, x [B*F, J*C]
    # with per-sample time rows, the out-LN and per-group drop-path, at f32
    # and bf16; then at f32 at the train step's R = 24·243·17 rows.
    cols_res = {}
    with torch.no_grad():
        block, out_ln = make_block(2)
        items = 2 * BATCH
        for dt in (torch.float32, torch.bfloat16):
            blk, oln = block, out_ln
            if dt == torch.bfloat16:
                blk = copy.deepcopy(block)
                for m in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                    m.weight.data = m.weight.data.bfloat16()
            lib_blk, lib_oln = copy.deepcopy(block).to(dt), copy.deepcopy(out_ln).to(dt)
            x = randn(items * FRAMES, JOINTS * EMBED).to(dt)
            t_rows = randn(items, EMBED, scale=0.5).to(dt)
            dp = (torch.rand(items * JOINTS, 2, generator=gen, device=dev) < 0.9).float() / 0.9
            kw = dict(t_rows=t_rows, out_ln=oln)
            run = lambda: fused_temporal_block_cols(x, blk, FRAMES, JOINTS, HEADS, **kw)
            plain = lambda: fused_temporal_block_cols_ref(x, blk, FRAMES, JOINTS, HEADS, **kw)
            lib = lambda: library_cols(x, lib_blk, FRAMES, JOINTS, HEADS, t_rows, lib_oln)
            out, ref = run(), plain()
            out_dp = fused_temporal_block_cols(x, blk, FRAMES, JOINTS, HEADS, dp_scales=dp, **kw)
            ref_dp = fused_temporal_block_cols_ref(x, blk, FRAMES, JOINTS, HEADS, dp_scales=dp,
                                                   **kw)
            torch.cuda.synchronize()
            name = "f32" if dt == torch.float32 else "bf16"
            if dt == torch.float32:
                abs_err, rel = rel_err(out, ref)
                dp_abs, dp_rel = rel_err(out_dp, ref_dp)
                check(torch.isfinite(out).all().item(), "B2 f32 output not finite")
                check(max(rel, dp_rel) <= KERNEL_REL_TOL,
                      f"B2 f32 rel err {max(rel, dp_rel):.3e} > {KERNEL_REL_TOL}")
                errs = f"rel_err={rel:.3e} drop-path rel_err={dp_rel:.3e} (tol {KERNEL_REL_TOL})"
            else:
                abs_err, rel, mean_rel = check_bf16("B2 bf16", out, ref)
                dp_abs, dp_rel, dp_mean = check_bf16("B2 bf16 with drop-path", out_dp, ref_dp)
                errs = (f"max_rel_err={rel:.3e} mean_rel_err={mean_rel:.3e} drop-path "
                        f"max_rel_err={dp_rel:.3e} mean_rel_err={dp_mean:.3e} "
                        f"(tol {BF16_MAX_TOL}, {BF16_MEAN_TOL})")
            lib_abs = (lib().float() - ref.float()).abs().max().item()
            t = timings(run, plain, lib, *block_work(rows, FRAMES, EMBED, hidden, items,
                                                     dt.itemsize),
                        peak_flops if dt == torch.float32 else peak_bf16)
            cols_res[name] = dict(abs_err=max(abs_err, dp_abs), **t)
            say(f"phase 2c fused_temporal_block_cols {name}: x=[{items}*{FRAMES}, "
                f"{JOINTS}*{EMBED}] max_abs_err={max(abs_err, dp_abs):.3e} {errs} "
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
    pred = step_fast(x2d, x2d_flip, x_init=x_init)
    torch.cuda.synchronize()
    launches = fused_transformer_block.launches
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

    def drive(step):
        for c in counters:
            c.launches = c.launches_bf16 = 0
        out = step(x2d, x2d_flip, x_init=x_init)
        torch.cuda.synchronize()
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
        out, got = drive(step)
        want = counts(b1_calls, b2_calls, DDIM_STEPS - 1)
        check(got == want, f"mixed {mode} eval launched {got}, expected {want}")
        check(out.shape == pred_plain.shape and out.dtype == torch.float32
              and torch.isfinite(out).all().item(), f"mixed {mode} eval output")
        secs = timed(step)
        mixed[mode] = dict(out=out, launches=got, dev=(out - pred_plain).abs().max().item(),
                           mpjpe=mpjpe(out, pred_plain), step_s=secs, step=step)
    step_bf16 = make_eval_step(GaussianDiffusion.create(
        make_fast_denoise_fn(model, torch.bfloat16), **kw), JOINTS_LEFT, JOINTS_RIGHT, device=dev)
    pred_bf16, bf16_launches = drive(step_bf16)
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

    # Phase 5b: where one mixed rows eval step's device time goes.
    profile_step("phase 5b profile of one mixed rows eval step",
                 lambda: mixed["rows"]["step"](x2d, x2d_flip, x_init=x_init), top_n=14)
    mixed_launches = {f"mixed_eval_{mode}": m["launches"] for mode, m in mixed.items()}
    mixed_launches["bf16_eval_rows"] = bf16_launches
    del step_fast, step_plain, step_bf16, step, out, model, pred, pred_plain, pred_bf16, mixed
    torch.cuda.empty_cache()

    # Phase 6: the attention kernels B3 and B4 against their plain versions
    # at the train path's shape and layout: q, k, v are views of one
    # [B*J, F, 3, H, 64] qkv projection, dO is [B*J, F, H, 64] seen as
    # [B*J, H, F, 64], as the temporal blocks of the recompute hand them over.
    groups, hd = TRAIN_BATCH * JOINTS, EMBED // HEADS
    qkv = randn(groups, FRAMES, 3, HEADS, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    do = randn(groups, FRAMES, HEADS, hd).transpose(1, 2)
    g_all, n, elems = groups * HEADS, FRAMES, groups * HEADS * FRAMES * hd
    attn = {}
    with torch.no_grad():
        for name, run, plain, work, nbytes in (
            ("grand_attention_fullseq", lambda: (grand_attention_fullseq(q, k, v),),
             lambda: (grand_attention_fullseq_ref(q, k, v),), 4 * g_all * n * n * hd,
             4 * 4 * elems),
            ("grand_attention_bwd", lambda: grand_attention_bwd(q, k, v, do),
             lambda: grand_attention_bwd_ref(q, k, v, do), 10 * g_all * n * n * hd, 7 * 4 * elems),
        ):
            outs, refs = run(), plain()
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(outs, refs)]
            abs_err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
            check(all(torch.isfinite(a).all().item() for a in outs), f"{name} not finite")
            check(rel <= KERNEL_REL_TOL, f"{name} rel err {rel:.3e} > {KERNEL_REL_TOL}")
            del outs, refs
            attn[name] = dict(abs_err=abs_err, rel=rel, ms=cuda_ms(run), plain_ms=cuda_ms(plain),
                              flops=work, bytes=nbytes)
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
        a["bound_by"] = "operations" if a["flops"] / peak_flops >= a["bytes"] / mem_rate else "bytes"
        say(f"phase 6 {name}: [B*H={g_all}, N={n}, D={hd}] max_abs_err={a['abs_err']:.3e} "
            f"rel_err={a['rel']:.3e} (tol {KERNEL_REL_TOL}) ms={a['ms']:.4f} "
            f"plain_ms={a['plain_ms']:.4f} library_ms={a['lib_ms']:.4f} "
            f"bound_ms={a['bound_ms']:.4f} ({a['bound_by']}) GFLOP={a['flops'] / 1e9:.2f} "
            f"achieved_TFLOPs={a['flops'] / a['ms'] / 1e9:.2f}")
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

    # (a) B=4: kernel path against the plain module on the same dp, t, noise.
    gt, x2d = batch(CHECK_BATCH)
    inject = dict(t=torch.randint(0, TIMESTEPS, (CHECK_BATCH,), generator=gen, device=dev),
                  noise=randn(CHECK_BATCH, FRAMES, JOINTS, 3),
                  dp_scales=draw_drop_path_scales(gen, CHECK_BATCH, DEPTH, DROP_PATH, FRAMES,
                                                  JOINTS))
    for c in counters:
        c.launches = 0
    loss_fast = diff_fast.training_loss(gt, x2d, **inject)
    grads_fast = torch.autograd.grad(loss_fast, params)
    torch.cuda.synchronize()
    check_launches = {c.__name__: c.launches for c in counters}
    loss_plain = diff_plain.training_loss(gt, x2d, **inject)
    grads_plain = torch.autograd.grad(loss_plain, params)
    loss_rel = abs(loss_fast.item() - loss_plain.item()) / abs(loss_plain.item())
    grad_rel = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(grads_fast, grads_plain))
    check(check_launches == per_step, f"train check launched {check_launches}, expected {per_step}")
    check(loss_rel <= LOSS_REL_TOL, f"train loss rel err {loss_rel:.3e} > {LOSS_REL_TOL}")
    check(grad_rel <= GRAD_REL_TOL, f"train grad rel err {grad_rel:.3e} > {GRAD_REL_TOL}")
    say(f"phase 7a train check B={CHECK_BATCH}: loss={loss_fast.item():.6f} "
        f"plain_loss={loss_plain.item():.6f} loss_rel_err={loss_rel:.3e} (tol {LOSS_REL_TOL}) "
        f"max_param_grad_rel_err={grad_rel:.3e} (tol {GRAD_REL_TOL}, over {len(params)} "
        f"parameters) launches={check_launches}")
    del grads_fast, grads_plain, loss_fast, loss_plain, gt, x2d, inject
    torch.cuda.empty_cache()

    # (b) B=24: the train step as a user calls it, t/noise/dp drawn from gen.
    optimizer, scheduler = make_optimizer(params, LR, LR_DECAY, steps_per_epoch=1000)
    train_step = make_train_step(diff_fast, optimizer, scheduler)
    gt, x2d = batch(TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    train_step(gt, x2d, generator=gen)  # warm-up
    torch.cuda.synchronize()
    train_launches = {c.__name__: c.launches for c in counters}
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

    # Phase 8: B6 against its plain version at the use_pallas eval path's
    # shape, 4·243 joint groups x 8 heads of n = 17: as views of one
    # [972, 17, 3, 8, 64] qkv projection (what the module hands over) and
    # as contiguous [7776, 17, 64] operands; then at n = 64 (two keys a
    # lane) and at an odd n. The library yardstick is SDPA - v.
    hd = EMBED // HEADS
    small = {}
    with torch.no_grad():
        for label, b, h, n, strided in (("qkv_views", 2 * BATCH * FRAMES, HEADS, JOINTS, True),
                                        ("contiguous", 2 * BATCH * FRAMES * HEADS, 1, JOINTS, False),
                                        ("n64", 243, HEADS, 64, True), ("n27", 101, HEADS, 27, True)):
            if strided:
                q, k, v = randn(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
            else:
                q, k, v = randn(b, n, hd), randn(b, n, hd), randn(b, n, hd)
            run = lambda: packed_grand_attention(q, k, v)
            plain = lambda: packed_grand_attention_ref(q, k, v)
            lib = lambda: F.scaled_dot_product_attention(q, k, v) - v
            out, ref = run(), plain()
            torch.cuda.synchronize()
            abs_err, _ = rel_err(out, ref)
            lib_abs, _ = rel_err(lib(), ref)
            check(out.shape == q.shape and torch.isfinite(out).all().item(),
                  f"B6 {label} output shape or values")
            check(abs_err <= SMALL_ATTN_ABS_TOL,
                  f"B6 {label} abs err {abs_err:.3e} > {SMALL_ATTN_ABS_TOL}")
            pairs = b * h
            t = timings(run, plain, lib, 4 * pairs * n * n * hd, 4 * 4 * pairs * n * hd, peak_flops)
            small[label] = dict(abs_err=abs_err, **t)
            say(f"phase 8 packed_grand_attention {label}: [G={pairs}, N={n}, D={hd}] "
                f"max_abs_err={abs_err:.3e} (tol {SMALL_ATTN_ABS_TOL}) ms={t['ms']:.4f} "
                f"plain_ms={t['plain_ms']:.4f} library_ms={t['lib_ms']:.4f} (library vs plain "
                f"max_abs {lib_abs:.3e}) bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) "
                f"GB_per_s={t['bytes'] / t['ms'] / 1e6:.1f}")
            del q, k, v, out, ref

    # Phase 9: B5 against its plain version at both eval shapes (R rows in
    # groups of 17 joints and of 243 frames), at f32 and at bf16 (weights
    # made bf16 once, as a bf16 snapshot holds them). The library yardstick
    # is F.layer_norm / F.linear / SDPA - v / F.linear in the same dtype.
    attn_block = {"f32": {}, "bf16": {}}
    with torch.no_grad():
        block, _ = make_block(3)
        block_bf = copy.deepcopy(block)
        for m in (block_bf.attn.qkv, block_bf.attn.proj):
            m.weight.data = m.weight.data.bfloat16()
        block_lib_bf = copy.deepcopy(block).bfloat16()
        drive = []
        for shape, n in (("spatial", JOINTS), ("temporal", FRAMES)):
            for name, dt, blk, lib_blk, peak in (("f32", torch.float32, block, block, peak_flops),
                                                 ("bf16", torch.bfloat16, block_bf, block_lib_bf,
                                                  peak_bf16)):
                x = randn(rows, EMBED).to(dt)
                run = lambda: fused_attention_block(x, blk, n, HEADS)
                plain = lambda: fused_attention_block_ref(x, blk, n, HEADS)
                lib = lambda: library_attn_block(x, lib_blk, n, HEADS)
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
                    abs_err, rel, mean_rel = check_bf16(f"B5 bf16 {shape}", out, ref)
                    errs = (f"max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} (tol {BF16_MAX_TOL}) "
                            f"mean_rel_err={mean_rel:.3e} (tol {BF16_MEAN_TOL})")
                lib_abs = (lib().float() - ref.float()).abs().max().item()
                t = timings(run, plain, lib, *attn_block_work(rows, n, EMBED, dt.itemsize), peak)
                attn_block[name][shape] = dict(abs_err=abs_err, **t)
                say(f"phase 9 fused_attention_block {name} {shape}: R={rows} n={n} C={EMBED} {errs} "
                    f"ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms={t['lib_ms']:.4f} "
                    f"(library vs plain max_abs {lib_abs:.3e}) bound_ms={t['bound_ms']:.4f} "
                    f"({t['bound_by']}) GFLOP={t['flops'] / 1e9:.2f} "
                    f"achieved_TFLOPs={t['flops'] / t['ms'] / 1e9:.2f}")
                drive.append((x, blk, n))
                del out, ref
        # B5 has no caller in the model: its path is the op itself. One call
        # per shape and dtype with the counts set to 0 just before: 4 calls
        # x 4 kernels, half of them bf16.
        fused_attention_block.launches = fused_attention_block.launches_bf16 = 0
        for x, blk, n in drive:
            check(torch.isfinite(fused_attention_block(x, blk, n, HEADS).float()).all().item(),
                  "B5 op output not finite")
        torch.cuda.synchronize()
        b5_launches = (fused_attention_block.launches, fused_attention_block.launches_bf16)
        check(b5_launches == (16, 8), f"B5 op launched {b5_launches}, expected (16, 8)")
        say(f"phase 9 fused_attention_block as an op: {len(drive)} calls, "
            f"launches={b5_launches[0]} (bf16 {b5_launches[1]})")
        del drive, x, block, block_bf, block_lib_bf
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
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "seed0.bin")
        torch.save(MixSTEDenoiser(num_frame=FRAMES, num_joints=JOINTS, embed_dim=EMBED,
                                  depth=DEPTH, num_heads=HEADS, mlp_ratio=MLP_RATIO, seed=0,
                                  device=dev).state_dict(), weights)
        with open(os.path.join(here, CLI_CONFIG)) as f:
            config = json.load(f)
        config["params"]["use_pallas_attention"] = True
        use_pallas_config = os.path.join(tmp, "use_pallas.json")
        with open(use_pallas_config, "w") as f:
            json.dump(config, f)
        Runner.evaluate, mixste.grand_attention = recording_evaluate, counting_attention
        try:
            for name, config_path, extra in (
                ("plain", os.path.join(here, CLI_CONFIG), []),
                ("use_pallas", use_pallas_config, []),
                ("fast_eval", os.path.join(here, CLI_CONFIG), ["--fast-eval"]),
                ("mixed", os.path.join(here, CLI_CONFIG),
                 bf16_args + ["--eval-f32-head", "--eval-f32-final-steps", "1"]),
                ("bf16", os.path.join(here, CLI_CONFIG), bf16_args),
            ):
                records.clear()
                plain_calls[0] = 0
                for c in kernel_counters:
                    c.launches = 0
                    if hasattr(c, "launches_bf16"):
                        c.launches_bf16 = 0
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    errors = cli_main(
                        ["--config", config_path, "--synthetic", "-str", "S1", "-ste", "S9",
                         "-a", "Walking", "--sampling_timesteps", str(DDIM_STEPS),
                         "--batch-size-eval", str(BATCH), "-c", os.path.join(tmp, name),
                         "--evaluate", weights] + extra)
                torch.cuda.synchronize()
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
    forwards = steps * DDIM_STEPS
    zero = {c.__name__: 0 for c in kernel_counters}
    zero.update(fused_transformer_block_bf16=0, plain_attention_calls=0)
    b1 = 2 * DEPTH * per_call * forwards
    want = {
        "plain": dict(zero, plain_attention_calls=2 * DEPTH * forwards),
        "use_pallas": dict(zero, packed_grand_attention=DEPTH * forwards,
                           grand_attention_fullseq=DEPTH * forwards),
        "fast_eval": dict(zero, fused_transformer_block=b1),
        "mixed": dict(zero, fused_transformer_block=b1,
                      fused_transformer_block_bf16=b1 * (DDIM_STEPS - 1) // DDIM_STEPS),
        "bf16": dict(zero, fused_transformer_block=b1, fused_transformer_block_bf16=b1),
    }
    for name, c in cli.items():
        check(c["launches"] == want[name], f"cli {name} launched {c['launches']}, expected "
              f"{want[name]}")
        c["dev"] = (c["pred"] - cli["plain"]["pred"]).abs().max().item()
        c["mpjpe"] = mpjpe(c["pred"], cli["plain"]["pred"])
        say(f"phase 10 cli {name} B={BATCH} (x2 flip) DDIM-{DDIM_STEPS}, {steps - 1} timed steps: "
            f"inference_speed_frames_per_s={c['frames_per_s']:.1f} seq_per_s={c['seq_per_s']:.3f} "
            f"e1_mm={c['errors']['e1']:.4f} e2_mm={c['errors']['e2']:.4f} "
            f"e3_mm={c['errors']['e3']:.4f} ev_mm={c['errors']['ev']:.4f} vs the plain run "
            f"(normalised units): max_abs_dev={c['dev']:.3e} mpjpe={c['mpjpe']:.4e} "
            f"launches={ {k: v for k, v in c['launches'].items() if v} }")
    for name in ("use_pallas", "fast_eval"):
        check(cli[name]["dev"] <= EVAL_ABS_BOUND, f"cli {name} deviates from the plain run by "
              f"{cli[name]['dev']:.3e} > {EVAL_ABS_BOUND}")
    check(cli["mixed"]["mpjpe"] <= cli["bf16"]["mpjpe"], f"cli mixed mpjpe "
          f"{cli['mixed']['mpjpe']:.4e} > the bf16 run's {cli['bf16']['mpjpe']:.4e}")
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
    entries = [{
        "name": "fused_transformer_block",
        "route": "cuda",
        "source": "diff3dhpe_torch/csrc/fused_block.cu",
        "replaces": "diff3dhpe_tpu/ops/fused_block.py:231",
        "launches": sum(b1_by_path.values()),
        "launches_by_path": b1_by_path,
        "launches_bf16_by_path": {k: v["fused_transformer_block_bf16"]
                                  for k, v in {**mixed_launches, **cli_launches}.items()},
        **pair_numbers(per_shape, peak_flops),
        "bf16": pair_numbers(per_shape_bf16, peak_bf16),
        "work": f"one spatial (n={JOINTS}) + one temporal (n={FRAMES}) call, R={rows}, C={EMBED}",
    }, {
        "name": "fused_temporal_block_cols",
        "route": "cuda",
        "source": "diff3dhpe_torch/csrc/fused_block.cu",
        "replaces": "diff3dhpe_tpu/ops/fused_block.py:642",
        "launches": sum(b2_by_path.values()),
        "launches_by_path": b2_by_path,
        "launches_bf16_by_path": {k: v["fused_temporal_block_cols_bf16"]
                                  for k, v in mixed_launches.items()},
        **one_call(cols_res["f32"]),
        "bf16": one_call(cols_res["bf16"]),
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
            "work": f"one call, [B*H={g_all}, N={FRAMES}, D={EMBED // HEADS}] f32",
        })
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
        "work": f"one call with n={JOINTS} + one with n={FRAMES}, R={rows}, C={EMBED}",
    })
    paths = by_path("packed_grand_attention",
                    train_step=train_launches["packed_grand_attention"])
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
                f"f32 as views of a qkv projection",
    })
    check(len(entries) == 6 and all(e["launches"] > 0 for e in entries),
          f"a kernel was launched no time: { {e['name']: e['launches'] for e in entries} }")
    say(json.dumps({"kernels": entries}))
    check(all(math.isfinite(e["ms"]) for e in entries), "timing failed")
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
