"""Device-time profile of B4 at bf16 (``grand_attention_bwd`` on bf16
operands) at the bf16 train step's shapes, on one NVIDIA GPU:

    python -m diff3dhpe_torch.utils.attn_bwd_profile [--out PATH.json] [--train-step]

q, k and v are views of one [B*J, F, 3, H, d] bf16 qkv projection and dO a
transposed [B*J, F, H, d] view, as the train step's recompute hands them
over (B*J = 24 * 17 = 408 groups of F = 243 frames), with 8 heads of 64 and
4 of 128. For each width it prints the call's time from CUDA events, each
kernel's device time and count from the profiler, SDPA's bf16 backward on
the same operands, and two ablations that locate the time: the operands
copied contiguous (what the strided views cost) and the groups cut to 128
frames (what scales with N² and what does not). Where the trainable forward
hands B4 its rows' softmax statistics (``_bwd_stats_bf16``), the call from
them (the train step's form) is timed too. With --train-step it also
times the bf16 fast-train AdamW step that calls B4 (chip_smoke.py's phase
7d with attn_bwd: batch 24 of 243 frames, embed 512, depth 8, seed-0
weights, 8 and 4 heads): samples/s, the median of 3 steps after a warm-up.
The script imports the port from sys.path, so running its file with
PYTHONPATH set to another checkout measures that checkout in the same
call. The last line is the JSON of every number, also written to
PATH.json. Exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

GROUPS, FRAMES, EMBED = 24 * 17, 243, 512


def event_ms(fn, iters=20, warmup=3):
    """Mean time of fn() in ms from CUDA events around `iters` calls."""
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


def kernel_ms(fn, iters=20):
    """{kernel name: (device ms a call, launches a call)} of fn() from the
    profiler, over `iters` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0][:80]
            out[name] = (e.self_device_time_total / 1e3 / iters, e.count / iters)
    return out


def operands(heads, frames, gen):
    hd = EMBED // heads
    q, k, v = (torch.randn(GROUPS, frames, 3, heads, hd, generator=gen, device="cuda")
               .bfloat16().permute(2, 0, 3, 1, 4))
    do = torch.randn(GROUPS, frames, heads, hd, generator=gen, device="cuda").bfloat16()
    return q, k, v, do.transpose(1, 2)


def profile_width(heads, gen):
    from torch.nn import functional as F

    from diff3dhpe_torch.ops import attention

    q, k, v, do = operands(heads, FRAMES, gen)
    hd = EMBED // heads
    flops = 10 * GROUPS * heads * FRAMES * FRAMES * hd
    alone = lambda: attention.grand_attention_bwd(q, k, v, do)
    r = dict(heads=heads, head_dim=hd, gflop_formulas=flops / 1e9)
    with torch.no_grad():
        r["ms"] = event_ms(alone)
        r["kernels"] = kernel_ms(alone)
        if hasattr(attention, "_bwd_stats_bf16"):
            stats = attention._bwd_stats_bf16(q)
            attention._fullseq(q, k, v, None, stats)
            train = lambda: attention._bwd(q, k, v, do, None, (stats,))
            r["train_ms"] = event_ms(train)
            r["train_kernels"] = kernel_ms(train)
        qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
        r["contiguous_ms"] = event_ms(lambda: attention.grand_attention_bwd(qc, kc, vc, doc))
        del qc, kc, vc, doc
        q2, k2, v2, do2 = operands(heads, 128, gen)
        r["n128_ms"] = event_ms(lambda: attention.grand_attention_bwd(q2, k2, v2, do2))
        r["n128_kernels"] = kernel_ms(lambda: attention.grand_attention_bwd(q2, k2, v2, do2))
        del q2, k2, v2, do2
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(qg, kg, vg) - vg
    r["sdpa_bwd_ms"] = event_ms(
        lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do, retain_graph=True))
    r["tflops_formulas"] = flops / r["ms"] / 1e9
    return r


def train_step_samples_per_s(heads, reps=3):
    """The bf16 fast-train step with attn_bwd at batch 24: samples/s, the
    median of `reps` timed steps after a warm-up, and the losses."""
    import statistics
    import time

    from diff3dhpe_torch import (GaussianDiffusion, MixSTEDenoiser, make_fast_train_denoise_fn,
                                 make_optimizer, make_train_step)

    batch, joints = 24, 17
    model = MixSTEDenoiser(num_frame=FRAMES, num_joints=joints, embed_dim=EMBED, depth=8,
                           num_heads=heads, mlp_ratio=2.0, seed=0, device="cuda").train()
    diff16 = GaussianDiffusion.create(
        make_fast_train_denoise_fn(model, 0.1, attn_bwd=True, dtype=torch.bfloat16),
        timesteps=1000, sampling_timesteps=9, clip_denoised=True, clip_loss=True,
        beta_schedule="cosine")
    optimizer, scheduler = make_optimizer(model.parameters(), 4e-5, 0.99, 1000)
    step = make_train_step(diff16, optimizer, scheduler)
    gen = torch.Generator(device="cuda").manual_seed(1)
    gt = torch.randn(batch, FRAMES, joints, 3, generator=gen, device="cuda") * 0.3
    x2d = torch.rand(batch, FRAMES, joints, 2, generator=gen, device="cuda") * 2 - 1
    step(gt, x2d, generator=gen)  # warm-up
    torch.cuda.synchronize()
    secs, losses = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        losses.append(step(gt, x2d, generator=gen).item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return dict(heads=heads, samples_per_s=batch / statistics.median(secs), step_s=secs,
                losses=losses)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--train-step", action="store_true",
                    help="also time the bf16 train step that calls B4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_bwd_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from diff3dhpe_torch.ops._build import build_all

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    build = build_all(("grand_attention",))
    ptxas, keep = [], False  # ptxas -v: the backward kernels' properties, spills, registers
    for ln in build.get("grand_attention", "").splitlines():
        if "Function properties for" in ln:
            keep = "bwd" in ln
        if keep and ("Function properties" in ln or "spill" in ln or "Used" in ln):
            ptxas.append(ln.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = dict(card=card, ptxas=ptxas, widths=[])
    for heads in (8, 4):
        r = profile_width(heads, gen)
        result["widths"].append(r)
        print(f"B4 bf16 d={r['head_dim']}: ms={r['ms']:.4f} "
              + (f"train_ms={r['train_ms']:.4f} " if "train_ms" in r else "")
              + f"contiguous_ms={r['contiguous_ms']:.4f} n128_ms={r['n128_ms']:.4f} "
              f"sdpa_bwd_ms={r['sdpa_bwd_ms']:.4f} TFLOPs(formulas)={r['tflops_formulas']:.1f} "
              f"kernels={r['kernels']}", flush=True)
        torch.cuda.empty_cache()
    if args.train_step:
        import diff3dhpe_torch

        result["package"] = diff3dhpe_torch.__file__
        result["train_step"] = [train_step_samples_per_s(heads) for heads in (8, 4)]
        for r in result["train_step"]:
            print(f"bf16 train step B=24 heads={r['heads']}: samples_per_s="
                  f"{r['samples_per_s']:.3f} step_s={r['step_s']} losses={r['losses']} "
                  f"({result['package']})", flush=True)
            torch.cuda.empty_cache()
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
