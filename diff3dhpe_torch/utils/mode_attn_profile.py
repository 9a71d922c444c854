"""Device-time profile of the f32 kernels of the contraction modes and of
the session precision "default" at the shapes the port runs them, on one
NVIDIA GPU:

    python -m diff3dhpe_torch.utils.mode_attn_profile [--parts attn,gemm,bwd] [--out PATH.json]

attn: the f32 attention step under the contraction modes ("high3",
"default"; ``ops.fused_block.block_attention``) at the eval shapes. qkv is
one [R, 3C] float32 projection, R = 16,524 rows (the mixed eval step's 2 ·
2 · 243 frames · 17 joints), C = 512, in groups of n = 17 (the spatial
blocks) and n = 243 (the temporal ones), with 8 heads of 64 and 4 of 128;
its separation r from "highest" is mean |kernel − plain| over mean |plain
− plain at "highest"|.

gemm: the f32-output tensor-core GEMM (``ops.fused_block._gemm_wgmma_f32``,
1 and 3 passes), the block's four products (qkv, proj, fc1, fc2) at M = R
rows, C = 512, hidden 1024, on operands split from float32 ones, with
their epilogues: ``torch.mm(out_dtype=float32)`` on the rounded operands
where PyTorch has it, and r from exact float32 sums of the same f32
operands (mean |kernel − plain| over mean |plain − exact|).

bwd: B4 at f32 under "default" (``ops.attention.grand_attention_bwd``) on
[408, H, 243, d] strided views of one qkv projection (the train step's
batch 24 · 17 joints of 243 frames; chip_smoke.py phase 21b's draws), 8
heads of 64 and 4 of 128: max and mean |·| of max|plain| and r from
"highest" against its plain version at "default", the same against
``b4_default_exact`` (S and dP summed exactly), the plain version's own
distance from that, its launches, SDPA's float32 backward, and the device
memory the call takes beyond its inputs and outputs.

Every part prints each kernel's device time and launches a call from the
profiler and the call's time from CUDA events. The script imports the port
from sys.path, so running its file with PYTHONPATH set to another checkout
measures that checkout in the same call (parent, change, change, parent).
The last line is the JSON of every number, also written to PATH.json.
Exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

ROWS, EMBED, HIDDEN = 2 * 2 * 243 * 17, 512, 1024
GROUPS, FRAMES = 24 * 17, 243


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
    profiler over `iters` calls, the session opened by a sentinel launch
    (the profiler can drop a session's first kernels after the card idled)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                and "spin_kernel" not in e.key):
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0][:80]
            out[name] = (e.self_device_time_total / 1e3 / iters, e.count / iters)
    return out


def b4_default_exact(q, k, v, do, scale=None):
    """(dq, dk, dv) of B4 at f32 under "default" with S = q·kᵀ and dP =
    dO·vᵀ summed exactly (float64 sums of the bf16-rounded operands, rounded
    once to float32) and every other step as the plain version
    ``grand_attention_bwd_ref`` takes it. dS and P reach bf16 roundings, so
    any float32 summation order of S and dP, the plain version's included,
    turns single roundings the other way (2^-8 of a term of dq, dk or dv):
    this is the order-free oracle B4's kernel and its plain version are
    both measured from."""
    from diff3dhpe_torch.ops.matmul_precision import bf16_round, matmul

    scale = q.shape[-1] ** -0.5 if scale is None else scale
    mm = lambda a, b: matmul(a, b, "default")
    exact = lambda a, b: torch.matmul(bf16_round(a).double(),
                                      bf16_round(b).double().transpose(-1, -2)).float()
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.softmax(exact(qf, kf) * scale, dim=-1)
    dp = exact(dof, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    return mm(ds, kf), mm(ds.transpose(-1, -2), qf), mm(p.transpose(-1, -2), dof) - dof


def errs(got, ref, highest):
    """max and mean |got − ref| of max|ref| and r = mean |got − ref| /
    mean |ref − highest|, each the largest over the tensors."""
    rel = mean_rel = r = 0.0
    for a, b, h in zip(got, ref, highest):
        scale = b.abs().max()
        rel = max(rel, ((a - b).abs().max() / scale).item())
        mean_rel = max(mean_rel, ((a - b).abs().mean() / scale).item())
        r = max(r, ((a - b).abs().mean() / (b - h).abs().mean()).item())
    return dict(rel=rel, mean_rel=mean_rel, r=r)


def attn_rows(gen):
    from diff3dhpe_torch.ops.fused_block import block_attention, block_attention_ref

    rows = []
    for heads in (8, 4):
        qkv = torch.randn(ROWS, 3 * EMBED, generator=gen, device="cuda")
        for n in (17, 243):
            highest = block_attention_ref(qkv, n, heads)
            for mode in ("high3", "default"):
                run = lambda: block_attention(qkv, n, heads, f32_prec=mode)
                ref = block_attention_ref(qkv, n, heads, f32_prec=mode)
                out = run()
                r = ((out - ref).abs().mean() / (ref - highest).abs().mean()).item()
                kernels = kernel_ms(run)
                row = dict(heads=heads, n=n, mode=mode, r=r,
                           rel=((out - ref).abs().max() / ref.abs().max()).item(),
                           device_ms=sum(ms for ms, _ in kernels.values()),
                           kernels={k: v for k, v in kernels.items()},
                           event_ms=event_ms(run))
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def gemm_rows(gen):
    from torch.nn import functional as F

    from diff3dhpe_torch.ops.fused_block import (
        _gemm_f32_ref, _gemm_wgmma_f32, _gemm_wgmma_f32_ref, split_bf16,
    )

    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    rows = []
    for label, n, k, epi in (("qkv", 3 * EMBED, EMBED, "bias"), ("proj", EMBED, EMBED, "residual"),
                             ("fc1", HIDDEN, EMBED, "gelu"), ("fc2", EMBED, HIDDEN, "residual")):
        a, w, bias = randn(ROWS, k), randn(n, k) * k ** -0.5, randn(n) * 0.1
        res = randn(ROWS, n) if epi == "residual" else None
        rscale = ((torch.rand(ROWS, 2, generator=gen, device="cuda") < 0.9) / 0.9).float() \
            if epi == "residual" else None
        (a_hi, a_lo), (w_hi, w_lo) = split_bf16(a), split_bf16(w)
        exact = _gemm_f32_ref(a, w, bias, epi, res, rscale)
        for passes in (1, 3):
            args = ((a_hi, a_lo, w_hi, w_lo) if passes == 3 else (a_hi, None, w_hi, None)) + (
                bias, epi, res, rscale)
            run = lambda: _gemm_wgmma_f32(*args)
            out, ref = run(), _gemm_wgmma_f32_ref(*args)
            kernels = kernel_ms(run)
            try:
                lib = event_ms(lambda: torch.mm(a_hi, w_hi.t(), out_dtype=torch.float32))
            except TypeError:
                lib = event_ms(lambda: F.linear(a_hi, w_hi))
            row = dict(product=label, passes=passes, m=ROWS, n=n, k=k,
                       r=((out - ref).abs().mean() / (ref - exact).abs().mean()).item(),
                       rel=((out - ref).abs().max() / ref.abs().max()).item(),
                       device_ms=sum(ms for ms, _ in kernels.values()), kernels=kernels,
                       event_ms=event_ms(run), library_ms=lib)
            rows.append(row)
            print(json.dumps(row), flush=True)
        del a, w, res, exact, a_hi, a_lo, w_hi, w_lo, out, ref
    return rows


def bwd_rows():
    from torch.nn import functional as F

    from diff3dhpe_torch.ops.attention import grand_attention_bwd, grand_attention_bwd_ref

    rows, prec = [], dict(matmul_precision="default")
    gen = torch.Generator(device="cuda").manual_seed(23)  # chip_smoke.py phase 21b's draws
    for heads, d in ((8, 64), (4, 128)):
        qkv = torch.randn(GROUPS, FRAMES, 3, heads, d, generator=gen, device="cuda")
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        do = torch.randn(GROUPS, FRAMES, heads, d, generator=gen, device="cuda").transpose(1, 2)
        run = lambda: grand_attention_bwd(q, k, v, do, **prec)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = run()
        torch.cuda.synchronize()
        scratch = torch.cuda.max_memory_allocated() - base - sum(
            t.numel() * t.element_size() for t in got)
        plain, exact = grand_attention_bwd_ref(q, k, v, do, **prec), b4_default_exact(q, k, v, do)
        highest = grand_attention_bwd_ref(q, k, v, do)
        row = dict(pairs=GROUPS * heads, n=FRAMES, d=d, plain=errs(got, plain, highest),
                   exact=errs(got, exact, highest), plain_from_exact=errs(plain, exact, highest))
        del got, plain, exact, highest
        kernels = kernel_ms(run)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(qg, kg, vg) - vg
        lib = kernel_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do, retain_graph=True))
        row.update(device_ms=sum(ms for ms, _ in kernels.values()),
                   launches=sum(c for _, c in kernels.values()), kernels=kernels,
                   event_ms=event_ms(run), scratch_bytes=scratch,
                   library_ms=sum(ms for ms, _ in lib.values()))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del qkv, q, k, v, do, qg, kg, vg, lib_out
        torch.cuda.empty_cache()
    return rows


PARTS = ("attn", "gemm", "bwd")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", default=",".join(PARTS),
                        help="comma-separated parts to run, of " + ", ".join(PARTS))
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        parser.error(f"--parts takes {', '.join(PARTS)}, got {args.parts}")
    if not torch.cuda.is_available():
        print("mode_attn_profile: no CUDA device", file=sys.stderr)
        return 1
    from diff3dhpe_torch.ops import fused_block

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; port from {fused_block.__file__}", flush=True)
    result = dict(card=card)
    with torch.no_grad():
        if "attn" in parts:
            result["rows"] = attn_rows(torch.Generator(device="cuda").manual_seed(21))
        if "gemm" in parts:
            result["gemm"] = gemm_rows(torch.Generator(device="cuda").manual_seed(18))
        if "bwd" in parts:
            result["bwd_default"] = bwd_rows()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
