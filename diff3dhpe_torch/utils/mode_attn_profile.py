"""Device-time profile of the f32 attention step under the contraction
modes ("high3", "default"; ``ops.fused_block.block_attention``) at the eval
shapes, on one NVIDIA GPU:

    python -m diff3dhpe_torch.utils.mode_attn_profile [--out PATH.json]

qkv is one [R, 3C] float32 projection, R = 16,524 rows (the mixed eval
step's 2 · 2 · 243 frames · 17 joints), C = 512, in groups of n = 17 (the
spatial blocks) and n = 243 (the temporal ones), with 8 heads of 64 and 4
of 128. For each it prints the kernel's device time and launches a call
from the profiler, the call's time from CUDA events, and its separation r
from "highest" (mean |kernel − plain| over mean |plain − plain at
"highest"|). The script imports the port from sys.path, so running its
file with PYTHONPATH set to another checkout measures that checkout in the
same call (parent, change, change, parent). The last line is the JSON of
every number, also written to PATH.json. Exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

ROWS, EMBED = 2 * 2 * 243 * 17, 512


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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("mode_attn_profile: no CUDA device", file=sys.stderr)
        return 1
    from diff3dhpe_torch.ops import fused_block
    from diff3dhpe_torch.ops.fused_block import block_attention, block_attention_ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; port from {fused_block.__file__}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    with torch.no_grad():
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
    result = dict(card=card, rows=rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
