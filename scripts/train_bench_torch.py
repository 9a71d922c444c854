"""Training-step bench of the PyTorch port, with its roofline share.

Port of ``scripts/train_bench.py``: times one train step (forward, backward
and the AdamW update, ``make_train_step``) of the flagship 243-frame model
(17 joints, embed 512, depth 8, 8 heads, drop-path 0.1, seed-0 weights,
random data) for one variant, and reports samples/s, peak memory and MFU.

  python scripts/train_bench_torch.py VARIANT [B] [FRAMES]   # one point
  python scripts/train_bench_torch.py sweep [FRAMES]         # the table

VARIANT: {flax,flaxblk,fast,fastblk,fastpair,fastattn}_{f32,bf16}
  flax_*:     the module under autograd, the whole forward recomputed in
              the backward (Config remat_mode="whole").
  flaxblk_*:  the module with each block recomputed (remat_blocks,
              remat_mode="block").
  fast_*:     the fused forward (B1) with the monolithic recompute backward
              (models/fast_eval.py::fast_forward_denoise_train).
  fastblk_*:  fast_* with the recompute checkpointed block by block.
  fastpair_*: the fused forward with the pair-boundary backward
              (fast_forward_denoise_train_pairs).
  fastattn_*: fastpair with the attention backward kernels (B3, B4, B6)
              in the recompute (attn_bwd).
B defaults to 8, FRAMES to 243. Every point prints one JSON line: the
median step time of TRAIN_ITERS (default 10, at least 3) timed steps after
one warm-up step, their spread, samples/s at B, peak memory, and MFU: the
useful FLOPs, 3 x the forward's (denoiser_matmul_flops: a forward and a
backward of twice its products, train_bench.py:26-40), over the card's
dense peak for the dtype (f32 67, bf16 989 TFLOP/s on an H100 SXM), with
the card's name and power limit. The sweep runs every variant at B = 8, 16
and 32 in this process, one line each; a point that runs out of memory
prints its line with "failed".
"""
from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PATHS = ("flax", "flaxblk", "fast", "fastblk", "fastpair", "fastattn")
VARIANTS = tuple(f"{p}_{d}" for p in PATHS for d in ("f32", "bf16"))
SWEEP_BATCHES = (8, 16, 32)
JOINTS, EMBED, DEPTH, HEADS = 17, 512, 8, 8


def build_train_step(variant: str, frames: int, *, joints=JOINTS, embed=EMBED, depth=DEPTH,
                     heads=HEADS, device="cuda"):
    """(train_step, model) for ``variant``: AdamW at lr 4e-5 with the decay
    of 0.99 an epoch of 100 steps, as train_bench.py builds it."""
    from diff3dhpe_torch import (
        GaussianDiffusion, MixSTEDenoiser, make_fast_train_denoise_fn, make_optimizer,
        make_train_denoise_fn, make_train_step,
    )

    path, dt = variant.rsplit("_", 1)
    if path not in PATHS or dt not in ("f32", "bf16"):
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    model = MixSTEDenoiser(
        num_frame=frames, num_joints=joints, in_chans=2, embed_dim=embed, depth=depth,
        num_heads=heads, mlp_ratio=2.0, qkv_bias=True, with_time_emb=True, mode="s2s",
        dtype=dtype, remat_blocks=path == "flaxblk", seed=0, device=device).train()
    if path in ("flax", "flaxblk"):
        denoise_fn = make_train_denoise_fn(model, 0.1, remat=path == "flax")
    else:
        denoise_fn = make_fast_train_denoise_fn(
            model, 0.1, attn_bwd=path == "fastattn", dtype=dtype,
            pair_vjp=path in ("fastpair", "fastattn"), ckpt_blocks=path == "fastblk")
    diffusion = GaussianDiffusion.create(denoise_fn, timesteps=1000, sampling_timesteps=9,
                                         clip_denoised=True, clip_loss=True,
                                         beta_schedule="cosine", mode="s2s")
    optimizer, scheduler = make_optimizer(model.parameters(), 4e-5, 0.99, steps_per_epoch=100)
    return make_train_step(diffusion, optimizer, scheduler), model


def measure(variant: str, b: int = 8, frames: int = 243, *, iters: int = 10, joints=JOINTS,
            embed=EMBED, depth=DEPTH, heads=HEADS, device="cuda") -> dict:
    """One point: the step times of ``iters`` timed steps after a warm-up,
    each ended by a synchronisation, and what follows from them."""
    from diff3dhpe_torch.device import resolve_device
    from diff3dhpe_torch.utils.profiling import card_info, denoiser_matmul_flops
    from diff3dhpe_torch.utils.sync import device_sync

    if iters < 3:
        raise ValueError(f"iters={iters}: at least 3 timed steps give a median and a spread")
    device = resolve_device(device)
    cuda = device.type == "cuda"
    train_step, model = build_train_step(variant, frames, joints=joints, embed=embed,
                                         depth=depth, heads=heads, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    gt = torch.randn(b, frames, joints, 3, generator=gen, device=device)
    x2d = torch.randn(b, frames, joints, 2, generator=gen, device=device)
    step_gen = torch.Generator(device=device).manual_seed(3)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    first = device_sync(train_step(gt, x2d, generator=step_gen))
    warmup_s = time.perf_counter() - t0
    secs, losses = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        loss = train_step(gt, x2d, generator=step_gen)
        losses.append(device_sync(loss))
        secs.append(time.perf_counter() - t0)
    if not all(math.isfinite(v) for v in [first] + losses):
        raise RuntimeError(f"{variant}: non-finite loss {[first] + losses}")
    step_s = statistics.median(secs)
    fwd_flops = denoiser_matmul_flops(frames, joints, embed, depth) * b
    card = card_info(device)
    peak = card["peak_bf16_tflops" if variant.endswith("bf16") else "peak_f32_tflops"]
    useful = 3.0 * fwd_flops / step_s / 1e12  # forward + backward (2x)
    executed = 4.0 * fwd_flops / step_s / 1e12  # + the recomputed forward
    del model, train_step
    return dict(
        variant=variant, batch=b, frames=frames, embed=embed, depth=depth, heads=heads,
        device=device.type, card=card["name"], power_limit=card["power_limit"],
        ms_per_step=step_s * 1e3, step_ms_all=[s * 1e3 for s in secs],
        step_ms_min=min(secs) * 1e3, step_ms_max=max(secs) * 1e3,
        spread_rel=(max(secs) - min(secs)) / step_s,
        samples_per_s=b / step_s, warmup_s=warmup_s,
        peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None,
        useful_tflops_per_step=3.0 * fwd_flops / 1e12, achieved_tflops=useful,
        peak_tflops=peak, mfu=useful / peak if peak else None,
        hw_util_with_remat=executed / peak if peak else None,
        loss_first=first, loss_last=losses[-1])


def sweep(batches=SWEEP_BATCHES, frames=243, *, iters=10, device="cuda", **sizes):
    """Every variant at each batch, one JSON line a point. A point that
    runs out of device memory prints {"failed": ...} and the sweep goes on."""
    rows = []
    for variant in VARIANTS:
        for b in batches:
            try:
                row = measure(variant, b, frames, iters=iters, device=device, **sizes)
            except torch.cuda.OutOfMemoryError as e:
                row = dict(variant=variant, batch=b, frames=frames, failed="out of memory",
                           error=str(e).splitlines()[0])
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None, device="cuda", batches=SWEEP_BATCHES, **sizes) -> int:
    """``VARIANT [B] [FRAMES]`` or ``sweep``; TRAIN_ITERS timed steps a
    point. ``batches`` (the sweep's) and ``sizes`` (embed, depth, heads,
    joints) override the flagship's, for tests on the CPU."""
    argv = sys.argv[1:] if argv is None else argv
    iters = int(os.environ.get("TRAIN_ITERS", "10"))
    variant = argv[0] if argv else "fastattn_f32"
    if variant == "sweep":
        frames = int(argv[1]) if len(argv) > 1 else 243
        sweep(batches, frames, iters=iters, device=device, **sizes)
        return 0
    b = int(argv[1]) if len(argv) > 1 else 8
    frames = int(argv[2]) if len(argv) > 2 else 243
    print(json.dumps(measure(variant, b, frames, iters=iters, device=device, **sizes)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
