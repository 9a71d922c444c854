"""Benchmark of the PyTorch port: pose sequences per second on one card,
on the reference's eval hot path.

Port of ``bench.py`` (the JAX package's bench, which stays as it is).
Protocol (bench.py:85-197; the reference evaluation, run.py:557-593): the
MixSTE s2s denoiser at 243 frames, 17 joints, embed 512, depth 8, seed-0
weights, random 2D input, DDIM-9 reverse diffusion with flip test-time
augmentation (the flipped copy rides the same batch). One sequence costs
2 x 9 = 18 denoiser forwards. After a warm-up outside the window, each
timed loop runs BENCH_ITERS independent eval steps and synchronises once,
after the last; every output is checked finite after the window. The loop
is repeated (BENCH_REPEATS, at least 3) and the median and spread reported.

Usage: python bench_torch.py  (on the card; one JSON line on stdout). Knobs,
as bench.py names them:
  BENCH_DTYPE            mixed (default: bf16 trunk, f32 head, f32 final
                         step), float32, bfloat16
  BENCH_BATCH            logical batch (default 2, 4 at bfloat16)
  BENCH_ITERS            eval steps per timed loop (16)
  BENCH_REPEATS          timed loops (3, at least 3)
  BENCH_TMODE            rows or cols (the temporal blocks' layout)
  BENCH_FRAMES           243, 81 or 27
  BENCH_HEADS            8 or 4
  BENCH_PALLAS           1: the module with its attention on the kernels
  BENCH_FAST             0: the plain module instead of the fused forward
  BENCH_REPEAT_N         hypotheses per sequence (1)
  BENCH_MIXED_F32_STEPS  DDIM steps at f32 in the mixed mode (1)
  BENCH_DDIM             DDIM steps (9)
  BENCH_FINAL_PREC       high3 or highest (one exact-f32 path in the port)
  BENCH_TIMEOUT, BENCH_RETRIES, BENCH_NO_SUPERVISE=1: the supervision.
Refused, with a ValueError naming the knob: BENCH_EXPORTED=1 (no exported
serving artifact yet), BENCH_TAIL_PAIRS > 0 and BENCH_FINAL_PREC=default
(the port's final step runs whole and in exact f32).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BASELINE_CACHE = os.path.join(ROOT, "bench_baseline.json")
JOINTS_LEFT, JOINTS_RIGHT = [4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]
DTYPES = ("mixed", "float32", "bfloat16")


def settings_from_env(env=None) -> dict:
    """The keyword arguments of ``measure`` from the BENCH_* knobs. Raises
    a ValueError naming the knob for a value the port does not run."""
    env = os.environ if env is None else env
    get = lambda name, default: env.get(name, default)
    if get("BENCH_EXPORTED", "0") == "1":
        raise ValueError("BENCH_EXPORTED=1 is not ported: the port has no exported serving "
                         "artifact (torch.export of the eval step, ROADMAP A.10)")
    tail_pairs = int(get("BENCH_TAIL_PAIRS", "0"))
    if tail_pairs > 0:
        raise ValueError(f"BENCH_TAIL_PAIRS={tail_pairs} is not ported: the mixed mode's final "
                         "step runs its forward in float32 as a whole (ROADMAP A.6)")
    final_prec = get("BENCH_FINAL_PREC", "high3")
    if final_prec not in ("high3", "highest"):
        raise ValueError(f"BENCH_FINAL_PREC={final_prec!r} is not ported: the port's float32 "
                         "kernels contract in exact float32 ('high3' and 'highest' both mean "
                         "that; ROADMAP C.2)")
    dtype = get("BENCH_DTYPE", "mixed")
    if dtype not in DTYPES:
        raise ValueError(f"BENCH_DTYPE={dtype!r}: one of {DTYPES}")
    tmode = get("BENCH_TMODE", "rows")
    if tmode not in ("rows", "cols"):
        raise ValueError(f"BENCH_TMODE={tmode!r}: rows or cols")
    repeats = int(get("BENCH_REPEATS", "3"))
    if repeats < 3:
        raise ValueError(f"BENCH_REPEATS={repeats}: at least 3 timed loops give a spread")
    return dict(
        frames=int(get("BENCH_FRAMES", "243")),
        heads=int(get("BENCH_HEADS", "8")),
        dtype=dtype,
        batch=int(get("BENCH_BATCH", "4" if dtype == "bfloat16" else "2")),
        iters=int(get("BENCH_ITERS", "16")),
        repeats=repeats,
        ddim=int(get("BENCH_DDIM", "9")),
        tmode=tmode,
        use_pallas=get("BENCH_PALLAS", "0") == "1",
        fast=get("BENCH_FAST", "1") == "1",
        repeat_n=int(get("BENCH_REPEAT_N", "1")),
        mixed_f32_steps=int(get("BENCH_MIXED_F32_STEPS", "1")),
        final_prec=final_prec,
    )


def build_eval_step(*, frames, joints, embed, depth, heads, dtype, ddim, tmode, use_pallas, fast,
                    repeat_n, mixed_f32_steps, seed, device):
    """The eval step bench.py:85-135 builds, on the port: the plain module
    (at bf16 for ``dtype="bfloat16"``) or the fused forward, and in the
    mixed mode the f32 fused forward for the last ``mixed_f32_steps``."""
    from diff3dhpe_torch import (
        GaussianDiffusion, MixSTEDenoiser, make_denoise_fn, make_eval_step, make_fast_denoise_fn,
    )

    model = MixSTEDenoiser(
        num_frame=frames, num_joints=joints, in_chans=2, embed_dim=embed, depth=depth,
        num_heads=heads, mlp_ratio=2.0, qkv_bias=True, with_time_emb=True, mode="s2s",
        use_pallas=use_pallas, dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32,
        seed=seed, device=device).eval()
    if fast:
        denoise_fn = make_fast_denoise_fn(
            model, torch.float32 if dtype == "float32" else torch.bfloat16, tmode,
            f32_head=dtype == "mixed")
    else:
        denoise_fn = make_denoise_fn(model)
    diffusion = GaussianDiffusion.create(denoise_fn, timesteps=1000, sampling_timesteps=ddim,
                                         clip_denoised=True, beta_schedule="cosine", mode="s2s")
    if fast and dtype == "mixed":
        diffusion = dataclasses.replace(
            diffusion, final_denoise_fn=make_fast_denoise_fn(model, torch.float32, tmode),
            final_denoise_steps=mixed_f32_steps)
    return make_eval_step(diffusion, JOINTS_LEFT, JOINTS_RIGHT, repeat_n=repeat_n, device=device)


def measure(*, frames=243, joints=17, embed=512, depth=8, heads=8, dtype="mixed", batch=None,
            iters=16, repeats=3, ddim=9, tmode="rows", use_pallas=False, fast=True, repeat_n=1,
            mixed_f32_steps=1, final_prec="high3", seed=0, device="cuda") -> dict:
    """Runs the protocol and returns its numbers: seq/s of each timed loop,
    their median, the kernels' launches inside the timed loops, and the
    sizes. ``device``: "cuda" (the card; raises without one) or "cpu"
    (the kernels' plain versions, for tests)."""
    from diff3dhpe_torch.device import resolve_device
    from diff3dhpe_torch.ops import read_launches, reset_launches
    from diff3dhpe_torch.utils.sync import device_sync

    device = resolve_device(device)
    batch = batch or (4 if dtype == "bfloat16" else 2)
    eval_step = build_eval_step(
        frames=frames, joints=joints, embed=embed, depth=depth, heads=heads, dtype=dtype,
        ddim=ddim, tmode=tmode, use_pallas=use_pallas, fast=fast, repeat_n=repeat_n,
        mixed_f32_steps=mixed_f32_steps, seed=seed, device=device)
    make_gen = lambda s: torch.Generator(device=device).manual_seed(s)
    x2d = torch.randn(batch, frames, joints, 2, generator=make_gen(1), device=device)
    x2d_flip = torch.randn(batch, frames, joints, 2, generator=make_gen(2), device=device)
    gen = make_gen(3)

    walls = []
    with torch.no_grad():
        device_sync(eval_step(x2d, x2d_flip, generator=gen))  # warm-up: build, load, allocate
        reset_launches()
        for _ in range(repeats):
            t0 = time.perf_counter()
            outs = [eval_step(x2d, x2d_flip, generator=gen) for _ in range(iters)]
            last = device_sync(outs[-1])  # the stream runs in order: this waits for all
            walls.append(time.perf_counter() - t0)
            # Outside the window: every step's output is finite.
            if not (math.isfinite(last) and all(bool(torch.isfinite(o).all()) for o in outs)):
                raise RuntimeError("an eval step produced a non-finite output")
        launches = read_launches()
    seq_per_s = [batch * iters / w for w in walls]
    return dict(
        seq_per_s=seq_per_s, median_seq_per_s=statistics.median(seq_per_s), wall_s=walls,
        launches={k: v for k, v in launches.items() if v}, device=device.type, frames=frames,
        joints=joints, embed=embed, depth=depth, heads=heads, dtype=dtype, batch=batch,
        iters=iters, repeats=repeats, ddim=ddim, tmode=tmode, use_pallas=use_pallas, fast=fast,
        repeat_n=repeat_n, mixed_f32_steps=mixed_f32_steps, final_prec=final_prec,
        out_shape=list(outs[-1].shape))


def _baseline(frames) -> float:
    """The reference's CPU seq/s from the committed ``bench_baseline.json``
    (bench.py's cache; only for the 243-frame protocol), else 0. It is read,
    never measured: the reference code is not in the repository."""
    if frames != 243 or not os.path.isfile(BASELINE_CACHE):
        return 0.0
    with open(BASELINE_CACHE) as f:
        return float(json.load(f)["torch_cpu_seqs_per_sec"])


def result_line(r: dict) -> dict:
    """The JSON object bench.py prints, from ``measure``'s result, with the
    card, the spread of the repeats and the MFU against the card's dense
    peak for the dtype (f32 for float32, bf16 for bfloat16 and mixed)."""
    from diff3dhpe_torch.utils.profiling import card_info, denoiser_matmul_flops

    card = card_info(r["device"])
    seq_s = r["median_seq_per_s"]
    # flip-TTA doubles the rows; each extra hypothesis runs the loop again.
    flops_per_seq = (2 * r["ddim"] * r["repeat_n"]
                     * denoiser_matmul_flops(r["frames"], r["joints"], r["embed"], r["depth"]))
    achieved = flops_per_seq * seq_s / 1e12
    peak_dtype = "f32" if r["dtype"] == "float32" else "bf16"
    peak = card.get(f"peak_{peak_dtype}_tflops")
    baseline = _baseline(r["frames"])
    mixed = r["dtype"] == "mixed" and r["fast"]
    return dict(
        metric=f"pose_seqs_per_sec_per_chip_{r['frames']}f_ddim{r['ddim']}_flipTTA",
        value=round(seq_s, 3),
        unit="seq/s/chip",
        vs_baseline=round(seq_s / baseline, 2) if baseline > 0 else 0.0,
        detail=dict(
            frames_per_sec_per_chip=round(seq_s * r["frames"], 1),
            seq_per_s_repeats=r["seq_per_s"],
            seq_per_s_min=min(r["seq_per_s"]),
            seq_per_s_max=max(r["seq_per_s"]),
            spread_rel=(max(r["seq_per_s"]) - min(r["seq_per_s"])) / seq_s,
            wall_s=r["wall_s"],
            device=r["device"],
            card=card["name"],
            power_limit=card["power_limit"],
            n_chips=1,
            frames=r["frames"], embed=r["embed"], depth=r["depth"], heads=r["heads"],
            batch=r["batch"], iters=r["iters"], repeats=r["repeats"],
            dtype=r["dtype"],
            fast=r["fast"],
            use_pallas=r["use_pallas"],
            temporal_mode=r["tmode"],
            mixed_f32_steps=r["mixed_f32_steps"] if mixed else 0,
            mixed_final_prec=r["final_prec"] if mixed else None,
            mixed_f32_tail_pairs=0,
            repeat_n=r["repeat_n"],
            baseline_torch_cpu_seqs_per_sec=round(baseline, 4),
            baseline_note="bench_baseline.json: the reference torch code on a host CPU, read "
                          "and never measured here; the ratio is not a GPU comparison",
            model_tflops_per_seq=round(flops_per_seq / 1e12, 4),
            achieved_tflops=round(achieved, 3),
            peak_tflops=peak,
            peak_dtype=peak_dtype if peak else None,
            mfu=round(achieved / peak, 5) if peak else None,
            launches=r["launches"],
            out_shape=r["out_shape"],
        ),
    )


def main(env=None, device="cuda", **sizes) -> int:
    """Measures at the knobs' settings on ``device`` and prints one JSON
    line. ``sizes`` (embed, depth, joints) override the flagship's, for
    tests on the CPU."""
    settings = settings_from_env(env)
    print(json.dumps(result_line(measure(**settings, **sizes, device=device))), flush=True)
    return 0


def supervised_main() -> int:
    """Runs ``main`` in a supervised child process (bench.py's
    ``supervised_main``): a hung CUDA context would otherwise cost the run.
    The child gets BENCH_NO_SUPERVISE=1, BENCH_TIMEOUT seconds (default
    900) without an exit, and one retry. The knobs are checked here first,
    so that a refused setting raises at once."""
    from diff3dhpe_torch.utils.supervise import run_supervised

    settings_from_env()
    timeout_s = float(os.environ.get("BENCH_TIMEOUT", "900"))
    retries = int(os.environ.get("BENCH_RETRIES", "1"))
    env = dict(os.environ, BENCH_NO_SUPERVISE="1")
    rc, out = run_supervised([sys.executable, os.path.abspath(__file__)], timeout_s, retries,
                             env=env)
    sys.stdout.buffer.write(out)
    sys.stdout.flush()
    return rc


if __name__ == "__main__":
    if os.environ.get("BENCH_NO_SUPERVISE", "0") == "1":
        sys.exit(main())
    else:
        sys.exit(supervised_main())
