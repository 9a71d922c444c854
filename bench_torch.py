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
  BENCH_FINAL_PREC       the mixed mode's final-step contraction mode: high3
                         (default, bf16x3), default (one bf16 pass) or
                         highest (exact f32)
  BENCH_TAIL_PAIRS       k > 0: the mixed mode's final step runs its last k
                         block pairs and head at f32, the rest bf16
  BENCH_EXPORTED         1: time the eval step exported with torch.export
                         and restored (io/export.py) in place of the live
                         one; x_T is drawn outside the artifact, from the
                         same generator
  BENCH_TIMEOUT, BENCH_RETRIES, BENCH_NO_SUPERVISE=1: the supervision.
Refused, with a ValueError naming the knob: a BENCH_FINAL_PREC other than
those three, and BENCH_TAIL_PAIRS outside the fused mixed mode.
"""
from __future__ import annotations

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
    from diff3dhpe_torch.ops.fused_block import F32_MODES

    final_prec = get("BENCH_FINAL_PREC", "high3")
    if final_prec not in F32_MODES:
        raise ValueError(f"BENCH_FINAL_PREC={final_prec!r}: one of {F32_MODES}")
    dtype = get("BENCH_DTYPE", "mixed")
    if dtype not in DTYPES:
        raise ValueError(f"BENCH_DTYPE={dtype!r}: one of {DTYPES}")
    tmode = get("BENCH_TMODE", "rows")
    if tmode not in ("rows", "cols"):
        raise ValueError(f"BENCH_TMODE={tmode!r}: rows or cols")
    repeats = int(get("BENCH_REPEATS", "3"))
    if repeats < 3:
        raise ValueError(f"BENCH_REPEATS={repeats}: at least 3 timed loops give a spread")
    fast = get("BENCH_FAST", "1") == "1"
    tail_pairs = int(get("BENCH_TAIL_PAIRS", "0"))
    if tail_pairs < 0 or (tail_pairs and not (fast and dtype == "mixed")):
        raise ValueError(f"BENCH_TAIL_PAIRS={tail_pairs}: a float32 tail of the final step's "
                         "forward needs BENCH_DTYPE=mixed and BENCH_FAST=1")
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
        fast=fast,
        repeat_n=int(get("BENCH_REPEAT_N", "1")),
        mixed_f32_steps=int(get("BENCH_MIXED_F32_STEPS", "1")),
        final_prec=final_prec,
        tail_pairs=tail_pairs,
        exported=get("BENCH_EXPORTED", "0") == "1",
    )


def build_eval_source(*, frames, joints, embed, depth, heads, dtype, ddim, use_pallas, fast,
                      repeat_n, mixed_f32_steps, tail_pairs, seed, device, final_prec="high3"):
    """What bench.py:85-135 builds, on the port, as a runner-like namespace
    (``cfg``, ``model``, ``diffusion`` and the joints; what
    ``io.export.live_eval_step`` and ``export_eval_step`` take): the plain
    module (at bf16 for ``dtype="bfloat16"``) or the fused forward, and in
    the mixed mode the f32 fused forward for the last ``mixed_f32_steps``,
    or with ``tail_pairs`` a bf16 one whose last pairs and head run f32,
    those final-step parts at contraction mode ``final_prec``."""
    from types import SimpleNamespace

    from diff3dhpe_torch import GaussianDiffusion, MixSTEDenoiser, make_denoise_fn
    from diff3dhpe_torch.config import Config

    model = MixSTEDenoiser(
        num_frame=frames, num_joints=joints, in_chans=2, embed_dim=embed, depth=depth,
        num_heads=heads, mlp_ratio=2.0, qkv_bias=True, with_time_emb=True, mode="s2s",
        use_pallas=use_pallas, dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32,
        seed=seed, device=device).eval()
    mixed = fast and dtype == "mixed"
    cfg = Config(number_of_frames=frames, embed_dim=embed, transformer_depth=depth,
                 num_heads=heads, compute_dtype="float32" if dtype == "float32" else "bfloat16",
                 fast_eval=fast, eval_f32_head=mixed,
                 eval_f32_final_steps=mixed_f32_steps if mixed else 0,
                 eval_f32_tail_pairs=tail_pairs, eval_final_prec=final_prec,
                 use_pallas_attention=use_pallas,
                 timesteps=1000, sampling_timesteps=ddim, clip_denoised=True,
                 beta_schedule="cosine", repeat_n=repeat_n, seed=seed)
    diffusion = GaussianDiffusion.create(make_denoise_fn(model), timesteps=1000,
                                         sampling_timesteps=ddim, clip_denoised=True,
                                         beta_schedule="cosine", mode="s2s")
    return SimpleNamespace(cfg=cfg, model=model, diffusion=diffusion, device=device,
                           num_joints=joints, joints_left=JOINTS_LEFT, joints_right=JOINTS_RIGHT)


def measure(*, frames=243, joints=17, embed=512, depth=8, heads=8, dtype="mixed", batch=None,
            iters=16, repeats=3, ddim=9, tmode="rows", use_pallas=False, fast=True, repeat_n=1,
            mixed_f32_steps=1, final_prec="high3", tail_pairs=0, exported=False, seed=0,
            device="cuda") -> dict:
    """Runs the protocol and returns its numbers: seq/s of each timed loop,
    their median, the kernels' launches inside the timed loops, and the
    sizes. ``exported``: the timed step is the eval step exported with
    ``torch.export`` and restored (its seconds and bytes are reported),
    fed the same x_T the live step would draw. ``device``: "cuda" (the
    card; raises without one) or "cpu" (the kernels' plain versions, for
    tests)."""
    from diff3dhpe_torch.device import resolve_device
    from diff3dhpe_torch.io.export import export_eval_step, live_eval_step, restore_eval_step
    from diff3dhpe_torch.ops import read_launches, reset_launches
    from diff3dhpe_torch.utils.sync import device_sync

    device = resolve_device(device)
    batch = batch or (4 if dtype == "bfloat16" else 2)
    source = build_eval_source(
        frames=frames, joints=joints, embed=embed, depth=depth, heads=heads, dtype=dtype,
        ddim=ddim, use_pallas=use_pallas, fast=fast, repeat_n=repeat_n,
        mixed_f32_steps=mixed_f32_steps, tail_pairs=tail_pairs, seed=seed, device=device,
        final_prec=final_prec)
    export = None
    if exported:
        t0 = time.perf_counter()
        data = export_eval_step(source, batch, temporal_mode=tmode)
        served = restore_eval_step(data)
        export = dict(export_s=time.perf_counter() - t0, artifact_bytes=len(data))
        state = source.model.state_dict()
        x_shape = (2 * batch * repeat_n, frames, joints, 3)

        def eval_step(x2d, x2d_flip, generator):
            # x_T drawn as the live step draws it (ddim_sample_loop).
            x_t = torch.randn(x_shape, generator=generator, device=device)
            return served(state, x2d, x2d_flip, x_t)
    else:
        eval_step = live_eval_step(source, tmode)
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
        tail_pairs=tail_pairs, exported=export, out_shape=list(outs[-1].shape))


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
            mixed_f32_tail_pairs=r["tail_pairs"] if mixed else 0,
            # The step timed: the live one, or the restored torch.export
            # artifact (with its export seconds and bytes).
            exported_artifact=r["exported"] is not None,
            export=r["exported"],
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
