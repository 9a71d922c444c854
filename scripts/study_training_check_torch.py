"""Checks of the accuracy study's bf16 training on the card (ROADMAP C.9).

The 4-head study (``STUDY_HEADS=4``) trained at bf16 with the attention
backward kernels stalls at the mean pose from epoch 1 on, where the 8-head
one converges. Three checks, each on the study's own training setup
(``scripts/accuracy_study_torch.py::study_config``, 8 actions, batch 8,
lr 4e-4, validation off), each printing JSON lines:

  python scripts/study_training_check_torch.py grads
      one step's gradients at B = 8 and 24, 8 and 4 heads: the fused bf16
      step with and without ``attn_bwd`` and the fused f32 step, each
      against the f32 module under plain autograd (max and median over
      the parameters of max|dg| / max|g|);
  python scripts/study_training_check_torch.py losses [EPOCHS]
      the train loss of each epoch at 4 heads (bf16 with and without
      ``attn_bwd``, f32 with it) and at 8 heads (bf16 with it);
  python scripts/study_training_check_torch.py kernels HEADS [EPOCHS]
      every call of B3 (with its row statistics) and B4 at bf16 in that
      training against its plain version on the same operands (max and
      mean |kernel - plain| / max|plain|, 64 calls a line), B4 from the
      statistics against B4 alone, and the largest attention score.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

DEVICE = "cuda"


def _study(heads, epochs, **changes):
    """(cfg, train_ds, val_ds, test_ds) of the study's training, without
    validation or periodic checkpoints."""
    import accuracy_study_torch as study

    s = study.settings({"STUDY_HEADS": str(heads), "STUDY_EPOCHS": str(epochs)})
    cfg = study.study_config(s, f"/tmp/study_training_check_{heads}").replace(
        no_eval=True, checkpoint_frequency=10 ** 6, **changes)
    return (cfg, *study.make_datasets(cfg, s["actions"]))


def _fit(cfg, train_ds, val_ds, test_ds):
    from diff3dhpe_torch.engine.runner import Runner

    runner = Runner(cfg, 17, test_ds.joints_left, test_ds.joints_right, device=DEVICE)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        return runner.fit(train_ds, val_ds)["losses_train"]


def grads():
    from diff3dhpe_torch import (
        GaussianDiffusion, MixSTEDenoiser, make_fast_train_denoise_fn, make_train_denoise_fn,
    )
    from diff3dhpe_torch.models.fast_eval import draw_drop_path_scales

    for heads in (8, 4):
        for b in (8, 24):
            model = MixSTEDenoiser(num_frame=243, embed_dim=512, depth=8, num_heads=heads,
                                   seed=0, device=DEVICE).train()
            g = torch.Generator(DEVICE).manual_seed(5)
            gt = torch.rand(b, 243, 17, 3, generator=g, device=DEVICE) * 2 - 1
            x2d = torch.rand(b, 243, 17, 2, generator=g, device=DEVICE) * 2 - 1
            t = torch.randint(0, 1000, (b,), generator=g, device=DEVICE)
            noise = torch.randn(b, 243, 17, 3, generator=g, device=DEVICE)
            dp = draw_drop_path_scales(g, b, 8, 0.1, 243, 17)

            def step(fn):
                model.zero_grad(set_to_none=True)
                diffusion = GaussianDiffusion.create(fn, timesteps=1000, clip_denoised=True,
                                                     clip_loss=True)
                loss = diffusion.training_loss(gt, x2d, t=t, noise=noise, dp_scales=dp)
                loss.backward()
                return loss.item(), {n: p.grad.float().clone() for n, p in model.named_parameters()}

            loss_ref, ref = step(make_train_denoise_fn(model, 0.1))
            row = dict(heads=heads, batch=b, loss_plain_f32=loss_ref)
            for name, kw in (("bf16_attn_bwd", dict(attn_bwd=True, dtype=torch.bfloat16)),
                             ("bf16_no_attn_bwd", dict(attn_bwd=False, dtype=torch.bfloat16)),
                             ("f32_attn_bwd", dict(attn_bwd=True))):
                loss, got = step(make_fast_train_denoise_fn(model, 0.1, **kw))
                errs = sorted(((got[n] - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
                              for n, r in ref.items())
                row[name] = dict(loss=loss, max_rel=errs[-1], median_rel=errs[len(errs) // 2])
            print(json.dumps(row), flush=True)
            del model
            torch.cuda.empty_cache()


def losses(epochs=3):
    for heads, dtype, attn_bwd in ((4, "bfloat16", True), (4, "bfloat16", False),
                                   (4, "float32", True), (8, "bfloat16", True)):
        t0 = time.time()
        got = _fit(*_study(heads, epochs, compute_dtype=dtype, fast_train_attn_bwd=attn_bwd))
        print(json.dumps(dict(heads=heads, dtype=dtype, attn_bwd=attn_bwd, losses=got,
                              seconds=time.time() - t0)), flush=True)
        torch.cuda.empty_cache()


def kernels(heads, epochs=2):
    from diff3dhpe_torch.ops import attention as A

    records = []
    bwd, fullseq = A._bwd, A._fullseq

    def rel(out, ref):
        d = (out.float() - ref.float()).abs()
        top = ref.float().abs().max().clamp_min(1e-30)
        return (d.max() / top).item(), (d.mean() / top).item()

    def checked_fullseq(q, k, v, scale, stats=None):
        out = fullseq(q, k, v, scale, stats)
        if stats is not None:  # the trainable forward's B3, keeping its statistics
            records.append(("fwd", rel(out, A.grand_attention_fullseq_ref(q, k, v, scale))))
        return out

    def checked_bwd(q, k, v, do, scale, fwd=None):
        got = bwd(q, k, v, do, scale, fwd)
        ref = A.grand_attention_bwd_ref(q, k, v, do, scale)
        alone = bwd(q, k, v, do, scale, None)
        smax = ((q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5).abs().max()
        records.append(("bwd", dict(
            errs=[rel(g, r) for g, r in zip(got, ref)], smax=smax.item(),
            same_alone=all(torch.equal(a, b) for a, b in zip(got, alone)),
            finite=all(bool(torch.isfinite(g).all()) for g in got))))
        return got

    A._bwd, A._fullseq = checked_bwd, checked_fullseq
    try:
        got = _fit(*_study(heads, epochs))
    finally:
        A._bwd, A._fullseq = bwd, fullseq
    b = [r for kind, r in records if kind == "bwd"]
    f = [r for kind, r in records if kind == "fwd"]
    print(json.dumps(dict(heads=heads, losses=got, b4_calls=len(b), b3_calls=len(f))), flush=True)
    for i in range(0, len(b), 64):
        part, fpart = b[i:i + 64], f[i:i + 64]
        print(json.dumps(dict(
            calls=f"{i}-{i + len(part) - 1}",
            b4_max_dq_dk_dv=[max(r["errs"][j][0] for r in part) for j in range(3)],
            b4_mean_dq_dk_dv=[max(r["errs"][j][1] for r in part) for j in range(3)],
            b3_max=max(e[0] for e in fpart), b3_mean=max(e[1] for e in fpart),
            same_bits_alone=all(r["same_alone"] for r in part),
            finite=all(r["finite"] for r in part), max_score=max(r["smax"] for r in part))),
            flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from diff3dhpe_torch.device import resolve_device

    resolve_device(DEVICE)
    if argv[0] == "grads":
        grads()
    elif argv[0] == "losses":
        losses(*map(int, argv[1:]))
    elif argv[0] == "kernels":
        kernels(*map(int, argv[1:]))
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
