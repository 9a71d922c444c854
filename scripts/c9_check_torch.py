"""Controlled runs of the 4-head bf16 training stall (ROADMAP C.9).

The 4-head accuracy study (``STUDY_HEADS=4``), trained at bf16 with the
attention backward kernels (``fast_train_attn_bwd``: B3 and B6 forward, B4
backward in the recompute), stalls at the mean pose. These runs tell a
fault of the port apart from a property of B4's rounding points (those of
JAX's Pallas tile), each on the study's own training
(``scripts/accuracy_study_torch.py::study_config``: 243 frames, embed 512,
depth 8, 4 heads, batch 8, lr 4e-4, synthetic latent S1,S5, validation off)
with the same seed and draws unless an offset says otherwise:

  python scripts/c9_check_torch.py control [EPOCHS]
      float32 with ``attn_bwd`` (B3, B4 and B6's kernels), without it, and
      with B4's plain version in place of its kernel: every step's loss,
      and the first step where each run differs from the run without
      ``attn_bwd`` by more than 1e-4 relative;
  python scripts/c9_check_torch.py swaps [EPOCHS]
      bfloat16 with ``attn_bwd`` (the kernels), without it, and with B4
      replaced on the card by its plain version ``grand_attention_bwd_ref``
      (the tile's rounding points) and by ``grand_attention_bwd_xla``
      (the autograd formulas' rounding points);
  python scripts/c9_check_torch.py seeds [EPOCHS [OFFSET ...]]
      replicates at the study's seed plus each OFFSET (default 1 and 2;
      the model's init and every draw change with it): bfloat16 with B4's
      kernel, with its plain tile version, without ``attn_bwd``, and with
      the kernel's gradients copied into fresh contiguous tensors (the
      same values in the plain version's layout);
  python scripts/c9_check_torch.py hybrids [EPOCHS [OFFSET ...]]
      bfloat16 with dq from B4's kernel and dk, dv from its plain tile
      version, and the other way round (offsets default 0, 1, 2);
  python scripts/c9_check_torch.py trace [EPOCHS [EVERY]]
      the bf16 run with B4's kernel and with its plain tile version, every
      EVERY steps: the temporal blocks' qkv bias norms by part, the norms
      of the k and v parts of its gradient (zero in exact arithmetic), and
      the largest attention score;
  python scripts/c9_check_torch.py exact [EPOCHS [OFFSET ...]]
      bfloat16 with B4 replaced by the float64 gradients of its operands
      rounded once at the tile's points (``_tile_exact_bwd``: dS and P
      rounded to bfloat16, each product then formed in float64), at the
      study's seed plus each OFFSET (default 0 to 5): which of the two
      summation orders, the kernel's or the plain tile version's, is the
      odd one out;
  python scripts/c9_check_torch.py lowlr [EPOCHS [OFFSET ...]]
      bfloat16 with B4's kernel and with its plain tile version at lr 2e-4
      (half the study's), offsets default 0, 1, 2: the operating point;
  python scripts/c9_check_torch.py grads [EPOCHS]
      the weights after EPOCHS (2) epochs of the bf16 run with ``attn_bwd``,
      then one step's gradients on a training batch, each tensor's relative
      L2 error and cosine against the float32 module under plain autograd,
      for bf16 with and without ``attn_bwd`` and float32 with it; the worst
      five tensors by name and the largest attention score of the step;
  python scripts/c9_check_torch.py calls [EPOCHS]
      every B4 (and B3) call of one training step at the weights after
      EPOCHS (2) epochs of the bf16 run with the kernels: the kernel, the
      kernel without B3's statistics, and both plain versions, each as a
      relative L2 error from the float64 gradients of the same operands,
      whole and by 64-row tile, and where the kernel and the plain tile
      version differ.

Each prints JSON lines; ``--out F`` also writes them, with every step's
loss, to the file F. ``C9_DEVICE=cpu`` with ``STUDY_FRAMES``,
``STUDY_EMBED``, ``STUDY_DEPTH`` and ``STUDY_ACTIONS`` cut runs it small on
the CPU (the kernels' plain versions), as a check of the script itself.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

DEVICE = os.environ.get("C9_DEVICE", "cuda")
HEADS = 4
# The control's bar: two float32 runs whose kernels match their plain
# versions to ~1e-6 track each other's loss this closely until they split.
SPLIT_REL = 1e-4


def _study(epochs, **changes):
    """(cfg, train_ds, val_ds) of the study's 4-head training, without
    validation or periodic checkpoints."""
    import accuracy_study_torch as study

    env = {k: v for k, v in os.environ.items() if k.startswith("STUDY_")}
    s = study.settings(dict(env, STUDY_HEADS=str(HEADS), STUDY_EPOCHS=str(epochs)))
    cfg = study.study_config(s, os.path.join(os.environ.get("TMPDIR", "/tmp"), "c9_check")).replace(
        no_eval=True, checkpoint_frequency=10 ** 6, **changes)
    train_ds, val_ds, _ = study.make_datasets(cfg, s["actions"])
    return cfg, train_ds, val_ds


def _fit(epochs, **changes):
    """Trains the study's model; returns (runner, per-epoch losses, every
    step's loss, seconds). The step losses are the ``train_step`` results,
    kept on the card and read once at the end."""
    from diff3dhpe_torch.engine import runner as R

    cfg, train_ds, val_ds = _study(epochs, **changes)
    steps = []
    make = R.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def train_step(*sa, **skw):
            loss = step(*sa, **skw)
            steps.append(loss)
            return loss

        return train_step

    runner = R.Runner(cfg, 17, train_ds.joints_left, train_ds.joints_right, device=DEVICE)
    t0 = time.time()
    R.make_train_step = recording
    try:
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            epoch_losses = runner.fit(train_ds, val_ds)["losses_train"]
    finally:
        R.make_train_step = make
    return runner, epoch_losses, torch.stack(steps).float().cpu().tolist(), time.time() - t0


@contextlib.contextmanager
def _b4_as(fn, with_stats=False):
    """B4 in the trainable attention's backward replaced by ``fn(q, k, v,
    do, scale)`` (None: the kernel), as ``study_training_check_torch.py
    kernels`` patches it; ``with_stats``: fn also takes what the forward
    kept, as ``_bwd`` does."""
    from diff3dhpe_torch.ops import attention as A

    bwd = A._bwd
    if fn is not None:
        A._bwd = fn if with_stats else (lambda q, k, v, do, scale, fwd=None: fn(q, k, v, do, scale))
    try:
        yield
    finally:
        A._bwd = bwd


def first_split(a, b, rel=SPLIT_REL):
    """The first index where a and b differ by more than ``rel`` of |b|
    (None where they never do)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if abs(x - y) > rel * abs(y):
            return i
    return None


def _row(name, epochs_losses, steps, seconds, **extra):
    return dict(run=name, epoch_losses=epochs_losses, last_step_losses=steps[-8:],
                steps=len(steps), seconds=round(seconds, 1), **extra)


def control(epochs=3):
    """float32 with attn_bwd, without it, and with B4's plain version: every
    step's loss and where each run splits from the one without attn_bwd."""
    from diff3dhpe_torch.ops import attention as A

    runs = {}
    for name, attn_bwd, fn in (("f32_attn_bwd_on", True, None), ("f32_attn_bwd_off", False, None),
                               ("f32_b4_plain_tile_ref", True, A.grand_attention_bwd_ref)):
        with _b4_as(fn):
            _, ep, steps, sec = _fit(epochs, compute_dtype="float32", fast_train_attn_bwd=attn_bwd)
        runs[name] = steps
        yield _row(name, ep, steps, sec, step_losses=steps)
        torch.cuda.empty_cache() if DEVICE == "cuda" else None
    off = runs.pop("f32_attn_bwd_off")
    for name, steps in runs.items():
        split = first_split(steps, off)
        rel = [abs(x - y) / abs(y) for x, y in zip(steps, off)]
        yield dict(run=f"{name}_vs_off", first_split_step=split, split_rel=SPLIT_REL,
                   max_rel_before_split=max(rel[:split] or [0.0]) if split is not None
                   else max(rel),
                   losses_at_split=None if split is None else [steps[split], off[split]],
                   rel_at_steps={str(k): rel[k] for k in (0, 1, 10, 50, 127, 255) if k < len(rel)})


def swaps(epochs=3):
    """bfloat16 with the kernels, without attn_bwd, and with B4 replaced by
    each of its two plain formulas."""
    from diff3dhpe_torch.ops import attention as A

    for name, attn_bwd, fn in (("bf16_attn_bwd_kernels", True, None),
                               ("bf16_attn_bwd_off", False, None),
                               ("bf16_b4_plain_tile_ref", True, A.grand_attention_bwd_ref),
                               ("bf16_b4_plain_xla", True, A.grand_attention_bwd_xla)):
        with _b4_as(fn):
            _, ep, steps, sec = _fit(epochs, compute_dtype="bfloat16",
                                     fast_train_attn_bwd=attn_bwd)
        yield _row(name, ep, steps, sec, step_losses=steps)
        torch.cuda.empty_cache() if DEVICE == "cuda" else None


def seeds(epochs=3, *offsets):
    """Replicates at the study's seed plus each offset: bfloat16 with B4's
    kernel, its plain tile version, without attn_bwd, and the kernel's
    gradients copied into fresh contiguous tensors."""
    from diff3dhpe_torch.config import Config
    from diff3dhpe_torch.ops import attention as A

    base, kernel = Config().seed, A._bwd
    copied = lambda q, k, v, do, scale, fwd=None: tuple(
        g.contiguous().clone() for g in kernel(q, k, v, do, scale, fwd))
    for off in offsets or (1, 2):
        for name, attn_bwd, fn in (("bf16_attn_bwd_kernels", True, None),
                                   ("bf16_b4_plain_tile_ref", True, A.grand_attention_bwd_ref),
                                   ("bf16_attn_bwd_off", False, None),
                                   ("bf16_b4_kernel_copied", True, copied)):
            with _b4_as(fn, with_stats=fn is copied):
                _, ep, steps, sec = _fit(epochs, compute_dtype="bfloat16",
                                         fast_train_attn_bwd=attn_bwd, seed=base + off)
            yield _row(name, ep, steps, sec, seed=base + off, step_losses=steps)
            torch.cuda.empty_cache() if DEVICE == "cuda" else None


def hybrids(epochs=3, *offsets):
    """bf16 runs with B4's dq from the kernel and dk, dv from the plain tile
    version, and the other way round, at the study's seed plus each offset
    (default 0, 1, 2): which output of the kernel the training feels."""
    from diff3dhpe_torch.config import Config
    from diff3dhpe_torch.ops import attention as A

    base, kernel = Config().seed, A._bwd

    def mixed(which):
        def bwd(q, k, v, do, scale, fwd=None):
            got = kernel(q, k, v, do, scale, fwd)
            ref = A.grand_attention_bwd_ref(q, k, v, do, scale)
            return tuple(g if use_kernel else r for g, r, use_kernel in zip(got, ref, which))
        return bwd

    for off in offsets or (0, 1, 2):
        for name, which in (("bf16_dq_kernel_dkdv_tile", (True, False, False)),
                            ("bf16_dq_tile_dkdv_kernel", (False, True, True))):
            with _b4_as(mixed(which), with_stats=True):
                _, ep, steps, sec = _fit(epochs, compute_dtype="bfloat16",
                                         fast_train_attn_bwd=True, seed=base + off)
            yield _row(name, ep, steps, sec, seed=base + off, step_losses=steps)
            torch.cuda.empty_cache() if DEVICE == "cuda" else None


def trace(epochs=2, every=16):
    """The bf16 run with B4's kernel and with its plain tile version (the
    study's seed), every ``every`` steps: the temporal blocks' qkv bias by
    part (the norms of q, k and v's; k's and v's gradients are zero in
    exact arithmetic, since softmax ignores a shift of a row's scores and
    P·v − v a shift of v), the norms of those two gradient parts, and the
    largest |q·kᵀ·d^-½| of the step's temporal attention."""
    from diff3dhpe_torch.engine import runner as R
    from diff3dhpe_torch.ops import attention as A

    kernel = A._bwd
    for name, patch in (("bf16_attn_bwd_kernels", None),
                        ("bf16_b4_plain_tile_ref", A.grand_attention_bwd_ref)):
        cfg, train_ds, val_ds = _study(epochs, compute_dtype="bfloat16", fast_train_attn_bwd=True)
        runner = R.Runner(cfg, 17, train_ds.joints_left, train_ds.joints_right, device=DEVICE)
        c = cfg.embed_dim
        smax, rows, step_no = [], [], [0]

        def scoring(q, k, v, do, scale, fwd=None):
            if step_no[0] % every == 0:
                s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
                smax.append((step_no[0], s.abs().amax()))
            if patch is None:
                return kernel(q, k, v, do, scale, fwd)
            return patch(q, k, v, do, scale)

        make = R.make_train_step

        def recording(*a, **kw):
            step = make(*a, **kw)

            def train_step(*sa, **skw):
                loss = step(*sa, **skw)
                if step_no[0] % every == 0:
                    row = [loss]
                    for blk in runner.model.TTEblocks:
                        bias, grad = blk.attn.qkv.bias, blk.attn.qkv.bias.grad
                        row += [bias[:c].norm(), bias[c:2 * c].norm(), bias[2 * c:].norm(),
                                grad[c:2 * c].norm(), grad[2 * c:].norm(), grad[:c].norm()]
                    rows.append((step_no[0], torch.stack([r.float() for r in row])))
                step_no[0] += 1
                return loss

            return train_step

        A._bwd, R.make_train_step = scoring, recording
        t0 = time.time()
        try:
            with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
                ep = runner.fit(train_ds, val_ds)["losses_train"]
        finally:
            A._bwd, R.make_train_step = kernel, make
        by_step = {}
        for s, m in smax:
            by_step[s] = max(by_step.get(s, 0.0), m.item())
        table = [[s] + [float(f"{x:.4g}") for x in r.cpu().tolist()] for s, r in rows]
        yield dict(run=f"trace_{name}", epoch_losses=ep, seconds=round(time.time() - t0, 1),
                   columns="step, loss, then per temporal block: |b_q|, |b_k|, |b_v|, "
                           "|g_bk|, |g_bv|, |g_bq|",
                   max_score_by_step=by_step, table=table)
        del runner
        torch.cuda.empty_cache() if DEVICE == "cuda" else None


def _exact_bwd(q, k, v, do, scale):
    """(dq, dk, dv) in float64 from the operands' values: the exact
    gradients that every rounding of B4 and its plain versions departs from."""
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    p = torch.softmax(qd @ kd.transpose(-1, -2) * scale, dim=-1)
    dp = dod @ vd.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    return ds @ kd, ds.transpose(-1, -2) @ qd, p.transpose(-1, -2) @ dod - dod


def _tile_exact_bwd(q, k, v, do, scale):
    """B4 with the plain tile version's rounding points and no other
    rounding: S, P, dP and their row sum in float64, dS and P rounded once
    to q's dtype, each product then formed in float64 from those values
    and rounded once to q's dtype, in ``grand_attention_bwd_ref``'s order."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dt = q.dtype
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    p = torch.softmax(qd @ kd.transpose(-1, -2) * scale, dim=-1)
    dp = dod @ vd.transpose(-1, -2)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dt).double()
    pq = p.to(dt).double()
    return ((ds @ kd).to(dt), (ds.transpose(-1, -2) @ qd).to(dt),
            (pq.transpose(-1, -2) @ dod - dod).to(dt))


def exact(epochs=3, *offsets):
    """bf16 training with B4 := ``_tile_exact_bwd`` at the study's seed plus
    each offset (default 0 to 5, the seeds of the ``seeds`` replicates and
    the study's own)."""
    from diff3dhpe_torch.config import Config

    base = Config().seed
    for off in offsets or range(6):
        with _b4_as(_tile_exact_bwd):
            _, ep, steps, sec = _fit(epochs, compute_dtype="bfloat16", fast_train_attn_bwd=True,
                                     seed=base + off)
        yield _row("bf16_b4_tile_exact", ep, steps, sec, seed=base + off, step_losses=steps)
        torch.cuda.empty_cache() if DEVICE == "cuda" else None


def lowlr(epochs=3, *offsets):
    """bf16 training at lr 2e-4 with B4's kernel and with its plain tile
    version, at the study's seed plus each offset (default 0, 1, 2)."""
    from diff3dhpe_torch.config import Config
    from diff3dhpe_torch.ops import attention as A

    base = Config().seed
    for off in offsets or (0, 1, 2):
        for name, fn in (("bf16_lr2e-4_attn_bwd_kernels", None),
                         ("bf16_lr2e-4_b4_plain_tile_ref", A.grand_attention_bwd_ref)):
            with _b4_as(fn):
                _, ep, steps, sec = _fit(epochs, compute_dtype="bfloat16",
                                         fast_train_attn_bwd=True, seed=base + off,
                                         learning_rate=2e-4)
            yield _row(name, ep, steps, sec, seed=base + off, learning_rate=2e-4,
                       step_losses=steps)
            torch.cuda.empty_cache() if DEVICE == "cuda" else None


def _rel(a, exact):
    return ((a.double() - exact).norm() / exact.norm()).item()


def calls(epochs=2):
    """Every B4 call of one training step at the weights after ``epochs``
    epochs of the bf16 run with the kernels: the kernel (from B3's
    statistics and alone), the plain tile version and the XLA formulas,
    each against the float64 gradients of the same operands (relative L2
    error of dq, dk and dv, the whole call and each 64-row tile of the
    rows it reduces over), and B3's output against float64 likewise."""
    from diff3dhpe_torch.ops import attention as A

    runner, ep, _, sec = _fit(epochs, compute_dtype="bfloat16", fast_train_attn_bwd=True)
    cfg = runner.cfg
    _, train_ds, _ = _study(epochs)
    b = next(iter(train_ds.batches(cfg.batch_size, shuffle=False, drop_last=True)))
    gt, x2d = (torch.as_tensor(a, device=DEVICE) for a in (b.gt_3d_norm, b.input_2d))
    bwd, fullseq = A._bwd, A._fullseq
    rows = []

    def checked_fullseq(q, k, v, scale, stats=None):
        out = fullseq(q, k, v, scale, stats)
        if stats is not None:
            s = q.shape[-1] ** -0.5
            qd, kd, vd = (t.double() for t in (q, k, v))
            exact = torch.softmax(qd @ kd.transpose(-1, -2) * s, dim=-1) @ vd - vd
            rows.append(dict(kind="b3", kernel=_rel(out, exact),
                             plain=_rel(A.grand_attention_fullseq_ref(q, k, v), exact)))
        return out

    def checked_bwd(q, k, v, do, scale, fwd=None):
        got = bwd(q, k, v, do, scale, fwd)
        s = q.shape[-1] ** -0.5 if scale is None else scale
        exact = _exact_bwd(q, k, v, do, s)
        others = dict(alone=bwd(q, k, v, do, scale, None),
                      plain_tile=A.grand_attention_bwd_ref(q, k, v, do, scale),
                      plain_xla=A.grand_attention_bwd_xla(q, k, v, do, scale))
        n = q.shape[-2]
        row = dict(kind="b4", smax=((q.float() @ k.float().transpose(-1, -2)) * s).abs().max()
                   .item(), n=n, groups=q.shape[0] * (q.shape[1] if q.ndim == 4 else 1))
        for name, g in dict(kernel=got, **others).items():
            row[name] = [_rel(a, e) for a, e in zip(g, exact)]
        # By 64-row tile of the rows each gradient's sum runs over: dq by
        # query tile, dk and dv by key tile.
        row["kernel_by_tile"] = [[_rel(a[..., i:i + 64, :], e[..., i:i + 64, :])
                                  for i in range(0, n, 64)] for a, e in zip(got, exact)]
        row["plain_by_tile"] = [[_rel(a[..., i:i + 64, :], e[..., i:i + 64, :])
                                 for i in range(0, n, 64)]
                                for a, e in zip(others["plain_tile"], exact)]
        row["same_bits_alone"] = all(torch.equal(a, c) for a, c in zip(got, others["alone"]))
        # Where the kernel and the plain tile version differ: the share of
        # elements, the rows (along n) with the largest share, and the mean
        # signed difference over the mean |plain|.
        row["kernel_vs_tile"] = []
        for a, c in zip(got, others["plain_tile"]):
            differs = (a != c).flatten(0, -3).float().mean(dim=(0, 2))  # [n]
            top = torch.topk(differs, 5)
            row["kernel_vs_tile"].append(dict(
                share=(a != c).float().mean().item(),
                top_rows=[[int(i), round(float(x), 4)] for x, i in zip(top.values, top.indices)],
                signed=((a.float() - c.float()).mean() / c.float().abs().mean()).item()))
        rows.append(row)
        return got

    from diff3dhpe_torch.models.fast_eval import draw_drop_path_scales

    g = torch.Generator(DEVICE).manual_seed(5)
    bs, f, j = gt.shape[:3]
    draws = dict(t=torch.randint(0, 1000, (bs,), generator=g, device=DEVICE),
                 noise=torch.randn(bs, f, j, 3, generator=g, device=DEVICE),
                 dp_scales=draw_drop_path_scales(g, bs, cfg.transformer_depth, 0.1, f, j))
    A._bwd, A._fullseq = checked_bwd, checked_fullseq
    try:
        runner.train_diffusion.training_loss(gt, x2d, **draws).backward()
    finally:
        A._bwd, A._fullseq = bwd, fullseq
    yield dict(run="calls", epochs_trained=epochs, epoch_losses=ep, seconds=round(sec, 1),
               b4_calls=sum(r["kind"] == "b4" for r in rows),
               b3_calls=sum(r["kind"] == "b3" for r in rows))
    for r in rows:
        yield dict(run="call", **r)


def _step_grads(model, fn, batch, draws):
    from diff3dhpe_torch import GaussianDiffusion

    model.zero_grad(set_to_none=True)
    diffusion = GaussianDiffusion.create(fn, timesteps=1000, clip_denoised=True, clip_loss=True)
    loss = diffusion.training_loss(*batch, **draws)
    loss.backward()
    return loss.item(), {n: p.grad.float().clone() for n, p in model.named_parameters()}


def grads(epochs=2):
    """Gradients at the weights after ``epochs`` epochs of the stalling run."""
    from diff3dhpe_torch import (
        MixSTEDenoiser, make_fast_train_denoise_fn, make_train_denoise_fn,
    )
    from diff3dhpe_torch.models.fast_eval import draw_drop_path_scales
    from diff3dhpe_torch.ops import attention as A

    runner, ep, _, sec = _fit(epochs, compute_dtype="bfloat16", fast_train_attn_bwd=True)
    cfg = runner.cfg
    state = {k: v.detach().clone() for k, v in runner.model.state_dict().items()}
    del runner
    torch.cuda.empty_cache() if DEVICE == "cuda" else None
    model = MixSTEDenoiser(num_frame=cfg.number_of_frames, embed_dim=cfg.embed_dim,
                           depth=cfg.transformer_depth, num_heads=HEADS, seed=0,
                           device=DEVICE).train()
    model.load_state_dict(state, strict=True)
    _, train_ds, _ = _study(epochs)
    b = next(iter(train_ds.batches(cfg.batch_size, shuffle=False, drop_last=True)))
    batch = tuple(torch.as_tensor(a, device=DEVICE) for a in (b.gt_3d_norm, b.input_2d))
    g = torch.Generator(DEVICE).manual_seed(5)
    bs, f, j = batch[0].shape[:3]
    draws = dict(t=torch.randint(0, 1000, (bs,), generator=g, device=DEVICE),
                 noise=torch.randn(bs, f, j, 3, generator=g, device=DEVICE),
                 dp_scales=draw_drop_path_scales(g, bs, cfg.transformer_depth, 0.1, f, j))

    smax = []
    bwd = A._bwd

    def scoring(q, k, v, do, scale, fwd=None):
        s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
        smax.append(s.abs().max().item())
        return bwd(q, k, v, do, scale, fwd)

    loss_ref, ref = _step_grads(model, make_train_denoise_fn(model, 0.1), batch, draws)
    row = dict(run="grads", epochs_trained=epochs, epoch_losses=ep, seconds=round(sec, 1),
               loss_plain_f32=loss_ref)
    for name, kw in (("bf16_attn_bwd_on", dict(attn_bwd=True, dtype=torch.bfloat16)),
                     ("bf16_attn_bwd_off", dict(attn_bwd=False, dtype=torch.bfloat16)),
                     ("f32_attn_bwd_on", dict(attn_bwd=True))):
        A._bwd = scoring
        try:
            loss, got = _step_grads(model, make_fast_train_denoise_fn(model, 0.1, **kw),
                                    batch, draws)
        finally:
            A._bwd = bwd
        per = {}
        for n, r in ref.items():
            d, gn = got[n] - r, got[n]
            rn = r.norm().item()
            per[n] = dict(rel_l2=d.norm().item() / max(rn, 1e-30),
                          cos=(gn * r).sum().item() / max(gn.norm().item() * rn, 1e-30))
        flat_g = torch.cat([got[n].flatten() for n in ref])
        flat_r = torch.cat([r.flatten() for r in ref.values()])
        worst = sorted(per.items(), key=lambda kv: -kv[1]["rel_l2"])[:5]
        rels = sorted(v["rel_l2"] for v in per.values())
        row[name] = dict(
            loss=loss, tensors=len(per), median_rel_l2=rels[len(rels) // 2],
            all_rel_l2=((flat_g - flat_r).norm() / flat_r.norm()).item(),
            all_cos=(torch.dot(flat_g, flat_r) / (flat_g.norm() * flat_r.norm())).item(),
            min_cos=min(v["cos"] for v in per.values()),
            worst5=[dict(name=n, **{k: round(x, 6) for k, x in v.items()}) for n, v in worst])
    row["max_score"] = max(smax) if smax else None
    yield row


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    out = None
    if "--out" in argv:
        i = argv.index("--out")
        out = argv[i + 1]
        del argv[i:i + 2]
    from diff3dhpe_torch.device import resolve_device

    resolve_device(DEVICE)
    phases = dict(control=control, swaps=swaps, seeds=seeds, hybrids=hybrids, trace=trace,
                  exact=exact, lowlr=lowlr, grads=grads, calls=calls)
    if not argv or argv[0] not in phases:
        raise SystemExit(__doc__)
    rows = []
    for row in phases[argv[0]](*map(int, argv[1:])):
        rows.append(row)
        short = {k: v for k, v in row.items() if k != "step_losses"}
        print(json.dumps(short), flush=True)
        if any(isinstance(x, float) and not math.isfinite(x) for x in row.get("epoch_losses", [])):
            print(json.dumps(dict(warning=f"{row['run']}: a non-finite epoch loss")), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(rows, f)
    return rows


if __name__ == "__main__":
    main()
