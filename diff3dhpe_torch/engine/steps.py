"""Train and eval step factories.

Port of ``diff3dhpe_tpu/engine/steps.py``:

- train step (reference epoch-loop body, run.py:322-347; the JAX
  single-device branch): loss = mean(p_losses), one AdamW step with the
  per-epoch exponential lr decay as a step schedule;
- eval step (reference evaluate():557-596): the flipped copy of the 2D
  input rides the same batch through ONE sampling pass ([x2d; x2d_flip]);
  the second half is un-flipped with a joint permutation and the two are
  averaged;
- val step (reference run.py:364-403): the eval step's prediction and the
  mean ``p_losses`` of both orientations, without autograd.

Each factory takes ``mesh``, a ``parallel.DataMesh`` (JAX: the mesh's
``data`` axis, :216-314, :327-428, :437-469); None keeps the
single-process step. With one, the step takes the global batch, and every
rank draws what the single process draws (t, noise, drop-path scales, x_T,
the per-step noise) for the global batch, in the same order, then keeps
its rows: the step computes the same thing at every world size. Under a
``model`` axis (``parallel.tensor``) the rows are the data rank's, which
the ranks of one model group compute together, and the sums and gathers
run over the data group; the fused training step there runs on whole
weights gathered from the shards (``make_train_step``'s ``whole``). JAX's
``shard_map`` fast train draws per shard instead (``fold_in(key,
axis_index)``); tests reproduce that by injecting its draws.

The denoiser factories take ``matmul_precision``, the session precision
that JAX's Runner sets (``Config.matmul_precision``;
``ops.matmul_precision``): the float32 products outside the fused kernels,
and every float32 product of the plain module and of the training
recompute, contract at it. The train, eval and val steps contract nothing
themselves: they run the denoiser their diffusion holds.
"""
from __future__ import annotations

import warnings
from typing import Callable, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from diff3dhpe_torch.device import resolve_device
from diff3dhpe_torch.diffusion.gaussian_diffusion import GaussianDiffusion
from diff3dhpe_torch.models.fast_eval import (
    bf16_snapshot,
    check_fused,
    draw_drop_path_scales,
    fast_forward_denoise,
    fast_forward_denoise_train,
    fast_forward_denoise_train_pairs,
)
from diff3dhpe_torch.models.mixste import draw_dropout_masks
from diff3dhpe_torch.parallel.tensor import shard_dropout_masks


def make_denoise_fn(model, matmul_precision: str = "highest") -> Callable:
    """denoise_fn(x, t) through the plain PyTorch module (the parity path),
    without autograd, its float32 products at ``matmul_precision``. It also
    takes ``p_losses``'s keywords, as the validation loss calls it:
    ``dp_scales`` (None: no drop-path) and ``generator``, which it does not
    draw from."""

    @torch.no_grad()
    def denoise_fn(x, t, *, dp_scales=None, generator=None):
        return model(x, t, dp_scales, matmul_precision)

    return denoise_fn


def make_fast_denoise_fn(model, dtype=torch.float32, temporal_mode: str = "rows",
                         f32_head: bool = False, f32_tail_pairs: int = 0,
                         f32_prec: str = "highest",
                         matmul_precision: str = "highest") -> Callable:
    """denoise_fn(x, t) through the fused-block forward
    (``models.fast_eval.fast_forward_denoise``), JAX ``make_fast_denoise_fn``.

    ``dtype``: float32 (the function reads ``model``'s weights as they are
    at each call) or bfloat16, where the function holds a snapshot of the
    weights taken when it is made (``bf16_snapshot``: the bf16 copies are
    made once, not on every call; later changes to ``model`` are not seen).
    ``temporal_mode``: "rows" or "cols". ``f32_head``: the head runs at
    float32 on the bf16 trunk's output, as in the mixed mode.
    ``f32_tail_pairs`` (bf16 only): the last this-many block pairs and the
    head run at float32 on ``model``'s own float32 weights, as they are at
    each call, while the pairs before them read the snapshot (JAX's
    precision tail). ``f32_prec`` pins the contraction mode of the fused
    blocks at float32, the float32 forward's or the tail's ("highest",
    "high3" or "default"; JAX's ``f32_prec``, :80-101), for this function
    alone; the port reads no mode from the environment.
    ``matmul_precision``: the session precision of the float32 products
    outside the fused blocks. A module with ``qk_scale`` or dropout is
    refused (``models.fast_eval.check_fused``)."""
    check_fused(model)
    bf16 = dtype == torch.bfloat16
    weights = bf16_snapshot(model, f32_head) if bf16 else model
    tail = f32_tail_pairs if bf16 else 0

    def denoise_fn(x, t):
        return fast_forward_denoise(weights, x, t, dtype=dtype, temporal_mode=temporal_mode,
                                    f32_head=f32_head, f32_tail_pairs=tail, f32_model=model,
                                    f32_prec=f32_prec, matmul_precision=matmul_precision)

    return denoise_fn


def make_mixed_diffusion(model, temporal_mode: str = "rows", f32_tail_pairs: int = 0,
                         f32_prec: str = "highest", matmul_precision: str = "highest",
                         **diffusion_kw) -> GaussianDiffusion:
    """The JAX package's default eval (``bench.py`` DTYPE="mixed", :101-135):
    a bf16 trunk with an f32 head for the DDIM steps, and the f32 fused
    forward for the last one, or with ``f32_tail_pairs`` > 0 a bf16 forward
    whose last that-many block pairs and head run at f32 (``bench.py``
    TAIL_PAIRS, :119-127). ``f32_prec`` is the contraction mode of the f32
    parts of that final step: JAX's bench runs them at "high3"
    (``BENCH_FINAL_PREC``), as does the runner (``Config.eval_final_prec``).
    ``matmul_precision``: the session precision of the float32 products
    outside the fused blocks (the f32 heads, the final step's dense
    layers). ``diffusion_kw`` go to ``GaussianDiffusion.create``."""
    prec = dict(f32_prec=f32_prec, matmul_precision=matmul_precision)
    if f32_tail_pairs > 0:
        final = make_fast_denoise_fn(model, torch.bfloat16, temporal_mode, f32_head=True,
                                     f32_tail_pairs=f32_tail_pairs, **prec)
    else:
        final = make_fast_denoise_fn(model, torch.float32, temporal_mode, **prec)
    return GaussianDiffusion.create(
        make_fast_denoise_fn(model, torch.bfloat16, temporal_mode, f32_head=True,
                             matmul_precision=matmul_precision),
        final_denoise_fn=final, final_denoise_steps=1, **diffusion_kw,
    )


def _train_denoise_fn(model, drop_path_rate, forward):
    """denoise_fn(x, t, *, dp_scales=None, generator=None) for training:
    ``forward(x, t, dp_scales)``, with the drop-path scales drawn from the
    generator when they are not given (neither: no drop-path), and after
    them, where the module drops, its dropout masks (``dp_scales``' third
    entry, ``models.mixste.draw_dropout_masks``)."""

    def draw_dp_scales(generator, batch, num_frame, num_joints):
        dp = draw_drop_path_scales(generator, batch, model.depth, drop_path_rate, num_frame,
                                   num_joints)
        masks = draw_dropout_masks(model, generator, batch, num_frame, num_joints)
        return dp if masks is None else (*dp, masks)

    def denoise_fn(x, t, *, dp_scales=None, generator=None):
        if dp_scales is None and generator is not None:
            dp_scales = draw_dp_scales(generator, x.shape[0], x.shape[1], x.shape[2])
        return forward(x, t, dp_scales)

    # The data-parallel train step draws the global batch's scales itself.
    denoise_fn.draw_dp_scales = draw_dp_scales
    return denoise_fn


def make_fast_train_denoise_fn(model, drop_path_rate: float = 0.1, attn_bwd: bool = False,
                               temporal_mode: str = "rows", dtype=torch.float32,
                               pair_vjp: bool = True, ckpt_blocks: bool = False,
                               matmul_precision: str = "highest") -> Callable:
    """Training denoise_fn on the fused forward in ``dtype`` (float32 or
    bfloat16) with a recompute backward, JAX ``make_fast_train_denoise_fn``
    (:108-175): ``pair_vjp`` the pair-boundary backward
    (``models.fast_eval.fast_forward_denoise_train_pairs``), else the
    monolithic one (``fast_forward_denoise_train``), whose recompute
    ``ckpt_blocks`` checkpoints block by block; with ``pair_vjp`` the flag
    has nothing to act on and a warning says so, as JAX's does.
    ``attn_bwd``: the recompute's attention runs through
    ``grand_attention_trainable`` (its kernels on CUDA). ``temporal_mode``:
    the fused forward's temporal layout, "rows" or "cols" (B2).
    ``matmul_precision``: the session precision of the float32 products
    outside the fused blocks and of the recompute, forward and backward.
    A module with ``qk_scale`` or dropout is refused
    (``models.fast_eval.check_fused``)."""
    check_fused(model)
    if pair_vjp and ckpt_blocks:
        warnings.warn(
            "ckpt_blocks has no effect when pair_vjp=True (the pair backward already "
            "recomputes one pair at a time); set pair_vjp=False to use the "
            "per-block-checkpointed monolithic backward", stacklevel=2)

    def forward(x, t, dp):
        if pair_vjp:
            return fast_forward_denoise_train_pairs(model, x, t, dp, attn_bwd, temporal_mode,
                                                    dtype, matmul_precision)
        return fast_forward_denoise_train(model, x, t, dp, attn_bwd, temporal_mode, dtype,
                                          ckpt_blocks, matmul_precision)

    return _train_denoise_fn(model, drop_path_rate, forward)


def make_train_denoise_fn(model, drop_path_rate: float = 0.1, remat: bool = False,
                          matmul_precision: str = "highest") -> Callable:
    """The plain counterpart: the module under ordinary autograd, with the
    same drop-path scales, its float32 products at ``matmul_precision``
    forward and backward. ``remat``: the whole forward is recomputed in the
    backward (``checkpoint``; JAX ``make_denoise_fn(remat=True)``,
    ``Config.remat_mode="whole"``); the module's own ``remat_blocks`` is the
    per-block form."""

    def forward(x, t, dp):
        if remat and torch.is_grad_enabled():
            return checkpoint(model, x, t, dp, matmul_precision, use_reentrant=False)
        return model(x, t, dp, matmul_precision)

    return _train_denoise_fn(model, drop_path_rate, forward)


def make_optimizer(params, learning_rate: float, lr_decay: float, steps_per_epoch: int,
                   weight_decay: float = 0.1):
    """(AdamW, LambdaLR): optax's adamw as JAX ``make_optimizer`` builds it
    (β 0.9/0.999, eps 1e-8 outside the square root, decoupled weight decay
    on every parameter) with lr = learning_rate · lr_decay^(step //
    steps_per_epoch) for the update of step ``step`` (from 0)."""
    opt = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    spe = max(steps_per_epoch, 1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: lr_decay ** (step // spe))
    return opt, sched


def _global_train_draws(diffusion, gt_3d_norm, input_2d, generator, t, noise, dp_scales):
    """t, noise and the drop-path scales of a global batch, each drawn from
    ``generator`` where not given, in the order the single-process step
    draws them (``p_losses``, then its denoiser)."""
    t, noise = diffusion.loss_draws(gt_3d_norm, t=t, noise=noise, generator=generator)
    draw = getattr(diffusion.denoise_fn, "draw_dp_scales", None)
    if dp_scales is None and generator is not None and draw is not None:
        dp_scales = draw(generator, input_2d.shape[0], input_2d.shape[1], input_2d.shape[2])
    return t, noise, dp_scales


def _local_draws(dp_scales, rows, mesh):
    """The rank's part of a global batch's drop-path scales (and dropout
    masks): its rows, and its model rank's part of each mask."""
    local = [None if d is None else d[:, rows] for d in dp_scales[:2]]
    if len(dp_scales) > 2:
        local.append(shard_dropout_masks({k: m[:, rows] for k, m in dp_scales[2].items()}, mesh))
    return tuple(local)


def make_train_step(diffusion: GaussianDiffusion, optimizer, scheduler=None, mesh=None,
                    whole=None):
    """Returns train_step(gt_3d_norm, input_2d, *, generator=None, t=None,
    noise=None, dp_scales=None) -> loss (a detached scalar tensor): one
    AdamW step on mean(p_losses) over the parameters ``optimizer`` holds.
    t, noise and the drop-path scales are drawn from ``generator`` where
    they are not given.

    With ``mesh``: the inputs and the draws (given or drawn) are those of
    the global batch, which must divide the data ranks (else a ValueError,
    "does not divide"); each rank runs its rows (``DataMesh.rows``; the
    drop-path scales [depth, B, ...] and the dropout masks on their axis 1;
    under a model axis the masks' heads and hidden columns of the model
    rank, ``parallel.tensor.shard_dropout_masks``), then the gradients
    and the loss are averaged over the data ranks after the backward in one
    all-reduce (JAX's ``pmean``), and every rank takes the same AdamW step.
    The gradients are averaged explicitly: the fused train forward is no
    module ``forward``, so a ``DistributedDataParallel`` wrapper would
    leave them unreduced.

    ``whole``: a ``parallel.tensor.WholeWeights`` where ``diffusion``'s
    denoiser runs whole weights under a model axis > 1 (the fused training
    forward, on ``whole.replica``) while ``optimizer`` holds the rank's
    shards: before every forward the replica is loaded with the gathered
    shards, and after the backward each shard takes its slice of the whole
    gradient; AdamW then steps the shards."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def train_step(gt_3d_norm, input_2d, *, generator=None, t=None, noise=None, dp_scales=None):
        optimizer.zero_grad(set_to_none=True)
        if whole is not None:
            whole.load()
        if mesh is not None:
            rows = mesh.rows(gt_3d_norm.shape[0])
            t, noise, dp_scales = _global_train_draws(diffusion, gt_3d_norm, input_2d, generator,
                                                      t, noise, dp_scales)
            gt_3d_norm, input_2d, t, noise = (a[rows] for a in (gt_3d_norm, input_2d, t, noise))
            if dp_scales is not None:
                dp_scales = _local_draws(dp_scales, rows, mesh)
            generator = None  # every draw is made
        loss = diffusion.training_loss(gt_3d_norm, input_2d, t=t, noise=noise,
                                       generator=generator, dp_scales=dp_scales)
        loss.backward()
        if whole is not None:
            whole.shard_grads_()
        if mesh is not None:
            loss = mesh.average_grads_(params, loss)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss.detach()

    return train_step


def flip_pose(pose, joints_left: Sequence[int], joints_right: Sequence[int]):
    """Negate x and swap left/right joints: [..., J, C] -> [..., J, C]."""
    perm = list(range(pose.shape[-2]))
    for a, b in zip(joints_left, joints_right):
        perm[a], perm[b] = b, a
    sign = torch.ones(pose.shape[-1], dtype=pose.dtype, device=pose.device)
    sign[0] = -1.0
    return (pose * sign)[..., perm, :]


def make_eval_step(
    diffusion: GaussianDiffusion,
    joints_left: Sequence[int],
    joints_right: Sequence[int],
    repeat_n: int = 1,
    tta: bool = True,
    device="cuda",
    mesh=None,
):
    """Returns eval_step(input_2d, input_2d_flip, *, x_init=None,
    generator=None, noises=None) -> predicted_3d_norm [B, F_out, J, 3] on
    ``device``.

    With ``tta`` the batch is doubled: ``x_init`` (x_T) then has
    2 * B * repeat_n rows, ordered [hypothesis][normal | flipped][row], as
    has each step of ``noises`` (the per-step noise where
    ddim_sampling_eta > 0, ``GaussianDiffusion.ddim_sample_loop``).
    ``tta=False`` runs a single pass and ignores ``input_2d_flip``
    (reference run.py:577-587).

    With ``mesh`` the inputs, x_T and ``noises`` (given or drawn from
    ``generator`` up front, in the single-process order) are the global
    batch's, which must divide the ranks (else a ValueError, "does not
    divide"); each rank samples its rows (``DataMesh.shard``: rows h·2B +
    s·B + [r·b, (r+1)·b) of x_T) and the prediction is gathered back in
    global order on every rank."""
    device = resolve_device(device)
    jl, jr = list(joints_left), list(joints_right)
    if len(jl) != len(jr):
        raise ValueError("joints_left and joints_right must pair up")

    def eval_step(input_2d, input_2d_flip, *, x_init=None, generator=None, noises=None):
        input_2d = torch.as_tensor(input_2d, dtype=torch.float32, device=device)
        x_init, noises = (None if a is None else torch.as_tensor(a, dtype=torch.float32,
                                                                 device=device)
                          for a in (x_init, noises))
        if mesh is None:
            return local_step(input_2d, input_2d_flip, x_init, generator, noises)
        b, f, j, _ = input_2d.shape
        rows = mesh.rows(b)
        shape = (b * repeat_n * (2 if tta else 1), f if diffusion.mode == "s2s" else 1, j, 3)
        if x_init is None and generator is not None:
            x_init = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        if diffusion.ddim_sampling_eta and noises is None and generator is not None:
            noises = diffusion.ddim_noises(shape, generator, device)
        x_init = None if x_init is None else mesh.shard(x_init, b)
        noises = None if noises is None else mesh.shard(noises, b, dim=1)
        flip = None if input_2d_flip is None else torch.as_tensor(
            input_2d_flip, dtype=torch.float32, device=device)[rows]
        return mesh.gather_rows(local_step(input_2d[rows], flip, x_init, generator, noises))

    def local_step(input_2d, input_2d_flip, x_init, generator, noises):
        b, f, j, _ = input_2d.shape
        f_out = f if diffusion.mode == "s2s" else 1
        if not tta:
            return diffusion.estimate_pose(input_2d, (b, f_out, j, 3), repeat_n=repeat_n,
                                           x_init=x_init, generator=generator, noises=noises)
        input_2d_flip = torch.as_tensor(input_2d_flip, dtype=torch.float32, device=device)
        both = torch.cat([input_2d, input_2d_flip], dim=0)
        pred = diffusion.estimate_pose(both, (2 * b, f_out, j, 3), repeat_n=repeat_n,
                                       x_init=x_init, generator=generator, noises=noises)
        return (pred[:b] + flip_pose(pred[b:], jl, jr)) / 2.0

    return eval_step


def make_val_step(
    diffusion: GaussianDiffusion,
    joints_left: Sequence[int],
    joints_right: Sequence[int],
    sample_diffusion: GaussianDiffusion = None,
    tta: bool = True,
    device="cuda",
    mesh=None,
):
    """End-of-epoch validation (JAX ``make_val_step``; reference
    run.py:364-403), without autograd. Returns val_step(gt_3d_norm,
    input_2d, input_2d_flip, *, generator=None, x_init=None, losses=None)
    -> (pred_norm, loss): the flip-TTA prediction of ``make_eval_step`` on
    ``sample_diffusion`` (default ``diffusion``; e.g. the fused eval), and
    the mean ``p_losses`` on ``diffusion`` of the batch and, with ``tta``,
    of its flipped copy, averaged. x_T, then t and noise of each
    orientation are drawn from ``generator`` in that order, unless given:
    ``x_init`` as ``make_eval_step`` takes it, ``losses`` as ((t, noise),
    (t_flip, noise_flip)).

    With ``mesh``: the eval step's (the prediction gathered on every
    rank), and each orientation's t and noise drawn (or given) for the
    global batch, in the single-process order, then sliced to the rank's
    rows; the loss is the mean over the ranks of their losses."""
    device = resolve_device(device)
    jl, jr = list(joints_left), list(joints_right)
    eval_step = make_eval_step(sample_diffusion or diffusion, jl, jr, tta=tta, device=device,
                               mesh=mesh)

    @torch.no_grad()
    def val_step(gt_3d_norm, input_2d, input_2d_flip, *, generator=None, x_init=None,
                 losses=None):
        as_tensor = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        gt_3d_norm, input_2d = as_tensor(gt_3d_norm), as_tensor(input_2d)
        pred = eval_step(input_2d, input_2d_flip, x_init=x_init, generator=generator)
        (t, noise), (t_flip, noise_flip) = losses or ((None, None), (None, None))
        inject = lambda a: None if a is None else torch.as_tensor(a, device=device)
        pairs = [(gt_3d_norm, input_2d, inject(t), inject(noise))]
        if tta:
            pairs.append((flip_pose(gt_3d_norm, jl, jr), as_tensor(input_2d_flip),
                          inject(t_flip), inject(noise_flip)))
        terms = []
        for gt, x2d, t, noise in pairs:
            if mesh is not None:
                t, noise = diffusion.loss_draws(gt, t=t, noise=noise, generator=generator)
                rows = mesh.rows(gt.shape[0])
                gt, x2d, t, noise = gt[rows], x2d[rows], t[rows], noise[rows]
            terms.append(diffusion.training_loss(gt, x2d, t=t, noise=noise, generator=generator))
        loss = terms[0] if len(terms) == 1 else 0.5 * (terms[0] + terms[1])
        return pred, loss if mesh is None else mesh.mean(loss)

    return val_step
