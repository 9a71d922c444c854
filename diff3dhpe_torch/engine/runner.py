"""Training and evaluation runner: the reference's epoch loop and
evaluation protocol (reference run.py:252-506 and evaluate:535-654) as a
reusable component on top of the train, val and eval steps.

Port of ``diff3dhpe_tpu/engine/runner.py``: model/diffusion assembly from
a ``Config``, the epoch loop (``fit``: train -> flip-TTA validation ->
logging -> periodic/best checkpoints -> early stop / max time, lr decay by
step), and the final per-action evaluation with Protocols #1/#2/#3 +
MPJVE and eval-throughput reporting.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from diff3dhpe_torch.config import Config
from diff3dhpe_torch.device import resolve_device, to_device
from diff3dhpe_torch.diffusion import GaussianDiffusion
from diff3dhpe_torch.engine.steps import (
    make_denoise_fn,
    make_eval_step,
    make_fast_denoise_fn,
    make_fast_train_denoise_fn,
    make_optimizer,
    make_train_denoise_fn,
    make_train_step,
    make_val_step,
)
from diff3dhpe_torch.io.checkpoint import (
    restore_checkpoint,
    rng_state_from_json,
    rng_state_to_json,
    save_checkpoint,
)
from diff3dhpe_torch.io.convert import state_dict_from_flax
from diff3dhpe_torch.metrics import mean_velocity_error, mpjpe, n_mpjpe, p_mpjpe
from diff3dhpe_torch.models import HPE_model
from diff3dhpe_torch.ops.attention import BWD_HEAD_DIMS, HEAD_DIM_RULE, MAX_N, takes_head_dim
from diff3dhpe_torch.ops.fused_block import F32_MODES, LN_MAX_C
from diff3dhpe_torch.ops.matmul_precision import check_matmul_precision
from diff3dhpe_torch.parallel import check_mesh_shape, parse_mesh_shape
from diff3dhpe_torch.parallel.tensor import (
    check_divisible,
    check_params_replicated,
    full_param_count,
    gather_optimizer_state,
    gather_params,
    shard_model,
    shard_optimizer_state,
    shard_params,
    WholeWeights,
)


class RunLogger:
    """Timestamped plain-text run logs, mirroring the reference's
    config_*/log_*/results_* files (reference run.py:136-138,209-214).
    ``echo``: the log and result lines are printed too (the ranks of a
    data-parallel run other than rank 0 neither write nor print)."""

    def __init__(self, checkpoint_dir: str, enabled: bool = True, echo: bool = True):
        self.enabled, self.echo = enabled, echo
        self.config_path = self.log_path = self.results_path = None
        if not enabled:
            return
        os.makedirs(checkpoint_dir, exist_ok=True)
        stamp = time.strftime("%Hh%Mm%Ss_on_%b_%d_%Y")
        self.config_path = os.path.join(checkpoint_dir, f"config_{stamp}.txt")
        self.log_path = os.path.join(checkpoint_dir, f"log_{stamp}.txt")
        self.results_path = os.path.join(checkpoint_dir, f"results_{stamp}.txt")

    def _write(self, path, text):
        if self.enabled:
            with open(path, "a") as f:
                f.write(text)

    def config(self, text):
        self._write(self.config_path, text)

    def log(self, text):
        if self.echo:
            print(text, end="" if text.endswith("\n") else "\n")
        self._write(self.log_path, text if text.endswith("\n") else text + "\n")

    def result(self, text):
        if self.echo:
            print(text, end="" if text.endswith("\n") else "\n")
        self._write(self.results_path, text if text.endswith("\n") else text + "\n")


def _refuse(cfg, field, why):
    raise ValueError(f"{field}={getattr(cfg, field)!r} is not ported: {why}")


def check_supported(cfg: Config, device="cpu", world_size: int = 1) -> None:
    """Raises ValueError, naming the field, for a configuration the JAX
    package runs and the port does not yet, or that this run's
    ``world_size`` ranks cannot take: ``mesh_shape`` "data:N,model:M" must
    have N·M = ``world_size`` ranks (unset: "data:``world_size``"), and a
    ``model`` axis M > 1 (tensor parallelism) must divide ``num_heads`` and
    the MLP's hidden width (the ValueError names ``num_heads`` or
    ``mlp_ratio``, and ``mesh_shape``). On a CUDA ``device``, where
    ``fast_eval`` or ``use_pallas_attention`` sends the attention through
    the kernels, also for a head width that they do not take (``num_heads``:
    they take head_dim a multiple of 8 from 8 to 128, float32 and bf16, at
    every contraction mode), for more frames than they hold keys a group
    (``number_of_frames`` above ``MAX_N``: the temporal attention keeps a
    whole score row resident); and, with ``fast_eval``,
    for an ``embed_dim`` wider than the block's LayerNorm kernel holds
    (``LN_MAX_C``: 2048 where a step runs float32, 4096 at bf16 alone). The
    CPU, and the plain module on either device, run every width and length.
    ``check_trainable`` adds what ``fit`` refuses.

    ``compute_dtype="bfloat16"`` builds the module at bf16 (flax's
    ``dtype``), with or without ``fast_eval`` and ``use_pallas_attention``.
    ``remat`` only chooses what the backward of training recomputes
    (diff3dhpe_tpu/models/mixste.py:262-279, engine/steps.py:33-60), so an
    evaluation with it computes what one without it computes."""
    refuse = lambda field, why: _refuse(cfg, field, why)
    check_mesh_shape(cfg.mesh_shape, world_size)
    model_axis = _model_axis(cfg, world_size)
    if model_axis > 1:
        check_divisible(cfg.num_heads, int(cfg.embed_dim * cfg.mlp_ratio), model_axis,
                        cfg.mesh_shape)
    check_matmul_precision(cfg.matmul_precision)
    bf16 = cfg.compute_dtype == "bfloat16"
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        refuse("compute_dtype", "float32 or bfloat16")
    if cfg.eval_f32_tail_pairs > 0 and not (cfg.fast_eval and bf16):
        refuse("eval_f32_tail_pairs", "the float32 tail splits the fused bf16 eval's final "
               "forward: it needs fast_eval and compute_dtype 'bfloat16'")
    if cfg.eval_f32_tail_pairs > 0 and cfg.eval_f32_final_steps <= 0:
        refuse("eval_f32_tail_pairs", "the float32 tail splits the final steps' forward, and "
               "eval_f32_final_steps is 0")
    if cfg.eval_final_prec not in F32_MODES:
        refuse("eval_final_prec", f"the float32 contraction modes are {F32_MODES}")
    if torch.device(device).type == "cuda" and (cfg.fast_eval or cfg.use_pallas_attention):
        _check_kernel_shapes(cfg)
    if torch.device(device).type == "cuda" and cfg.fast_eval:
        f32_steps = not bf16 or cfg.eval_f32_final_steps > 0
        widest = LN_MAX_C[torch.float32 if f32_steps else torch.bfloat16]
        if cfg.embed_dim > widest:
            refuse("embed_dim", f"the CUDA LayerNorm of the fused blocks takes rows of up to "
                   f"{widest} at this path's dtypes")


def _model_axis(cfg, world_size):
    return parse_mesh_shape(cfg.mesh_shape, world_size)["model"]


def _check_kernel_shapes(cfg, train=False):
    """Refuses, by field, a head width or a frame count that the CUDA
    attention kernels of the configured path do not take; ``train``: fused
    training's, whose attention backward (B4) takes head_dim 64 and 128."""
    head_dim, divides = cfg.embed_dim // cfg.num_heads, cfg.embed_dim % cfg.num_heads == 0
    if not divides or not takes_head_dim(head_dim):
        _refuse(cfg, "num_heads", f"head_dim {cfg.embed_dim / cfg.num_heads:g} (embed_dim "
                f"{cfg.embed_dim}): the CUDA attention kernels of this path take head_dim "
                f"{HEAD_DIM_RULE}")
    if train and head_dim not in BWD_HEAD_DIMS:
        _refuse(cfg, "num_heads", f"head_dim {head_dim} (embed_dim {cfg.embed_dim}): the CUDA "
                f"kernels of fused training take head_dim {BWD_HEAD_DIMS} (its attention "
                f"backward is compiled for those)")
    if cfg.number_of_frames > MAX_N:
        _refuse(cfg, "number_of_frames", f"the CUDA attention kernels of this path take at most "
                f"{MAX_N} keys a group, and the temporal attention's group is the window's "
                f"frames (the plain module takes every length)")


def _dtype(cfg):
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def eval_diffusion(cfg: Config, diffusion, model, temporal_mode: str = "rows"):
    """The sampler of ``cfg``'s eval path on ``model``'s weights (JAX
    runner.py:128-171): ``diffusion`` itself (the plain or ``use_pallas``
    module), or with ``fast_eval`` the fused forward at ``compute_dtype``
    (a bf16 one holds a ``bf16_snapshot``), whose last
    ``eval_f32_final_steps`` steps run the float32 fused forward, or with
    ``eval_f32_tail_pairs`` a bf16 forward whose last that-many block pairs
    and head run at float32; those final steps contract at
    ``eval_final_prec``, where JAX's runner pins them (:148-163). An f32
    ``fast_eval`` run ignores ``eval_final_prec``, as JAX's does. The
    float32 products outside the fused blocks contract at
    ``matmul_precision``, the session precision JAX's runner sets (:93).
    ``temporal_mode``: the fused forward's temporal layout (the runner's is
    "rows", JAX's default; the bench and the export also take "cols")."""
    if not cfg.fast_eval:
        return diffusion
    bf16 = cfg.compute_dtype == "bfloat16"
    prec = cfg.matmul_precision
    out = dataclasses.replace(diffusion, denoise_fn=make_fast_denoise_fn(
        model, _dtype(cfg), temporal_mode, f32_head=bf16 and cfg.eval_f32_head,
        matmul_precision=prec))
    if bf16 and cfg.eval_f32_final_steps > 0:
        if cfg.eval_f32_tail_pairs > 0:
            final = make_fast_denoise_fn(model, torch.bfloat16, temporal_mode, f32_head=True,
                                         f32_tail_pairs=cfg.eval_f32_tail_pairs,
                                         f32_prec=cfg.eval_final_prec, matmul_precision=prec)
        else:
            final = make_fast_denoise_fn(model, torch.float32, temporal_mode,
                                         f32_prec=cfg.eval_final_prec, matmul_precision=prec)
        out = dataclasses.replace(out, final_denoise_fn=final,
                                  final_denoise_steps=cfg.eval_f32_final_steps)
    return out


def check_trainable(cfg: Config, device="cpu", world_size: int = 1) -> None:
    """What ``fit`` refuses beyond ``check_supported``, naming the field:
    ``use_pallas_attention`` without ``fast_train``, whose attention kernels
    have no backward (JAX's ``jax.grad`` through them raises too). On a
    CUDA ``device``, with ``fast_train``: a head width the fast-train
    kernels do not take (64, 128), more frames than their attention holds
    keys (``MAX_N``), and an ``embed_dim`` wider than the LayerNorm kernel
    holds at the training dtype. bfloat16 training,
    ``remat`` (both modes) and the monolithic backward
    (``fast_train_pair_vjp=False``) train. ``fast_train`` under a
    ``mesh_shape`` whose ``model`` and ``data`` axes are both > 1, as JAX
    raises there (engine/steps.py:239-246); at a data axis of 1 it trains
    on whole weights gathered from the shards, as JAX's jit path does
    (``parallel.tensor.WholeWeights``)."""
    check_supported(cfg, device, world_size)
    sizes = parse_mesh_shape(cfg.mesh_shape, world_size)
    if cfg.fast_train and sizes["model"] > 1 and sizes["data"] > 1:
        raise ValueError(f"fast_train=True is not supported under mesh_shape="
                         f"{cfg.mesh_shape!r}: a model axis beside a data axis > 1, where "
                         f"JAX's fused training raises too; use 'data:1,model:"
                         f"{sizes['model']}' or a data-only mesh, or train the plain module "
                         f"(fast_train off)")
    if cfg.use_pallas_attention and not cfg.fast_train:
        _refuse(cfg, "use_pallas_attention", "its attention kernels have no backward; train "
                "with fast_train (and fast_train_attn_bwd for the attention backward kernels)")
    if torch.device(device).type == "cuda" and cfg.fast_train:
        _check_kernel_shapes(cfg, train=True)
        widest = LN_MAX_C[_dtype(cfg)]
        if cfg.embed_dim > widest:
            _refuse(cfg, "embed_dim", f"the CUDA LayerNorm of the fused blocks takes rows of up "
                    f"to {widest} at {cfg.compute_dtype}")


class Runner:
    """Model, diffusion, train, val and eval steps for one ``Config``;
    ``fit`` runs the epoch loop, ``evaluate`` the final evaluation protocol
    on a dataset.

    The module is built at ``compute_dtype`` (flax's ``dtype``; the
    parameters stay float32), with ``remat_blocks`` under ``remat`` and
    ``remat_mode="block"``, as in JAX. The denoiser of the evaluation is,
    as in JAX: the module (``use_pallas_attention`` sends its attention
    through the attention kernels); with ``fast_eval`` the fused-block
    forward in ``compute_dtype`` (``eval_f32_head`` keeps a bf16 trunk's
    head float32); with bfloat16 and ``eval_f32_final_steps`` > 0 the last
    steps run the float32 fused forward (the mixed mode). The temporal
    blocks run in the rows layout, JAX's default. The validation loss runs
    on the module. The denoiser of training is the module under autograd
    (the whole forward recomputed under ``remat`` with ``remat_mode=
    "whole"``), or with ``fast_train`` the fused forward in
    ``compute_dtype`` with the pair-boundary recompute backward, or the
    monolithic one with ``fast_train_pair_vjp=False``
    (``fast_train_attn_bwd``: its attention through the attention
    kernels), drop-path at ``drop_path_rate`` either way. Every float32
    product of these denoisers outside the fused blocks contracts at
    ``matmul_precision`` (JAX's session precision, set from the same field,
    :93), passed to each as an argument.

    ``device`` is "cuda" unless the caller asks for "cpu"; nothing falls
    back. ``check_supported`` lists what is refused, ``check_trainable``
    what ``fit`` refuses besides.

    ``mesh``: a ``parallel.DataMesh``, this process's rank of a run across
    processes, laid out by ``cfg.mesh_shape`` (the runner's ``mesh`` has
    its model axis); the runner then runs on ``mesh.device``, its steps
    take the global batches (``cfg.batch_size``, ``cfg.batch_size_eval``)
    and each data rank runs its rows (``engine.steps``), and only rank 0
    writes checkpoints and logs and prints (the other ranks' default logger
    neither writes nor prints). Under a ``model`` axis > 1 (tensor
    parallelism, ``parallel.tensor``) ``model`` holds the rank's shards
    and the plain module's train, val and eval steps run on them; the
    fused eval runs on a whole replica, ``full_model()``, rebuilt from
    the gathered weights before each validation and evaluation (JAX's
    ``shard_map`` with ``P()`` parameters), and ``fast_train`` (at a data
    axis of 1) trains that replica, loaded from the shards before every
    step, its gradients sliced back to the shards that AdamW steps
    (``parallel.tensor.WholeWeights``); ``set_params`` and the checkpoints
    take and write whole state dicts."""

    def __init__(self, cfg: Config, num_joints: int, joints_left, joints_right,
                 logger: Optional[RunLogger] = None, device="cuda", mesh=None):
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        check_supported(cfg, self.device, self.world_size)
        if mesh is not None:
            self.mesh = mesh.with_model_axis(_model_axis(cfg, mesh.size))
        self.cfg = cfg
        self._replica = self._whole = None
        self.num_joints = num_joints
        self.joints_left = list(joints_left)
        self.joints_right = list(joints_right)
        self.logger = logger or RunLogger(cfg.checkpoint, enabled=False, echo=self.is_main)

        self._model_kw = dict(
            num_frame=cfg.number_of_frames,
            num_joints=num_joints,
            in_chans=2,
            embed_dim=cfg.embed_dim,
            depth=cfg.transformer_depth,
            num_heads=cfg.num_heads,
            mlp_ratio=cfg.mlp_ratio,
            qkv_bias=True,
            with_time_emb=cfg.with_time_emb,
            use_pallas=cfg.use_pallas_attention,
            dtype=_dtype(cfg),
            remat_blocks=cfg.remat and cfg.remat_mode == "block",
        )
        self.model = HPE_model(cfg.model)(**self._model_kw, seed=cfg.seed, device=self.device)
        if self.tp:
            shard_model(self.model, self.mesh)
        prec = cfg.matmul_precision
        self.diffusion = GaussianDiffusion.create(
            make_denoise_fn(self.model, prec),
            timesteps=cfg.timesteps,
            sampling_timesteps=cfg.sampling_timesteps,
            loss_type=cfg.loss_type,
            clip_denoised=cfg.clip_denoised,
            beta_schedule=cfg.beta_schedule,
            ddim_sampling_eta=cfg.ddim_sampling_eta,
            clip_loss=cfg.clip_loss,
            mode="s2s" if cfg.out_all else "s2f",
        )
        if cfg.fast_train:
            train_model = self.model
            if self.tp:
                self._whole = WholeWeights(self._replica_module(), self.model, self.mesh)
                train_model = self._whole.replica
            train_fn = make_fast_train_denoise_fn(
                train_model, cfg.drop_path_rate, attn_bwd=cfg.fast_train_attn_bwd,
                dtype=_dtype(cfg), pair_vjp=cfg.fast_train_pair_vjp, matmul_precision=prec)
        else:
            train_fn = make_train_denoise_fn(self.model, cfg.drop_path_rate,
                                             remat=cfg.remat and cfg.remat_mode == "whole",
                                             matmul_precision=prec)
        self.train_diffusion = dataclasses.replace(self.diffusion, denoise_fn=train_fn)
        self._build_eval()

    def _build_eval(self):
        """``eval_diffusion``, ``eval_step`` and ``val_step`` from the
        model's current weights (a bf16 denoise_fn holds a snapshot of
        them, so this runs again whenever the weights are replaced)."""
        cfg = self.cfg
        model = self.full_model() if cfg.fast_eval else self.model
        self.eval_diffusion = eval_diffusion(cfg, self.diffusion, model)
        self.eval_step = make_eval_step(
            self.eval_diffusion, self.joints_left, self.joints_right,
            repeat_n=cfg.repeat_n, tta=cfg.test_time_augmentation, device=self.device,
            mesh=self.mesh,
        )
        self.val_step = make_val_step(
            self.diffusion, self.joints_left, self.joints_right,
            sample_diffusion=self.eval_diffusion, tta=cfg.test_time_augmentation,
            device=self.device, mesh=self.mesh,
        )

    @property
    def world_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    @property
    def tp(self) -> bool:
        """Whether the module is sharded over a model axis > 1."""
        return self.mesh is not None and self.mesh.model_size > 1

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's whole state dict under the reference's names: its
        own, or under tensor parallelism its shards gathered (collective:
        every rank calls it)."""
        state = self.model.state_dict()
        return gather_params(state, self.mesh) if self.tp else state

    def full_model(self):
        """The whole module: ``model``, or under tensor parallelism a
        replica loaded with the gathered weights as they are now
        (collective)."""
        if not self.tp:
            return self.model
        replica = self._replica_module()
        replica.load_state_dict(self.full_state_dict(), strict=True)
        return replica

    def _replica_module(self):
        """The whole module that the fused paths run under tensor
        parallelism, made once (its weights as last loaded)."""
        if self._replica is None:
            self._replica = HPE_model(self.cfg.model)(
                **self._model_kw, seed=self.cfg.seed, device=self.device).eval()
        return self._replica

    @property
    def is_main(self) -> bool:
        """Whether this process writes the run's files: rank 0, or the one process."""
        return self.mesh is None or self.mesh.is_main

    # ------------------------------------------------------------------
    def init_params(self, seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """A fresh state dict drawn from ``seed`` (default ``cfg.seed``)
        through an explicit ``torch.Generator``, on the CPU."""
        fresh = HPE_model(self.cfg.model)(
            **self._model_kw, seed=self.cfg.seed if seed is None else seed, device="cpu")
        return fresh.state_dict()

    def set_params(self, params):
        """``params``: a state dict under the reference's names, or the JAX
        package's parameter tree (nested dicts, as flax holds them)."""
        if "fusion_layer" in params:  # the flax tree's top level
            params = state_dict_from_flax(
                params, self.cfg.transformer_depth, self.cfg.with_time_emb, self.model.mode)
        if self.tp:
            params = shard_params(params, self.mesh)
        self.model.load_state_dict(params, strict=True)
        if self.mesh is not None:
            check_params_replicated(self.model, self.mesh)
        self._build_eval()

    def param_count(self) -> int:
        """The parameters of the whole module (under tensor parallelism too)."""
        return full_param_count(self.model, self.mesh)

    def _to_device(self, value):
        """Arrays (and tuples of them, and dicts of those) as tensors on the
        runner's device, without making the host wait for the card
        (``device.to_device``): integers as int64, the rest float32."""
        if isinstance(value, dict):
            return {k: self._to_device(v) for k, v in value.items()}
        if isinstance(value, (tuple, list)):
            return tuple(self._to_device(v) for v in value)
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))
        return to_device(t, self.device, torch.float32 if t.is_floating_point() else torch.int64)

    # ------------------------------------------------------------------
    def fit(self, train_ds, val_ds, resume: Optional[str] = None, draws=None) -> Dict:
        """Epoch loop (JAX ``Runner.fit``; reference run.py:252-506).
        Per-epoch validation and early stopping run on ``val_ds``, the
        reference's 'val' split (train subjects, no augmentation, its own
        noise knobs; reference run.py:278-284 and load_noisy_data.py:95-107),
        as JAX does; the final test evaluation is a separate ``evaluate``.

        Each epoch: AdamW steps on shuffled train batches (``drop_last``),
        lr = learning_rate · lr_decay^(step // steps_per_epoch); one host
        read of the epoch's losses; validation (unless ``no_eval``); the
        log line; ``epoch_{n}/`` every ``checkpoint_frequency`` epochs and
        ``best_epoch/`` at a new best validation MPJPE (mm); then
        ``patience`` and ``max_time`` (hours) may stop the loop.

        Random draws (t, noise, drop-path scales, x_T) come from one
        ``torch.Generator`` on the runner's device, seeded with ``cfg.seed
        + epoch`` at the start of every epoch: JAX reseeds so only on
        resume (its key chain otherwise runs on), and torch cannot draw
        JAX's bits anyway; reseeding every epoch makes a resumed run equal
        an unbroken one. ``resume``: a checkpoint directory of this port;
        the model, optimizer, scheduler (so the lr schedule goes on from
        the saved step), counters and ``train_ds.shuffle_rng`` are restored
        and training goes on at the next epoch.

        ``draws``: for tests, a callable (kind, epoch, index) -> the draws
        to use instead of the generator's: for kind "train" and train batch
        ``index`` dict(t=, noise=, dp_scales=), for "val" and validation
        batch ``index`` dict(x_init=, losses=((t, noise), (t_flip,
        noise_flip))), as ``make_train_step`` and ``make_val_step`` take
        them. Entry points pass None.

        In a data-parallel run (``mesh``) every rank iterates the same
        global batches (the same ``shuffle_rng``) and runs its rows of each;
        the ranks must start from the same weights (checked, after a
        resume too; under tensor parallelism the replicated parameters on
        every rank, the shards across the data group). Only rank 0 writes
        checkpoints, logs and the curve, and every rank waits at a barrier
        after each checkpoint; a checkpoint is the same whole state dict
        (the model's and AdamW's moments gathered) at any world size and
        mesh, so it resumes or evaluates under another. The stop on
        ``max_time`` is rank 0's.

        Returns dict(losses_train, losses_valid (MPJPE in m), best_epoch,
        min_loss (mm), best_path (None without a best checkpoint), seconds:
        per epoch run, dict(train=, validate=, save=) host seconds)."""
        cfg = self.cfg
        log = self.logger
        check_trainable(cfg, self.device, self.world_size)
        steps_per_epoch = max(len(train_ds) // cfg.batch_size, 1)
        optimizer, scheduler = make_optimizer(self.model.parameters(), cfg.learning_rate,
                                              cfg.lr_decay, steps_per_epoch, cfg.weight_decay)
        train_step = make_train_step(self.train_diffusion, optimizer, scheduler, mesh=self.mesh,
                                     whole=self._whole)

        epoch = 0
        best_epoch = 0
        min_loss = np.inf
        min_train_loss = np.inf
        curr_step = 0

        names = [n for n, _ in self.model.named_parameters()]
        if resume:
            state, meta = restore_checkpoint(resume, field="resume")
            model_state, opt_state = state["model_diffusion"], state["optimizer"]
            if self.tp:
                model_state = shard_params(model_state, self.mesh)
                opt_state = shard_optimizer_state(opt_state, names, self.mesh)
            self.model.load_state_dict(model_state, strict=True)
            optimizer.load_state_dict(opt_state)
            scheduler.load_state_dict(state["lr_scheduler"])
            epoch = meta["epoch"] + 1
            best_epoch = meta.get("best_epoch", 0)
            min_loss = meta.get("min_loss", np.inf)
            min_train_loss = meta.get("min_train_loss", np.inf)
            if meta.get("shuffle_rng_state"):
                train_ds.shuffle_rng = rng_state_from_json(meta["shuffle_rng_state"])
            log.log(f"Resumed from {resume} at epoch {epoch}\n")
        if self.mesh is not None:
            check_params_replicated(self.model, self.mesh)

        losses_train: List[float] = []
        losses_valid: List[float] = []
        seconds: List[Dict[str, float]] = []
        start_training_time = time.time()
        best_path = os.path.join(cfg.checkpoint, "best_epoch")

        def save(path):
            # Under tensor parallelism every rank gathers, rank 0 writes.
            opt_state = optimizer.state_dict()
            if self.tp:
                opt_state = gather_optimizer_state(opt_state, names, self.mesh)
            model_state = self.full_state_dict()
            if self.is_main:
                save_checkpoint(path, dict(
                    model_diffusion=model_state, optimizer=opt_state,
                    lr_scheduler=scheduler.state_dict(), step=scheduler.last_epoch), meta)
            if self.mesh is not None:
                self.mesh.barrier()

        while epoch < cfg.epochs:
            start_time = time.time()
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed + epoch)
            self.model.train()
            epoch_losses = []
            for i, b in enumerate(train_ds.batches(cfg.batch_size, shuffle=True, drop_last=True)):
                injected = {} if draws is None else self._to_device(draws("train", epoch, i))
                epoch_losses.append(train_step(
                    self._to_device(b.gt_3d_norm), self._to_device(b.input_2d),
                    generator=generator, **injected))
            # The epoch's one host read of its losses (float32 mean, as JAX's).
            train_loss = float(np.mean(torch.stack(epoch_losses).cpu().numpy())
                               if epoch_losses else np.nan)
            losses_train.append(train_loss)
            self.model.eval()
            time_trained = time.time()

            if not cfg.no_eval:
                # The eval denoiser may hold a snapshot of the weights.
                self._build_eval()
                val_mpjpe, val_loss = self._validate(val_ds, generator, draws, epoch)
                losses_valid.append(val_mpjpe)
            else:
                val_mpjpe, val_loss = np.nan, np.nan
            time_validated = time.time()

            elapsed = (time.time() - start_time) / 60
            log.log(
                f"Epoch: {epoch}, Time(mins): {elapsed:.2f}, "
                f"Train/_pose_loss: {train_loss:.8f}, "
                f"Valid/_mpjpe_mm: {val_mpjpe * 1000:.4f}, Valid/_pose_loss: {val_loss:.8f}\n"
            )

            # The best is taken before either checkpoint is written, so a
            # periodic checkpoint's meta counts its own epoch (JAX writes it
            # before, and a run resumed from it forgets that epoch's best).
            is_best = not cfg.no_eval and val_mpjpe * 1000 < min_loss
            if is_best:
                min_loss = val_mpjpe * 1000
                min_train_loss = train_loss
                best_epoch = epoch
                curr_step = 0
            else:
                curr_step += 1
            meta = dict(
                epoch=epoch,
                best_epoch=best_epoch,
                min_loss=float(min_loss),
                min_train_loss=float(min_train_loss),
                shuffle_rng_state=rng_state_to_json(train_ds.shuffle_rng),
            )
            if (epoch + 1) % cfg.checkpoint_frequency == 0:
                path = os.path.join(cfg.checkpoint, f"epoch_{epoch}")
                save(path)
                log.log(f"Saved checkpoint to {path}\n")
            if is_best:
                save(best_path)
                log.log("save best checkpoint\n")
            seconds.append(dict(train=time_trained - start_time,
                                validate=time_validated - time_trained,
                                save=time.time() - time_validated))

            if curr_step >= cfg.patience:
                log.log("Early stop!\n")
                break
            out_of_time = time.time() - start_training_time > cfg.max_time * 3600
            if out_of_time if self.mesh is None else self.mesh.from_main(out_of_time):
                log.log(f"Max_time for training elapsed {cfg.max_time:.2f} hours, stopping\n")
                break
            epoch += 1

        log.log(f"Training finished! Total time: {(time.time() - start_training_time) / 60}\n")
        if cfg.export_training_curves and len(losses_train) > 3 and self.is_main:
            self._export_curves(losses_train, losses_valid)
        has_best = os.path.isdir(best_path)  # rank 0's files decide, on every rank
        if self.mesh is not None:
            has_best = self.mesh.from_main(has_best)
        return dict(
            losses_train=losses_train,
            losses_valid=losses_valid,
            best_epoch=best_epoch,
            min_loss=min_loss,
            best_path=best_path if has_best else None,
            seconds=seconds,
        )

    def _export_curves(self, losses_train, losses_valid):
        """Loss-curve PNG (reference run.py:513-531)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure()
        epoch_x = np.arange(3, len(losses_train)) + 1
        plt.plot(epoch_x, losses_train[3:], "--", color="C0", label="train loss")
        if len(losses_valid) > 3:
            plt.plot(epoch_x[: len(losses_valid) - 3], losses_valid[3:], color="C1",
                     label="valid MPJPE (m)")
        plt.legend()
        plt.ylabel("loss / MPJPE (m)")
        plt.xlabel("Epoch")
        plt.savefig(os.path.join(self.cfg.checkpoint, "loss_3d.png"))
        plt.close("all")

    def _validate(self, val_ds, generator, draws=None, epoch=0):
        """Per-epoch validation pass (JAX ``Runner._validate``). Returns
        (mpjpe, loss):

        - mpjpe: frame-mask-weighted MPJPE over real (non-padded) rows, the
          early-stop / best-checkpoint signal.
        - loss: plain mean of the per-batch p_losses values, matching the
          reference's logged val loss (run.py:353-406 averages the loader's
          batch losses uniformly). The final fixed-shape batch pads by
          repeating its last real row, so padding contributes real data.

        Draws come from ``generator``, or from ``draws("val", epoch, i)``."""
        errs, losses, n = [], [], 0
        for i, b in enumerate(val_ds.batches(self.cfg.batch_size_eval)):
            injected = {} if draws is None else self._to_device(draws("val", epoch, i))
            pred_norm, loss = self.val_step(
                b.gt_3d_norm, b.input_2d,
                b.input_2d_flip if b.input_2d_flip is not None else b.input_2d,
                generator=generator, **injected)
            pred = val_ds.reverse_norm_3d_pose(pred_norm.cpu().numpy())
            mask = (b.target_mask & b.row_mask[:, None]).reshape(-1)
            pred_f = pred.reshape(-1, self.num_joints, 3)[mask]
            gt_f = b.gt_3d.reshape(-1, self.num_joints, 3)[mask]
            errs.append(float(mpjpe(pred_f[:, None], gt_f[:, None])) * mask.sum())
            losses.append(float(loss))
            n += mask.sum()
        return (np.sum(errs) / n, np.mean(losses)) if n else (np.nan, np.nan)

    # ------------------------------------------------------------------
    def evaluate(self, test_ds, action: Optional[str] = None, generator=None,
                 unit_scale: float = 1000.0, x_init=None) -> Dict:
        """Final evaluation protocol (reference evaluate:535-654): flip-TTA
        DDIM sampling, unnormalise, mask, Protocol #1/#2/#3 + MPJVE, and
        model-time throughput.

        ``generator``: the torch.Generator (on the runner's device) that
        x_T is drawn from, default one seeded with ``cfg.seed``.
        ``x_init``: instead, a callable batch index -> x_T of that batch
        ([rows, F_out, J, 3], rows as ``make_eval_step`` orders them), so
        that a test can inject another sampler's draws. unit_scale converts
        the dataset's native pose units into the mm the report prints: 1000
        for meter-based datasets (H3.6M et al.). Targets that are NaN (2D-only
        footage) make every error NaN; the predictions and the speed stand.

        In a data-parallel run each rank samples its rows of a batch and the
        step gathers the prediction on every rank: the metrics are those of
        the gathered predictions, and ``model_time`` is the rank's wall
        time of the steps, the gather included (rank 0's in the report)."""
        cfg = self.cfg
        log = self.logger
        self.model.eval()
        if self.tp and cfg.fast_eval:
            self._build_eval()  # the replica from the weights as they are now
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        e1_sum = e2_sum = e3_sum = ev_sum = 0.0
        n = 0
        model_time = 0.0
        predictions = []

        def inputs(b):
            flip = b.input_2d_flip if b.input_2d_flip is not None else b.input_2d
            return (torch.as_tensor(b.input_2d, device=self.device),
                    torch.as_tensor(flip, device=self.device))

        # Warm-up OUTSIDE the timed path (kernel build and load, allocator,
        # cuBLAS handles), on a throwaway generator so that the timed pass
        # sees the caller's draws. Batches are fixed-shape, so one batch
        # warms every shape.
        for b in test_ds.batches(cfg.batch_size_eval):
            warm = torch.Generator(device=self.device).manual_seed(cfg.seed ^ 0xC0FFEE)
            self.eval_step(*inputs(b), generator=warm).cpu()
            break
        for i, b in enumerate(test_ds.batches(cfg.batch_size_eval)):
            x2d, x2d_flip = inputs(b)
            x_t = None if x_init is None else x_init(i)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the inputs' copies are not model time
            t0 = time.time()
            pred_norm = self.eval_step(x2d, x2d_flip, x_init=x_t, generator=generator)
            # The device-to-host copy waits for the step: the only
            # synchronisation in the timed window. model_time covers device
            # work + the transfer; the host-side unnormalise happens OUTSIDE
            # the window, matching the reference's model-call-only timing
            # (run.py:575,592-593).
            pred_norm_host = pred_norm.cpu().numpy()
            model_time += time.time() - t0
            pred = test_ds.reverse_norm_3d_pose(pred_norm_host)

            mask = (b.target_mask & b.row_mask[:, None]).reshape(-1)
            pred_f = pred.reshape(-1, self.num_joints, 3)[mask]
            gt_f = b.gt_3d.reshape(-1, self.num_joints, 3)[mask]
            predictions.append(pred_f)
            k = mask.sum()
            n += k
            if np.isnan(gt_f).any():  # no ground truth (custom footage): no errors
                e1_sum = e2_sum = e3_sum = ev_sum = float("nan")
                continue
            e1_sum += float(mpjpe(pred_f[:, None], gt_f[:, None])) * k
            e3_sum += float(n_mpjpe(pred_f[:, None], gt_f[:, None])) * k
            e2_sum += float(p_mpjpe(pred_f, gt_f)) * k
            ev_sum += float(mean_velocity_error(pred_f, gt_f)) * k

        e1, e2, e3, ev = (
            e1_sum / n * unit_scale,
            e2_sum / n * unit_scale,
            e3_sum / n * unit_scale,
            ev_sum / n * unit_scale,
        )
        speed = n / model_time if model_time > 0 else float("inf")
        header = "----------" if action is None else f"----{action}----"
        log.result(
            f"{header}\neval_frame: {n}\ninference_time: {model_time / 60}min\n"
            f"inference_speed: {speed}frame/s\n"
            f"Protocol #1 Error (MPJPE): {e1}mm\n"
            f"Protocol #2 Error (P-MPJPE): {e2}mm\n"
            f"Protocol #3 Error (N-MPJPE): {e3}mm\n"
            f"Velocity Error (MPJVE): {ev}mm\n----------\n"
        )
        return dict(
            e1=e1, e2=e2, e3=e3, ev=ev, n_frames=int(n),
            model_time=model_time, frames_per_sec=speed,
            predictions=np.concatenate(predictions) if predictions else None,
        )
