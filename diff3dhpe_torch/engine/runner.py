"""Evaluation runner: the reference's evaluation protocol (reference
evaluate:535-654) as a reusable component on top of the eval step.

Port of the evaluate half of ``diff3dhpe_tpu/engine/runner.py``:
model/diffusion assembly from a ``Config`` and the final per-action
evaluation with Protocols #1/#2/#3 + MPJVE and eval-throughput reporting.
The epoch loop (``fit``), per-epoch validation and checkpoint saving are
not ported yet.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from diff3dhpe_torch.config import Config
from diff3dhpe_torch.device import resolve_device
from diff3dhpe_torch.diffusion import GaussianDiffusion
from diff3dhpe_torch.engine.steps import make_denoise_fn, make_eval_step, make_fast_denoise_fn
from diff3dhpe_torch.io.convert import state_dict_from_flax
from diff3dhpe_torch.metrics import mean_velocity_error, mpjpe, n_mpjpe, p_mpjpe
from diff3dhpe_torch.models import HPE_model
from diff3dhpe_torch.ops.attention import HEAD_DIMS
from diff3dhpe_torch.ops.fused_block import LN_MAX_C


class RunLogger:
    """Timestamped plain-text run logs, mirroring the reference's
    config_*/log_*/results_* files (reference run.py:136-138,209-214)."""

    def __init__(self, checkpoint_dir: str, enabled: bool = True):
        self.enabled = enabled
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
        print(text, end="" if text.endswith("\n") else "\n")
        self._write(self.log_path, text if text.endswith("\n") else text + "\n")

    def result(self, text):
        print(text, end="" if text.endswith("\n") else "\n")
        self._write(self.results_path, text if text.endswith("\n") else text + "\n")


def check_supported(cfg: Config, device="cpu") -> None:
    """Raises ValueError, naming the field, for a configuration the JAX
    package runs and the port does not yet. On a CUDA ``device`` also for a
    head width that the kernels of the configured path do not take: they
    take head_dim 64 and 128 (float32 and bf16); and, with ``fast_eval``,
    for an ``embed_dim`` wider than the block's LayerNorm kernel holds
    (``LN_MAX_C``: 2048 where a step runs float32, 4096 at bf16 alone). The
    CPU runs every width.

    ``remat`` is accepted: in JAX it only chooses whether the blocks are
    rematerialised in the backward pass of training
    (diff3dhpe_tpu/models/mixste.py:262-279), so an evaluation with it on
    computes what one without it computes, and the runner only evaluates."""
    def refuse(field, why):
        raise ValueError(f"{field}={getattr(cfg, field)!r} is not ported: {why}")

    if cfg.mesh_shape is not None and cfg.mesh_shape.replace(" ", "") not in ("data:1", ""):
        refuse("mesh_shape", "the port runs on one device")
    bf16 = cfg.compute_dtype == "bfloat16"
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        refuse("compute_dtype", "float32 or bfloat16")
    if bf16 and not cfg.fast_eval:
        refuse("compute_dtype", "bfloat16 runs only through fast_eval (the module is float32)")
    if bf16 and cfg.use_pallas_attention:
        refuse("use_pallas_attention", "the use_pallas module runs at float32; not with "
               "compute_dtype='bfloat16'")
    if cfg.eval_f32_tail_pairs > 0:
        refuse("eval_f32_tail_pairs", "the final step's forward runs float32 as a whole")
    if cfg.eval_final_prec not in ("high3", "highest"):
        refuse("eval_final_prec", "the float32 kernels contract in exact float32 "
               "('high3' and 'highest' both mean that)")
    if torch.device(device).type == "cuda" and (cfg.fast_eval or cfg.use_pallas_attention):
        head_dim = cfg.embed_dim // cfg.num_heads
        if head_dim not in HEAD_DIMS:
            refuse("num_heads", f"head_dim {head_dim} (embed_dim {cfg.embed_dim}): the CUDA "
                   f"kernels of this path take head_dim {HEAD_DIMS}")
    if torch.device(device).type == "cuda" and cfg.fast_eval:
        f32_steps = not bf16 or cfg.eval_f32_final_steps > 0
        widest = LN_MAX_C[torch.float32 if f32_steps else torch.bfloat16]
        if cfg.embed_dim > widest:
            refuse("embed_dim", f"the CUDA LayerNorm of the fused blocks takes rows of up to "
                   f"{widest} at this path's dtypes")


class Runner:
    """Model, diffusion and eval step for one ``Config``; ``evaluate`` runs
    the final evaluation protocol on a dataset.

    The denoiser of the evaluation is, as in JAX: the module
    (``use_pallas_attention`` sends its attention through the attention
    kernels); with ``fast_eval`` the fused-block forward in
    ``compute_dtype`` (``eval_f32_head`` keeps a bf16 trunk's head float32);
    with bfloat16 and ``eval_f32_final_steps`` > 0 the last steps run the
    float32 fused forward (the mixed mode). The temporal blocks run in the
    rows layout, JAX's default.

    ``device`` is "cuda" unless the caller asks for "cpu"; nothing falls
    back. ``check_supported`` lists what is refused."""

    def __init__(self, cfg: Config, num_joints: int, joints_left, joints_right,
                 logger: Optional[RunLogger] = None, device="cuda"):
        self.device = resolve_device(device)
        check_supported(cfg, self.device)
        self.cfg = cfg
        self.num_joints = num_joints
        self.joints_left = list(joints_left)
        self.joints_right = list(joints_right)
        self.logger = logger or RunLogger(cfg.checkpoint, enabled=False)

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
        )
        self.model = HPE_model(cfg.model)(**self._model_kw, seed=cfg.seed,
                                          device=self.device).eval()
        self.diffusion = GaussianDiffusion.create(
            make_denoise_fn(self.model),
            timesteps=cfg.timesteps,
            sampling_timesteps=cfg.sampling_timesteps,
            loss_type=cfg.loss_type,
            clip_denoised=cfg.clip_denoised,
            beta_schedule=cfg.beta_schedule,
            ddim_sampling_eta=cfg.ddim_sampling_eta,
            clip_loss=cfg.clip_loss,
            mode="s2s" if cfg.out_all else "s2f",
        )
        self._build_eval()

    def _build_eval(self):
        """``eval_diffusion`` and ``eval_step`` from the model's current
        weights (a bf16 denoise_fn holds a snapshot of them, so this runs
        again whenever the weights are replaced)."""
        cfg = self.cfg
        self.eval_diffusion = self.diffusion
        if cfg.fast_eval:
            is_bf16 = cfg.compute_dtype == "bfloat16"
            self.eval_diffusion = dataclasses.replace(
                self.diffusion,
                denoise_fn=make_fast_denoise_fn(
                    self.model, torch.bfloat16 if is_bf16 else torch.float32,
                    f32_head=is_bf16 and cfg.eval_f32_head),
            )
            if is_bf16 and cfg.eval_f32_final_steps > 0:
                self.eval_diffusion = dataclasses.replace(
                    self.eval_diffusion,
                    final_denoise_fn=make_fast_denoise_fn(self.model, torch.float32),
                    final_denoise_steps=cfg.eval_f32_final_steps,
                )
        self.eval_step = make_eval_step(
            self.eval_diffusion, self.joints_left, self.joints_right,
            repeat_n=cfg.repeat_n, tta=cfg.test_time_augmentation, device=self.device,
        )

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
        self.model.load_state_dict(params, strict=True)
        self._build_eval()

    def param_count(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

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
        for meter-based datasets (H3.6M et al.)."""
        cfg = self.cfg
        log = self.logger
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
