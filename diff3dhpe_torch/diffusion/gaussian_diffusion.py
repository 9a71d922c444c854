"""Conditional Gaussian diffusion (direct-x0 prediction, variable loss).

Port of ``diff3dhpe_tpu/diffusion/gaussian_diffusion.py``: the DDIM reverse
loop, the forward process, the multi-hypothesis pose estimate and the
training loss. The denoiser is any callable ``denoise_fn(x, t) -> x0``
([B, F, J, Cin + 3], [B] -> [B, F_out, J, 3]); the JAX scan over steps
becomes a Python loop. A training denoiser also takes ``dp_scales`` and
``generator`` keywords (``engine.steps.make_fast_train_denoise_fn``).

Randomness is explicit: x_T, the training t and noise are either passed
in or drawn from a ``torch.Generator`` the caller passes. Torch cannot
reproduce JAX's draws, so parity tests inject the same values into both.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from diff3dhpe_torch.device import to_device
from diff3dhpe_torch.diffusion.schedules import DiffusionConstants, make_diffusion_constants


def ddim_time_pairs(total_timesteps: int, sampling_timesteps: int) -> np.ndarray:
    """The reference's DDIM time grid: reversed pairs of
    linspace(-1, T-1, S+1) truncated to int (reference :270-273).

    Returns int array [S, 2] of (t, t_next), ordered T-1 -> -1."""
    times = np.linspace(-1, total_timesteps - 1, sampling_timesteps + 1)
    times = list(reversed(times.astype(np.int64).tolist()))
    return np.array(list(zip(times[:-1], times[1:])), dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Stateless DDIM sampler around ``denoise_fn(x, t)``."""

    denoise_fn: Callable[..., torch.Tensor]
    constants: DiffusionConstants
    sampling_timesteps: int
    loss_type: str = "l2"
    conditional: bool = True
    clip_denoised: bool = False
    ddim_sampling_eta: float = 0.0
    clip_loss: bool = False
    mode: str = "s2s"  # "s2s" | "s2f"
    # When set, the LAST ``final_denoise_steps`` DDIM steps call
    # ``final_denoise_fn`` instead of ``denoise_fn`` (the JAX package's
    # mixed-precision split; the update math is the same).
    final_denoise_fn: Optional[Callable[..., torch.Tensor]] = None
    final_denoise_steps: int = 1

    @classmethod
    def create(
        cls,
        denoise_fn,
        timesteps: int = 100,
        sampling_timesteps: Optional[int] = 20,
        clip_denoised: bool = False,
        beta_schedule: str = "cosine",
        ddim_sampling_eta: float = 0.0,
        mode: str = "s2s",
        loss_type: str = "l2",
        conditional: bool = True,
        clip_loss: bool = False,
        final_denoise_fn=None,
        final_denoise_steps: int = 1,
    ) -> "GaussianDiffusion":
        if sampling_timesteps is None:
            sampling_timesteps = timesteps
        if not 0 < sampling_timesteps <= timesteps:
            raise ValueError(f"need 0 < sampling_timesteps <= timesteps, got "
                             f"{sampling_timesteps} and {timesteps}")
        if loss_type not in ("l1", "l2"):
            raise ValueError(f"invalid loss type {loss_type}")
        return cls(
            denoise_fn=denoise_fn,
            constants=make_diffusion_constants(beta_schedule, timesteps),
            sampling_timesteps=int(sampling_timesteps),
            clip_denoised=clip_denoised,
            ddim_sampling_eta=float(ddim_sampling_eta),
            mode=mode,
            loss_type=loss_type,
            conditional=conditional,
            clip_loss=clip_loss,
            final_denoise_fn=final_denoise_fn,
            final_denoise_steps=int(final_denoise_steps),
        )

    @property
    def num_timesteps(self) -> int:
        return self.constants.num_timesteps

    def _at(self, name, t, like):
        """constants.<name>[t] on like's device, shaped to broadcast over
        like's trailing dims."""
        table = to_device(getattr(self.constants, name), like.device)
        return table[t.to(like.device)].reshape((t.shape[0],) + (1,) * (like.ndim - 1))

    def q_sample(self, x_start, t, noise):
        """x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps (reference :360-366)."""
        return (self._at("sqrt_alphas_cumprod", t, x_start) * x_start
                + self._at("sqrt_one_minus_alphas_cumprod", t, x_start) * noise)

    def p_losses(self, x_start, pose_2d, *, t=None, noise=None, generator=None,
                 dp_scales=None):
        """Per-element training loss (reference p_losses:392-419), with
        x_start's shape: (l1|l2)(x0_hat, x0) * (1 + acp_t / sqrt(1 - acp_t)),
        the weight clamped at 3 under ``clip_loss``.

        x_start: clean normalised 3D pose [B, F_out, J, 3]; pose_2d:
        conditioning [B, F, J, 2]. ``t`` [B] (int) and ``noise`` are drawn
        from ``generator`` when not given, in that order; ``dp_scales`` and
        ``generator`` go on to the denoiser, which draws its drop-path
        scales from the generator when ``dp_scales`` is None."""
        b, f = x_start.shape[0], pose_2d.shape[1]
        dev = x_start.device
        if t is None:
            t = torch.randint(0, self.num_timesteps, (b,), generator=generator, device=dev)
        t = torch.as_tensor(t, device=dev)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=dev)
        x_noisy = self.q_sample(x_start, t, noise)
        x_in = x_noisy.repeat_interleave(f, dim=1) if self.mode == "s2f" else x_noisy
        model_in = torch.cat([pose_2d, x_in], dim=-1) if self.conditional else x_in
        model_out = self.denoise_fn(model_in, t.float(), dp_scales=dp_scales, generator=generator)

        coef = 1.0 + self._at("alphas_cumprod", t, x_start) / self._at(
            "sqrt_one_minus_alphas_cumprod", t, x_start)
        if self.clip_loss:
            coef = torch.clamp(coef, max=3.0)
        diff = model_out - x_start
        err = diff ** 2 if self.loss_type == "l2" else diff.abs()
        return err * coef

    def training_loss(self, x_start, pose_2d, **kw):
        """Mean training loss (a scalar tensor); ``kw`` as ``p_losses``."""
        return self.p_losses(x_start, pose_2d, **kw).mean()

    def _ddim_step_tables(self):
        """Per-step schedule scalars as float32 numpy arrays [S]."""
        c = self.constants
        pairs = ddim_time_pairs(self.num_timesteps, self.sampling_timesteps)
        t = pairs[:, 0]
        t_next = pairs[:, 1]
        alpha = c.alphas_cumprod[t].astype(np.float64)
        # alpha_next is only read when t_next >= 0.
        alpha_next = c.alphas_cumprod[np.clip(t_next, 0, None)].astype(np.float64)
        sqrt_om = c.sqrt_one_minus_alphas_cumprod[t].astype(np.float64)
        eta = self.ddim_sampling_eta
        sigma = eta * np.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
        coef = np.sqrt(1 - alpha_next - sigma ** 2)
        f32 = lambda a: np.asarray(a, np.float32)
        return dict(
            t=f32(t), is_last=t_next < 0, alpha=f32(alpha),
            sqrt_alpha_next=f32(np.sqrt(alpha_next)), sqrt_om=f32(sqrt_om),
            sigma=f32(sigma), coef=f32(coef),
        )

    def _model_x_start(self, x, t_scalar, x_cond, denoise_fn):
        """One denoiser call + optional clamp (reference ddim_sample:251-258)."""
        x_in = x.repeat_interleave(x_cond.shape[1], dim=1) if self.mode == "s2f" else x
        model_in = torch.cat([x_cond, x_in], dim=-1)
        t = torch.full((x.shape[0],), float(t_scalar), dtype=torch.float32, device=x.device)
        x_start = denoise_fn(model_in, t)
        if self.clip_denoised:
            x_start = x_start.clamp(-1.0, 1.0)
        # A bf16 estimate enters the float32 update exactly, as JAX promotes
        # it against its float32 step tables.
        return x_start.to(torch.float32)

    @torch.no_grad()
    def ddim_sample_loop(self, x_cond, target_shape, x_init=None, generator=None):
        """DDIM reverse diffusion (reference :263-300).

        x_cond [B, F, J, Cin] conditioning; target_shape (B, F_out, J, 3).
        ``x_init`` is x_T; without it x_T ~ N(0, I) is drawn from
        ``generator`` (which must then be given, on x_cond's device), as is
        the per-step noise when ddim_sampling_eta != 0."""
        if (x_init is None or self.ddim_sampling_eta) and generator is None:
            raise ValueError("pass x_init, or a torch.Generator to draw the noise from")

        def noise():
            return torch.randn(tuple(target_shape), generator=generator,
                               dtype=torch.float32, device=x_cond.device)

        x = noise() if x_init is None else x_init.to(torch.float32)
        if tuple(x.shape) != tuple(target_shape):
            raise ValueError(f"x_init has shape {tuple(x.shape)}, expected {tuple(target_shape)}")
        tb = self._ddim_step_tables()
        s = self.sampling_timesteps
        n_final = min(self.final_denoise_steps, s) if self.final_denoise_fn else 0
        for i in range(s):
            fn = self.final_denoise_fn if i >= s - n_final else self.denoise_fn
            x_start = self._model_x_start(x, tb["t"][i], x_cond, fn)
            if tb["is_last"][i]:
                x = x_start
                continue
            # The reference multiplies x_start by alpha (NOT sqrt(alpha)) in
            # the eps-extraction term (reference :296); reproduced here.
            x = x_start * float(tb["sqrt_alpha_next"][i]) + float(tb["coef"][i]) * (
                (x - float(tb["alpha"][i]) * x_start) / float(tb["sqrt_om"][i])
            )
            if self.ddim_sampling_eta:
                x = x + float(tb["sigma"][i]) * noise()
        return x

    def estimate_pose(self, pose_2d, target_shape, repeat_n: int = 1, x_init=None,
                      generator=None):
        """DDIM-sample a 3D pose estimate; with repeat_n > 1 the hypotheses
        ride a tiled batch (hypothesis r of row i at row r * B + i, also
        the row order of ``x_init``) and are averaged (reference :434-448)."""
        b = target_shape[0]
        if repeat_n > 1:
            pose_2d = pose_2d.repeat(repeat_n, 1, 1, 1)
            target_shape = (b * repeat_n,) + tuple(target_shape[1:])
        pred = self.ddim_sample_loop(pose_2d, tuple(target_shape), x_init=x_init,
                                     generator=generator)
        if repeat_n > 1:
            return pred.reshape((repeat_n, b) + tuple(pred.shape[1:])).mean(dim=0)
        return pred
