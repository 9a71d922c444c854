"""Conditional Gaussian diffusion (direct-x0 prediction, variable loss).

Port of ``diff3dhpe_tpu/diffusion/gaussian_diffusion.py``: the DDIM reverse
loop (with its chain for the visualisation), the forward process and its
snapshots, the ancestral DDPM loop, the multi-hypothesis pose estimate and
the training loss. The denoiser is any callable ``denoise_fn(x, t) -> x0``
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
        p2_loss_weight_gamma: float = 0.0,
        p2_loss_weight_k: float = 1.0,
    ) -> "GaussianDiffusion":
        """``p2_loss_weight_gamma`` and ``p2_loss_weight_k`` set
        ``constants.p2_loss_weight`` (``make_diffusion_constants``), as
        JAX's ``create`` does; no loss reads it, in either package."""
        if sampling_timesteps is None:
            sampling_timesteps = timesteps
        if not 0 < sampling_timesteps <= timesteps:
            raise ValueError(f"need 0 < sampling_timesteps <= timesteps, got "
                             f"{sampling_timesteps} and {timesteps}")
        if loss_type not in ("l1", "l2"):
            raise ValueError(f"invalid loss type {loss_type}")
        return cls(
            denoise_fn=denoise_fn,
            constants=make_diffusion_constants(beta_schedule, timesteps, p2_loss_weight_gamma,
                                               p2_loss_weight_k),
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

    def get_noisy_pose(self, x_start, num_sample: int, noise=None, generator=None):
        """Forward-diffusion snapshots for the visualisation (reference
        :378-389, JAX :120-134): x_t of ``x_start`` [B, ...] at t = 0, T //
        num_sample, 2 T // num_sample, ... with one ``noise`` (drawn from
        ``generator`` when not given). Returns (stack [B, ..., len(t_list)],
        t_list)."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, dtype=x_start.dtype,
                                device=x_start.device)
        t_list = list(range(0, self.num_timesteps, self.num_timesteps // num_sample))
        b = x_start.shape[0]
        snaps = [self.q_sample(x_start, torch.full((b,), t, dtype=torch.long,
                                                   device=x_start.device), noise)
                 for t in t_list]
        return torch.stack(snaps, dim=-1), t_list

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
        f = pose_2d.shape[1]
        t, noise = self.loss_draws(x_start, t=t, noise=noise, generator=generator)
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

    def loss_draws(self, x_start, t=None, noise=None, generator=None):
        """(t [B], noise) of ``p_losses`` on ``x_start`` [B, ...]: each
        drawn from ``generator`` where not given, t first."""
        dev = x_start.device
        if t is None:
            t = torch.randint(0, self.num_timesteps, (x_start.shape[0],), generator=generator,
                              device=dev)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=dev)
        return torch.as_tensor(t, device=dev), noise

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

    def ddim_noises(self, target_shape, generator, device):
        """[S, *target_shape]: the per-step noise that ``ddim_sample_loop``
        draws from ``generator`` where ddim_sampling_eta > 0, drawn up front
        in its order (x_T, when drawn, comes first); the last step adds
        none, and its entry is zeros."""
        shape = tuple(target_shape)
        return torch.stack([
            torch.zeros(shape, device=device) if last else
            torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
            for last in self._ddim_step_tables()["is_last"]])

    @torch.no_grad()
    def ddim_sample_loop(self, x_cond, target_shape, x_init=None, generator=None,
                         collect_chain: bool = False, noises=None):
        """DDIM reverse diffusion (reference :263-300).

        x_cond [B, F, J, Cin] conditioning; target_shape (B, F_out, J, 3).
        ``x_init`` is x_T; without it x_T ~ N(0, I) is drawn from
        ``generator`` (which must then be given, on x_cond's device), as is
        the per-step noise when ddim_sampling_eta != 0, unless ``noises``
        [S, B, F_out, J, 3] gives it (step i adds noises[i]; the last step
        adds none). With ``collect_chain`` it returns (x_0, states, x0
        estimates), the per-step states and x0 estimates stacked on a last
        axis of length S (JAX :220-303, the visualisation's)."""
        eta = self.ddim_sampling_eta
        if (x_init is None or (eta and noises is None)) and generator is None:
            raise ValueError("pass x_init, or a torch.Generator to draw the noise from")

        def noise():
            return torch.randn(tuple(target_shape), generator=generator,
                               dtype=torch.float32, device=x_cond.device)

        x = noise() if x_init is None else x_init.to(torch.float32)
        if tuple(x.shape) != tuple(target_shape):
            raise ValueError(f"x_init has shape {tuple(x.shape)}, expected {tuple(target_shape)}")
        tb = self._ddim_step_tables()
        s = self.sampling_timesteps
        if eta and noises is not None and tuple(noises.shape) != (s,) + tuple(target_shape):
            raise ValueError(f"noises has shape {tuple(noises.shape)}, expected "
                             f"{(s,) + tuple(target_shape)}")
        n_final = min(self.final_denoise_steps, s) if self.final_denoise_fn else 0
        states, x0s = [], []
        for i in range(s):
            fn = self.final_denoise_fn if i >= s - n_final else self.denoise_fn
            x_start = self._model_x_start(x, tb["t"][i], x_cond, fn)
            if tb["is_last"][i]:
                x = x_start
            else:
                # The reference multiplies x_start by alpha (NOT sqrt(alpha))
                # in the eps-extraction term (reference :296); reproduced here.
                x = x_start * float(tb["sqrt_alpha_next"][i]) + float(tb["coef"][i]) * (
                    (x - float(tb["alpha"][i]) * x_start) / float(tb["sqrt_om"][i])
                )
                if eta:
                    x = x + float(tb["sigma"][i]) * (noise() if noises is None else noises[i])
            if collect_chain:
                states.append(x)
                x0s.append(x_start)
        if collect_chain:
            return x, torch.stack(states, dim=-1), torch.stack(x0s, dim=-1)
        return x

    @torch.no_grad()
    def p_sample_loop(self, x_cond, target_shape, x_init=None, noises=None, generator=None):
        """Ancestral DDPM sampling over all T steps (reference
        p_sample_loop:235-248, JAX :305-345), for the visualisation: the
        denoiser's output is read as the noise eps, and its time input is
        the noise level sqrt(acp[t + 1]) as the reference's p_mean_variance
        passes it (reference :211-220). ``x_init`` (x_T) and ``noises`` [T,
        *target_shape] (step s, at t = T - 1 - s, adds noises[s]; the last
        adds none) are drawn from ``generator`` where not given."""
        if (x_init is None or noises is None) and generator is None:
            raise ValueError("pass x_init and noises, or a torch.Generator to draw them from")
        c, n = self.constants, self.num_timesteps
        dev, shape = x_cond.device, tuple(target_shape)
        if noises is not None and tuple(noises.shape) != (n,) + shape:
            raise ValueError(f"noises has shape {tuple(noises.shape)}, expected {(n,) + shape}")
        x = (torch.randn(shape, generator=generator, device=dev) if x_init is None
             else x_init.to(torch.float32))
        f32 = lambda a: np.asarray(a, np.float32)
        level = f32(c.sqrt_alphas_cumprod_prev)
        sqrt_om, sqrt_acp = f32(c.sqrt_one_minus_alphas_cumprod), f32(c.sqrt_alphas_cumprod)
        coef1, coef2 = f32(c.posterior_mean_coef1), f32(c.posterior_mean_coef2)
        sigma = np.exp(np.float32(0.5) * f32(c.posterior_log_variance_clipped))
        for step, t in enumerate(range(n - 1, -1, -1)):
            x_in = x
            if self.mode == "s2f" and self.conditional:
                x_in = x.repeat_interleave(x_cond.shape[1], dim=1)
            model_in = torch.cat([x_cond, x_in], dim=-1) if self.conditional else x_in
            time = torch.full((x.shape[0],), float(level[t + 1]), dtype=torch.float32, device=dev)
            eps = self.denoise_fn(model_in, time).to(torch.float32)
            x_start = (x - float(sqrt_om[t]) * eps) / float(sqrt_acp[t])
            x = float(coef1[t]) * x_start + float(coef2[t]) * x
            if t > 0:
                z = (torch.randn(shape, generator=generator, device=dev) if noises is None
                     else noises[step])
                x = x + z * float(sigma[t])
        return x

    def estimate_pose(self, pose_2d, target_shape, repeat_n: int = 1, x_init=None,
                      generator=None, reduce: bool = True, noises=None):
        """DDIM-sample a 3D pose estimate; with repeat_n > 1 the hypotheses
        ride a tiled batch (hypothesis r of row i at row r * B + i, also
        the row order of ``x_init`` and of each step of ``noises``) and are
        averaged (reference :434-448). ``reduce=False`` returns the
        hypotheses [repeat_n, B, ...] instead of their mean (JAX :350-380,
        the reference's multi-hypothesis visualisation)."""
        b = target_shape[0]
        if repeat_n > 1:
            pose_2d = pose_2d.repeat(repeat_n, 1, 1, 1)
            target_shape = (b * repeat_n,) + tuple(target_shape[1:])
        pred = self.ddim_sample_loop(pose_2d, tuple(target_shape), x_init=x_init,
                                     generator=generator, noises=noises)
        if repeat_n > 1:
            pred = pred.reshape((repeat_n, b) + tuple(pred.shape[1:]))
            return pred.mean(dim=0) if reduce else pred
        return pred if reduce else pred[None]
