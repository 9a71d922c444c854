"""MixSTE spatio-temporal transformer denoiser, plain PyTorch.

The port's parity path: the part the flax module
``diff3dhpe_tpu/models/mixste.py::MixSTEDenoiser`` plays for JAX. Module
and parameter names are the reference model's
(common/nets/model_conditional_diffusion_mixste_s2s_grand_linLift.py), so
``state_dict()`` keys equal the names ``io.convert.state_dict_from_flax``
emits and a strict load works both ways.

Per denoise call (x: [B, F, J, in_chans + 3] = 2D xy ++ noisy 3D xyz):
  fusion Linear in->C
  time embedding: sinusoidal(C) -> Linear 2C -> GELU -> Linear 2C
  depth x [ spatial block over joints  -> Spatial_norm,
            temporal block over frames -> Temporal_norm ]
  (the spatial position embedding enters before the first spatial block,
   the temporal one between the first spatial and temporal blocks)
  [s2f: learned weighted mean over frames]
  head: LayerNorm (eps 1e-5) -> Linear C->3

Drop-path (stochastic depth) takes explicit scales: ``forward(x, time,
dp_scales)`` with one scale per attention group and residual branch, the
counterpart of the flax ``DropPath`` and of JAX's ``xla_forward_denoise``
with ``dp_scales``. Dropout is 0 in every shipped config and not ported.
"""
from __future__ import annotations

import math
import torch
from torch import nn
from torch.nn import functional as F

from diff3dhpe_torch.device import resolve_device
from diff3dhpe_torch.ops.attention import (
    fused_grand_attention,
    grand_attention,
    grand_attention_trainable,
)


def sinusoidal_pos_emb(t, dim: int):
    """Diffusion-time sinusoidal embedding (reference SinusoidalPosEmb:24-36).

    t: [B] float; returns [B, dim] float32 = cat(sin, cos) over dim//2
    frequencies."""
    half_dim = dim // 2
    emb_scale = math.log(10000) / (half_dim - 1)
    freqs = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb_scale
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator):
    """Redraw every Linear/Conv1d under ``module`` from ``generator`` (a CPU
    generator; the module on the CPU) with torch's default
    U(±1/sqrt(fan_in)) bound for weights and biases, the flax TorchDense
    init."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    """Multi-head self-attention with the GRAND (attn − I) v modification.
    ``use_pallas`` (JAX's name for it): the attention core goes through the
    dispatcher ``fused_grand_attention``, whose kernels are float32."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, use_pallas: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.use_pallas = use_pallas
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, attn_bwd: bool = False):
        """``attn_bwd``: the attention core runs through
        ``grand_attention_trainable`` (its kernels on CUDA) instead of the
        autograd of the plain formulas."""
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        if attn_bwd:
            out = grand_attention_trainable(q, k, v)
        elif self.use_pallas:
            out = fused_grand_attention(q, k, v, self.scale)
        else:
            out = grand_attention(q, k, v, self.scale)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Block(nn.Module):
    """Pre-norm transformer block with per-block diffusion-time injection
    (reference Block:90-135). Operates on [B, F, J, C]; ``is_spatial``
    selects whether attention mixes joints (per frame) or frames (per
    joint). ``dp`` [B, G, 2] scales the attention (column 0) and MLP
    (column 1) branches of each attention group: G = F frames for a spatial
    block, J joints for a temporal one (JAX ``_xla_block``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, qkv_bias: bool,
                 with_time_emb: bool = True, use_pallas: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, use_pallas)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.time_mlp = (
            nn.Sequential(nn.SiLU(), nn.Linear(dim * 2, dim)) if with_time_emb else None
        )

    def forward(self, x, is_spatial: bool, time_emb=None, dp=None, attn_bwd: bool = False):
        b, f, p, c = x.shape
        if self.time_mlp is not None and time_emb is not None:
            x = x + self.time_mlp(time_emb)[:, None, None, :]
        if is_spatial:
            tokens = x.reshape(b * f, p, c)
        else:
            tokens = x.transpose(1, 2).reshape(b * p, f, c)
        def branch(col, y):
            return y if dp is None else dp[:, :, col].reshape(-1, 1, 1) * y

        tokens = tokens + branch(0, self.attn(self.norm1(tokens), attn_bwd))
        tokens = tokens + branch(1, self.mlp(self.norm2(tokens)))
        if is_spatial:
            return tokens.reshape(b, f, p, c)
        return tokens.reshape(b, p, f, c).transpose(1, 2)


class MixSTEDenoiser(nn.Module):
    """Conditional-diffusion MixSTE denoiser with GRAND attention + linear
    lift: x [B, F, J, in_chans + 3], time [B] -> [B, F, J, 3] (s2s) or
    [B, 1, J, 3] (s2f).

    Parameters are drawn from ``seed`` (torch.nn.Linear's default
    U(±1/sqrt(fan_in)) for weights and biases, zero position embeddings)
    and placed on ``device``. ``use_pallas``: every block's attention goes
    through ``ops.attention.fused_grand_attention`` (B6 for the joints, B3
    for the frames, on CUDA; their plain versions on the CPU). Those kernels
    are float32, so such a model cast to bfloat16 raises in its forward."""

    def __init__(
        self,
        num_frame: int = 9,
        num_joints: int = 17,
        in_chans: int = 2,
        embed_dim: int = 32,
        depth: int = 4,
        num_heads: int = 8,
        mlp_ratio: float = 2.0,
        qkv_bias: bool = True,
        with_time_emb: bool = True,
        mode: str = "s2s",
        out_dim: int = 3,
        use_pallas: bool = False,
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        if mode not in ("s2s", "s2f"):
            raise ValueError(f"mode must be 's2s' or 's2f', got {mode!r}")
        device = resolve_device(device)
        c = embed_dim
        self.num_frame, self.num_joints, self.depth = num_frame, num_joints, depth
        self.num_heads, self.embed_dim, self.mode = num_heads, c, mode
        self.with_time_emb, self.use_pallas = with_time_emb, use_pallas

        self.fusion_layer = nn.Linear(in_chans + 3, c)
        # nn.Sequential(SinusoidalPosEmb, Linear, GELU, Linear) in the
        # reference: index 0 holds no parameters.
        self.time_mlp = (
            nn.Sequential(nn.Identity(), nn.Linear(c, c * 2), nn.GELU(), nn.Linear(c * 2, c * 2))
            if with_time_emb else None
        )
        self.Spatial_pos_embed = nn.Parameter(torch.zeros(1, num_joints, c))
        self.Temporal_pos_embed = nn.Parameter(torch.zeros(1, num_frame, c))

        def blocks():
            return nn.ModuleList(
                Block(c, num_heads, mlp_ratio, qkv_bias, with_time_emb, use_pallas)
                for _ in range(depth)
            )

        self.STEblocks = blocks()
        self.TTEblocks = blocks()
        self.Spatial_norm = nn.LayerNorm(c, eps=1e-6)
        self.Temporal_norm = nn.LayerNorm(c, eps=1e-6)
        if mode == "s2f":
            # Conv1d(F -> 1, k=1) on [B, F, J*C]: a learned weighted mean.
            self.weighted_mean = nn.Conv1d(num_frame, 1, kernel_size=1)
        self.head = nn.Sequential(nn.LayerNorm(c, eps=1e-5), nn.Linear(c, out_dim))
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def time_embedding(self, time):
        """[B] diffusion times -> [B, 2C] time embedding (None without)."""
        if self.time_mlp is None:
            return None
        return self.time_mlp(sinusoidal_pos_emb(time, self.embed_dim))

    def weighted_mean_over_frames(self, x):
        """s2f head: [B, F, J, C] -> [B, 1, J, C], with the weights in x's dtype."""
        w = self.weighted_mean.weight.reshape(-1).to(x.dtype)
        return torch.einsum("bfpc,f->bpc", x, w)[:, None] + self.weighted_mean.bias.to(x.dtype)

    def pair(self, i, x, t, dp_s=None, dp_t=None, attn_bwd: bool = False):
        """Block pair i on [B, F, J, C]: spatial block, Spatial_norm, [the
        temporal position embedding when i == 0], temporal block,
        Temporal_norm. ``t`` is the [B, 2C] time embedding (or None); dp_s
        [B, F, 2], dp_t [B, J, 2] the pair's drop-path scales. The port of
        JAX ``_xla_pair``, and the recompute target of the fused pair's
        backward (``models.fast_eval``)."""
        x = self.Spatial_norm(self.STEblocks[i](x, True, t, dp_s, attn_bwd))
        if i == 0:
            x = x + self.Temporal_pos_embed[:, :, None, :]
        return self.Temporal_norm(self.TTEblocks[i](x, False, t, dp_t, attn_bwd))

    def pair_parameters(self, i):
        """The parameters that block pair i reads, in a fixed order."""
        mods = (self.STEblocks[i], self.TTEblocks[i], self.Spatial_norm, self.Temporal_norm)
        params = [p for m in mods for p in m.parameters()]
        return params + [self.Temporal_pos_embed] if i == 0 else params

    def forward(self, x, time, dp_scales=None):
        """``dp_scales``: None, or (dp_spatial [depth, B, F, 2], dp_temporal
        [depth, B, J, 2]) drop-path scales (``draw_drop_path_scales``)."""
        if x.ndim != 4:
            raise ValueError(f"expected x of shape [B, F, J, C], got {tuple(x.shape)}")
        if self.use_pallas and self.fusion_layer.weight.dtype != torch.float32:
            raise ValueError("use_pallas needs a float32 model: the attention kernels are "
                             f"float32, the weights are {self.fusion_layer.weight.dtype}")
        dp_sp, dp_tp = (None, None) if dp_scales is None else dp_scales
        x = self.fusion_layer(x)
        t = self.time_embedding(time)
        x = x + self.Spatial_pos_embed[None]
        for i in range(self.depth):
            x = self.pair(i, x, t, None if dp_sp is None else dp_sp[i],
                          None if dp_tp is None else dp_tp[i])
        if self.mode == "s2f":
            x = self.weighted_mean_over_frames(x)
        return self.head(x)
