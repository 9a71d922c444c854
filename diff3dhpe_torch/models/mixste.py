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
with ``dp_scales``. Dropout (``drop_rate``, ``attn_drop_rate``; 0 in every
shipped config) takes explicit masks the same way, as a third entry of
``dp_scales`` (``draw_dropout_masks``), at flax's sites and in flax's
order: after each position embedding, after the attention's ``proj``,
after the MLP's GELU and after its ``fc2`` (``drop_rate``), and, where
``attn_drop_rate`` > 0, on the materialised attention probabilities,
ahead of ``use_pallas`` (JAX mixste.py:138-143). Without masks (the
evaluation) no element is dropped. ``qk_scale`` is the attention's scale
in place of head_dim^-½, with JAX's ``or``: None and 0 both mean
head_dim^-½.

Tensor parallelism (``parallel.tensor.shard_model``): each ``Attention``
and ``Mlp`` holds its model rank's heads and hidden columns and its
``model_group``; the column-parallel ``qkv`` and ``fc1`` read their input
through ``copy_to_model`` and the row-parallel ``proj`` and ``fc2`` sum
their partial products with ``reduce_from_model`` before adding the bias
once. Without a model group the code path is the one-process module's.

``matmul_precision`` (``forward``'s argument; ``ops.matmul_precision``) is
the session precision JAX's Runner sets: at "default" or "bfloat16" every
float32 product of the module (the dense layers, the attention's two
products, the s2f weighted mean) contracts in one bf16 pass, forward and
backward; "highest", the default, is exact float32.

``dtype=torch.bfloat16`` is flax's ``MixSTEDenoiser(dtype=bfloat16)``:
parameters stay float32 (flax's ``param_dtype``), every dense layer casts
its input, weight and bias to bf16 (``dense``), the attention runs on bf16
q, k, v with its softmax in float32, and a LayerNorm, which has no dtype in
flax, returns float32 (its output type is promoted with its float32
parameters), so the residual stream is float32 from the first
``Spatial_norm`` on and the output is bf16. ``remat_blocks`` recomputes
each block in the backward (``torch.utils.checkpoint``, JAX's
``nn.remat(Block)``).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from diff3dhpe_torch.device import resolve_device
from diff3dhpe_torch.ops.attention import fused_grand_attention, grand_attention
from diff3dhpe_torch.ops.matmul_precision import matmul, session_mode
from diff3dhpe_torch.parallel.tensor import copy_to_model, reduce_from_model


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


def dense(layer, x, dtype=None, matmul_precision="highest", model_group=None):
    """flax ``TorchDense`` (JAX ``fast_eval._dense``): x @ W + b in ``dtype``
    (default x's), x, W and b cast to it; below float32 the bias is added to
    the rounded product. At float32 the product contracts at
    ``matmul_precision`` (the bias added after it). ``model_group``: the
    layer is row-parallel, its partial products summed over the group
    (``reduce_from_model``) before the bias is added."""
    dtype = x.dtype if dtype is None else dtype
    x, w = x.to(dtype), layer.weight.to(dtype)
    b = None if layer.bias is None else layer.bias.to(dtype)
    if dtype == torch.float32 and session_mode(matmul_precision) != "highest":
        y = matmul(x, w.t(), matmul_precision)
    elif dtype == torch.float32 and model_group is None:
        return F.linear(x, w, b)
    else:
        y = F.linear(x, w)
    if model_group is not None:
        y = reduce_from_model(y, model_group)
    return y if b is None else y + b


def gelu(x):
    """Exact GELU; below float32 as JAX's ``jax.nn.gelu(approximate=False)``
    is typed: (x / 2) · erfc(−x · √½), each step rounded to x's dtype and √½
    a constant of it."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return (x * 0.5) * torch.erfc(-x * float(torch.tensor(0.5 ** 0.5, dtype=x.dtype)))


def silu(x):
    """SiLU; below float32 as JAX's ``jax.nn.silu`` is typed, x · 1 / (1 +
    exp(−x)) with each step rounded to x's dtype."""
    return F.silu(x) if x.dtype == torch.float32 else x * (1 / (1 + torch.exp(-x)))


def dropout(x, kept, rate):
    """flax ``nn.Dropout`` on x with its mask given: ``kept`` (bool, x's
    shape) marks the kept elements, each x / (1 − rate) in x's dtype (a
    division by the keep rate as a constant of x's dtype, JAX's weakly
    typed Python float), the others 0. With ``kept`` None or a rate of 0 it
    returns x; at a rate of 1 zeros whose gradient is 0 (flax returns
    zeros there: x / 0 would make it NaN)."""
    if kept is None or rate <= 0.0:
        return x
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if rate >= 1.0:
        return torch.where(torch.zeros_like(kept), x, zero)
    keep = 1.0 - rate
    if x.dtype != torch.float32:
        keep = float(torch.tensor(keep, dtype=x.dtype))
    return torch.where(kept, x / keep, zero)


# The dropout sites of one block (``Block.forward``'s ``drop``): the
# attention probabilities at attn_drop_rate, the others at drop_rate.
BLOCK_DROP_SITES = ("attn", "proj", "fc1", "fc2")


def draw_dropout_masks(model, generator, batch, num_frame, num_joints):
    """The dropout masks of one training forward of ``model`` (None where
    its ``drop_rate`` and ``attn_drop_rate`` are both 0), drawn from
    ``generator`` on its device: each element kept where a uniform draw
    falls below 1 − rate, as ``jax.random.bernoulli`` keeps it. A dict of
    bool tensors, each with the batch on dim 1, for the whole module (all
    heads, the whole hidden width) whatever its model axis:

    - ``pos`` [2, B, F, J, C]: after the spatial and the temporal position
      embedding;
    - ``{site}_spatial`` [depth, B, F, ...] and ``{site}_temporal`` [depth,
      B, J, ...], one per block, the group's tokens in flax's order: ``attn``
      [..., H, N, N] (with ``attn_drop_rate`` > 0), ``proj`` and ``fc2``
      [..., N, C], ``fc1`` [..., N, hidden].

    The draws are torch's, not JAX's: tests inject the same masks into
    both."""
    rates = {"attn": model.attn_drop_rate}
    rates.update(dict.fromkeys(("pos", "proj", "fc1", "fc2"), model.drop_rate))
    if not any(r > 0.0 for r in rates.values()):
        return None
    b, f, p, c = batch, num_frame, num_joints, model.embed_dim
    h, hidden, depth = model.num_heads, model.mlp_hidden, model.depth
    dev = generator.device
    groups = {"spatial": (f, p), "temporal": (p, f)}  # (groups a sample, tokens a group)
    shapes = {"pos": (2, b, f, p, c)}
    for kind, (g, n) in groups.items():
        shapes.update({f"attn_{kind}": (depth, b, g, h, n, n), f"proj_{kind}": (depth, b, g, n, c),
                       f"fc1_{kind}": (depth, b, g, n, hidden),
                       f"fc2_{kind}": (depth, b, g, n, c)})
    masks = {}
    for name, shape in shapes.items():
        rate = rates[name.split("_")[0]]
        if rate <= 0.0:
            continue
        kept = torch.empty(shape, dtype=torch.bool, device=dev)
        for i in range(shape[0]):  # a layer at a time: a float draw of the whole is 4x its size
            kept[i] = torch.rand(shape[1:], generator=generator, device=dev) < 1.0 - rate
        masks[name] = kept
    return masks


def layer_norm(ln, x, dtype=torch.float32):
    """The LayerNorm ``ln`` computed in float32 on x, returned in ``dtype``:
    float32 as flax's LayerNorm returns it (the type of x promoted with its
    float32 parameters), or x's dtype as JAX's ``fast_eval._layernorm``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


class Mlp(nn.Module):
    """fc1 -> GELU -> [dropout] -> fc2 -> [dropout] at rate ``drop``; under
    tensor parallelism (``model_group``) fc1's output columns and fc2's
    input columns are the model rank's."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = drop
        self.model_group = None

    def forward(self, x, dtype=torch.float32, matmul_precision="highest", drop=None):
        """``drop``: None, or the block's masks (``fc1``: this rank's
        hidden columns; ``fc2``)."""
        group, kept = self.model_group, drop or {}
        if group is not None:
            x = copy_to_model(x, group)
        mid = dropout(gelu(dense(self.fc1, x, dtype, matmul_precision)), kept.get("fc1"),
                      self.drop)
        return dropout(dense(self.fc2, mid, dtype, matmul_precision, group), kept.get("fc2"),
                       self.drop)


class Attention(nn.Module):
    """Multi-head self-attention with the GRAND (attn − I) v modification.
    ``use_pallas`` (JAX's name for it): the attention core goes through the
    dispatcher ``fused_grand_attention``, at float32 or bfloat16. The
    dispatcher has no backward and refuses to run under autograd, as
    ``jax.grad`` through JAX's ``use_pallas`` module raises. Under tensor
    parallelism (``model_group``) ``num_heads`` counts the model rank's
    heads, of the global width ``head_dim``, and the scale stays the global
    width's. ``qk_scale``: the scale, JAX's ``qk_scale or head_dim^-½``.
    ``attn_drop`` and ``proj_drop``: the dropout rates of the
    probabilities and of the output."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, use_pallas: bool = False,
                 qk_scale=None, attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.use_pallas = use_pallas
        self.model_group = None
        self.scale = qk_scale or self.head_dim ** -0.5
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, core=None, dtype=torch.float32, matmul_precision="highest", drop=None):
        """``core``: the attention core, (q, k, v) [B, H, N, D] -> [B, H, N,
        D] at the scale D^-½ and at the caller's matmul precision; default
        the module's own (the dispatcher with ``use_pallas``, else the plain
        formulas, at ``matmul_precision``, each at ``self.scale``).
        ``dtype``: of the dense layers and so of q, k, v and the attention.
        ``drop``: None, or the block's masks; with ``attn`` the
        probabilities are materialised and dropped, whatever ``core`` and
        ``use_pallas`` (JAX's branch, taken first)."""
        b, n, _ = x.shape
        prec, group, kept = matmul_precision, self.model_group, drop or {}
        if group is not None:
            x = copy_to_model(x, group)
        qkv = dense(self.qkv, x, dtype, prec).reshape(b, n, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        if kept.get("attn") is not None:
            out = grand_attention(q, k, v, self.scale, prec,
                                  drop=lambda p: dropout(p, kept["attn"], self.attn_drop))
        elif core is not None:
            out = core(q, k, v)
        elif self.use_pallas:
            out = fused_grand_attention(q, k, v, self.scale, prec)
        else:
            out = grand_attention(q, k, v, self.scale, prec)
        out = out.transpose(1, 2).reshape(b, n, self.num_heads * self.head_dim)
        return dropout(dense(self.proj, out, dtype, prec, group), kept.get("proj"),
                       self.proj_drop)


class Block(nn.Module):
    """Pre-norm transformer block with per-block diffusion-time injection
    (reference Block:90-135). Operates on [B, F, J, C]; ``is_spatial``
    selects whether attention mixes joints (per frame) or frames (per
    joint). ``dp`` [B, G, 2] scales the attention (column 0) and MLP
    (column 1) branches of each attention group: G = F frames for a spatial
    block, J joints for a temporal one (JAX ``_xla_block``). ``drop`` and
    ``attn_drop``: the dropout rates of the attention's output and the MLP,
    and of the attention probabilities; ``qk_scale`` the attention's."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, qkv_bias: bool,
                 with_time_emb: bool = True, use_pallas: bool = False, qk_scale=None,
                 drop: float = 0.0, attn_drop: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, use_pallas, qk_scale, attn_drop, drop)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)
        self.time_mlp = (
            nn.Sequential(nn.SiLU(), nn.Linear(dim * 2, dim)) if with_time_emb else None
        )

    def forward(self, x, is_spatial: bool, time_emb=None, dp=None, attn_core=None,
                dtype=torch.float32, matmul_precision="highest", drop=None):
        """``dtype``: of the dense layers and the attention (flax's
        ``dtype``); norm1 and norm2 feed dense layers only, so their output
        type does not matter. A drop-path scale multiplies its branch in the
        branch's dtype (JAX ``_xla_block``), after the branch's dropout.
        ``matmul_precision``: of the float32 products. ``drop``: None, or
        {site: mask} of ``BLOCK_DROP_SITES``, each with the groups' tokens
        in its leading dim (B·G)."""
        b, f, p, c = x.shape
        prec = matmul_precision
        if self.time_mlp is not None and time_emb is not None:
            x = x + dense(self.time_mlp[1], silu(time_emb), dtype, prec)[:, None, None, :]
        if is_spatial:
            tokens = x.reshape(b * f, p, c)
        else:
            tokens = x.transpose(1, 2).reshape(b * p, f, c)

        def branch(col, y):
            return y if dp is None else y * dp[:, :, col].reshape(-1, 1, 1).to(y.dtype)

        tokens = tokens + branch(0, self.attn(layer_norm(self.norm1, tokens), attn_core, dtype,
                                              prec, drop))
        tokens = tokens + branch(1, self.mlp(layer_norm(self.norm2, tokens), dtype, prec, drop))
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
    for the frames, on CUDA, at float32 or bfloat16; their plain versions on
    the CPU). ``dtype``: float32 or bfloat16, the compute dtype of the
    module doc (parameters stay float32). ``remat_blocks``: each block is
    recomputed in the backward instead of keeping its activations.
    ``qk_scale``, ``drop_rate`` and ``attn_drop_rate``: flax's fields (module
    doc); the fused paths of ``models.fast_eval`` refuse a module that sets
    any of them, where JAX's silently run head_dim^-½ and no dropout."""

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
        dtype=torch.float32,
        remat_blocks: bool = False,
        seed: int = 0,
        device="cuda",
        qk_scale=None,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
    ):
        super().__init__()
        if mode not in ("s2s", "s2f"):
            raise ValueError(f"mode must be 's2s' or 's2f', got {mode!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        device = resolve_device(device)
        c = embed_dim
        self.num_frame, self.num_joints, self.depth = num_frame, num_joints, depth
        self.num_heads, self.embed_dim, self.mode = num_heads, c, mode
        self.with_time_emb, self.use_pallas = with_time_emb, use_pallas
        self.dtype, self.remat_blocks = dtype, remat_blocks
        self.qk_scale, self.drop_rate, self.attn_drop_rate = qk_scale, drop_rate, attn_drop_rate
        self.mlp_hidden = int(c * mlp_ratio)

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
                Block(c, num_heads, mlp_ratio, qkv_bias, with_time_emb, use_pallas, qk_scale,
                      drop_rate, attn_drop_rate)
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

    def time_embedding(self, time, dtype=None, matmul_precision="highest"):
        """[B] diffusion times -> [B, 2C] time embedding in ``dtype`` (default
        the module's; None without), JAX ``compute_t``."""
        if self.time_mlp is None:
            return None
        dtype = self.dtype if dtype is None else dtype
        t = dense(self.time_mlp[1], sinusoidal_pos_emb(time, self.embed_dim), dtype,
                  matmul_precision)
        return dense(self.time_mlp[3], gelu(t), dtype, matmul_precision)

    def weighted_mean_over_frames(self, x, matmul_precision="highest"):
        """s2f head: [B, F, J, C] -> [B, 1, J, C], with the weights in x's
        dtype; at float32 the contraction over frames at ``matmul_precision``."""
        w = self.weighted_mean.weight.reshape(-1).to(x.dtype)
        bias = self.weighted_mean.bias.to(x.dtype)
        if x.dtype == torch.float32 and session_mode(matmul_precision) != "highest":
            b, f, p, c = x.shape
            mean = matmul(w[None], x.reshape(b, f, p * c), matmul_precision)
            return mean.reshape(b, 1, p, c) + bias
        return torch.einsum("bfpc,f->bpc", x, w)[:, None] + bias

    def pair_parameters(self, i):
        """The parameters that block pair i reads, in a fixed order."""
        mods = (self.STEblocks[i], self.TTEblocks[i], self.Spatial_norm, self.Temporal_norm)
        params = [p for m in mods for p in m.parameters()]
        return params + [self.Temporal_pos_embed] if i == 0 else params

    def forward(self, x, time, dp_scales=None, matmul_precision="highest"):
        """``dp_scales``: None, or (dp_spatial [depth, B, F, 2], dp_temporal
        [depth, B, J, 2]) drop-path scales (``draw_drop_path_scales``; None
        for none), with a third entry, the dropout masks
        (``draw_dropout_masks``), where the step drops. Each block pair:
        spatial block, Spatial_norm, [the temporal position embedding before
        the first temporal block], temporal block, Temporal_norm; with
        ``remat_blocks`` and autograd recording, each block under
        ``checkpoint`` (the drop-path scales and the masks are inputs, so
        the recompute sees the same ones). ``matmul_precision``: the session
        precision of the float32 products (module doc)."""
        if x.ndim != 4:
            raise ValueError(f"expected x of shape [B, F, J, C], got {tuple(x.shape)}")
        if self.fusion_layer.weight.dtype != torch.float32:
            raise ValueError("the module keeps float32 parameters (flax's param_dtype), got "
                             f"{self.fusion_layer.weight.dtype}; build it with dtype="
                             "torch.bfloat16 to compute at bf16")
        dp_sp, dp_tp, masks = (None, None, None) if dp_scales is None else (*dp_scales, None)[:3]
        masks = masks or {}
        dt, prec = self.dtype, matmul_precision
        pos = masks.get("pos")
        x = dense(self.fusion_layer, x, dt, prec)
        t = self.time_embedding(time, matmul_precision=prec)
        x = dropout(x + self.Spatial_pos_embed[None].to(x.dtype), None if pos is None else pos[0],
                    self.drop_rate)

        def block(blk, y, is_spatial, dp, kind, i):
            drop = {s: masks[f"{s}_{kind}"][i].flatten(0, 1) for s in BLOCK_DROP_SITES
                    if f"{s}_{kind}" in masks} or None
            if self.remat_blocks and torch.is_grad_enabled():
                return checkpoint(blk, y, is_spatial, t, dp, None, dt, prec, drop,
                                  use_reentrant=False)
            return blk(y, is_spatial, t, dp, None, dt, prec, drop)

        for i in range(self.depth):
            x = layer_norm(self.Spatial_norm, block(
                self.STEblocks[i], x, True, None if dp_sp is None else dp_sp[i], "spatial", i))
            if i == 0:
                x = dropout(x + self.Temporal_pos_embed[:, :, None, :].to(x.dtype),
                            None if pos is None else pos[1], self.drop_rate)
            x = layer_norm(self.Temporal_norm, block(
                self.TTEblocks[i], x, False, None if dp_tp is None else dp_tp[i], "temporal", i))
        if self.mode == "s2f":
            x = self.weighted_mean_over_frames(x, prec)
        return dense(self.head[1], layer_norm(self.head[0], x), dt, prec)
