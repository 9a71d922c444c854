"""Typed run configuration (the port's copy of
``diff3dhpe_tpu/config/config.py``, field for field).

Key names mirror the reference's configs/*.json ``params`` block plus its
CLI flags (reference: common/arguments.py:13-105 and the JSON merge in
run.py:39-113), so the three shipped reference config files parse unchanged.
The reference's three-stage merge (JSON <- CLI overrides -> flat namespace)
becomes: dataclass defaults <- JSON <- explicit overrides.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class Config:
    # Run identity / data
    seed: int = 42
    dataset: str = "h36m"
    keypoints: str = "gt"
    model: str = "ConditionalDiffusionMixSTES2SGRANDLinLift"
    subjects_train: str = "S1,S5,S6,S7,S8"
    subjects_test: str = "S9,S11"
    actions: str = "*"
    data_root: str = "data"
    checkpoint: str = "checkpoint"
    checkpoint_frequency: int = 40

    # Training
    epochs: int = 200
    batch_size: int = 64
    batch_size_eval: int = 512
    learning_rate: float = 4e-5
    lr_decay: float = 0.99
    weight_decay: float = 0.1
    patience: int = 200
    max_time: float = 200.0  # hours
    no_eval: bool = False
    export_training_curves: bool = False

    # Windowing
    stride: int = 81
    number_of_frames: int = 81
    out_all: bool = True
    downsample: int = 1
    subset: float = 1.0

    # Diffusion
    beta_schedule: str = "cosine"
    timesteps: int = 1000
    sampling_timesteps: int = 5
    ddim_sampling_eta: float = 0.0
    clip_denoised: bool = True
    clip_loss: bool = True
    loss_type: str = "l2"
    repeat_n: int = 1

    # Model
    transformer_depth: int = 8
    embed_dim: int = 512
    num_heads: int = 8
    mlp_ratio: float = 2.0
    drop_path_rate: float = 0.1
    with_time_emb: bool = True

    # Augmentation / ablation corruption
    data_augmentation: bool = True
    test_time_augmentation: bool = True
    train_extra_noise_std: float = 0.0
    train_val_extra_noise_std: float = 0.0
    test_extra_noise_std: float = 0.0
    train_joint_drop: float = 0.0
    train_val_joint_drop: float = 0.0
    test_joint_drop: float = 0.0

    # Execution. Every field of the JAX package's Config is kept, so its
    # config files and command lines parse; ``engine.runner.Runner`` refuses
    # the values the port cannot run yet (see its docstring).
    # The ranks' mesh, "data:N,model:M" with N·M the world size (None: every
    # rank on data): N data-parallel groups (parallel/mesh.py), each of M
    # ranks splitting the heads and the MLP's hidden width (tensor
    # parallelism, parallel/tensor.py); M must divide both.
    mesh_shape: Optional[str] = None
    # The session matmul precision of the float32 products outside the fused
    # blocks (ops/matmul_precision.py): "highest", or one bf16 pass at
    # "default" / "bfloat16".
    matmul_precision: str = "highest"
    compute_dtype: str = "float32"  # "bfloat16" for the fast eval path
    # The module's attention goes through the attention kernels
    # (ops.attention.fused_grand_attention), at float32 or bfloat16.
    use_pallas_attention: bool = False
    remat: bool = False  # rematerialised backward of training (JAX); evaluation ignores it
    remat_mode: str = "block"
    # Fused-kernel inference path (models/fast_eval.py) for the evaluation.
    fast_eval: bool = False
    # Mixed-precision fast eval (with fast_eval and compute_dtype=bfloat16):
    # the LAST N DDIM steps run the float32 fused forward, and the head
    # (final LN + [C, 3] projection) stays float32 on the bf16 trunk.
    eval_f32_final_steps: int = 0
    eval_f32_head: bool = False
    # The float32 contraction mode of those final steps' fused blocks
    # (ops/fused_block.py): "highest" (exact float32), "high3" (bf16x3) or
    # "default" (one bf16 pass).
    eval_final_prec: str = "high3"
    # N > 0: only the last N block pairs and the head of the final steps
    # run float32, on a bf16 forward (fast_eval with compute_dtype
    # "bfloat16" and eval_f32_final_steps > 0; the precision tail).
    eval_f32_tail_pairs: int = 0
    # Fused-kernel training forward with the pair-boundary recompute
    # backward (models/fast_eval.py), and its attention backward kernels.
    fast_train: bool = False
    fast_train_pair_vjp: bool = True
    fast_train_attn_bwd: bool = False

    # Checkpointing / eval
    resume: str = ""
    evaluate: str = ""
    pretrained_model: Optional[str] = None
    workers: int = 0  # kept for CLI compat; the numpy pipeline is in-process

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    @property
    def pad(self) -> int:
        return 0 if self.out_all else (self.number_of_frames - 1) // 2


_BOOL_KEYS = {
    "out_all", "data_augmentation", "test_time_augmentation", "clip_denoised",
    "with_time_emb", "clip_loss", "no_eval",
}


def _coerce(key: str, value):
    """Accept the reference's string-typed booleans ('True'/'False')."""
    if key in _BOOL_KEYS and isinstance(value, str):
        return value == "True"
    return value


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Build a Config from a reference-format JSON file plus overrides.

    ``overrides`` with value None are ignored (matching the reference's
    'CLI flag set only if not None' merge, run.py:50-110).
    """
    cfg = Config()
    fields = {f.name for f in dataclasses.fields(Config)}
    if path:
        with open(path) as f:
            params = json.load(f)["params"]
        known = {k: _coerce(k, v) for k, v in params.items() if k in fields}
        cfg = cfg.replace(**known)
    if overrides:
        known = {
            k: _coerce(k, v) for k, v in overrides.items() if k in fields and v is not None
        }
        cfg = cfg.replace(**known)
    return cfg
