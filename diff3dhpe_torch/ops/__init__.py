from diff3dhpe_torch.ops.attention import (
    fused_grand_attention,
    grand_attention,
    grand_attention_bwd,
    grand_attention_bwd_ref,
    grand_attention_fullseq,
    grand_attention_fullseq_ref,
    grand_attention_trainable,
    packed_grand_attention,
    packed_grand_attention_ref,
)
from diff3dhpe_torch.ops.fused_block import (
    fused_attention_block,
    fused_attention_block_ref,
    fused_temporal_block_cols,
    fused_temporal_block_cols_ref,
    fused_transformer_block,
    fused_transformer_block_ref,
)

# The six kernel wrappers, each counting the launches of its kernels in
# ``.launches`` (and, where it has a bf16 instance, ``.launches_bf16``).
KERNEL_WRAPPERS = (fused_transformer_block, fused_temporal_block_cols, grand_attention_fullseq,
                   grand_attention_bwd, packed_grand_attention, fused_attention_block)


def reset_launches() -> None:
    """Sets every kernel wrapper's launch counts to 0."""
    for w in KERNEL_WRAPPERS:
        w.launches = 0
        if hasattr(w, "launches_bf16"):
            w.launches_bf16 = 0


def read_launches() -> dict:
    """{wrapper name: launches, wrapper name + "_bf16": bf16 launches}."""
    got = {}
    for w in KERNEL_WRAPPERS:
        got[w.__name__] = w.launches
        if hasattr(w, "launches_bf16"):
            got[f"{w.__name__}_bf16"] = w.launches_bf16
    return got


__all__ = [
    "KERNEL_WRAPPERS", "read_launches", "reset_launches",
    "fused_attention_block", "fused_attention_block_ref", "fused_grand_attention",
    "fused_temporal_block_cols", "fused_temporal_block_cols_ref",
    "fused_transformer_block", "fused_transformer_block_ref",
    "grand_attention", "grand_attention_bwd", "grand_attention_bwd_ref",
    "grand_attention_fullseq", "grand_attention_fullseq_ref", "grand_attention_trainable",
    "packed_grand_attention", "packed_grand_attention_ref",
]
