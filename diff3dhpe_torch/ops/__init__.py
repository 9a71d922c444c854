from diff3dhpe_torch.ops.attention import (
    fused_grand_attention,
    grand_attention,
    grand_attention_bwd,
    grand_attention_bwd_ref,
    grand_attention_fullseq,
    grand_attention_fullseq_ref,
    grand_attention_trainable,
)
from diff3dhpe_torch.ops.fused_block import (
    fused_temporal_block_cols,
    fused_temporal_block_cols_ref,
    fused_transformer_block,
    fused_transformer_block_ref,
)

__all__ = [
    "fused_grand_attention", "fused_temporal_block_cols", "fused_temporal_block_cols_ref",
    "fused_transformer_block", "fused_transformer_block_ref",
    "grand_attention", "grand_attention_bwd", "grand_attention_bwd_ref",
    "grand_attention_fullseq", "grand_attention_fullseq_ref", "grand_attention_trainable",
]
