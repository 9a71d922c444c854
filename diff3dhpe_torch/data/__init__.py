from diff3dhpe_torch.data.chunking import (
    ChunkSpec,
    build_seq2frame_chunks,
    build_seq2seq_chunks,
    materialize_window,
)
from diff3dhpe_torch.data.dataset import Batch, PoseDataset
from diff3dhpe_torch.data.h36m import Human36mDataset, h36m_skeleton
from diff3dhpe_torch.data.synthetic import make_synthetic_h36m_like

__all__ = [
    "Batch", "ChunkSpec", "Human36mDataset", "PoseDataset", "build_seq2frame_chunks",
    "build_seq2seq_chunks", "h36m_skeleton", "make_synthetic_h36m_like", "materialize_window",
]
