"""Checkpoints of numpy and torch state: per-leaf ``.npy`` files with a
manifest, atomic publish, keep-N retention, an async writer
(`repro_torch.ckpt.checkpoint`). The directory layout is the reference's,
so each package restores the other's numpy checkpoints."""
from repro_torch.ckpt.checkpoint import CheckpointManager, path_str

__all__ = ["CheckpointManager", "path_str"]
