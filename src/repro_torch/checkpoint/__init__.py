"""Async, atomic checkpointing of parameter + optimizer trees in the
reference's on-disk format.  Counterpart of ``repro/checkpoint``."""

from repro_torch.checkpoint.checkpointer import (CheckpointConfig, Checkpointer,
                                                 restore_tree, save_tree)

__all__ = ["Checkpointer", "CheckpointConfig", "save_tree", "restore_tree"]
