"""Checkpoints: atomic-commit manifests, async save, restore
(``store.py``)."""
from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          restore, restore_blind, save)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "restore_blind",
           "save"]
