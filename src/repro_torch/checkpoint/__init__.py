"""repro_torch.checkpoint — the async checkpointer (the port of
``repro.checkpoint``; the reference's on-disk layout)."""

from .checkpointer import Checkpointer, install_sigterm_hook

__all__ = ["Checkpointer", "install_sigterm_hook"]
