"""repro_torch.data — the deterministic synthetic token pipeline (the
port of ``repro.data``; numpy batches, bit-equal to the reference's)."""

from .pipeline import DataConfig, SyntheticTokens

__all__ = ["DataConfig", "SyntheticTokens"]
