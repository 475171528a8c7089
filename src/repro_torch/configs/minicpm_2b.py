"""minicpm-2b — llama-like dense decoder trained with the WSD schedule.
[arXiv:2404.06395]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753, head_dim=64,
    rope_theta=1e4, mlp_act="silu", tie_embeddings=True,
    scale_embed=True, lr_schedule="wsd",
)

SMOKE = ArchConfig(
    name="minicpm-2b-smoke", family="dense",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16,
    rope_theta=1e4, mlp_act="silu", tie_embeddings=True,
    scale_embed=True, lr_schedule="wsd", q_chunk=16, kv_chunk=32,
)
