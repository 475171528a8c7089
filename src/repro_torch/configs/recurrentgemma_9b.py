"""recurrentgemma-9b — RG-LRU + local attention hybrid (2:1 pattern).
[arXiv:2402.19427]

long_500k RUNS: RG-LRU state is O(1) and the attention layers are
local-only (window 2048 ring cache).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    lru_width=4096, conv_width=4,
    window=2048, pattern="swa",
    rope_theta=1e4, mlp_act="gelu", tie_embeddings=True,
    scale_embed=True, logit_softcap=30.0,
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    num_layers=8, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=256, head_dim=16,
    lru_width=64, conv_width=4,
    window=16, pattern="swa",
    rope_theta=1e4, mlp_act="gelu", tie_embeddings=True,
    scale_embed=True, logit_softcap=30.0, q_chunk=16, kv_chunk=32,
)
