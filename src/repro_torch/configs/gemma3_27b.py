"""gemma3-27b — dense GQA, 5:1 local:global attention, QK-norm.
[hf:google/gemma-3-27b-pt; dims per assignment]

long_500k is SKIPPED for this arch: the 1-in-6 global layers are full
attention over the whole context (see DESIGN.md §Arch-applicability).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    num_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab=262144, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    window=1024, pattern="gemma3",
    attn_scale=168 ** -0.5,        # query_pre_attn_scalar = d_model/n_heads
    mlp_act="gelu", tie_embeddings=True, scale_embed=True,
)

SMOKE = ArchConfig(
    name="gemma3-27b-smoke", family="dense",
    num_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    qk_norm=True, rope_theta=1e4,
    window=8, pattern="gemma3",
    mlp_act="gelu", tie_embeddings=True, scale_embed=True,
    q_chunk=16, kv_chunk=32,
)
