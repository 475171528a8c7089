"""deepseek-7b — llama-arch dense decoder (GQA kv=32 == MHA).
[arXiv:2401.02954]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400, head_dim=128,
    rope_theta=1e4, mlp_act="silu",
)

SMOKE = ArchConfig(
    name="deepseek-7b-smoke", family="dense",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=112, vocab=256, head_dim=16,
    rope_theta=1e4, mlp_act="silu", q_chunk=16, kv_chunk=32,
)
