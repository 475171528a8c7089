"""qwen2.5-14b — dense GQA decoder with QKV bias.
[hf:Qwen/Qwen2.5-14B; dims per assignment]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6, mlp_act="silu",
)

SMOKE = ArchConfig(
    name="qwen2.5-14b-smoke", family="dense",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    qkv_bias=True, rope_theta=1e4, mlp_act="silu",
    q_chunk=16, kv_chunk=32,
)
