"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention.
[arXiv:2401.04088]

All layers are SWA, so the decode KV cache is a ring buffer of the
window — the eviction IS the overwrite (see models/transformer.py).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, head_dim=128,
    n_experts=8, top_k=2, moe_d_ff=16384,
    router_fn="softmax", moe_cf=1.25,
    window=4096, pattern="swa",
    rope_theta=1e6, mlp_act="silu",
)

SMOKE = ArchConfig(
    name="mixtral-8x22b-smoke", family="moe",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    n_experts=4, top_k=2, moe_d_ff=128,
    router_fn="softmax", moe_cf=2.0,
    window=16, pattern="swa",
    rope_theta=1e4, mlp_act="silu", q_chunk=16, kv_chunk=32,
)
