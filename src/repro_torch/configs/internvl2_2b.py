"""internvl2-2b — InternLM2-1.8B backbone + InternViT frontend (STUB).
[arXiv:2404.16821]

Per the assignment spec the ViT is a stub: ``input_specs`` provides
precomputed patch embeddings (B, 256, vit_dim); a learned projection
maps them into the LM embedding space, occupying the first 256
positions of the sequence.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, head_dim=128,
    num_image_tokens=256, vit_dim=1024,
    rope_theta=1e6, mlp_act="silu",
)

SMOKE = ArchConfig(
    name="internvl2-2b-smoke", family="vlm",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    num_image_tokens=8, vit_dim=32,
    rope_theta=1e4, mlp_act="silu", q_chunk=16, kv_chunk=32,
)
