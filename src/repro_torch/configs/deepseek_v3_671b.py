"""deepseek-v3-671b — MLA + 1 shared / 256 routed top-8 MoE + MTP.
[arXiv:2412.19437]

The MLA decode path uses the absorbed (latent-space) form — the paper's
compile-time weight-layout trick (Eq. 3) in attention-algebra form.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,                      # dense FFN width (first layers use it;
                                     # modeled uniformly as shared+routed)
    vocab=129280, head_dim=128,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=256, top_k=8, n_shared=1, moe_d_ff=2048,
    router_fn="sigmoid", moe_cf=1.25,
    mtp=True, rope_theta=1e4, mlp_act="silu",
)

SMOKE = ArchConfig(
    name="deepseek-v3-671b-smoke", family="moe",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16,
    mla=True, q_lora_rank=32, kv_lora_rank=16,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    n_experts=8, top_k=2, n_shared=1, moe_d_ff=32,
    router_fn="sigmoid", moe_cf=2.0,
    mtp=True, rope_theta=1e4, mlp_act="silu",
    q_chunk=16, kv_chunk=32,
)
