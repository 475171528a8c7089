"""mamba2-780m — attention-free SSD (state-space duality) stack.
[arXiv:2405.21060]

long_500k RUNS for this arch: decode state is O(1) in context length.
The paper's attention-related passes are inapplicable (noted in
DESIGN.md §Arch-applicability); the SSD chunk matmuls use the fused
epilogue idea instead.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, head_dim=0,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    ssm_chunk=256, tie_embeddings=True, rope_theta=0.0,
)

SMOKE = ArchConfig(
    name="mamba2-780m-smoke", family="ssm",
    num_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=256, head_dim=0,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4,
    ssm_chunk=16, tie_embeddings=True, rope_theta=0.0,
)
