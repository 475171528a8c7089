"""whisper-base — encoder-decoder audio backbone; conv frontend STUB.
[arXiv:2212.04356]

``input_specs`` provides precomputed frame embeddings (B, 1500, 512).
Decode shapes exercise the decoder step with the cached encoder output;
the 32k decode depth is structural (beyond Whisper's trained 448
positions — the framework lowers it regardless; see DESIGN.md).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64,
    encoder_layers=6, n_frames=1500,
    rope_theta=0.0, mlp_act="gelu", tie_embeddings=True,
    norm_eps=1e-5,
)

SMOKE = ArchConfig(
    name="whisper-base-smoke", family="audio",
    num_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16,
    encoder_layers=2, n_frames=32,
    rope_theta=0.0, mlp_act="gelu", tie_embeddings=True,
    norm_eps=1e-5, q_chunk=16, kv_chunk=32,
)
