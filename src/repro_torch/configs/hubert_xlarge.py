"""HuBERT-XLarge — audio encoder backbone [arXiv:2106.07447].

48L d_model=1280 16H (MHA: kv=16) d_ff=5120 vocab=504 (k-means unit
codebook). Encoder-only (bidirectional attention, no decode path). The
conv/mel frontend is stubbed per assignment: ``input_specs`` provides frame
embeddings of shape [batch, frames, d_model].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    source="arXiv:2106.07447",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    is_encoder=True,
    mlp_kind="gelu",
    rope_theta=0.0,  # learned/absolute positions in w2v2 family -> none here
    frontend="audio",
))
