"""DeepSeekMoE-16B — fine-grained MoE [arXiv:2401.06066].

28L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=102400.
64 routed experts top-6 + 2 shared experts; layer 0 uses a dense MLP
(d_ff=10944), faithful to the release.  Routed as published
(``norm_topk_prob`` false: the top-6 softmax weights are not
renormalised; no capacity on the serving path).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    source="arXiv:2401.06066",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    mlp_kind="swiglu",
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    first_layer_dense=True,
    dense_d_ff=10944,
    norm_topk_prob=False,
    moe_dropless=True,
))
