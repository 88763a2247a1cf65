"""deepseek-moe-16b: fine-grained MoE, 2 shared + 64 routed top-6, dense first
layer [arXiv:2401.06066].  Assignment's d_ff=1408 is the fine-grained expert dim;
the dense layer-0 FFN uses the model's 10944."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408,
    first_dense=1, d_ff_dense=10944,
)
