"""zamba2-1.2b: Mamba2 backbone + ONE shared attention block every 6 layers
[arXiv:2411.15242].  Sub-quadratic -> runs long_500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    attn_every=6, sub_quadratic=True,
)
