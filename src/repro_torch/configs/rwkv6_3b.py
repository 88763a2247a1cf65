"""rwkv6-3b (Finch): attention-free, data-dependent decay [arXiv:2404.05892].
Sub-quadratic -> runs long_500k.  40 heads of dim 64."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv", n_layers=32, d_model=2560,
    n_heads=40, n_kv_heads=40, d_ff=8960, vocab=65536,
    ssm_chunk=256, sub_quadratic=True,
)
