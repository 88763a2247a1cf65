"""qwen2.5-14b: dense GQA with QKV bias [hf:Qwen/Qwen2.5-14B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=13824, vocab=152064,
    rope_theta=1e6, qkv_bias=True,
)
