"""llava-next-mistral-7b: mistral-7b backbone + anyres patch-embedding stub
[hf:llava-hf/llava-v1.6-mistral-7b-hf].  The vision tower is upstream; the stub
frontend supplies 2304 precomputed patch embeddings (CLIP-L hidden 1024)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32000,
    rope_theta=1e6, n_patches=2304, patch_dim=1024,
)
