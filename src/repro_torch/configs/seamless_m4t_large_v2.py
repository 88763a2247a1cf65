"""seamless-m4t-large-v2: enc-dec multimodal backbone [arXiv:2308.11596].
24 encoder + 24 decoder layers (the real text stack; assignment's "24L" read as
per-stack depth).  Audio frontend is a stub: precomputed frame embeddings at
seq_len // 4 frames."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=24, n_dec_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64, d_ff=8192,
    vocab=256206, enc_ratio=4,
)
