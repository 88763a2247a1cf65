"""minicpm3-4b: MLA (multi-head latent attention) [hf:openbmb/MiniCPM3-4B].

True MLA dims: q_lora 768, kv_lora 256, qk = 64 nope + 32 rope, v 64.
Assignment's "GQA kv=40" = MHA over the 40 latent-expanded heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="mla", n_layers=62, d_model=2560,
    n_heads=40, n_kv_heads=40, d_ff=6400, vocab=73448,
    q_lora=768, kv_lora=256, nope_dim=64, rope_dim=32, v_head_dim=64,
)
