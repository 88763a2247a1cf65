"""Dense GQA transformer block (llama3.2-1b, yi-34b, qwen2.5-14b; the
mistral backbone of llava-next-mistral-7b; the dense prelude of
deepseek-moe-16b; the shared attention block of zamba2-1.2b).

Counterpart of the reference package's ``models/dense.py``.  In the full
causal forward its attention is the flash-attention kernel (K5) on CUDA
tensors and the kernel's plain version on the CPU
(``layers.chunked_attention``); decode attends over the cache in plain
torch.  Registered for the ``dense`` and ``vlm`` families, as in the
reference (the VLM's patch frontend is ``CausalLM._embed_inputs``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.causal_lm import BlockDef, register_block
from repro_torch.models.sharding import add_layer_axis


def init(gen, cfg: ModelConfig):
    return {
        "attn_norm": L.ones(gen, (cfg.d_model,)),
        "attn": L.init_gqa(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.hd, bias=cfg.qkv_bias),
        "mlp_norm": L.ones(gen, (cfg.d_model,)),
        "mlp": L.init_swiglu(gen, cfg.d_model, cfg.d_ff),
    }


def logical(cfg: ModelConfig):
    return {
        "attn_norm": (None, "embed"),
        "attn": add_layer_axis(L.gqa_logical(bias=cfg.qkv_bias)),
        "mlp_norm": (None, "embed"),
        "mlp": add_layer_axis(L.swiglu_logical()),
    }


def apply(cfg: ModelConfig, lp, x, lc, ctx):
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    attn_out, new_cache = L.attention_block(
        lp["attn"], h, cfg=cfg, positions=ctx["positions"], cache=lc,
        pos=ctx["pos"], causal=True, q_offset=ctx["q_offset"],
        plain=ctx["plain"],
    )
    x = x + attn_out
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    x = x + L.swiglu(lp["mlp"], h)
    return x, new_cache


def init_cache(cfg: ModelConfig, B, T, dtype, device):
    kv = (B, T, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device)}


def cache_logical(cfg: ModelConfig):
    dims = ("batch", "kv_seq", "kv_heads", None)
    return {"k": dims, "v": dims}


BLOCK = BlockDef(init=init, logical=logical, apply=apply,
                 init_cache=init_cache, cache_logical=cache_logical)
register_block("dense", BLOCK)
register_block("vlm", BLOCK)
