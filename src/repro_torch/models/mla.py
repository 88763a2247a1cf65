"""Multi-head Latent Attention block (minicpm3-4b; DeepSeek-V2-style MLA).

Counterpart of the reference package's ``models/mla.py``.  Training and
prefill run the EXPANDED form: the latents are up-projected to per-head k
and v, the single shared rope key is broadcast over the heads, and the
full causal attention is the flash-attention kernel (K5) on CUDA tensors,
its plain version on CPU ones (``layers.chunked_attention``).  The q/k head
(``nope_dim + rope_dim``, 96 at minicpm3-4b) is wider than the v head
(``v_head_dim``, 64): K5 takes a v narrower than q and k.

Decode runs the ABSORBED form in plain torch, as in the reference, where no
kernel serves it: the cache holds only the compressed latents ``ckv`` (B,
T, kv_lora) and the shared rope key ``kr`` (B, T, rope_dim); ``wuk`` is
absorbed into the query and ``wuv`` into the output, so decode attends over
an effective head of ``kv_lora + rope_dim`` with float32 scores, softmax and
context.  Over a latent cache split along T (the decode rules' ``kv_seq``)
the softmax is split (``partition.split_kv_attention``): each shard's
partial context is kv_lora wide, combined before the ``wuv`` product.

The reference's ``logical`` / ``cache_logical`` sharding trees are ported
(``models/sharding.py``), and so are its ``constrain`` hints
(``models/partition.py``; the identity on plain tensors).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L
from repro_torch.models.causal_lm import BlockDef, register_block
from repro_torch.models.partition import (constrain, split_kv_attention,
                                          write_at)
from repro_torch.models.sharding import add_layer_axis
from repro_torch.obs.profiling import scope


def init(gen, cfg: ModelConfig):
    H, qk = cfg.n_heads, cfg.nope_dim + cfg.rope_dim
    d = cfg.d_model
    return {
        "attn_norm": L.ones(gen, (d,)),
        "attn": {
            "wdq": L.normal_init(gen, (d, cfg.q_lora)),
            "q_norm": L.ones(gen, (cfg.q_lora,)),
            "wuq": L.normal_init(gen, (cfg.q_lora, H * qk)),
            "wdkv": L.normal_init(gen, (d, cfg.kv_lora)),
            "kv_norm": L.ones(gen, (cfg.kv_lora,)),
            "wkr": L.normal_init(gen, (d, cfg.rope_dim)),
            "wuk": L.normal_init(gen, (cfg.kv_lora, H * cfg.nope_dim)),
            "wuv": L.normal_init(gen, (cfg.kv_lora, H * cfg.v_head_dim)),
            "wo": L.normal_init(gen, (H * cfg.v_head_dim, d)),
        },
        "mlp_norm": L.ones(gen, (d,)),
        "mlp": L.init_swiglu(gen, d, cfg.d_ff),
    }


def _project_q(p, x, cfg, dtype, positions):
    B, S, _ = x.shape
    H, qk = cfg.n_heads, cfg.nope_dim + cfg.rope_dim
    cq = L.rms_norm(x @ L.cast(p["wdq"], dtype), p["q_norm"], cfg.norm_eps)
    q = (cq @ L.cast(p["wuq"], dtype)).reshape(B, S, H, qk)
    q = constrain(q, "batch", "seq", "heads", None)
    q_nope, q_rope = q[..., :cfg.nope_dim], q[..., cfg.nope_dim:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(p, x, cfg, dtype, positions):
    ckv = L.rms_norm(x @ L.cast(p["wdkv"], dtype), p["kv_norm"],
                     cfg.norm_eps)
    kr = (x @ L.cast(p["wkr"], dtype))[:, :, None, :]       # (B, S, 1, rope)
    kr = L.apply_rope(kr, positions, cfg.rope_theta)
    return ckv, kr[:, :, 0, :]


def _expanded_attention(p, x, cfg, dtype, positions, q_offset, plain):
    """Training / prefill: latents up-projected, causal attention (K5)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _project_q(p, x, cfg, dtype, positions)
    ckv, kr = _latents(p, x, cfg, dtype, positions)
    with scope("mla_expand"):   # the latents to K5's operands
        k_nope = (ckv @ L.cast(p["wuk"], dtype)).reshape(B, S, H,
                                                         cfg.nope_dim)
        v = (ckv @ L.cast(p["wuv"], dtype)).reshape(B, S, H,
                                                    cfg.v_head_dim)
        k_rope = kr[:, :, None, :].expand(B, S, H, cfg.rope_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope], dim=-1)
    out = L.chunked_attention(q, k, v, causal=True, q_offset=q_offset,
                              block_q=cfg.attn_block_q, plain=plain)
    return out.reshape(B, S, H * cfg.v_head_dim) @ L.cast(p["wo"], dtype)


def _absorbed_decode(p, x, cfg, dtype, positions, cache, pos):
    """Decode: one token attends directly against the compressed latents.
    Returns (out, new_cache)."""
    B, S, _ = x.shape  # S == 1
    H = cfg.n_heads
    q_nope, q_rope = _project_q(p, x, cfg, dtype, positions)
    ckv_new, kr_new = _latents(p, x, cfg, dtype, positions)
    ckv = constrain(write_at(cache["ckv"], ckv_new, pos), "batch", "kv_seq",
                    None)
    kr = constrain(write_at(cache["kr"], kr_new, pos), "batch", "kv_seq",
                   None)
    new_cache = {"ckv": ckv, "kr": kr}

    wuk = L.cast(p["wuk"], dtype).reshape(cfg.kv_lora, H, cfg.nope_dim)
    wuv = L.cast(p["wuv"], dtype).reshape(cfg.kv_lora, H, cfg.v_head_dim)
    q_c = torch.einsum("bqhn,chn->bqhc", q_nope, wuk)         # absorb W_uk
    scale = 1.0 / math.sqrt(cfg.nope_dim + cfg.rope_dim)

    def scores(q_c, q_rope, ckv32, kr):
        return (torch.einsum("bqhc,btc->bhqt", q_c.float(), ckv32)
                + torch.einsum("bqhr,btr->bhqt", q_rope.float(), kr.float())
                ) * scale

    def plain(q_c, q_rope, ckv, kr):
        ckv32 = ckv.float()
        s = scores(q_c, q_rope, ckv32, kr)
        t_idx = torch.arange(ckv.shape[1], device=x.device)
        s = s.masked_fill((t_idx > pos)[None, None, None, :], -1e30)
        prob = torch.softmax(s, dim=-1)
        return torch.einsum("bhqt,btc->bqhc", prob, ckv32)

    def partial(q_c, q_rope, ckv, kr, *, t0, kv_len):
        # the split softmax's block: o in the latent space (kv_lora wide)
        ckv32 = ckv.float()
        prob, m, l = FA.softmax_partial(scores(q_c, q_rope, ckv32, kr),
                                        t0=t0, kv_len=kv_len)
        return (torch.einsum("bhqt,btc->bqhc", prob, ckv32),
                m.transpose(1, 2), l.transpose(1, 2))

    kv_len = torch.full((B,), pos + 1, dtype=torch.int64, device=x.device)
    ctx_c = split_kv_attention((q_c, q_rope), (ckv, kr), kv_len, plain=plain,
                               partial=partial)
    out = torch.einsum("bqhc,chv->bqhv", ctx_c, wuv.float()).to(dtype)
    return out.reshape(B, S, H * cfg.v_head_dim) @ L.cast(p["wo"], dtype), \
        new_cache


def apply(cfg: ModelConfig, lp, x, lc, ctx):
    dtype = x.dtype
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    if lc is None:
        attn_out = _expanded_attention(lp["attn"], h, cfg, dtype,
                                       ctx["positions"], ctx["q_offset"],
                                       ctx["plain"])
        new_cache = None
    else:
        attn_out, new_cache = _absorbed_decode(lp["attn"], h, cfg, dtype,
                                               ctx["positions"], lc,
                                               ctx["pos"])
    x = x + attn_out
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    x = x + L.swiglu(lp["mlp"], h)
    return x, new_cache


def init_cache(cfg: ModelConfig, B, T, dtype, device):
    return {"ckv": torch.zeros((B, T, cfg.kv_lora), dtype=dtype,
                               device=device),
            "kr": torch.zeros((B, T, cfg.rope_dim), dtype=dtype,
                              device=device)}


def logical(cfg: ModelConfig):
    return {
        "attn_norm": (None, "embed"),
        "attn": add_layer_axis({
            "wdq": ("embed", None), "q_norm": (None,), "wuq": (None, "heads"),
            "wdkv": ("embed", None), "kv_norm": (None,),
            "wkr": ("embed", None), "wuk": (None, "heads"),
            "wuv": (None, "heads"), "wo": ("heads", "embed"),
        }),
        "mlp_norm": (None, "embed"),
        "mlp": add_layer_axis(L.swiglu_logical()),
    }


def cache_logical(cfg: ModelConfig):
    return {"ckv": ("batch", "kv_seq", None), "kr": ("batch", "kv_seq", None)}


BLOCK = BlockDef(init=init, logical=logical, apply=apply,
                 init_cache=init_cache, cache_logical=cache_logical)
register_block("mla", BLOCK)
