"""Common transformer layers for the LLM side (pure functions over param dicts).

Counterpart of the reference package's ``models/layers.py``, with the same
conventions:

* Params are nested dicts of float32 tensors (master weights); compute is
  ``cfg.dtype`` (bf16), cast at use.  Layer stacks are STACKED on a leading
  L axis; :func:`scan_layers` walks it in a Python loop over views (the
  reference's ``lax.scan``; there is no remat, the port does not train the
  LLMs yet).
* Initializers draw from a ``torch.Generator`` on the device the tensors are
  made on; they give other numbers than ``jax.random`` from the same seed,
  so tests carry the reference's params across (``api.params_from_numpy``).
* Attention: the full causal forward (``causal``, ``q_offset == 0``, no
  ``kv_len``) is the flash-attention kernel's function (K5), so on CUDA
  tensors :func:`chunked_attention` launches it; every other call (decode
  against a cache) and every CPU call runs the plain blocked attention
  (``kernels.flash_attention.attention_blocks``).  The choice follows the
  arguments and the tensors' device, never a failure.

``constrain`` (GSPMD sharding hints) has no counterpart: one card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.nets import map_tree, map_trees, tree_leaves
from repro_torch.kernels import flash_attention as FA

# ------------------------------------------------------------------------- init


def normal_init(gen, shape, std=0.02):
    """N(0, std^2) float32 on ``gen``'s device."""
    return torch.randn(shape, generator=gen, device=gen.device) * std


def zeros(gen, shape):
    return torch.zeros(shape, device=gen.device)


def ones(gen, shape):
    return torch.ones(shape, device=gen.device)


def full(gen, shape, value):
    return torch.full(shape, value, dtype=torch.float32, device=gen.device)


def stack_trees(trees: list):
    """Leaf-wise ``torch.stack`` of identically structured trees."""
    return map_trees(lambda *xs: torch.stack(xs), *trees)


def stack_init(layer_init, gen, n_layers):
    """Stacked (L, ...) params from ``n_layers`` draws of ``layer_init``."""
    return stack_trees([layer_init(gen) for _ in range(n_layers)])


# ------------------------------------------------------------------------ norms

def rms_norm(x, w, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


# ------------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float = 1e4):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta=1e4):
    """x: (B, S, H, dh); positions: (B, S) or (S,)"""
    dh = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(dh, theta), device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs               # (B, S, dh/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1, o2 = x1 * cos - x2 * sin, x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape)


# -------------------------------------------------------------------- attention

def chunked_attention(q, k, v, *, causal=True, q_offset=0, block_q=512,
                      kv_len=None, plain=False):
    """GQA attention without materializing the full (S, T) score tensor.

    q: (B, S, H, dh); k/v: (B, T, Hk, dh), H % Hk == 0.
    q_offset: absolute position of q[0] (causal masking for prefill chunks).
    kv_len: optional (B,) valid cache lengths (decode); None -> all T valid.

    ``causal`` with ``q_offset == 0`` and no ``kv_len`` is K5's function: on
    CUDA tensors the kernel runs it (its own tiles, its own causal skip);
    ``plain=True`` takes the kernel's plain version there instead, by name.
    The reference's ``causal_skip`` (an XLA-only FLOP saving with the same
    values) has no counterpart: the kernel skips above the diagonal anyway.
    """
    if causal and q_offset == 0 and kv_len is None:
        fn = FA.flash_attention_plain if plain else FA.flash_attention
        return fn(q, k, v, causal=True, block_q=block_q)
    return FA.attention_blocks(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len, block_q=block_q)


def decode_attention(q, k, v, pos):
    """Single-position attention against a full cache. q: (B,1,H,dh), pos: (B,)"""
    return chunked_attention(q, k, v, causal=False, kv_len=pos + 1, block_q=1)


def init_gqa(gen, d_model, n_heads, n_kv, head_dim, bias=False, std=0.02):
    p = {
        "wq": normal_init(gen, (d_model, n_heads * head_dim), std),
        "wk": normal_init(gen, (d_model, n_kv * head_dim), std),
        "wv": normal_init(gen, (d_model, n_kv * head_dim), std),
        "wo": normal_init(gen, (n_heads * head_dim, d_model), std),
    }
    if bias:
        p["bq"] = zeros(gen, (n_heads * head_dim,))
        p["bk"] = zeros(gen, (n_kv * head_dim,))
        p["bv"] = zeros(gen, (n_kv * head_dim,))
    return p


def gqa_project(p, x, n_heads, n_kv, head_dim, dtype):
    B, S, _ = x.shape
    q = x @ p["wq"].to(dtype)
    k = x @ p["wk"].to(dtype)
    v = x @ p["wv"].to(dtype)
    if "bq" in p:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, n_kv, head_dim),
            v.reshape(B, S, n_kv, head_dim))


def attention_block(p, x, *, cfg, positions, cache=None, pos=None,
                    causal=True, q_offset=0, plain=False):
    """Self-attention with optional KV cache. Returns (out, new_cache).

    With a cache the block writes k/v at ``pos`` (one token) and attends
    over the cache; a multi-token write goes to the cache's head
    (``_scatter_prefill``) as in the reference, which then attends without
    a causal mask at one rope position: do not use it as a cached prefill
    (ROADMAP Queue 3)."""
    dtype = x.dtype
    q, k, v = gqa_project(p, x, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                block_q=cfg.attn_block_q, plain=plain)
        new_cache = None
    else:
        if k.shape[1] == 1:
            ck, cv = cache["k"].clone(), cache["v"].clone()
            ck[:, pos] = k[:, 0].to(ck.dtype)
            cv[:, pos] = v[:, 0].to(cv.dtype)
        else:
            ck, cv = _scatter_prefill(cache["k"], k), \
                _scatter_prefill(cache["v"], v)
        new_cache = {"k": ck, "v": cv}
        kv_len = torch.full((x.shape[0],), pos + 1, dtype=torch.int64,
                            device=x.device)
        out = decode_attention(q, ck.to(dtype), cv.to(dtype), kv_len - 1)
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(dtype), new_cache


def _scatter_prefill(cache, fresh):
    out = cache.clone()
    out[:, :fresh.shape[1]] = fresh.to(cache.dtype)
    return out


# ------------------------------------------------------------------------ MLPs

def init_swiglu(gen, d_model, d_ff, std=0.02):
    return {
        "wi": normal_init(gen, (d_model, d_ff), std),
        "wg": normal_init(gen, (d_model, d_ff), std),
        "wo": normal_init(gen, (d_ff, d_model), std),
    }


def swiglu(p, x):
    dt = x.dtype
    h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    return h @ p["wo"].to(dt)


# ----------------------------------------------------------------- vocab layers

def init_embedding(gen, vocab, d_model, std=0.02):
    return {"table": normal_init(gen, (vocab, d_model), std)}


def embed(p, tokens, dtype):
    # gather, then cast: the same values as the reference's cast-then-take,
    # without casting the whole table
    return p["table"][tokens].to(dtype)


def _mask_padded_vocab(logits, n_valid):
    if n_valid is None or n_valid == logits.shape[-1]:
        return logits
    bad = torch.arange(logits.shape[-1], device=logits.device) >= n_valid
    return logits.masked_fill(bad, -1e30)


def unembed(p, x, n_valid=None):
    logits = x @ p["table"].to(x.dtype).T
    return _mask_padded_vocab(logits, n_valid)


def init_lm_head(gen, d_model, vocab, std=0.02):
    return {"w": normal_init(gen, (d_model, vocab), std)}


def lm_head(p, x, n_valid=None):
    return _mask_padded_vocab(x @ p["w"].to(x.dtype), n_valid)


# -------------------------------------------------------------- layer-stack scan

def scan_layers(block_fn, stacked_params, x, cache=None):
    """Run x through L stacked layers; threads per-layer cache through.

    block_fn(layer_params, x, layer_cache) -> (x, new_layer_cache).  Layer l
    gets views ``[l]`` of the stacked params (and cache); the new per-layer
    caches are stacked again (None when the blocks return none)."""
    n_layers = tree_leaves(stacked_params)[0].shape[0]
    new = []
    for l in range(n_layers):
        lc = None if cache is None else map_tree(lambda t: t[l], cache)
        x, nc = block_fn(map_tree(lambda t: t[l], stacked_params), x, lc)
        new.append(nc)
    return x, (None if new[0] is None else stack_trees(new))
