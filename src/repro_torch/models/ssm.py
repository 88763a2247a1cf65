"""RWKV6 ("Finch") block: the sub-quadratic family of this slice.

Counterpart of the RWKV6 part of the reference package's ``models/ssm.py``
(Mamba2 and the Zamba2 hybrid are not ported yet, ROADMAP Queue 1, item
14).  Per head, data-dependent per-channel decay w_t:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t ;  y_t = r_t (S_{t-1} + u k_t^T v_t)

The full causal forward runs the WKV recurrence from a zero state and drops
the final state, which is the WKV6 kernel's function (K6): on CUDA tensors
the kernel runs it, on CPU tensors its plain version, the reference's
chunked form (``kernels.wkv6.wkv6_chunked``, the reference's
``_wkv6_chunked``, with ``min(ssm_chunk, T)`` steps per chunk — so, as in
the reference, T must then be a multiple of ``ssm_chunk`` when it exceeds
it).  Where grad is enabled and an input needs it (``CausalLM.loss``), the
full forward goes through the kernel's training entry (``wkv6_train``: K6
forward, the chunked plain version's VJP by recompute in the backward);
``plain=True`` takes the plain version, differentiable by autograd.
Decode is the O(1) recurrent state update (``_wkv6_step``) in plain
torch, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import wkv6 as WK
from repro_torch.models import layers as L
from repro_torch.models.causal_lm import BlockDef, register_block


def rwkv6_init(gen, cfg: ModelConfig):
    d = cfg.d_model
    return {
        "tm_norm": L.ones(gen, (d,)),
        "tm": {
            "mu_r": L.full(gen, (d,), 0.5), "mu_k": L.full(gen, (d,), 0.5),
            "mu_v": L.full(gen, (d,), 0.5), "mu_w": L.full(gen, (d,), 0.5),
            "mu_g": L.full(gen, (d,), 0.5),
            "wr": L.normal_init(gen, (d, d)), "wk": L.normal_init(gen, (d, d)),
            "wv": L.normal_init(gen, (d, d)), "wg": L.normal_init(gen, (d, d)),
            "w_decay": L.normal_init(gen, (d, d), std=0.01),  # data-dependent decay
            "decay_bias": L.full(gen, (d,), -6.0),
            "u_bonus": L.zeros(gen, (d,)),
            "wo": L.normal_init(gen, (d, d)),
            "ln_w": L.ones(gen, (d,)),
        },
        "cm_norm": L.ones(gen, (d,)),
        "cm": {
            "mu_k": L.full(gen, (d,), 0.5),
            "wk": L.normal_init(gen, (d, cfg.d_ff)),
            "wv": L.normal_init(gen, (cfg.d_ff, d)),
        },
    }


def _token_shift(x, mu, last):
    """lerp between current token and previous token. last: (B,1,d) or None."""
    first = torch.zeros_like(x[:, :1]) if last is None else last.to(x.dtype)
    prev = torch.cat([first, x[:, :-1]], dim=1)
    return x + (prev - x) * mu.to(x.dtype)


def _wkv6_step(r, k, v, w, u, state):
    """r/k/v/w: (B,H,P); state: (B,H,P,P)."""
    kv = torch.einsum("bhp,bhq->bhpq", k, v)
    y = torch.einsum("bhp,bhpq->bhq", r, state + u[None, :, :, None] * kv)
    state = state * w[..., None] + kv
    return y, state


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    d = cfg.d_model
    H = cfg.n_heads if cfg.n_heads else d // 64
    return H, d // H


def rwkv6_apply(cfg: ModelConfig, lp, x, lc, ctx):
    d = cfg.d_model
    H, P = _heads(cfg)
    dt_f = x.dtype
    Bsz, T, _ = x.shape
    decode = lc is not None

    # ---- time mix -----------------------------------------------------------
    tm_h = L.rms_norm(x, lp["tm_norm"], cfg.norm_eps)
    tm = lp["tm"]
    last_x = lc["tm_shift"] if decode else None
    r = _token_shift(tm_h, tm["mu_r"], last_x) @ tm["wr"].to(dt_f)
    k = _token_shift(tm_h, tm["mu_k"], last_x) @ tm["wk"].to(dt_f)
    v = _token_shift(tm_h, tm["mu_v"], last_x) @ tm["wv"].to(dt_f)
    g = _token_shift(tm_h, tm["mu_g"], last_x) @ tm["wg"].to(dt_f)
    dw = _token_shift(tm_h, tm["mu_w"], last_x) @ tm["w_decay"].to(dt_f)
    # data-dependent decay in (0,1):  w = exp(-exp(bias + dw))
    w = torch.exp(-torch.exp(tm["decay_bias"].float() + dw.float()))

    shp = (Bsz, T, H, P)
    r4, k4, v4, w4 = (a.float().reshape(shp) for a in (r, k, v, w))
    u4 = tm["u_bonus"].float().reshape(H, P)

    if not decode:
        if ctx["plain"]:
            wkv = WK.wkv6_plain
        elif L.needs_grad(r4, k4, v4, w4, u4):
            wkv = WK.wkv6_train
        else:
            wkv = WK.wkv6
        y = wkv(r4, k4, v4, w4, u4, chunk=min(cfg.ssm_chunk, T))
        new_cache = None
    else:
        y1, new_state = _wkv6_step(r4[:, 0], k4[:, 0], v4[:, 0], w4[:, 0],
                                   u4, lc["wkv"].float())
        y = y1[:, None]
    y = y.reshape(Bsz, T, d).to(dt_f)
    y = L.rms_norm(y, tm["ln_w"], cfg.norm_eps) * F.silu(g)
    x = x + y @ tm["wo"].to(dt_f)

    # ---- channel mix ----------------------------------------------------------
    cm_h = L.rms_norm(x, lp["cm_norm"], cfg.norm_eps)
    cm = lp["cm"]
    last_c = lc["cm_shift"] if decode else None
    kc = _token_shift(cm_h, cm["mu_k"], last_c) @ cm["wk"].to(dt_f)
    x = x + (torch.square(F.relu(kc)) @ cm["wv"].to(dt_f))

    if decode:
        new_cache = {
            "wkv": new_state.to(lc["wkv"].dtype),
            "tm_shift": tm_h[:, -1:],   # next step's token-shift inputs
            "cm_shift": cm_h[:, -1:],
        }
    return x, new_cache


def rwkv6_cache(cfg: ModelConfig, B, T, dtype, device):
    d = cfg.d_model
    H, P = _heads(cfg)
    return {
        "wkv": torch.zeros((B, H, P, P), dtype=torch.float32, device=device),
        "tm_shift": torch.zeros((B, 1, d), dtype=dtype, device=device),
        "cm_shift": torch.zeros((B, 1, d), dtype=dtype, device=device),
    }


register_block("rwkv", BlockDef(init=rwkv6_init, apply=rwkv6_apply,
                                init_cache=rwkv6_cache))
