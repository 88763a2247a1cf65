"""State-space / linear-attention blocks: Mamba2 (SSD) and RWKV6 ("Finch").

Counterpart of the reference package's ``models/ssm.py``; the Zamba2
hybrid that stacks Mamba2 blocks is ``models/zamba.py``.

Mamba2 (SSD), per head h with scalar decay a_t = exp(dt_t * A):

    state_t = a_t * state_{t-1} + dt_t * B_t x_t^T ;  y_t = C_t^T state_t

The full forward is the chunked SSD scan (``_ssd_chunked``: quadratic
within a chunk of ``min(ssm_chunk, T)`` steps, a recurrence over chunk
states across them; T must then be a multiple of the chunk, as in the
reference), in float32 and plain torch on every device: the reference has
no kernel for it.  One difference: the reference forms the intra-chunk
decays as ``where(mask, exp(seg_i - seg_j), 0)``, whose masked entries
overflow float32 once a chunk's log-decay passes ~88 (zamba2-1.2b's chunk
of 256 at init reaches ~177), so its gradient is not finite there
(``inf * 0``); the port masks the exponent before ``exp``, which gives
the same forward and a finite gradient.  The within-chunk cumulative
log-decay and its pairwise differences are formed in float64 and cast
back: at a chunk of 256 they are differences of sums near 177, which
float32 rounds by ~1.5e-5, enough to move the gradient in A by 2e-5 to
4e-5 of max (the reference's own chunk-256 values carry that rounding,
2.6e-6 to 5.5e-6 of max off float64; ``tests/test_torch_zamba.py``).
Decode is the O(1) state update (``_ssd_step``).

RWKV6, per head, data-dependent per-channel decay w_t:

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

Both blocks carry the reference's ``*_logical`` / ``*_cache_logical``
sharding trees (``models/sharding.py``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import wkv6 as WK
from repro_torch.models import layers as L
from repro_torch.models.causal_lm import BlockDef, register_block
from repro_torch.models.partition import constrain, on_shards
from repro_torch.models.sharding import add_layer_axis


# ================================================================== Mamba2 (SSD)

def _ssd_chunked(x, dt, A, Bm, Cm, state0, chunk):
    """Chunked SSD scan.

    x: (B, T, H, P)    per-head inputs      (P = ssm_head_dim)
    dt: (B, T, H)      positive step sizes
    A: (H,)            negative per-head decay rate
    Bm, Cm: (B, T, N)  shared input/output projections (N = ssm_state)
    state0: (B, H, P, N)
    returns y (B, T, H, P), state_T
    """
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    nc, c = T // chunk, chunk
    if nc * c != T:
        raise ValueError(f"T={T} % chunk={chunk} != 0")

    xl = x.reshape(Bsz, nc, c, H, P)
    dtl = dt.reshape(Bsz, nc, c, H)
    Bl = Bm.reshape(Bsz, nc, c, N)
    Cl = Cm.reshape(Bsz, nc, c, N)

    dA = dtl * A[None, None, None, :]                 # (B,nc,c,H) negative
    seg64 = torch.cumsum(dA.double(), 2)              # within-chunk log-decay
    seg = seg64.to(x.dtype)

    # ---- intra-chunk: L[i,j] = exp(seg_i - seg_j) for i >= j, else 0;
    # masked before exp (above the diagonal the difference is positive)
    diff = (seg64[:, :, :, None, :]
            - seg64[:, :, None, :, :]).to(x.dtype)                # (B,nc,c,c,H)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    Ldec = torch.exp(diff.masked_fill(~mask[None, None, :, :, None],
                                      float("-inf")))
    G = torch.einsum("bnik,bnjk->bnij", Cl, Bl)                    # (B,nc,c,c)
    M = G[..., None] * Ldec                                        # (B,nc,c,c,H)
    xdt = xl * dtl[..., None]                                      # (B,nc,c,H,P)
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", M, xdt)

    # ---- chunk states + inter-chunk recurrence ------------------------------
    decay_to_end = torch.exp((seg64[:, :, -1:, :] - seg64).to(x.dtype))
    S_chunk = torch.einsum("bnch,bnchp,bnck->bnhpk", decay_to_end * dtl, xl,
                           Bl)
    chunk_decay = torch.exp(seg[:, :, -1, :])                      # (B,nc,H)
    s, states_in = state0, []
    for n in range(nc):          # the state ENTERING each chunk
        states_in.append(s)
        s = s * chunk_decay[:, n, :, None, None] + S_chunk[:, n]
    states_in = torch.stack(states_in, dim=1)                      # (B,nc,H,P,N)

    # ---- contribution of the carried-in state -------------------------------
    y_inter = torch.einsum("bnck,bnhpk,bnch->bnchp", Cl, states_in,
                           torch.exp(seg))
    return (y_intra + y_inter).reshape(Bsz, T, H, P), s


def _ssd_step(x, dt, A, Bm, Cm, state):
    """Single-token recurrence. x:(B,H,P) dt:(B,H) Bm/Cm:(B,N) state:(B,H,P,N)."""
    dA = torch.exp(dt * A[None, :])                                # (B,H)
    upd = torch.einsum("bhp,bk->bhpk", x * dt[..., None], Bm)
    state = state * dA[:, :, None, None] + upd
    y = torch.einsum("bhpk,bk->bhp", state, Cm)
    return y, state


def _mamba2_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_in, H, P, N)."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


def mamba2_init(gen, cfg: ModelConfig):
    d = cfg.d_model
    d_in, H, _, N = _mamba2_dims(cfg)
    return {
        "norm": L.ones(gen, (d,)),
        "in_proj": L.normal_init(gen, (d, 2 * d_in + 2 * N + H)),  # x, z, B, C, dt
        "conv_w": L.normal_init(gen, (cfg.ssm_conv, d_in + 2 * N), std=0.2),
        "A_log": L.zeros(gen, (H,)),     # A = -exp(A_log) -> A = -1 at init
        "D": L.ones(gen, (H,)),
        "dt_bias": L.zeros(gen, (H,)),
        "out_norm": L.ones(gen, (d_in,)),
        "out_proj": L.normal_init(gen, (d_in, d)),
    }


def _causal_conv(u, w, conv_state=None):
    """Depthwise causal conv, width K. u: (B,T,C), w: (K,C).

    conv_state: (B, K-1, C) trailing inputs from the previous segment (decode).
    Returns (out, new_conv_state).
    """
    K = w.shape[0]
    if conv_state is None:
        pad = u.new_zeros((u.shape[0], K - 1, u.shape[2]))
    else:
        pad = conv_state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                              # (B, T+K-1, C)
    out = sum(full[:, i:i + u.shape[1]] * w[i][None, None, :]
              for i in range(K))
    new_state = full[:, -(K - 1):] if K > 1 else None
    return out, new_state


def mamba2_apply(cfg: ModelConfig, lp, x, lc, ctx):
    d_in, H, P, N = _mamba2_dims(cfg)
    dt_f = x.dtype
    Bsz, T, _ = x.shape
    f32 = torch.float32

    h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
    proj = constrain(h @ lp["in_proj"].to(dt_f), "batch", "seq", "ff")
    xz, z, Bm, Cm, dt_raw = torch.split(proj, [d_in, d_in, N, N, H], dim=-1)
    conv_in = torch.cat([xz, Bm, Cm], dim=-1)
    conv_state = None if lc is None else lc["conv"]
    conv_out, new_conv = _causal_conv(conv_in, lp["conv_w"].to(dt_f),
                                      conv_state)
    xz, Bm, Cm = torch.split(F.silu(conv_out), [d_in, N, N], dim=-1)

    A = -torch.exp(lp["A_log"].to(f32))
    dt = F.softplus(dt_raw.to(f32) + lp["dt_bias"].to(f32))
    xh = xz.reshape(Bsz, T, H, P).to(f32)
    Bm32, Cm32 = Bm.to(f32), Cm.to(f32)

    if lc is None:
        state0 = xh.new_zeros((Bsz, H, P, N))
        y, _ = _ssd_chunked(xh, dt, A, Bm32, Cm32, state0,
                            min(cfg.ssm_chunk, T))
        new_cache = None
    else:
        y1, new_state = _ssd_step(xh[:, 0], dt[:, 0], A, Bm32[:, 0],
                                  Cm32[:, 0], lc["ssm"].to(f32))
        y = y1[:, None]
        new_cache = {"ssm": new_state.to(lc["ssm"].dtype),
                     "conv": new_conv.to(lc["conv"].dtype)}
    y = y + xh * lp["D"].to(f32)[None, None, :, None]
    y = y.reshape(Bsz, T, d_in).to(dt_f)
    y = L.rms_norm(y * F.silu(z), lp["out_norm"], cfg.norm_eps)
    return x + y @ lp["out_proj"].to(dt_f), new_cache


def mamba2_cache(cfg: ModelConfig, B, T, dtype, device):
    d_in, H, P, N = _mamba2_dims(cfg)
    return {
        "ssm": torch.zeros((B, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((B, cfg.ssm_conv - 1, d_in + 2 * N), dtype=dtype,
                            device=device),
    }


def mamba2_logical(cfg: ModelConfig):
    return {
        "norm": (None, "embed"),
        "in_proj": (None, "embed", "ff"),
        "conv_w": (None, None, "ff"),
        "A_log": (None, "ff"), "D": (None, "ff"), "dt_bias": (None, "ff"),
        "out_norm": (None, "ff"),
        "out_proj": (None, "ff", "embed"),
    }


def mamba2_cache_logical(cfg: ModelConfig):
    return {"ssm": ("batch", "ff", None, None), "conv": ("batch", None, "ff")}


register_block("ssm", BlockDef(init=mamba2_init, logical=mamba2_logical,
                               apply=mamba2_apply, init_cache=mamba2_cache,
                               cache_logical=mamba2_cache_logical))


# ===================================================================== RWKV6

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
        # each device's heads of its batch rows (K6 takes local tensors)
        y = on_shards(functools.partial(wkv, chunk=min(cfg.ssm_chunk, T)),
                      r4, (k4, v4, w4), (u4,))
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
    kc = constrain(kc, "batch", "seq", "ff")
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


def rwkv6_logical(cfg: ModelConfig):
    dd = (None, "embed", "heads")
    return {
        "tm_norm": (None, "embed"),
        "tm": {
            "mu_r": (None, "embed"), "mu_k": (None, "embed"),
            "mu_v": (None, "embed"), "mu_w": (None, "embed"),
            "mu_g": (None, "embed"),
            "wr": dd, "wk": dd, "wv": dd, "wg": dd, "w_decay": dd,
            "decay_bias": (None, "heads"), "u_bonus": (None, "heads"),
            "wo": (None, "heads", "embed"), "ln_w": (None, "embed"),
        },
        "cm_norm": (None, "embed"),
        "cm": {"mu_k": (None, "embed"), "wk": (None, "embed", "ff"),
               "wv": (None, "ff", "embed")},
    }


def rwkv6_cache_logical(cfg: ModelConfig):
    # 40 heads don't divide the 16-way model axis; the recurrent state is
    # tiny (no sequence dim), so batch-shard only
    return {"wkv": ("batch", None, None, None),
            "tm_shift": ("batch", None, "act_embed"),
            "cm_shift": ("batch", None, "act_embed")}


# the recurrent decode has no rope and no position-indexed cache
register_block("rwkv", BlockDef(init=rwkv6_init, logical=rwkv6_logical,
                                apply=rwkv6_apply, init_cache=rwkv6_cache,
                                cache_logical=rwkv6_cache_logical,
                                reads_pos=False))
