"""Mixture-of-Experts block (deepseek-moe-16b fine-grained, phi3.5-moe).

Counterpart of the reference package's ``models/moe.py``: grouped,
capacity-based dispatch with the reference's exact drop semantics.

1. The router's top-k over E experts, the lower index first on ties (as
   ``jax.lax.top_k``; ``torch.topk`` promises no order), and the top-k
   gates normalised.
2. The T tokens split into G groups (:func:`_n_groups`).  In each group
   the token-major (token, slot) pairs are stably sorted by expert; a
   pair's position is its rank within its expert, and pairs at or past
   the capacity C (:func:`capacity`) are DROPPED.
3. The kept pairs written into a (G, E, C, d) buffer by one indexed write
   into its flat (G * E * C, d) view.  Kept pairs have unique (expert,
   position) destinations, so the write needs no atomics.
4. A batched SwiGLU over the experts.
5. Each token's k outputs gathered back, gated, and summed over the k
   slots in slot order (deterministic on a card; the reference's
   scatter-add up to float order).

DeepSeek's always-on shared experts run as a dense SwiGLU of width
``n_shared_experts * d_expert``.  The Switch load-balance term ``E *
sum_e f_e p_e`` leaves :func:`apply` as ``{"aux": aux}`` when there is no
cache, and ``CausalLM.loss`` adds ``0.01 *`` its mean over the layers.
``f_e`` comes from counts and carries no gradient; ``p_e`` does.

``cfg.moe_shard_map`` selects :func:`moe_ffn_shardmap`, the reference's
expert parallelism over a ``("data", "model")`` grid, in the context of
``models/expert_parallel.py`` (a rank of the grid, or its one-process
twin; with none it raises).  Its drop rules differ from ``moe_ffn``'s:
one group a data shard, capacity from the shard's tokens.  Its layer
returns ``{"aux_parts": ...}`` (the load-balance statistics, summed over
the data shards in ``CausalLM.loss``) instead of ``{"aux": ...}``.

The reference has no Pallas kernel for MoE: the router, the sort, the
dispatch and the expert products are plain torch on every device.  The
attention is the dense block's (``layers.attention_block``), so prefill
and training run the flash-attention kernel (K5) on CUDA tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense
from repro_torch.models import expert_parallel as EP
from repro_torch.models import layers as L
from repro_torch.models.causal_lm import BlockDef, register_block
from repro_torch.models.partition import constrain, expert_einsum
from repro_torch.models.sharding import add_layer_axis


def init(gen, cfg: ModelConfig):
    E, d, de = cfg.n_experts, cfg.d_model, cfg.d_expert
    p = {
        "attn_norm": L.ones(gen, (d,)),
        "attn": L.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           bias=cfg.qkv_bias),
        "mlp_norm": L.ones(gen, (d,)),
        "router": L.normal_init(gen, (d, E), std=0.02),
        "experts": {
            "wi": L.normal_init(gen, (E, d, de)),
            "wg": L.normal_init(gen, (E, d, de)),
            "wo": L.normal_init(gen, (E, de, d)),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_swiglu(gen, d, cfg.n_shared_experts * de)
    return p


def logical(cfg: ModelConfig):
    p = {
        "attn_norm": (None, "embed"),
        "attn": add_layer_axis(L.gqa_logical(bias=cfg.qkv_bias)),
        "mlp_norm": (None, "embed"),
        "router": (None, "embed", None),
        "experts": {
            "wi": (None, "expert", "embed", None),
            "wg": (None, "expert", "embed", None),
            "wo": (None, "expert", None, "embed"),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = add_layer_axis(L.swiglu_logical())
    return p


def _n_groups(T: int) -> int:
    """Token groups of the grouped dispatch: capacity is enforced per
    group (the reference's GShard-style grouping, copied exactly)."""
    g = 256
    while g > 1 and T // g < 64:
        g //= 2
    return g


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    return max(4, int(math.ceil(group_tokens * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def route(cfg: ModelConfig, p, xg):
    """The router on xg (G, t, d): float32 probabilities (G, t, E), the
    normalised top-k gates and their experts (G, t, k).  The product runs
    in xg's dtype and is then cast to float32, as in the reference; the
    top k come from a stable descending sort, so ties keep the lower
    expert first."""
    logits = (xg @ p["router"].to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def _dispatch(cfg: ModelConfig, xg, idx, gate, ex, m: int = 0):
    """Grouped, capacity-based dispatch of xg (G, t, d) to the experts
    ``ex`` (E/M of them: those of model rank m; all E with m = 0), gated
    and summed over the k slots: (G, t, d), zero where a token's experts
    are all elsewhere or dropped.

    In each group the token-major (token, slot) pairs are stably sorted by
    expert over all E; a pair's position is its rank within its expert,
    and the pairs of ``ex``'s experts at a position below C =
    ``capacity(cfg, t)`` are kept.  The kept pairs go into a (G * E/M * C,
    d) buffer by one indexed write (their destinations are unique, so no
    atomics; dropped pairs go to a spare last row, cut off), a batched
    SwiGLU runs over the experts, and each pair's output comes back by a
    gather in token-major order."""
    G, t, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = ex["wi"].shape[0]
    dt, dev = xg.dtype, xg.device
    C = capacity(cfg, t)
    e_flat = idx.reshape(G, t * k)                       # token-major slots
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, e_flat, torch.ones_like(e_flat))
    # one batched stable sort: a slot's position is its rank in its expert
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    starts = torch.cumsum(counts, dim=1) - counts
    pos_sorted = torch.arange(t * k, device=dev) - \
        torch.gather(starts, 1, e_sorted)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    local = e_flat - m * E_loc
    keep = (local >= 0) & (local < E_loc) & (pos < C)   # token-major
    g_off = torch.arange(G, device=dev)[:, None] * E_loc
    slot = (g_off + torch.clamp(local, 0, E_loc - 1)) * C + \
        torch.clamp(pos, max=C - 1)                      # row of the buffer

    vals = xg.repeat_interleave(k, dim=1) * keep[..., None].to(dt)
    dst = torch.where(keep, slot, G * E_loc * C)
    buf = torch.zeros((G * E_loc * C + 1, d), dtype=dt, device=dev)
    buf = buf.index_put((dst.reshape(-1),), vals.reshape(-1, d))
    buf = buf[:-1].reshape(G, E_loc, C, d)
    buf = constrain(buf, "batch", "expert", None, None)

    h = F.silu(expert_einsum("gecd,edf->gecf", buf, ex["wg"].to(dt)))
    h = h * expert_einsum("gecd,edf->gecf", buf, ex["wi"].to(dt))
    h = constrain(h, "batch", "expert", None, None)
    out_buf = expert_einsum("gecf,efd->gecd", h, ex["wo"].to(dt))
    out_buf = constrain(out_buf, "batch", "expert", None, None)

    # combine: a gather over (token, slot), gated, summed over the k slots
    back = out_buf.reshape(G * E_loc * C, d)[slot] * keep[..., None].to(dt)
    w = gate.to(dt).reshape(G, t * k, 1)
    return (back * w).reshape(G, t, k, d).sum(dim=2)


def moe_ffn(cfg: ModelConfig, p, x):
    """Grouped sort-based dispatch. x: (B, S, d) -> (out, aux_loss)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = _n_groups(T)
    xg = constrain(x.reshape(G, T // G, d), "batch", None, None)
    probs, gate, idx = route(cfg, p, xg)

    # load-balance aux (Switch-style): E * sum_e f_e * p_e, f_e from the
    # slots' counts (the reference's bincount, which has no meta kernel)
    counts = torch.zeros((E,), dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
    me = probs.mean(dim=(0, 1))
    ce = counts.float() / (T * k)
    aux = E * torch.sum(me * ce)

    out = _dispatch(cfg, xg, idx, gate, p["experts"]).reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + L.swiglu(p["shared"], x)
    return out, aux


def moe_ffn_shardmap(cfg: ModelConfig, p, x, ep=None):
    """Expert-parallel dispatch (the reference's ``moe_ffn_shardmap``,
    ``src/repro/models/moe.py:148-217``).  x: (B, S, d) -> (out, the
    load-balance statistics (2, E)).

    The router, its top-k and the normalised gates run over the tokens
    here (a data shard on a rank, all of them in the twin).  Each data
    shard's T / D tokens are one group with capacity ``capacity(cfg, T /
    D)``; model rank m computes the part of its E/M experts
    (:func:`_dispatch`), the parts are summed over the model group, and
    the shared experts are added after.  The statistics are each
    expert's summed probability and count over the global token count
    (and k), so their sum over the data shards gives the reference's
    ``me`` and ``ce``; ``CausalLM.loss`` forms ``E * sum(me * ce)``.
    ``ep`` is the context (default: the current one)."""
    ep = ep if ep is not None else EP.current_ep()
    if ep is None:
        raise ValueError(
            f"{cfg.name}: moe_shard_map=True needs an expert-parallel "
            "context (models.expert_parallel.use_ep with an EPPlan, or a "
            "grid rank's GridRank.expert_parallel()); none is active")
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    D, M = ep.data, ep.model
    if E % M:
        raise ValueError(f"{E} experts do not split over {M} model ranks")
    E_loc = E // M
    rank = isinstance(ep, EP.EPRank)
    want = E_loc if rank else E
    if p["experts"]["wi"].shape[0] != want:
        raise ValueError(
            f"the layer holds {p['experts']['wi'].shape[0]} experts; "
            f"{'rank' if rank else 'the twin of'} {D} x {M} wants {want} "
            "(models.expert_parallel.shard_experts)")
    T = B * S
    dt = x.dtype
    xf = x.reshape(T, d)
    probs, gate, idx = route(cfg, p, xf)
    gate = gate.to(dt)
    counts = torch.zeros((E,), dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
    n_tok = T * D if rank else T                         # global tokens
    stats = torch.stack([probs.sum(dim=0) / n_tok,
                         counts.float() / (n_tok * k)])

    ex = p["experts"]
    if rank:   # one group: this data shard's tokens
        xg = ep.copy_to_model(torch.cat([xf, gate], dim=1))
        part = _dispatch(cfg, xg[None, :, :d], idx[None], xg[None, :, d:],
                         ex, ep.m)[0]
        out = ep.reduce_model(part)
    else:      # D groups, the data shards; the parts summed in order of m
        if T % D:
            raise ValueError(f"{T} tokens over {D} data shards")
        shards = (xf.reshape(D, T // D, d), idx.reshape(D, T // D, k),
                  gate.reshape(D, T // D, k))
        out = None
        for mm in range(M):
            w = {n: v[mm * E_loc:(mm + 1) * E_loc] for n, v in ex.items()}
            part = _dispatch(cfg, *shards, w, mm)
            out = part if out is None else out + part
    out = out.reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + L.swiglu(p["shared"], x)
    return out, stats


def apply(cfg: ModelConfig, lp, x, lc, ctx):
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    attn_out, new_cache = L.attention_block(
        lp["attn"], h, cfg=cfg, positions=ctx["positions"], cache=lc,
        pos=ctx["pos"], causal=True, q_offset=ctx["q_offset"],
        plain=ctx["plain"],
    )
    x = x + attn_out
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.moe_shard_map:
        ff, aux = moe_ffn_shardmap(cfg, lp, h, ctx.get("ep"))
        ys = {"aux_parts": aux}
    else:
        ff, aux = moe_ffn(cfg, lp, h)
        ys = {"aux": aux}
    x = x + ff
    if new_cache is None:
        # no cache: the per-layer aux loss leaves through the scan's output
        return x, ys
    return x, new_cache


# the dense block's KV cache
register_block("moe", BlockDef(init=init, logical=logical, apply=apply,
                               init_cache=dense.init_cache,
                               cache_logical=dense.cache_logical))
