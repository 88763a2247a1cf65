"""Common transformer layers for the LLM side (pure functions over param dicts).

Counterpart of the reference package's ``models/layers.py``, with the same
conventions:

* Params are nested dicts of float32 tensors (master weights); compute is
  ``cfg.dtype`` (bf16), cast at use.  Layer stacks are STACKED on a leading
  L axis; :func:`scan_layers` walks it in a Python loop over views (the
  reference's ``lax.scan``), each layer under a non-reentrant
  ``torch.utils.checkpoint`` with ``remat`` (the reference's
  ``jax.checkpoint``).
* Initializers draw from a ``torch.Generator`` on the device the tensors are
  made on; they give other numbers than ``jax.random`` from the same seed,
  so tests carry the reference's params across (``api.params_from_numpy``).
* Attention: every full call (``q_offset == 0``, no ``kv_len``), causal
  or not and with S == T or not (the encoder-decoder's bidirectional
  encoder and its cross-attention over the encoder's memory), is the
  flash-attention kernel's function (K5), so :func:`chunked_attention`
  sends it to the kernel's wrapper with its own ``causal`` flag: on CUDA
  tensors it launches K5, on CPU tensors the wrapper takes its plain
  version.  A call with ``kv_len`` (self-attention decode against a cache)
  runs the plain blocked attention
  (``kernels.flash_attention.attention_blocks``); against a cache split
  along T, the split softmax (:func:`decode_attention`).  The choice
  follows the arguments and the tensors' device, never a failure.  Where
  grad is enabled and q, k or v needs it, a full call goes through the
  kernel's training entry (``flash_attention_train``: K5 forward, the
  plain version's VJP by recompute in the backward).
* Loss: :func:`fused_head_cross_entropy` chunks the head product and the
  cross-entropy over the sequence, each chunk a ``torch.autograd.Function``
  that saves only its inputs and recomputes its logits in the backward
  (the reference's ``jax.checkpoint`` per chunk), so the float32 (B, S, V)
  logits never exist.

* Every init function has a twin ``*_logical`` returning the same tree
  with tuples of LOGICAL axis names for leaves (the reference's; mapped to
  mesh axes by ``models/sharding.py``).  The reference's ``constrain``
  sites (sharding hints on activations) are here at the same places with
  the same logical names (``models/partition.py::constrain``): on
  DTensors, in the partitioned dry run, they redistribute; on plain
  tensors they are the identity.  K5 and K6 then take the local shards
  of head- and batch-sharded DTensors (``partition.on_shards``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.nets import map_tree, map_trees, tree_leaves
from repro_torch.kernels import flash_attention as FA
from repro_torch.models.partition import (constrain, fsdp_gathered,
                                          is_dtensor, on_shards,
                                          policy_active, split_kv_attention,
                                          ungathered, unsharded, write_at)

# ------------------------------------------------------------------------- init


class MetaDraws:
    """Stands for a generator on the meta device, which torch has not: the
    dry run's params (``launch.dryrun``) need shapes and dtypes, no
    values."""

    device = torch.device("meta")


def normal_init(gen, shape, std=0.02):
    """N(0, std^2) float32 on ``gen``'s device (on the meta device, an
    empty tensor of the shape)."""
    if gen.device.type == "meta":
        return torch.empty(shape, device=gen.device)
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
    """Stacked (L, ...) params from ``n_layers`` draws of ``layer_init``,
    copied into the stack one layer at a time: the peak holds the stack and
    one layer (deepseek-moe-16b's 63 GB of float32 layers fit a card once,
    not twice)."""
    first = layer_init(gen)
    out = map_tree(lambda t: t.new_empty((n_layers,) + t.shape), first)
    for l in range(n_layers):
        layer = first if l == 0 else layer_init(gen)
        map_trees(lambda o, t: o[l].copy_(t), out, layer)
        del layer
    return out


# ------------------------------------------------------------------------ norms

def rms_norm(x, w, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layer_norm(x, w, b, eps=1e-5):
    """LayerNorm over the last axis, in float32, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


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

    q: (B, S, H, dh); k: (B, T, Hk, dh); v: (B, T, Hk, dv), H % Hk == 0,
    dv <= dh (MLA's v head is narrower than its q/k head).
    q_offset: absolute position of q[0] (causal masking for prefill chunks).
    kv_len: optional (B,) valid cache lengths (decode); None -> all T valid.

    A full call (``q_offset == 0``, no ``kv_len``; causal or not, any S
    and T) is K5's function: on CUDA tensors the kernel runs it (its own
    tiles, its own causal skip), through its training entry where grad is
    enabled and an input needs it; ``plain=True`` takes the kernel's plain
    version (differentiable by autograd) there instead, by name.
    The reference's ``causal_skip`` (an XLA-only FLOP saving with the same
    values) has no counterpart: the kernel skips above the diagonal anyway.
    """
    if q_offset == 0 and kv_len is None:
        if plain:
            fn = FA.flash_attention_plain
        elif needs_grad(q, k, v):
            fn = FA.flash_attention_train
        else:
            fn = FA.flash_attention
        return on_shards(functools.partial(fn, causal=causal,
                                           block_q=block_q),
                         q, (k, v), group=q.shape[2] // k.shape[2])
    return FA.attention_blocks(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len, block_q=block_q)


def needs_grad(*ts) -> bool:
    """Grad is enabled and one of ``ts`` needs it: take a kernel's
    training entry."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def decode_attention(q, k, v, pos):
    """Single-position attention against a full cache. q: (B,1,H,dh), pos: (B,)

    A cache split along T (a DTensor's, or a rank's slice under
    ``partition.use_seq``) takes the split softmax
    (``partition.split_kv_attention``); else the blocked attention."""
    kv_len = pos + 1
    return split_kv_attention(
        q, (k, v), kv_len,
        plain=lambda q, k, v: chunked_attention(q, k, v, causal=False,
                                                kv_len=kv_len, block_q=1),
        partial=FA.attention_partial, dtype=q.dtype)


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


def gqa_logical(bias=False):
    p = {
        "wq": ("embed", "heads"), "wk": ("embed", "heads"),
        "wv": ("embed", "heads"), "wo": ("heads", "embed"),
    }
    if bias:
        p.update({"bq": ("heads",), "bk": ("heads",), "bv": ("heads",)})
    return p


def gqa_query(p, x, n_heads, head_dim, dtype):
    """The query projection of :func:`gqa_project` alone (B, S, H, dh)."""
    B, S, _ = x.shape
    q = x @ p["wq"].to(dtype)
    if "bq" in p:
        q = q + p["bq"].to(dtype)
    return constrain(q.reshape(B, S, n_heads, head_dim), "batch", "seq",
                     "heads", None)


def gqa_project(p, x, n_heads, n_kv, head_dim, dtype):
    B, S, _ = x.shape
    q = gqa_query(p, x, n_heads, head_dim, dtype)
    k = x @ p["wk"].to(dtype)
    v = x @ p["wv"].to(dtype)
    if "bq" in p:
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return (q,
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
            ck, cv = write_at(cache["k"], k, pos), write_at(cache["v"], v, pos)
        else:
            ck, cv = _scatter_prefill(cache["k"], k), \
                _scatter_prefill(cache["v"], v)
        ck = constrain(ck, "batch", "kv_seq", "kv_heads", None)
        cv = constrain(cv, "batch", "kv_seq", "kv_heads", None)
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


def swiglu_logical():
    return {"wi": ("embed", "ff"), "wg": ("embed", "ff"),
            "wo": ("ff", "embed")}


def swiglu(p, x):
    dt = x.dtype
    h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    h = constrain(h, "batch", "seq", "ff")
    return h @ p["wo"].to(dt)


def init_gelu_mlp(gen, d_model, d_ff, std=0.02):
    return {
        "wi": normal_init(gen, (d_model, d_ff), std),
        "bi": zeros(gen, (d_ff,)),
        "wo": normal_init(gen, (d_ff, d_model), std),
        "bo": zeros(gen, (d_model,)),
    }


def gelu_mlp_logical():
    return {"wi": ("embed", "ff"), "bi": ("ff",), "wo": ("ff", "embed"),
            "bo": ("embed",)}


def gelu_mlp(p, x):
    """The reference's ``jax.nn.gelu`` is the tanh approximation."""
    dt = x.dtype
    h = F.gelu(x @ p["wi"].to(dt) + p["bi"].to(dt), approximate="tanh")
    h = constrain(h, "batch", "seq", "ff")
    return h @ p["wo"].to(dt) + p["bo"].to(dt)


# ----------------------------------------------------------------- vocab layers

def init_embedding(gen, vocab, d_model, std=0.02):
    return {"table": normal_init(gen, (vocab, d_model), std)}


def embedding_logical():
    return {"table": ("vocab", "embed")}


def embed(p, tokens, dtype):
    # gather, then cast: the same values as the reference's cast-then-take,
    # without casting the whole table
    return constrain(p["table"][tokens].to(dtype), "batch", "seq",
                     "act_embed")


def _mask_padded_vocab(logits, n_valid):
    if n_valid is None or n_valid == logits.shape[-1]:
        return logits
    bad = torch.arange(logits.shape[-1], device=logits.device) >= n_valid
    return logits.masked_fill(bad, -1e30)


def unembed(p, x, n_valid=None):
    logits = x @ p["table"].to(x.dtype).T
    return _mask_padded_vocab(constrain(logits, "batch", "seq", "vocab"),
                              n_valid)


def init_lm_head(gen, d_model, vocab, std=0.02):
    return {"w": normal_init(gen, (d_model, vocab), std)}


def lm_head_logical():
    return {"w": ("embed", "vocab")}


def lm_head(p, x, n_valid=None):
    logits = constrain(x @ p["w"].to(x.dtype), "batch", "seq", "vocab")
    return _mask_padded_vocab(logits, n_valid)


# ------------------------------------------------------------------------ loss

def _token_nll(logits, labels):
    """Per-token NLL: log-sum-exp of the logits less the label's logit."""
    logits = unsharded(logits, -1)
    lse = torch.logsumexp(logits, dim=-1)
    # gather takes int64 indices; the dry run's batch holds the
    # reference's int32 labels
    return lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def cross_entropy(logits, labels, mask=None):
    """Mean token NLL; logits float32 for stability."""
    nll = _token_nll(logits.float(), labels)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)


class _ChunkNLL(torch.autograd.Function):
    """Summed masked NLL of one sequence chunk through the head; saves its
    inputs only and recomputes the chunk's logits in the backward."""

    @staticmethod
    def _nll(xi, wt, li, mi, transpose_w, n_valid):
        logits = (xi @ wt.T) if transpose_w else (xi @ wt)
        logits = constrain(logits, "batch", None, "vocab")
        logits = _mask_padded_vocab(logits.float(), n_valid)
        return torch.sum(_token_nll(logits, li) * mi)

    @staticmethod
    def forward(ctx, xi, wt, li, mi, transpose_w, n_valid):
        ctx.save_for_backward(xi, wt, li, mi)
        ctx.args = (transpose_w, n_valid)
        with torch.profiler.record_function("fused_head_ce"):
            return _ChunkNLL._nll(xi, wt, li, mi, transpose_w, n_valid)

    @staticmethod
    def backward(ctx, g):
        xi, wt, li, mi = ctx.saved_tensors
        with torch.profiler.record_function("fused_head_ce"), \
                torch.enable_grad():
            xd, wd = xi.detach().requires_grad_(), wt.detach().requires_grad_()
            nll = _ChunkNLL._nll(xd, wd, li, mi, *ctx.args)
            dx, dw = torch.autograd.grad(nll, (xd, wd), g)
        return dx, dw, None, None, None, None


def fused_head_cross_entropy(x, w, labels, mask=None, chunk=512,
                             transpose_w=False, n_valid=None):
    """LM head + softmax cross-entropy, CHUNKED over the sequence so the
    float32 (B, S, V) logits are never materialized: each chunk's product
    and CE is recomputed in the backward, one chunk at a time.

    x: (B, S, D); w: (D, V) head weight (or the (V, D) tied table with
    ``transpose_w``).  Ragged S is padded (mask 0); columns at or past
    ``n_valid`` are masked.  Returns the mean NLL over ``mask``."""
    B, S, D = x.shape
    ck = min(chunk, S)
    n_chunks = (S + ck - 1) // ck
    pad = n_chunks * ck - S
    mask = x.new_ones((B, S), dtype=torch.float32) if mask is None \
        else mask.float()
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    # one cast of the head for all chunks (the reference casts inside
    # each; the values are the same)
    wt = w.to(x.dtype)
    total = x.new_zeros((), dtype=torch.float32)
    for i in range(n_chunks):
        sl = slice(i * ck, (i + 1) * ck)
        total = total + _ChunkNLL.apply(x[:, sl], wt, labels[:, sl],
                                        mask[:, sl], transpose_w, n_valid)
    return total / torch.clamp(mask.sum(), min=1.0)


# -------------------------------------------------------------- layer-stack scan

# the products whose outputs remat policy "dots" keeps (the reference's
# dots_with_no_batch_dims_saveable, as aten ops)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default})


def _keep_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(block_fn, policy):
    """``block_fn`` under a non-reentrant checkpoint: ``"full"`` keeps
    only its inputs, ``"dots"`` also the outputs of its matrix products.
    The blocks draw no random numbers, so no RNG state is stashed."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    if policy in (None, "full"):
        ctx_fn = None
    elif policy == "dots":
        ctx_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _keep_dots)
    else:
        raise ValueError(f"remat policy {policy!r}: 'full' or 'dots'")

    def fn(lp, h, lc):
        kw = {} if ctx_fn is None else {"context_fn": ctx_fn}
        return checkpoint(block_fn, lp, h, lc, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return fn


def scan_layers(block_fn, stacked_params, x, cache=None, remat=False,
                policy="full"):
    """Run x through L stacked layers; threads per-layer cache through.

    block_fn(layer_params, x, layer_cache) -> (x, new_layer_cache).  Layer l
    gets views ``[l]`` of the stacked params (and cache); the new per-layer
    caches are stacked again (None when the blocks return none).

    ``remat`` re-materializes each layer in the backward (where grad is
    enabled): ``policy="full"`` keeps only the per-layer carries,
    ``"dots"`` also the products' outputs (``aten.mm`` / ``addmm`` /
    ``bmm``), trading memory for recompute."""
    stacked_params = ungathered(stacked_params)
    n_layers = tree_leaves(stacked_params)[0].shape[0]
    if is_dtensor(tree_leaves(stacked_params)[0]):
        # each layer's FSDP-sharded weights gathered inside the layer (and
        # again in its remat recompute)
        inner = block_fn

        def block_fn(lp, h, lc):
            with policy_active():
                return inner(fsdp_gathered(lp), h, lc)
    fn = _remat(block_fn, policy) if remat and torch.is_grad_enabled() \
        else block_fn
    new = []
    for l in range(n_layers):
        lc = None if cache is None else map_tree(lambda t: t[l], cache)
        x, nc = fn(map_tree(lambda t: t[l], stacked_params), x, lc)
        new.append(nc)
    return x, (None if new[0] is None else stack_trees(new))
