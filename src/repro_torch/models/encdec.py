"""Encoder-decoder backbone (seamless-m4t-large-v2's text/unit stack).

Counterpart of the reference package's ``models/encdec.py``.  The audio
frontend is a stub, as in the reference: a batch's ``frames`` are
precomputed frame embeddings (B, F, d_model), F = S // ``enc_ratio``.

* Encoder: ``n_layers`` of LayerNorm, bidirectional GQA self-attention
  (rope on its positions), LayerNorm, GELU MLP; then ``enc_norm``.
* Decoder: ``n_dec_layers`` of LayerNorm, causal self-attention (rope),
  LayerNorm, cross-attention over the encoder's memory (no rope: q from
  the decoder, k and v from the memory through the same ``cross_attn``
  projections, the output through its ``wo``), LayerNorm, GELU MLP; then
  ``final_norm`` and the untied head, the padded vocab's columns masked.

Every attention call is a full call, so each is K5's function
(``layers.chunked_attention``): a prefill makes ``n_layers +
2 * n_dec_layers`` of them (``attn_calls``) with three shapes, the
encoder's non-causal S = T = F, the decoder's causal S = T and the
cross-attention's non-causal S x F; both stacks run under per-layer remat
with ``cfg.remat``.  A decode step attends over its self cache in plain
torch (``kv_len``) and over the cached memory's keys and values with a
full non-causal call of one query (K5 on a card, ``n_dec_layers`` a
step).  The cross cache is filled once from the encoded frames
(:meth:`EncDecModel.fill_cross_cache`), as the reference's ``serve`` and
tests fill theirs.

The reference's ``logical`` / ``cache_specs`` sharding trees are ported
(``models/sharding.py``), and so is its ``constrain`` hint on the
encoder's input (``models/partition.py``; the identity on plain
tensors).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.nets import map_tree
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.causal_lm import CausalLM, _dtype
from repro_torch.models.partition import constrain
from repro_torch.models.sharding import add_layer_axis, specs_from_logical


def _ln_init(gen, d):
    return {"w": L.ones(gen, (d,)), "b": L.zeros(gen, (d,))}


def _ln_logical():
    return {"w": (None, "embed"), "b": (None, "embed")}


def _ln(x, p, eps):
    return L.layer_norm(x, p["w"], p["b"], eps)


def _enc_layer_init(gen, cfg):
    return {
        "attn_norm": _ln_init(gen, cfg.d_model),
        "attn": L.init_gqa(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.hd),
        "mlp_norm": _ln_init(gen, cfg.d_model),
        "mlp": L.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff),
    }


def _dec_layer_init(gen, cfg):
    return {
        "self_norm": _ln_init(gen, cfg.d_model),
        "self_attn": L.init_gqa(gen, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.hd),
        "cross_norm": _ln_init(gen, cfg.d_model),
        "cross_attn": L.init_gqa(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd),
        "mlp_norm": _ln_init(gen, cfg.d_model),
        "mlp": L.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff),
    }


class EncDecModel(CausalLM):
    def __init__(self, cfg: ModelConfig, device=None):
        # no block lookup: the stacks are composed here
        self.cfg = cfg
        self.block = None
        self.prelude = None
        # K5 once an encoder layer, twice a decoder layer, all under remat
        self.attn_calls = cfg.n_layers + 2 * cfg.n_dec_layers
        self.attn_remat = bool(cfg.remat)
        self.decode_reads_pos = True
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ params
    def init(self, gen=None) -> dict:
        """The reference's tree (``enc`` and ``dec`` stacked over their
        layers, ``enc_norm`` and ``final_norm`` unstacked) with float32
        leaves, drawn from ``gen``."""
        cfg = self.cfg
        g = self._generator(gen)
        return {
            "embed": L.init_embedding(g, cfg.padded_vocab, cfg.d_model),
            "enc": L.stack_init(lambda gg: _enc_layer_init(gg, cfg), g,
                                cfg.n_layers),
            "dec": L.stack_init(lambda gg: _dec_layer_init(gg, cfg), g,
                                cfg.n_dec_layers),
            "enc_norm": _ln_init(g, cfg.d_model),
            "final_norm": _ln_init(g, cfg.d_model),
            "head": L.init_lm_head(g, cfg.d_model, cfg.padded_vocab),
        }

    def logical(self) -> dict:
        """``enc`` / ``dec`` stacked (their norms carry the L axis),
        ``enc_norm`` / ``final_norm`` single."""
        enc_l = {
            "attn_norm": _ln_logical(),
            "attn": add_layer_axis(L.gqa_logical()),
            "mlp_norm": _ln_logical(),
            "mlp": add_layer_axis(L.gelu_mlp_logical()),
        }
        dec_l = {
            "self_norm": _ln_logical(),
            "self_attn": add_layer_axis(L.gqa_logical()),
            "cross_norm": _ln_logical(),
            "cross_attn": add_layer_axis(L.gqa_logical()),
            "mlp_norm": _ln_logical(),
            "mlp": add_layer_axis(L.gelu_mlp_logical()),
        }
        single_ln = {"w": ("embed",), "b": ("embed",)}
        return {
            "embed": L.embedding_logical(), "enc": enc_l, "dec": dec_l,
            "enc_norm": single_ln, "final_norm": single_ln,
            "head": L.lm_head_logical(),
        }

    # ------------------------------------------------------------------- cache
    def cache_specs(self, rules):
        dims = (None, "batch", "kv_seq", "kv_heads", None)
        return specs_from_logical(
            {k: dims for k in ("self_k", "self_v", "cross_k", "cross_v")},
            rules)

    def init_cache(self, batch_size: int, seq_len: int):
        """Zero self K/V over ``seq_len`` and cross K/V over ``max(1,
        seq_len // enc_ratio)`` frames, stacked over the decoder layers."""
        cfg = self.cfg
        F = max(1, seq_len // cfg.enc_ratio)

        def kv(t):
            return torch.zeros((cfg.n_dec_layers, batch_size, t,
                                cfg.n_kv_heads, cfg.hd), dtype=_dtype(cfg),
                               device=self.device)

        return {"self_k": kv(seq_len), "self_v": kv(seq_len),
                "cross_k": kv(F), "cross_v": kv(F)}

    @torch.no_grad()
    def fill_cross_cache(self, params, cache, frames):
        """``cache`` with its cross K/V replaced by the projections of the
        encoded ``frames`` (B, F, d_model), one decoder layer at a time
        through its ``cross_attn`` (the reference's ``serve.generate``)."""
        cfg = self.cfg
        mem = self.encode(params, frames)
        ks, vs = [], []
        for l in range(cfg.n_dec_layers):
            lp = map_tree(lambda t: t[l], params["dec"]["cross_attn"])
            _, mk, mv = L.gqa_project(lp, mem, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.hd, mem.dtype)
            ks.append(mk)
            vs.append(mv)
        return {**cache, "cross_k": torch.stack(ks),
                "cross_v": torch.stack(vs)}

    # ----------------------------------------------------------------- encoder
    def encode(self, params, frames, plain=False):
        """The encoder over ``frames`` (cast to the config's dtype): its
        memory (B, F, d_model) after ``enc_norm``."""
        cfg = self.cfg
        x = constrain(frames.to(_dtype(cfg)), "batch", "seq", "act_embed")
        positions = torch.arange(x.shape[1], device=x.device)[None, :]

        def enc_fn(lp, h, lc):
            a = _ln(h, lp["attn_norm"], cfg.norm_eps)
            out, _ = L.attention_block(lp["attn"], a, cfg=cfg,
                                       positions=positions, causal=False,
                                       plain=plain)
            h = h + out
            a = _ln(h, lp["mlp_norm"], cfg.norm_eps)
            return h + L.gelu_mlp(lp["mlp"], a), None

        x, _ = L.scan_layers(enc_fn, params["enc"], x, None, remat=cfg.remat,
                             policy=cfg.remat_policy)
        return _ln(x, params["enc_norm"], cfg.norm_eps)

    # ----------------------------------------------------------------- decoder
    def _decode_stack(self, params, x, memory, cache, pos, positions,
                      plain=False):
        """The decoder layers: teacher-forced over ``memory`` (``cache``
        None), or one token against ``cache`` at ``pos``.  Returns (x,
        stacked new cache | None)."""
        cfg = self.cfg
        dtype = x.dtype
        H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd

        def dec_fn(lp, h, lc):
            a = _ln(h, lp["self_norm"], cfg.norm_eps)
            sc = None if lc is None else {"k": lc["self_k"], "v": lc["self_v"]}
            out, nsc = L.attention_block(lp["self_attn"], a, cfg=cfg,
                                         positions=positions, cache=sc,
                                         pos=pos, causal=True, plain=plain)
            h = h + out
            a = _ln(h, lp["cross_norm"], cfg.norm_eps)
            q = L.gqa_query(lp["cross_attn"], a, H, dh, dtype)
            if lc is None:   # teacher-forced: cross K/V from the memory
                _, mk, mv = L.gqa_project(lp["cross_attn"], memory, H, Hk, dh,
                                          dtype)
                out = L.chunked_attention(q, mk, mv, causal=False,
                                          block_q=cfg.attn_block_q,
                                          plain=plain)
                nc = None
            else:
                out = L.chunked_attention(q, lc["cross_k"].to(dtype),
                                          lc["cross_v"].to(dtype),
                                          causal=False, block_q=1,
                                          plain=plain)
                nc = {"self_k": nsc["k"], "self_v": nsc["v"],
                      "cross_k": lc["cross_k"], "cross_v": lc["cross_v"]}
            B, S = a.shape[:2]
            h = h + out.reshape(B, S, H * dh) @ lp["cross_attn"]["wo"].to(dtype)
            a = _ln(h, lp["mlp_norm"], cfg.norm_eps)
            return h + L.gelu_mlp(lp["mlp"], a), nc

        return L.scan_layers(dec_fn, params["dec"], x, cache, remat=cfg.remat,
                             policy=cfg.remat_policy)

    # ----------------------------------------------------------------- forward
    def _hidden(self, params, batch, cache=None, pos=None, plain=False):
        """Decoder output after ``final_norm``: teacher-forced over the
        encoded ``batch["frames"]``, or one token against ``cache``.
        Returns (x, new_cache | None); the inherited ``forward``, ``loss``
        (the chunked fused head cross-entropy, padded columns masked),
        ``prefill`` and ``decode_step`` call it."""
        cfg = self.cfg
        x = L.embed(params["embed"], batch["tokens"], _dtype(cfg))
        B, S = x.shape[:2]
        if pos is None:
            positions = torch.arange(S, device=x.device)[None, :]
            memory = self.encode(params, batch["frames"], plain=plain)
            x, nc = self._decode_stack(params, x, memory, None, None,
                                       positions, plain)
        else:
            positions = torch.full((B, 1), pos, dtype=torch.int64,
                                   device=x.device)
            x, nc = self._decode_stack(params, x, None, cache, pos,
                                       positions, plain)
        return _ln(x, params["final_norm"], cfg.norm_eps), nc
