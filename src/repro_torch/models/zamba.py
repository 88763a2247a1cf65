"""Zamba2 hybrid backbone: Mamba2 stacks with ONE SHARED attention block applied
every ``attn_every`` layers (zamba2-1.2b: 38 Mamba2 blocks, shared attn every 6).

Counterpart of the reference package's ``models/zamba.py``.  The layer stack
is staged: ``n_stages = n_layers // attn_every`` groups of Mamba2 blocks, the
shared-parameter attention block (the dense block's tree: RMS norm, GQA
attention, RMS norm, SwiGLU) after each, and a tail of ``n_layers %
attn_every`` Mamba2 blocks.  Each shared-attention APPLICATION has its own
KV cache slot (same weights, different keys and values).  As in the
reference, the Mamba2 groups run under per-layer remat (``cfg.remat``) and
the shared block does not; on a card its full causal forward launches the
flash-attention kernel (K5), once per stage.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.nets import map_tree, map_trees
from repro_torch.device import resolve_device
from repro_torch.models import dense as dense_mod
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.causal_lm import CausalLM, _dtype
from repro_torch.models.sharding import (add_layer_axis, map_logical,
                                         specs_from_logical)


class Zamba2Model(CausalLM):
    def __init__(self, cfg: ModelConfig, device=None):
        # no block lookup: the blocks are composed here
        self.cfg = cfg
        self.block = None
        self.prelude = None
        self.n_stages = cfg.n_layers // cfg.attn_every
        self.tail = cfg.n_layers % cfg.attn_every
        # the shared attention (K5) once a stage, outside remat
        self.attn_calls, self.attn_remat = self.n_stages, False
        self.decode_reads_pos = True
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ params
    def init(self, gen=None) -> dict:
        """The reference's tree (``mamba`` stacked over all layers,
        ``shared_attn`` unstacked) with float32 leaves, drawn from
        ``gen``."""
        cfg = self.cfg
        g = self._generator(gen)
        return {
            "embed": L.init_embedding(g, cfg.padded_vocab, cfg.d_model),
            "mamba": L.stack_init(lambda gg: ssm_mod.mamba2_init(gg, cfg), g,
                                  cfg.n_layers),
            "shared_attn": dense_mod.init(g, cfg),
            "final_norm": L.ones(g, (cfg.d_model,)),
            "head": L.init_lm_head(g, cfg.d_model, cfg.padded_vocab),
        }

    def logical(self) -> dict:
        """``mamba`` stacked, ``shared_attn`` the dense block's tree
        without its L axis."""
        cfg = self.cfg
        return {
            "embed": L.embedding_logical(),
            "mamba": ssm_mod.mamba2_logical(cfg),
            "shared_attn": map_logical(lambda d: d[1:],
                                       dense_mod.logical(cfg)),
            "final_norm": ("embed",),
            "head": L.lm_head_logical(),
        }

    # ------------------------------------------------------------------- cache
    def cache_specs(self, rules):
        return {
            "mamba": specs_from_logical(
                add_layer_axis(ssm_mod.mamba2_cache_logical(self.cfg)), rules),
            "attn": specs_from_logical(
                add_layer_axis(dense_mod.cache_logical(self.cfg)), rules),
        }

    def init_cache(self, batch_size: int, seq_len: int):
        """``mamba`` stacked over the layers, ``attn`` over the stages."""
        cfg, dt, dev = self.cfg, _dtype(self.cfg), self.device
        mam = ssm_mod.mamba2_cache(cfg, batch_size, seq_len, dt, dev)
        att = dense_mod.init_cache(cfg, batch_size, seq_len, dt, dev)
        return {
            "mamba": {k: t.new_zeros((cfg.n_layers,) + t.shape)
                      for k, t in mam.items()},
            "attn": {k: t.new_zeros((self.n_stages,) + t.shape)
                     for k, t in att.items()},
        }

    # ----------------------------------------------------------------- forward
    def _hidden(self, params, batch, cache=None, pos=None, plain=False):
        """The reference's ``_hidden_zamba``: the staged stack up to (and
        including) the final norm.  Returns (x, new_cache | None); the
        inherited ``forward``, ``loss``, ``prefill`` and ``decode_step``
        call it."""
        cfg = self.cfg
        x = L.embed(params["embed"], batch["tokens"], _dtype(cfg))
        B, S = x.shape[:2]
        if pos is None:
            positions = torch.arange(S, device=x.device)[None, :]
        else:
            positions = torch.full((B, 1), pos, dtype=torch.int64,
                                   device=x.device)
        ctx = dict(positions=positions, pos=pos, q_offset=0,
                   mode="decode" if pos is not None else "full", plain=plain)

        def mamba_fn(lp, h, lc):
            return ssm_mod.mamba2_apply(cfg, lp, h, lc, ctx)

        def group(x, a, b):
            mc = None if cache is None else \
                map_tree(lambda t: t[a:b], cache["mamba"])
            x, nm = L.scan_layers(mamba_fn,
                                  map_tree(lambda t: t[a:b], params["mamba"]),
                                  x, mc, remat=cfg.remat,
                                  policy=cfg.remat_policy)
            new_mamba.append(nm)
            return x

        sa = params["shared_attn"]
        new_mamba, new_attn = [], []
        e = cfg.attn_every
        for s in range(self.n_stages):
            x = group(x, s * e, (s + 1) * e)
            ac = None if cache is None else \
                map_tree(lambda t: t[s], cache["attn"])
            h = L.rms_norm(x, sa["attn_norm"], cfg.norm_eps)
            attn_out, na = L.attention_block(
                sa["attn"], h, cfg=cfg, positions=positions, cache=ac,
                pos=pos, causal=True, plain=plain)
            x = x + attn_out
            h = L.rms_norm(x, sa["mlp_norm"], cfg.norm_eps)
            x = x + L.swiglu(sa["mlp"], h)
            new_attn.append(na)
        if self.tail:
            a = self.n_stages * e
            x = group(x, a, a + self.tail)

        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        if cache is None:
            return x, None
        return x, {
            "mamba": map_trees(lambda *vs: torch.cat(vs, dim=0), *new_mamba),
            "attn": map_trees(lambda *vs: torch.stack(vs, dim=0), *new_attn),
        }
