"""Decoder-only LM assembly, generic over per-family block definitions.

Counterpart of the reference package's ``models/causal_lm.py``.  A family
registers a :class:`BlockDef` (per-layer init / apply / cache init).  The
assembly provides the embedding, the loop over the stacked layers, the final
norm and the LM head, and three entry points: ``loss`` (the teacher-forced
next-token loss for training: the layers under per-layer remat with
``cfg.remat`` / ``cfg.remat_policy``, then the chunked fused head
cross-entropy; on a card every attention layer's forward launches the
flash-attention kernel and every RWKV time-mix layer's the WKV6 kernel,
their backward being the plain versions' VJP), ``prefill`` (the full causal
forward through the same kernels) and ``decode_step`` (one token against a
cache, plain torch on every device, as in the reference, where no Pallas
kernel serves decode).  A config with ``first_dense`` leading dense layers
(deepseek-moe-16b) runs them as a ``prelude`` stack of the dense block
(``d_ff_dense`` wide) before its ``n_layers - first_dense`` main layers;
its params and caches then hold ``prelude`` beside ``layers``.  ``loss``
adds the MoE load-balance term, ``0.01 *`` the mean of the layers'
``ys["aux"]``.

The VLM family (llava-next-mistral-7b) is the dense block with a stub
frontend: a batch's precomputed ``patch_embeds`` (B, P, patch_dim) are
projected by ``vis_proj`` and prepended to the token embeddings, so the
layers (and K5) see one causal sequence of P + S positions; ``loss`` drops
the patch positions before the head.  Decode takes tokens only, as in the
reference.  The Zamba2 hybrid (``models/zamba.py``) and the
encoder-decoder (``models/encdec.py``) are subclasses.

The model lives on one device, ``cuda`` unless the caller asks for the CPU
(``build_model(cfg, device="cpu")``); its params and caches are made there.
On the ``meta`` device (the dry run, ``launch/dryrun.py``) ``init`` and
``init_cache`` give tensors of the right shapes and dtypes with no storage,
and the entry points trace the step the card runs, the kernels counted, not
launched.  The reference's sharding trees are ported: ``logical`` (the
param tree's logical axes), ``param_specs``, ``cache_struct`` and
``cache_specs`` (``models/sharding.py``), and so are its ``constrain``
hints (``models/partition.py``: they act on the DTensors of the
partitioned dry run and leave plain tensors as they are).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import expert_parallel as EP
from repro_torch.models import layers as L
from repro_torch.models.partition import constrain, fsdp_gathered
from repro_torch.models.sharding import add_layer_axis, specs_from_logical


@dataclass(frozen=True)
class BlockDef:
    init: Callable          # (gen, cfg) -> layer params
    logical: Callable       # (cfg) -> logical tree (stacked L axis first)
    apply: Callable         # (cfg, lp, x, lc, ctx) -> (y, new_lc)
    init_cache: Callable | None = None   # (cfg, B, T, dtype, device) -> per-layer cache
    cache_logical: Callable | None = None   # (cfg) -> per-layer cache dims
    reads_pos: bool = True  # decode reads its position (rope, cache index)


BLOCKS: dict[str, BlockDef] = {}


def register_block(family: str, block: BlockDef):
    BLOCKS[family] = block


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class CausalLM:
    """Pure-function model bundle for one config on one device."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family not in BLOCKS:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported yet "
                f"(ROADMAP Queue 1; ported: {', '.join(BLOCKS)})")
        self.cfg = cfg
        self.block = BLOCKS[cfg.family]
        # leading dense layers outside the homogeneous stack (deepseek-moe)
        self.prelude = BLOCKS["dense"] if cfg.first_dense else None
        self._n_main = cfg.n_layers - cfg.first_dense
        # calls of the sequence mixer's kernel (K5, or K6 for RWKV) in one
        # full forward, and whether remat runs them again in the backward
        self.attn_calls = cfg.n_layers
        self.attn_remat = bool(cfg.remat)
        self.decode_reads_pos = self.block.reads_pos
        self.device = resolve_device(device)

    def _prelude_cfg(self) -> ModelConfig:
        return replace(self.cfg, family="dense",
                       d_ff=self.cfg.d_ff_dense or self.cfg.d_ff)

    def _generator(self, gen) -> torch.Generator:
        if self.device.type == "meta":
            return L.MetaDraws()
        if isinstance(gen, torch.Generator):
            return gen
        return torch.Generator(device=self.device).manual_seed(
            0 if gen is None else int(gen))

    # ------------------------------------------------------------------ params
    def init(self, gen=None, *, experts=None) -> dict:
        """Params drawn from ``gen`` (a ``torch.Generator`` on the model's
        device, or an int seed for one): the reference's tree, keys and
        shapes, with float32 leaves.  ``experts=(m, M)`` keeps model rank
        m's E/M experts of each MoE layer as the layer is drawn (the same
        draws: ``shard_experts`` of the full tree, without ever holding
        more than one layer's experts)."""
        cfg = self.cfg
        g = self._generator(gen)

        def layer_init(gg):
            lp = self.block.init(gg, cfg)
            return lp if experts is None else \
                EP.shard_experts(lp, *experts, axis=0)

        p = {
            "embed": L.init_embedding(g, cfg.padded_vocab, cfg.d_model),
            "layers": L.stack_init(layer_init, g, self._n_main),
            "final_norm": L.ones(g, (cfg.d_model,)),
        }
        if self.prelude:
            pc = self._prelude_cfg()
            p["prelude"] = L.stack_init(lambda gg: self.prelude.init(gg, pc),
                                        g, cfg.first_dense)
        if not cfg.tie_embeddings:
            p["head"] = L.init_lm_head(g, cfg.d_model, cfg.padded_vocab)
        if cfg.family == "vlm":
            p["vis_proj"] = {
                "w": L.normal_init(g, (cfg.patch_dim, cfg.d_model)),
                "b": L.zeros(g, (cfg.d_model,)),
            }
        return p

    def logical(self) -> dict:
        """The param tree with tuples of logical axis names for leaves."""
        cfg = self.cfg
        t = {
            "embed": L.embedding_logical(),
            "layers": self.block.logical(cfg),
            "final_norm": ("embed",),
        }
        if self.prelude:
            t["prelude"] = self.prelude.logical(self._prelude_cfg())
        if not cfg.tie_embeddings:
            t["head"] = L.lm_head_logical()
        if cfg.family == "vlm":
            t["vis_proj"] = {"w": (None, "embed"), "b": ("embed",)}
        return t

    def param_specs(self, rules):
        return specs_from_logical(self.logical(), rules)

    # ------------------------------------------------------------------- cache
    def _stacked_cache(self, block, cfg, n_layers, B, T):
        one = block.init_cache(cfg, B, T, _dtype(cfg), self.device)
        return {k: t.new_zeros((n_layers,) + t.shape) for k, t in one.items()}

    def init_cache(self, batch_size: int, seq_len: int):
        """Zero per-layer caches, stacked on a leading L axis (None for a
        family without one); ``{"prelude", "layers"}`` with a prelude."""
        if self.block.init_cache is None:
            return None
        main = self._stacked_cache(self.block, self.cfg, self._n_main,
                                   batch_size, seq_len)
        if not self.prelude:
            return main
        pre = self._stacked_cache(self.prelude, self._prelude_cfg(),
                                  self.cfg.first_dense, batch_size, seq_len)
        return {"prelude": pre, "layers": main}

    def on_meta(self):
        """This model on the meta device: its ``init`` and ``init_cache``
        give tensors of the right shapes and dtypes and no storage."""
        meta = copy.copy(self)
        meta.device = torch.device("meta")
        return meta

    def cache_struct(self, batch_size: int, seq_len: int):
        """:meth:`init_cache`'s tree on the meta device (no allocation)."""
        return self.on_meta().init_cache(batch_size, seq_len)

    def cache_specs(self, rules):
        if self.block.cache_logical is None:
            return None
        main = specs_from_logical(
            add_layer_axis(self.block.cache_logical(self.cfg)), rules)
        if not self.prelude:
            return main
        pre = specs_from_logical(add_layer_axis(
            self.prelude.cache_logical(self._prelude_cfg())), rules)
        return {"prelude": pre, "layers": main}

    # ----------------------------------------------------------------- forward
    def _embed_inputs(self, params, batch, dtype):
        """Token embeddings, with the VLM's projected patches in front."""
        x = L.embed(params["embed"], batch["tokens"], dtype)
        if self.cfg.family == "vlm" and "patch_embeds" in batch:
            vp = params["vis_proj"]
            pe = batch["patch_embeds"].to(dtype) @ vp["w"].to(dtype) \
                + vp["b"].to(dtype)
            pe = constrain(pe, "batch", "seq", "act_embed")
            x = torch.cat([pe, x], dim=1)
        return x

    def _hidden(self, params, batch, cache=None, pos=None, plain=False):
        """Backbone up to (and including) the final norm. Returns (x,
        new_cache | ys): without a cache, the main layers' stacked outputs
        (the MoE block's ``{"aux": ...}``, else None).

        The layers run under ``cfg.remat`` / ``cfg.remat_policy`` as in the
        reference; remat acts only where grad is enabled (``loss``)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch, _dtype(cfg))
        B, S = x.shape[:2]
        if pos is None:
            positions = torch.arange(S, device=x.device)[None, :]
        else:
            positions = torch.full((B, 1), pos, dtype=torch.int64,
                                   device=x.device)
        # the expert-parallel context is captured here: a remat recompute
        # runs the layers again in the autograd engine's thread (a card's),
        # where the caller's thread-local context is not set
        ctx = dict(positions=positions, pos=pos, q_offset=0,
                   mode="decode" if pos is not None else "full", plain=plain,
                   ep=EP.current_ep())

        main_cache, pre_cache = cache, None
        if self.prelude and cache is not None:
            pre_cache, main_cache = cache["prelude"], cache["layers"]

        new_pre = None
        if self.prelude:
            pc = self._prelude_cfg()
            x, new_pre = L.scan_layers(
                lambda lp, h, lc: self.prelude.apply(pc, lp, h, lc, ctx),
                params["prelude"], x, pre_cache, remat=cfg.remat,
                policy=cfg.remat_policy)

        def block_fn(lp, h, lc):
            # the residual stream's layout between layers (the reference's
            # sequence-parallel lever, "res_seq")
            h = constrain(h, "batch", "res_seq", "act_embed")
            h, nc = self.block.apply(cfg, lp, h, lc, ctx)
            return constrain(h, "batch", "res_seq", "act_embed"), nc

        x, new_main = L.scan_layers(block_fn, params["layers"], x, main_cache,
                                    remat=cfg.remat, policy=cfg.remat_policy)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        if self.prelude and cache is not None:
            return x, {"prelude": new_pre, "layers": new_main}
        return x, new_main

    def forward(self, params, batch, cache=None, pos=None, *, plain=False):
        """batch: {"tokens": (B, S) [, "patch_embeds": (B, P, patch_dim)]}.

        cache/pos given  -> decode mode (S == 1), returns (logits, new_cache)
        cache/pos absent -> full causal forward, returns (logits, None)

        ``plain=True`` runs the kernels' plain versions on CUDA tensors too
        (the card check compares the two paths); CPU tensors always take
        them.  Under sharding rules (the partitioned dry run) ``params``
        are read through ``fsdp_gathered``: FSDP-split weights gathered
        where first read, each layer's inside its layer."""
        params = fsdp_gathered(params)
        x, nc = self._hidden(params, batch, cache, pos, plain)
        nv = self.cfg.vocab if self.cfg.padded_vocab != self.cfg.vocab \
            else None
        if self.cfg.tie_embeddings:
            logits = L.unembed(params["embed"], x, nv)
        else:
            logits = L.lm_head(params["head"], x, nv)
        return logits, nc

    def _head_weight(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"]["table"], True
        return params["head"]["w"], False

    # ------------------------------------------------------------ entry points
    def loss(self, params, batch, *, plain=False):
        """Teacher-forced next-token loss via the CHUNKED fused head + CE
        (the full float32 logits are never materialized).  batch: tokens and
        labels (B, S), optionally ``loss_mask``.  Differentiable in
        ``params``; ``plain=True`` as in :meth:`forward`.  MoE models add
        ``0.01 *`` the mean load-balance term of their layers.  The VLM's
        patch positions carry no next-token targets: they are dropped
        before the head.  ``params`` are read as in :meth:`forward`."""
        cfg = self.cfg
        params = fsdp_gathered(params)
        x, ys = self._hidden(params, batch, plain=plain)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            x = x[:, batch["patch_embeds"].shape[1]:]
        w, tied = self._head_weight(params)
        loss = L.fused_head_cross_entropy(
            x, w, batch["labels"], batch.get("loss_mask"), transpose_w=tied,
            n_valid=cfg.vocab if cfg.padded_vocab != cfg.vocab else None)
        loss = EP.global_token_mean(loss, batch.get("loss_mask"))
        if isinstance(ys, dict) and "aux" in ys:  # MoE load-balance loss
            loss = loss + 0.01 * torch.mean(ys["aux"])
        elif isinstance(ys, dict) and "aux_parts" in ys:
            # expert parallelism: each layer's (me, ce) summed over the data
            # shards, then E * sum(me * ce)
            parts = EP.reduce_data(ys["aux_parts"])
            aux = cfg.n_experts * torch.sum(parts[:, 0] * parts[:, 1], dim=-1)
            loss = loss + 0.01 * torch.mean(aux)
        return loss

    @torch.no_grad()
    def prefill(self, params, batch, *, plain=False):
        logits, _ = self.forward(params, batch, plain=plain)
        return logits

    @torch.no_grad()
    def decode_step(self, params, cache, batch, pos):
        """One-token step against a pre-existing cache. tokens: (B, 1)."""
        return self.forward(params, batch, cache=cache, pos=pos)
