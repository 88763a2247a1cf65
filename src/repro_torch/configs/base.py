"""Model/shape configuration schema for the architecture zoo.

One ``<arch>.py`` per assigned architecture instantiates :class:`ModelConfig` with
the exact published numbers (plus ``reduced()`` for CPU smoke tests).  The four
input-shape cells are fixed by the assignment:

    train_4k     seq 4096,   global_batch 256   (train_step)
    prefill_32k  seq 32768,  global_batch 32    (inference prefill)
    decode_32k   seq 32768,  global_batch 128   (one-token decode w/ full KV cache)
    long_500k    seq 524288, global_batch 1     (long-context decode; sub-quadratic
                                                 archs only: zamba2, rwkv6)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | mla | moe | hybrid | rwkv | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0        # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"   # full | dots (dots_with_no_batch_dims_saveable)
    attn_block_q: int = 512          # query block for chunked attention
    attn_causal_skip: bool = False   # python-loop q blocks, slice k/v causally
    # ---- MoE ----
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    first_dense: int = 0             # leading dense layers (deepseek-moe: 1)
    d_ff_dense: int = 0              # d_ff of those dense layers (0 -> d_ff)
    capacity_factor: float = 1.25
    moe_shard_map: bool = False      # explicit EP via shard_map (see moe.py)
    # ---- MLA ----
    q_lora: int = 0
    kv_lora: int = 0
    nope_dim: int = 0
    rope_dim: int = 0
    v_head_dim: int = 0
    # ---- SSM / hybrid ----
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0              # zamba2: shared attn block every k mamba blocks
    # ---- enc-dec ----
    n_dec_layers: int = 0
    enc_ratio: int = 4               # encoder frames = seq_len // enc_ratio
    # ---- vlm ----
    n_patches: int = 0               # stub frontend: precomputed patch embeddings
    patch_dim: int = 0
    # ---- skips ----
    sub_quadratic: bool = False      # may run long_500k
    note: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables padded to a 256 multiple so explicit input
        shardings divide evenly on the (16,16)/(2,16,16) meshes; padded logit
        columns are masked out in the loss and the serving argmax."""
        return ((self.vocab + 255) // 256) * 256

    def supports(self, shape: ShapeConfig) -> bool:
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False
        return True

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        base = dict(
            n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4),
            d_ff=128, vocab=256, head_dim=16, remat=False, attn_block_q=32,
        )
        if self.family == "moe":
            base.update(n_experts=4, top_k=2, d_expert=32, n_shared_experts=min(self.n_shared_experts, 1),
                        first_dense=min(self.first_dense, 1))
        if self.family == "mla":
            base.update(q_lora=32, kv_lora=16, nope_dim=8, rope_dim=8, v_head_dim=16, head_dim=0)
        if self.family in ("hybrid", "rwkv"):
            base.update(ssm_state=8, ssm_head_dim=8, ssm_chunk=16, d_model=64)
            if self.attn_every:
                base.update(attn_every=2, n_layers=4)
        if self.family == "encdec":
            base.update(n_dec_layers=2)
        if self.family == "vlm":
            base.update(n_patches=8, patch_dim=32)
        base.update(overrides)
        return replace(self, **base)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (total)."""
    d, hd = cfg.d_model, cfg.hd
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    attn = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) + (cfg.n_heads * hd) * d
    if cfg.family == "mla":
        qk_head = cfg.nope_dim + cfg.rope_dim
        attn = (d * cfg.q_lora + cfg.q_lora * cfg.n_heads * qk_head
                + d * (cfg.kv_lora + cfg.rope_dim)
                + cfg.kv_lora * cfg.n_heads * (cfg.nope_dim + cfg.v_head_dim)
                + cfg.n_heads * cfg.v_head_dim * d)
    dense_ffn = 3 * d * cfg.d_ff
    if cfg.family == "moe":
        moe_ffn = 3 * d * cfg.d_expert * (cfg.n_experts + cfg.n_shared_experts) + d * cfg.n_experts
        n_moe = cfg.n_layers - cfg.first_dense
        ffn_total = cfg.first_dense * dense_ffn + n_moe * moe_ffn
        per_layer_rest = attn + 2 * d
        return emb + ffn_total + cfg.n_layers * per_layer_rest
    if cfg.family == "rwkv":
        tmix = d * d * 4 + d * 6  # r,k,v,g,o approx + decays
        cmix = 2 * d * cfg.d_ff
        return emb + cfg.n_layers * (tmix + cmix + 4 * d)
    if cfg.family in ("hybrid",):
        d_in = cfg.ssm_expand * d
        mamba = d * (2 * d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim) + d_in * d
        shared_attn = attn + dense_ffn
        n_attn_uses = cfg.n_layers // max(cfg.attn_every, 1)
        return emb + cfg.n_layers * (mamba + 2 * d) + shared_attn
    if cfg.family == "encdec":
        enc = cfg.n_layers * (attn + dense_ffn + 4 * d)
        dec = cfg.n_dec_layers * (2 * attn + dense_ffn + 6 * d)
        return emb + enc + dec
    return emb + cfg.n_layers * (attn + dense_ffn + 2 * d)


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: shared + top_k routed)."""
    if cfg.family != "moe":
        return param_count(cfg)
    d = cfg.d_model
    moe_active = 3 * d * cfg.d_expert * (cfg.top_k + cfg.n_shared_experts) + d * cfg.n_experts
    dense_ffn = 3 * d * cfg.d_ff
    hd = cfg.hd
    attn = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) + (cfg.n_heads * hd) * d
    n_moe = cfg.n_layers - cfg.first_dense
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return emb + cfg.first_dense * dense_ffn + n_moe * moe_active + cfg.n_layers * (attn + 2 * d)
