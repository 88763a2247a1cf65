"""Model registry, the canonical synthetic batch and the param carriers.

Counterpart of the reference package's ``models/api.py``.
``build_model(cfg, device)`` returns the family's model object;
``batch_struct`` builds the batch as meta tensors of the reference's
shapes and dtypes (int32 tokens; the dry run, no allocation);
``make_batch`` builds the same arrays as the reference for the same seed
(numpy ``default_rng``: integer tokens, and the VLM's ``patch_embeds`` or
the encoder-decoder's ``frames`` as standard normal draws in the config's
dtype, drawn in key order); ``params_from_numpy`` / ``params_to_numpy``
(``core.nets``'s) carry a param tree between the two packages key by key
(``jax.tree.map(np.asarray, params)`` on the reference's side), keeping the
stacked leading L axis and the float32 master weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.nets import params_from_numpy, params_to_numpy  # noqa: F401
# block registration side effects
from repro_torch.models import dense as _dense  # noqa: F401
from repro_torch.models import mla as _mla      # noqa: F401
from repro_torch.models import moe as _moe      # noqa: F401
from repro_torch.models import ssm as _ssm      # noqa: F401
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.causal_lm import CausalLM, _dtype
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.zamba import Zamba2Model


def build_model(cfg: ModelConfig, device=None) -> CausalLM:
    """The model of ``cfg`` on ``device`` (``cuda`` unless given): a
    :class:`CausalLM` over the family's registered block (``dense``,
    ``vlm``, ``mla``, ``moe``, ``rwkv``), :class:`Zamba2Model` for
    ``hybrid`` and :class:`EncDecModel` for ``encdec``.  A family with no
    registered block raises ``NotImplementedError``."""
    if cfg.family == "hybrid":
        return Zamba2Model(cfg, device)
    if cfg.family == "encdec":
        return EncDecModel(cfg, device)
    return CausalLM(cfg, device)


def _token_shapes(cfg: ModelConfig, shape: ShapeConfig, kind: str):
    """name -> (shape, dtype) for the given entry point; the VLM's
    ``seq_len`` counts its patches and its tokens."""
    B, S = shape.global_batch, shape.seq_len
    t, f = torch.int64, _dtype(cfg)
    if kind == "decode":
        return {"tokens": ((B, 1), t)}
    if kind not in ("train", "prefill"):
        raise ValueError(kind)
    n_tok = S
    if cfg.family == "vlm":
        n_tok = S - cfg.n_patches
        if n_tok <= 0:
            raise ValueError(
                f"{cfg.name}: seq_len {S} leaves no text tokens after its "
                f"{cfg.n_patches} patches (seq_len counts both)")
    out = {"tokens": ((B, n_tok), t)}
    if kind == "train":
        out["labels"] = ((B, n_tok), t)
    if cfg.family == "vlm":
        out["patch_embeds"] = ((B, cfg.n_patches, cfg.patch_dim), f)
    if cfg.family == "encdec":
        out["frames"] = ((B, max(1, S // cfg.enc_ratio), cfg.d_model), f)
    return out


def batch_struct(cfg: ModelConfig, shape: ShapeConfig,
                 kind: str | None = None) -> dict:
    """The batch of ``shape``'s entry point as meta tensors with the
    reference's dtypes: int32 tokens and labels (``make_batch`` gives the
    port's int64), float inputs in ``cfg.dtype``."""
    kind = kind or shape.kind
    return {k: torch.empty(s, dtype=torch.int32 if d == torch.int64 else d,
                           device="meta")
            for k, (s, d) in _token_shapes(cfg, shape, kind).items()}


def make_batch(cfg: ModelConfig, shape: ShapeConfig, kind: str | None = None,
               seed: int = 0, device=None) -> dict:
    """Deterministic synthetic batch: the reference's values for the same
    seed, tokens as int64 tensors, float inputs in ``cfg.dtype``, on
    ``device`` (default: the CPU)."""
    kind = kind or shape.kind
    rng = np.random.default_rng(seed)
    out = {}
    for k, (s, d) in _token_shapes(cfg, shape, kind).items():
        a = rng.integers(0, cfg.vocab, size=s) if d == torch.int64 \
            else rng.normal(0, 1, size=s)
        out[k] = torch.as_tensor(a, dtype=d, device=device)
    return out
