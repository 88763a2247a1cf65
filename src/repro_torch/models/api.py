"""Model registry, the canonical synthetic batch and the param carriers.

Counterpart of the reference package's ``models/api.py``.
``build_model(cfg, device)`` returns the family's model object;
``make_batch`` builds the same token arrays as the reference for the same
seed (numpy ``default_rng``); ``params_from_numpy`` / ``params_to_numpy``
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
from repro_torch.models.causal_lm import CausalLM


def build_model(cfg: ModelConfig, device=None) -> CausalLM:
    """The model of ``cfg`` on ``device`` (``cuda`` unless given).  The
    families ported are ``dense``, ``mla``, ``moe`` and ``rwkv``; the others
    (``vlm``, ``hybrid``, ``encdec``) raise ``NotImplementedError``."""
    return CausalLM(cfg, device)


def _token_shapes(cfg: ModelConfig, shape: ShapeConfig, kind: str):
    B, S = shape.global_batch, shape.seq_len
    if kind == "train":
        return {"tokens": (B, S), "labels": (B, S)}
    if kind == "prefill":
        return {"tokens": (B, S)}
    if kind == "decode":
        return {"tokens": (B, 1)}
    raise ValueError(kind)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, kind: str | None = None,
               seed: int = 0, device=None) -> dict:
    """Deterministic synthetic batch: the reference's token values for the
    same seed, as int64 tensors on ``device`` (default: the CPU)."""
    kind = kind or shape.kind
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab, size=s),
                               dtype=torch.int64, device=device)
            for k, s in _token_shapes(cfg, shape, kind).items()}


