"""Gradient compression with error feedback (the data-parallel baseline's
allreduce payload).

Counterpart of the reference package's ``optim/compress.py``.  The
data-parallel trainer (the paper's Fig. 1a comparison point) all-reduces
O(N_params) gradient bytes a step, the cost domain decomposition avoids;
compression is the standard mitigation.  Both schemes keep an
error-feedback accumulator (``compressed = C(g + e); e' = (g + e) -
compressed``):

* ``int8`` — per-leaf symmetric quantisation, scale = max|x| / 127
  (+1e-30), rounded half to even (``torch.round``, like ``jnp.round``) and
  clipped to ±127;
* ``topk`` — keep the entries with ``|x| >=`` the k-th largest magnitude,
  k = max(1, round(frac * size)); ties at the threshold are kept, as with
  ``jax.lax.top_k`` and ``>=`` (dense masked form; on a wire it is sent
  sparse, which :func:`wire_bytes` models as index + value pairs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Literal

import torch

from repro_torch.core.nets import map_trees, tree_leaves

Pytree = Any


@dataclass(frozen=True)
class CompressionConfig:
    scheme: Literal["int8", "topk"] = "int8"
    topk_frac: float = 0.01  # fraction of entries kept by topk


def _quant_int8(x: torch.Tensor) -> torch.Tensor:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q * scale  # the dequantised value the receiver reconstructs


def _topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    flat = torch.abs(x).reshape(-1)
    k = max(1, int(round(frac * flat.numel())))
    thresh = torch.topk(flat, k).values[-1]
    return torch.where(torch.abs(x) >= thresh, x, torch.zeros_like(x))


@torch.no_grad()
def compress_decompress(grads: Pytree, err: Pytree, cfg: CompressionConfig
                        ) -> tuple[Pytree, Pytree]:
    """Error-feedback compression: (decompressed grads, new error
    accumulator), leaf by leaf."""

    total = map_trees(torch.add, grads, err)
    if cfg.scheme == "int8":
        comp = map_trees(_quant_int8, total)
    else:
        comp = map_trees(lambda t: _topk_mask(t, cfg.topk_frac), total)
    return comp, map_trees(torch.sub, total, comp)


def wire_bytes(params: Pytree, cfg: CompressionConfig | None) -> int:
    """Modelled allreduce payload bytes per step (the comparison
    benchmarks' model)."""
    leaves = tree_leaves(params)
    n = sum(x.numel() for x in leaves)
    if cfg is None:
        return 4 * n
    if cfg.scheme == "int8":
        return n + 4 * len(leaves)  # 1 B/entry + a scale per leaf
    k = max(1, int(round(cfg.topk_frac * n)))
    return 8 * k  # 4 B index + 4 B value per kept entry
