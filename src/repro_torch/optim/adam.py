"""Adam / AdamW from scratch (paper §6 uses Adam per subdomain).

Counterpart of the reference package's ``optim/adam.py``.  Supports the
paper's per-subdomain learning rates: ``lr`` may be a scalar OR a tensor
broadcast against each leaf's LEADING axis (the stacked ``n_sub`` axis of
the reference trainer).  Parameters are nested dicts / lists of tensors;
updates are functional (new tensors, as in the reference) and run under
``torch.no_grad()``.  Also a warmup-cosine schedule and gradient clipping by
global norm.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core.nets import map_tree, map_trees, tree_leaves

Pytree = Any


@dataclass(frozen=True)
class AdamConfig:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0  # decoupled (AdamW) when > 0


def init_adam(params: Pytree) -> dict:
    zeros = lambda p: map_tree(lambda x: torch.zeros_like(x).detach(), p)
    first = tree_leaves(params)[0]
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


def _bcast_lr(lr, leaf):
    """Broadcast a scalar / per-subdomain lr against a leaf."""
    lr = torch.as_tensor(lr, dtype=leaf.dtype, device=leaf.device)
    if lr.dim() == 0:
        return lr
    return lr.reshape(lr.shape + (1,) * (leaf.dim() - lr.dim()))


@torch.no_grad()
def adam_update(grads: Pytree, state: dict, params: Pytree, lr,
                cfg: AdamConfig = AdamConfig()) -> tuple[Pytree, dict]:
    count = state["count"] + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, c)
    bc2 = 1.0 - torch.pow(cfg.b2, c)

    m = map_trees(lambda mu, g: cfg.b1 * mu + (1 - cfg.b1) * g, state["m"],
                  grads)
    v = map_trees(lambda nu, g: cfg.b2 * nu + (1 - cfg.b2) * g * g,
                  state["v"], grads)

    def upd(p, mu, nu):
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p
        return p - _bcast_lr(lr, p) * step

    new_params = map_trees(upd, params, m, v)
    return new_params, {"m": m, "v": v, "count": count}


@torch.no_grad()
def clip_by_global_norm(grads: Pytree, max_norm: float, norm=None):
    """Scale ``grads`` to a global norm of at most ``max_norm``; ``norm``
    is the norm when the caller has it (a sharded tree's, summed over its
    ranks), else it is computed from the leaves."""
    gn = norm if norm is not None else torch.sqrt(
        sum(torch.sum(g.float() ** 2) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-12), max=1.0)
    return map_tree(lambda g: g * scale.to(g.dtype), grads), gn


def warmup_cosine(step: torch.Tensor, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = peak_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
