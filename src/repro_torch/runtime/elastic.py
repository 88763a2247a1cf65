"""Elastic re-decomposition: resume a DD-PINN run on a DIFFERENT worker count.

Counterpart of the reference package's ``runtime/elastic.py``.  At scale,
restarts rarely come back with the same world size.  The paper's
decomposition is static; this extends it: a checkpoint taken at ``n_old``
subdomains can seed a restart at ``n_new`` subdomains.  Each NEW subdomain
adopts the parameters of the OLD subdomain whose centroid is nearest to its
own (the physics re-synchronizes the interfaces within a few hundred steps).
Optimizer moments restart from zero (standard after a topology change); the
Adam step count is preserved via checkpoint metadata
(``runtime.supervisor.elastic_resume`` restores it).

Also provides straggler-aware re-balancing of residual point counts (the
paper's §7.6 notes subdomain 7's 800 points idling the other 9 workers):
:func:`balanced_counts` levels the per-worker budget, and with ``weights``
(e.g. measured per-worker throughput from chunk walltimes, see
:func:`throughput_weights`) it allocates PROPORTIONALLY to worker speed, so
a straggling worker gets fewer points instead of stalling the exchange.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.domain import Decomposition
from repro_torch.core.nets import map_tree


def remap_params(
    old_params,            # stacked (n_old, ...)
    old_decomp: Decomposition,
    new_decomp: Decomposition,
):
    """Nearest-centroid parameter adoption across decompositions.

    Returns ``(params, src)``: every tensor leaf indexed along its stacked
    axis on its own device (other leaves become CPU tensors), and ``src``
    (n_new,), the old subdomain each new one adopts, as numpy."""
    n_old, n_new = old_decomp.n_sub, new_decomp.n_sub
    old_c = np.stack([old_decomp.centroid(q) for q in range(n_old)])
    new_c = np.stack([new_decomp.centroid(q) for q in range(n_new)])
    # nearest old subdomain for every new one
    d2 = ((new_c[:, None, :] - old_c[None, :, :]) ** 2).sum(-1)
    src = np.argmin(d2, axis=1)  # (n_new,)

    def take(x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return x[torch.as_tensor(src, device=x.device)]

    return map_tree(take, old_params), src


class CentroidSpec:
    """Minimal stand-in for a :class:`Decomposition` in :func:`remap_params`
    when only the centroids survive (e.g. read back from checkpoint metadata
    after an elastic restart — the old geometry object is gone)."""

    def __init__(self, centroids):
        self._c = np.asarray(centroids, np.float64)
        self.n_sub = len(self._c)

    def centroid(self, q: int) -> np.ndarray:
        return self._c[q]


def balanced_counts(counts: list[int],
                    weights: list[float] | None = None) -> list[int]:
    """Rebalance per-worker point counts, preserving the global point budget.

    Without ``weights``: equalize (the paper's own fix for its §7.6
    imbalance).  With ``weights`` (relative worker speeds, any positive
    scale): allocate the budget proportionally to speed — the
    straggler-aware variant fed by measured chunk walltimes.
    Largest-remainder rounding keeps the total exact."""
    total = sum(counts)
    n = len(counts)
    if weights is None:
        base = total // n
        out = [base] * n
        for i in range(total - base * n):
            out[i] += 1
        return out
    w = np.asarray(weights, np.float64)
    if len(w) != n:
        raise ValueError(f"{len(w)} weights for {n} workers")
    if (w < 0).any() or w.sum() <= 0:
        raise ValueError("weights must be non-negative with a positive sum")
    share = w / w.sum() * total
    out = np.floor(share).astype(np.int64)
    for i in np.argsort(-(share - out))[: total - int(out.sum())]:
        out[i] += 1
    return [int(c) for c in out]


def throughput_weights(counts, walltimes) -> list[float]:
    """Per-worker speed (points/sec) from measured per-worker chunk
    walltimes — the ``weights`` input to :func:`balanced_counts` (paper §7.6:
    fast workers idle behind the straggler; give them more points
    instead)."""
    c = np.asarray(counts, np.float64)
    t = np.asarray(walltimes, np.float64)
    if c.shape != t.shape:
        raise ValueError(f"counts {c.shape} vs walltimes {t.shape}")
    return [float(x) for x in c / np.maximum(t, 1e-12)]
