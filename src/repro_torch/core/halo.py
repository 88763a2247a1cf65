"""Interface (halo) exchange on stacked arrays: the single-process
counterpart of the paper's MPI.Isend/Irecv stage.

Counterpart of the reference package's ``core/halo.py::exchange_gather``:
neighbour-index gathers over the leading ``n_sub`` axis, zeros where a slot
has no neighbour (the paper's ``MPI.PROC_NULL`` + zeroed buffer; the loss
re-masks those slots anyway).  Both endpoints of an edge store the same
physical points under the same slot, so the received buffer aligns
pointwise with the local data.  The exchange is differentiable (the
transpose of a gather is a scatter-add).  The one-rank-per-subdomain
exchange comes with the distributed trainer.
"""
from __future__ import annotations

import torch

from repro_torch.core.domain import Topology


def gather_index(topo: Topology, device=None):
    """The gather's index tensors on ``device``: (neighbour or 0, slot,
    has-a-neighbour mask), each (n_sub, K).  Build them once per trainer:
    making them anew per step would copy host memory to the device."""
    nbr = torch.as_tensor(topo.neighbor, dtype=torch.long, device=device)
    k_idx = torch.arange(topo.n_slots, device=device).expand_as(nbr)
    return nbr.clamp(min=0), k_idx, nbr >= 0


def exchange_gather(payload: torch.Tensor, topo: Topology,
                    index=None) -> torch.Tensor:
    """payload (n_sub, K, n_iface, C) stacked -> received, zeros where no
    neighbour.  ``index`` is :func:`gather_index`'s result (built here when
    not given)."""
    safe, k_idx, has = (gather_index(topo, payload.device) if index is None
                        else index)
    recv = payload[safe, k_idx]                    # (n_sub, K, n_iface, C)
    return recv * has.to(payload.dtype)[..., None, None]


def exchange_tree_gather(payload: dict, topo: Topology, index=None) -> dict:
    return {k: exchange_gather(v, topo, index) for k, v in payload.items()}
