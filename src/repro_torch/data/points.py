"""Collocation / boundary / interface point pipeline (paper §5.1
pre-processing).

Counterpart of the reference package's ``data/points.py``: the sampling is
numpy and the same code, so for the same ``np.random.Generator`` seed the
arrays are identical to the reference's.  Per-subdomain residual counts may
differ (paper Table 3); arrays are padded to the max and masked.
``balance=True`` equalizes points per worker (the straggler mitigation the
paper suggests for its §7.6 load imbalance).  :meth:`StackedBatch.device_arrays`
moves a batch onto a device as the losses' :class:`SubBatch` of tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.domain import Decomposition, Topology
from repro_torch.core.losses import SubBatch
from repro_torch.core.pdes import PDE


@dataclass
class StackedBatch:
    """All SubBatch fields with a leading n_sub axis (numpy, host-side)."""

    res_pts: np.ndarray
    res_mask: np.ndarray
    data_pts: np.ndarray
    data_vals: np.ndarray
    data_comp: np.ndarray
    data_mask: np.ndarray
    iface_pts: np.ndarray
    iface_nrm: np.ndarray
    edge_mask: np.ndarray

    @property
    def n_sub(self) -> int:
        return self.res_pts.shape[0]

    def device_arrays(self, device=None) -> SubBatch:
        """The batch as float32 tensors on ``device`` (None: the CPU)."""
        return SubBatch(**{f.name: torch.as_tensor(getattr(self, f.name),
                                                   dtype=torch.float32,
                                                   device=device)
                           for f in fields(self)})


def _pad_stack(arrays: list[np.ndarray], n_max: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of (n_q, ...) arrays to (n_sub, n_max, ...) + mask."""
    shape = (len(arrays), n_max) + arrays[0].shape[1:]
    out = np.zeros(shape, np.float32)
    mask = np.zeros((len(arrays), n_max), np.float32)
    for q, a in enumerate(arrays):
        out[q, : len(a)] = a
        mask[q, : len(a)] = 1.0
    return out, mask


def make_batch(
    decomp: Decomposition,
    topo: Topology,
    pde: PDE,
    n_res: int | Sequence[int],
    n_bnd: int,
    rng: np.random.Generator,
    n_interior_data: int = 0,
    balance: bool = False,
) -> StackedBatch:
    """Sample all training points (paper §5.1: once, in pre-processing).

    n_res: residual points per subdomain (int) or per-subdomain counts
    (Table 3).  n_bnd: boundary points per subdomain owning a piece of the
    global boundary.  n_interior_data: interior observation points per
    subdomain (inverse problems).  balance: override heterogeneous counts
    with their mean.
    """
    n = decomp.n_sub
    res_counts = ([int(n_res)] * n if np.isscalar(n_res)
                  else [int(c) for c in n_res])
    if balance:
        res_counts = [int(np.mean(res_counts))] * n

    res_list, data_pts_l, data_val_l, data_comp_l = [], [], [], []
    for q in range(n):
        res_list.append(decomp.sample_interior(q, res_counts[q], rng)
                        .astype(np.float32))
        # boundary data (Dirichlet/IC per PDE)
        bpts = decomp.sample_boundary(q, n_bnd, rng)
        if len(bpts):
            vals, comp, keep = pde.boundary_data(bpts)
            sel = keep > 0
            bpts, vals, comp = bpts[sel], vals[sel], comp[sel]
        else:
            vals = np.zeros((0, pde.n_fields), np.float32)
            comp = np.zeros((0, pde.n_fields), np.float32)
        # interior observations (inverse problems)
        if n_interior_data > 0 and hasattr(pde, "interior_data"):
            ipts = decomp.sample_interior(q, n_interior_data, rng)
            ivals, icomp = pde.interior_data(ipts)
            bpts = np.concatenate([bpts, ipts]) if len(bpts) else ipts
            vals = np.concatenate([vals, ivals])
            comp = np.concatenate([comp, icomp])
        data_pts_l.append(np.asarray(bpts, np.float32).reshape(-1, decomp.dim))
        data_val_l.append(np.asarray(vals, np.float32))
        data_comp_l.append(np.asarray(comp, np.float32))

    res_pts, res_mask = _pad_stack(res_list, max(res_counts))
    n_data_max = max(1, max(len(a) for a in data_pts_l))
    data_pts, data_mask = _pad_stack(data_pts_l, n_data_max)
    data_vals, _ = _pad_stack(data_val_l, n_data_max)
    data_comp, _ = _pad_stack(data_comp_l, n_data_max)

    return StackedBatch(
        res_pts=res_pts, res_mask=res_mask,
        data_pts=data_pts, data_vals=data_vals, data_comp=data_comp,
        data_mask=data_mask,
        iface_pts=topo.iface_points.astype(np.float32),
        iface_nrm=topo.iface_normal.astype(np.float32),
        edge_mask=topo.edge_mask.astype(np.float32),
    )


def stack_batches(batches: Sequence[SubBatch]) -> SubBatch:
    """Stack per-step SubBatches along a NEW leading chunk axis: the input
    of ``trainer.run_chunk(state, stacked)`` (steps=None), which consumes
    one batch per outer step (e.g. resampled collocation points).  All
    batches must share the padded layout."""
    return SubBatch(**{f.name: torch.stack([getattr(b, f.name)
                                            for b in batches])
                       for f in fields(SubBatch)})


def make_vanilla_batch(decomp: Decomposition, pde: PDE, n_res: int,
                       n_bnd: int, rng: np.random.Generator,
                       device=None) -> SubBatch:
    """Single-domain PINN batch (the eq. (3) baseline): every subdomain's
    points pooled, no interfaces.  Float32 tensors on ``device`` (None: the
    CPU), with no subdomain axis."""
    sb = make_batch(decomp, _dummy_topo(decomp), pde, n_res, n_bnd, rng)
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    arrays = {f.name: flat(getattr(sb, f.name)) for f in fields(sb)
              if not f.name.startswith(("iface", "edge"))}
    arrays.update(iface_pts=np.zeros((1, 1, decomp.dim)),
                  iface_nrm=np.zeros((1, 1, decomp.dim)),
                  edge_mask=np.zeros((1,)))
    return SubBatch(**{k: torch.as_tensor(v, dtype=torch.float32,
                                          device=device)
                       for k, v in arrays.items()})


def _dummy_topo(decomp: Decomposition) -> Topology:
    """A topology with no edges: one empty slot per subdomain."""
    n = decomp.n_sub
    return Topology(
        n_sub=n, n_slots=1, n_iface=1, dim=decomp.dim,
        neighbor=np.full((n, 1), -1, np.int32),
        edge_mask=np.zeros((n, 1), np.float32),
        iface_points=np.zeros((n, 1, 1, decomp.dim)),
        iface_normal=np.ones((n, 1, 1, decomp.dim)),
        perms=[[]])
