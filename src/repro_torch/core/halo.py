"""Interface (halo) exchange: the paper's MPI.Isend/Irecv stage.

Counterpart of the reference package's ``core/halo.py``.  Two exchanges
with one semantics (tested equal):

* :func:`exchange_gather` — the single-process exchange on STACKED arrays
  (leading ``n_sub`` axis): neighbour-index gathers, zeros where a slot has
  no neighbour (the paper's ``MPI.PROC_NULL`` + zeroed buffer; the loss
  re-masks those slots anyway).  Used by ``ReferenceTrainer``.
* :func:`exchange_p2p` — one rank per subdomain (``DistributedDDTrainer``):
  in slot k each rank sends its slot-k payload to its neighbour across
  colour k and receives that neighbour's, one ``dist.batch_isend_irecv``
  per slot (the counterpart of the reference's one ``ppermute`` per slot);
  a rank with no partner in a slot receives zeros.

Both endpoints of an edge store the same physical points under the same
slot, so the received buffer aligns pointwise with the local data.  Both
are differentiable: the transpose of a gather is a scatter-add, the
transpose of the P2P permutation is the reversed exchange (what
``couple_gradients=True`` runs in the backward).

:class:`Comm` holds a rank's collectives over the default process group.
The ``gloo`` backend moves host tensors only, so a payload on a card is
staged through a pinned host buffer (one copy down, the sends and receives,
one copy up) and the staged bytes are counted; CPU tensors go as they are.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.domain import Topology
from repro_torch.obs.profiling import scope


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
    with scope("comm"):
        safe, k_idx, has = (gather_index(topo, payload.device)
                            if index is None else index)
        recv = payload[safe, k_idx]                # (n_sub, K, n_iface, C)
        return recv * has.to(payload.dtype)[..., None, None]


def exchange_tree_gather(payload: dict, topo: Topology, index=None) -> dict:
    return {k: exchange_gather(v, topo, index) for k, v in payload.items()}


# ------------------------------------------------------- one rank per subdomain

class Comm:
    """This rank's collectives over the default process group (``gloo``).

    Tensors on a card are staged through pinned host buffers, cached by
    shape; ``staged_bytes`` counts every byte copied down or up."""

    def __init__(self, device: torch.device):
        if not dist.is_initialized():
            raise RuntimeError(
                "no process group: start the ranks with "
                "repro_torch.launch.mesh.run_ranks")
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.device = torch.device(device)
        self.stage = self.device.type == "cuda"
        self.staged_bytes = 0
        self._bufs: dict = {}

    def _buf(self, key, shape, dtype) -> torch.Tensor:
        k = (key, tuple(shape), dtype)
        if k not in self._bufs:
            self._bufs[k] = torch.empty(shape, dtype=dtype,
                                        pin_memory=self.stage)
        return self._bufs[k]

    def down(self, t: torch.Tensor, key: str = "down") -> torch.Tensor:
        """``t`` as a contiguous host tensor (staged when on a card)."""
        if not self.stage:
            return t.detach().contiguous()
        h = self._buf(key, t.shape, t.dtype)
        h.copy_(t.detach())
        self.staged_bytes += h.numel() * h.element_size()
        return h

    def up(self, h: torch.Tensor) -> torch.Tensor:
        """A host tensor back on this rank's device."""
        if not self.stage:
            return h
        self.staged_bytes += h.numel() * h.element_size()
        return h.to(self.device)

    def exchange(self, x: torch.Tensor, peers) -> torch.Tensor:
        """x (1, K, ...) -> received (1, K, ...): in slot k send ``x[0, k]``
        to ``peers[k][0]`` and receive from ``peers[k][1]`` (None: no
        partner; that slot receives zeros).  One ``batch_isend_irecv`` per
        slot."""
        send = self.down(x[0], "send")
        recv = self._buf("recv", send.shape, send.dtype) if self.stage \
            else torch.empty_like(send)
        recv.zero_()
        for k, (dst, src) in enumerate(peers):
            ops = []
            if dst is not None:
                ops.append(dist.P2POp(dist.isend, send[k], dst))
            if src is not None:
                ops.append(dist.P2POp(dist.irecv, recv[k], src))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        return self.up(recv)[None]

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                   group=None) -> torch.Tensor:
        """The reduction of ``t`` over the ranks of ``group`` (default: all
        of them); a new tensor on ``t``'s device."""
        h = self.down(t, "reduce") if self.stage else \
            t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(h, op=op, group=group)
        return self.up(h)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world, *t.shape): every rank's ``t``, in rank order."""
        if t.dtype == torch.bool:
            return self.all_gather(t.to(torch.uint8)).bool()
        h = self.down(t, "gather")
        out = [torch.empty_like(h) for _ in range(self.world)]
        dist.all_gather(out, h)
        return self.up(torch.stack(out))

    def all_gather_cat(self, tree: dict, dim: int = 0) -> dict:
        """Every leaf of a flat dict of tensors concatenated over the ranks
        along ``dim``; one ``all_gather`` per dtype (leaves packed)."""
        out = {}
        by_dtype: dict = {}
        for k, v in tree.items():
            by_dtype.setdefault(v.dtype, []).append(k)
        for dtype, keys in by_dtype.items():
            flat = torch.cat([tree[k].reshape(-1) for k in keys])
            rows = self.all_gather(flat)                    # (world, L)
            ofs = 0
            for k in keys:
                n, shape = tree[k].numel(), tree[k].shape
                out[k] = torch.cat([r[ofs:ofs + n].reshape(shape)
                                    for r in rows], dim=dim)
                ofs += n
        return out

    def barrier(self) -> None:
        dist.barrier()


def p2p_peers(topo: Topology, rank: int) -> list:
    """Per slot, (the rank this one sends to, the rank it receives from)
    from ``topo.perms`` ((src, dst) pairs, both directions per edge);
    None where the rank has no partner in the slot."""
    peers = []
    for perm in topo.perms:
        dst = [d for s, d in perm if s == rank]
        src = [s for s, d in perm if d == rank]
        peers.append((dst[0] if dst else None, src[0] if src else None))
    return peers


class _P2PExchange(torch.autograd.Function):
    """The P2P exchange with its transpose, the reversed exchange, as the
    backward: the gradient a neighbour holds for the payload it received
    from this rank goes back to this rank."""

    @staticmethod
    def forward(ctx, payload, peers, comm):
        ctx.peers, ctx.comm = peers, comm
        return comm.exchange(payload, peers)

    @staticmethod
    def backward(ctx, grad):
        with scope("comm"):
            rev = [(src, dst) for dst, src in ctx.peers]
            return ctx.comm.exchange(grad, rev), None, None


def exchange_p2p(payload: torch.Tensor, peers, comm: Comm) -> torch.Tensor:
    """payload (1, K, n_iface, C), this rank's slots -> the received
    (1, K, n_iface, C), zeros where the rank has no partner.  ``peers``
    from :func:`p2p_peers`."""
    with scope("comm"):
        return _P2PExchange.apply(payload, peers, comm)


def exchange_tree_p2p(payload: dict, peers, comm: Comm) -> dict:
    """:func:`exchange_p2p` of every payload field in ONE exchange: the
    fields are concatenated on the last axis per slot and split after."""
    keys = list(payload)
    sizes = [payload[k].shape[-1] for k in keys]
    recv = exchange_p2p(torch.cat([payload[k] for k in keys], dim=-1),
                        peers, comm)
    return dict(zip(keys, torch.split(recv, sizes, dim=-1)))
