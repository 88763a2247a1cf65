"""Expert parallelism: the context the MoE block's ``moe_ffn_shardmap`` runs in.

Counterpart of the reference package's ``set_mesh`` + ``use_rules`` around
its ``moe_ffn_shardmap`` (a ``shard_map`` over the ``("data", "model")``
mesh).  :func:`use_ep` makes one of two contexts current:

* :class:`EPRank` — this process is rank (d, m) of a ``data x model``
  grid (``launch/mesh.py::make_grid_mesh``; a rank's body gets its own
  from ``GridRank.expert_parallel()``): it holds data shard d of the
  batch (B / D rows, :meth:`EPRank.shard_batch`) and experts [m E/M,
  (m+1) E/M) of every MoE layer (:func:`shard_experts`, or
  ``CausalLM.init(seed, experts=(m, M))``), and it reduces over its two
  groups through :class:`repro_torch.core.halo.Comm` (``gloo``; staged
  through pinned host buffers on a card).  The partitioned dry run's
  rank 0 of a fake grid has one too (``launch/mesh.py``'s
  ``FakeRank.expert_parallel()``): its ``Comm`` on the meta device stages
  nothing and issues each ``dist.all_reduce`` all the same, so the dry
  run records the ranks' collectives;
* :class:`EPPlan` — the one-process twin of a (D, M) grid: all the tokens
  and all the experts in this process, every (d, m) part run here and
  summed over m in the order 0 .. M-1, with no collective.  The CPU tests
  hold the ranks to it, and so does the card check.

The collectives, as autograd Functions (Megatron's pair over the model
group, a sum both ways over the data group):

* :meth:`EPRank.reduce_model` — the MoE's partial output: an all-reduce
  forward, the identity backward;
* :meth:`EPRank.copy_to_model` — the tokens and the gates, replicated over
  the model ranks: the identity forward, an all-reduce backward (each
  rank's gradient holds only its own experts' share);
* :meth:`EPRank.reduce_data` — the load-balance statistics: an all-reduce
  forward and backward.  Every data rank's loss holds the same aux term,
  and the data-parallel mean of the gradients divides by D again, so the
  backward sum is what makes the mean equal the reference's gradient.

The training step's own reductions (``launch/train.py::lm_train_step``):
:func:`global_token_mean` (the cross-entropy over every data shard's
``loss_mask``), :func:`mean_over_data` (one packed all-reduce a dtype of
the gradients, the loss riding in the float32 buffer) and
:func:`global_norm` (the expert leaves' squares summed over the model
group, the replicated leaves counted once).  A group of one rank issues no
collective.  With no context these are identities, and every path is the
one-device path.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass

import torch

_state = threading.local()


@dataclass(frozen=True)
class EPPlan:
    """The one-process twin of a ``data x model`` grid."""

    data: int
    model: int


@dataclass
class EPRank:
    """Rank (d, m) of a ``data x model`` grid, its groups and its ``Comm``."""

    data: int
    model: int
    d: int
    m: int
    data_group: object
    model_group: object
    comm: object

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch (every entry is B-major)."""
        B = next(iter(batch.values())).shape[0]
        if B % self.data:
            raise ValueError(f"batch of {B} rows over {self.data} data "
                             "ranks")
        n = B // self.data
        return {k: v[self.d * n:(self.d + 1) * n] for k, v in batch.items()}

    def reduce_model(self, part: torch.Tensor) -> torch.Tensor:
        if self.model == 1:
            return part
        return _AllReduce.apply(part, self.comm, self.model_group, True,
                                False)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        if self.model == 1:
            return x
        return _AllReduce.apply(x, self.comm, self.model_group, False, True)

    def reduce_data(self, t: torch.Tensor) -> torch.Tensor:
        if self.data == 1:
            return t
        return _AllReduce.apply(t, self.comm, self.data_group, True, True)


class _AllReduce(torch.autograd.Function):
    """A sum over ``group`` forward (``fwd``) and / or backward (``bwd``);
    the identity where not."""

    @staticmethod
    def forward(ctx, x, comm, group, fwd, bwd):
        ctx.comm, ctx.group, ctx.bwd = comm, group, bwd
        return comm.all_reduce(x, group=group) if fwd else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd:
            g = ctx.comm.all_reduce(g, group=ctx.group)
        return g, None, None, None, None


@contextmanager
def use_ep(ep: EPPlan | EPRank | None):
    prev = getattr(_state, "ep", None)
    _state.ep = ep
    try:
        yield ep
    finally:
        _state.ep = prev


def current_ep() -> EPPlan | EPRank | None:
    return getattr(_state, "ep", None)


def reduce_data(t: torch.Tensor) -> torch.Tensor:
    """:meth:`EPRank.reduce_data` on a rank, else the identity (the twin
    holds every data shard)."""
    ep = current_ep()
    return ep.reduce_data(t) if isinstance(ep, EPRank) else t


# --------------------------------------------------------------- the experts

def _cut(t: torch.Tensor, m: int, M: int, axis: int) -> torch.Tensor:
    E = t.shape[axis]
    if E % M:
        raise ValueError(f"{E} experts do not split over {M} model ranks")
    n = E // M
    return t.narrow(axis, m * n, n).clone()


def shard_experts(tree, m: int, M: int, axis: int = 1):
    """``tree`` with every leaf under an ``"experts"`` key cut to model
    rank m's E/M experts along ``axis`` (1 for a model's stacked params,
    0 for one layer's); other leaves are shared, not copied."""
    if not isinstance(tree, dict):
        return tree
    return {k: ({n: _cut(t, m, M, axis) for n, t in v.items()}
                if k == "experts" else shard_experts(v, m, M, axis))
            for k, v in tree.items()}


def _expert_leaves(tree, inside=False):
    """(leaf, is an expert leaf) of a tree of dicts, in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _expert_leaves(v, inside or k == "experts")
    elif tree is not None:
        yield tree, inside


# ------------------------------------------------------- the training step

def global_token_mean(ce: torch.Tensor, mask) -> torch.Tensor:
    """A data rank's share of the global token mean: ``ce`` is the mean over
    this shard's ``mask``; the data ranks' losses then average to the mean
    over every shard's tokens.  The identity unless a rank of more than
    one data shard has a mask (equal shards need no count)."""
    ep = current_ep()
    if not isinstance(ep, EPRank) or ep.data == 1 or mask is None:
        return ce
    n_d = mask.float().sum()
    n = ep.comm.all_reduce(n_d, group=ep.data_group)
    return ce * (ep.data * n_d / n)


def mean_over_data(loss: torch.Tensor, grads: list):
    """(loss, grads) averaged over the data group: one all-reduce a dtype
    of the packed gradients, the loss in the float32 buffer.  The
    identity with no rank context or one data rank."""
    ep = current_ep()
    if not isinstance(ep, EPRank) or ep.data == 1:
        return loss, grads
    by_dtype: dict = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    by_dtype.setdefault(loss.dtype, [])
    out = list(grads)
    for dtype, idx in by_dtype.items():
        parts = [grads[i].reshape(-1) for i in idx]
        if dtype == loss.dtype:
            parts.append(loss.detach().reshape(1))
        flat = ep.comm.all_reduce(torch.cat(parts), group=ep.data_group)
        flat = flat / ep.data
        ofs = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[ofs:ofs + n].reshape(grads[i].shape)
            ofs += n
        if dtype == loss.dtype:
            loss = flat[ofs].reshape(loss.shape)
    return loss, out


def global_norm(grads) -> torch.Tensor | None:
    """The global gradient norm across a rank's model group: the
    replicated leaves' squares once, the expert leaves' summed over the
    model ranks.  None (the one-device norm) with no rank context or one
    model rank."""
    ep = current_ep()
    if not isinstance(ep, EPRank) or ep.model == 1:
        return None
    sq = {False: [], True: []}
    for g, is_expert in _expert_leaves(grads):
        sq[is_expert].append(torch.sum(g.float() ** 2))
    exp = ep.comm.all_reduce(torch.stack(sq[True]).sum(),
                             group=ep.model_group)
    return torch.sqrt(torch.stack(sq[False]).sum() + exp)
