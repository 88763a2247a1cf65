"""The sharding rules on DTensors: the partitioned dry run's layouts.

Companion of the torch-free ``models/sharding.py``.  There a spec says how
a tree WOULD be laid out on a mesh; here it is laid out: each leaf
becomes a ``torch.distributed.tensor.DTensor`` over a ``DeviceMesh`` of
the plan's axes (``launch/mesh.py::MeshPlan.fake_group``), its local
shard a meta tensor of the size one device holds.  A step run on such
trees is the program of one rank of the partitioned step, as the
reference's GSPMD partitions a jitted one:

* :func:`placements` — a ``PartitionSpec`` entry is ``Shard(dim)`` on the
  mesh dim of that name; a tuple entry such as ``("pod", "data")`` shards
  the dim over each; every other mesh dim is ``Replicate``;
* :func:`meta_dtensors` — a tree of meta tensors as DTensors whose local
  shards have ``MeshPlan.shard_shape``'s size (rank 0's: ceil(dim / n),
  as XLA pads);
* :func:`constrain` — the reference's ``sharding.constrain`` (a
  ``with_sharding_constraint`` by logical names): a DTensor is
  redistributed to the active rules' placements; a plain tensor, or any
  tensor with no active rules, comes back as it is, so the one-device
  paths run exactly as without it;
* :func:`on_shards` — a kernel's function on the local shards of
  batch- and head-sharded DTensors (K5 and K6 take local tensors; their
  meta branches count each device's calls and work);
* :func:`write_at` — the decode's one-position cache write
  (``dynamic_update_slice``): ``clone`` and an indexed write on a plain
  tensor, a select on the position on a DTensor, so a cache sharded along
  that dim is written where each shard holds it;
* :func:`fsdp_gathered` — a param tree's ``embed`` (FSDP) splits
  gathered before use, ZeRO-3's all-gather (its gradient reduce-scattered
  back); ``layers.scan_layers`` gathers each layer's inside the layer;
* :func:`unsharded` — a tensor whole along one dim (the cross-entropy's
  vocab); :func:`expert_einsum` — the experts' products on each device's
  (group, expert) shards;
* :func:`split_kv_attention` — a decode's attention over a cache split
  along T as a split softmax: each shard's partial (o, m, l) at its
  offset, one MAX and one packed SUM all-reduce over the split's mesh
  dims (functional collectives on DTensors; on real ranks, whose caches
  are plain slices, through the ``Comm`` of the :class:`SeqRank` made
  current by :func:`use_seq`, which :func:`write_at` follows too);
* :class:`ReplicateUnsharded` — the torch-function policy the step runs
  under: an op on replicated DTensors runs on their local tensors (what
  every device runs alike), a product's partial sums are reduced where
  they are made, and where DTensor has no sharding for an op on its
  inputs' placements (an uneven unflatten, an indexed write, a sort) the
  op runs on its inputs replicated, as GSPMD falls back to
  rematerialising an operand in full; such ops are counted by name
  (``fallbacks``).  Only an error raised in DTensor's own code is taken
  for a missing sharding: any other propagates.

The model code calls :func:`constrain`, :func:`on_shards`,
:func:`write_at`, :func:`split_kv_attention` and :func:`expert_einsum` on
every path; on plain tensors with no :func:`use_seq` each is the plain
operation.
"""
from __future__ import annotations

import os
import threading
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.models.sharding import current_rules, spec

_state = threading.local()


def _dt():
    from torch.distributed import tensor
    return tensor


def is_dtensor(x) -> bool:
    """``x`` is a DTensor (imports nothing of ``torch.distributed`` for a
    plain tensor)."""
    return type(x) is not torch.Tensor and isinstance(x, torch.Tensor) \
        and type(x).__name__ == "DTensor"


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def placements(spec_, mesh) -> list:
    """The placements of a ``PartitionSpec`` on a ``DeviceMesh`` with
    named dims (a mesh dim of one device splits nothing: ``Replicate``)."""
    dt = _dt()
    names = mesh.mesh_dim_names
    out = [dt.Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec_):
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"mesh {names} has no axis {a!r}")
            if mesh.size(names.index(a)) > 1:
                out[names.index(a)] = dt.Shard(dim)
    return out


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= max(int(s), 1)
    return tuple(reversed(stride))


def meta_dtensors(tree, specs, mesh, plan):
    """A tree of meta tensors (dicts, with a specs tree alike) as DTensors
    over ``mesh`` of their global shapes, each local shard a new meta
    tensor of ``plan.shard_shape``'s size (``plan``: the ``MeshPlan`` of
    the mesh's shape)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: meta_dtensors(tree[k], specs[k], mesh, plan)
                for k in tree}
    local_ = torch.empty(plan.shard_shape(tree.shape, specs),
                         dtype=tree.dtype, device="meta")
    return _dt().DTensor.from_local(local_, mesh, placements(specs, mesh),
                                    run_check=False, shape=tree.shape,
                                    stride=_contiguous_stride(tree.shape))


def local(x):
    """The local shard of a DTensor (differentiable), else ``x``."""
    return x.to_local() if is_dtensor(x) else x


def constrain(x, *logical):
    """The reference's ``sharding.constrain``: ``x`` redistributed to the
    placements of ``logical`` under the active rules where ``x`` is a
    DTensor and rules are active; else ``x`` itself."""
    rules = current_rules()
    if rules is None or not is_dtensor(x):
        return x
    want = placements(spec(*logical, rules=rules), x.device_mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _gather(t, axes):
    if not is_dtensor(t):
        return t
    dt = _dt()
    names = t.device_mesh.mesh_dim_names
    want = [dt.Replicate() if names[i] in axes else p
            for i, p in enumerate(t.placements)]
    return t if want == list(t.placements) else \
        t.redistribute(t.device_mesh, want)


class _Gathered(dict):
    """A dict of params whose leaves come gathered at their first read,
    once; a leaf the step never reads is never gathered (XLA drops an
    unused argument).  :func:`ungathered` gives the leaves as stored."""

    def __init__(self, tree, axes):
        super().__init__(tree)
        self._axes, self._done, self._stored = axes, set(), tree

    def __getitem__(self, key):
        v = super().__getitem__(key)
        if key in self._done:
            return v
        v = _Gathered(v, self._axes) if isinstance(v, dict) \
            else _gather(v, self._axes)
        self[key] = v
        self._done.add(key)
        return v


def fsdp_gathered(tree):
    """A dict of params whose DTensor leaves come whole over the mesh dims
    of the ``embed`` rule (the weights' FSDP storage split, ZeRO-3:
    gathered where first read, the gradient reduce-scattered back); the
    tree itself where no rules are active.  A layer stack read through it
    and handed to ``layers.scan_layers`` is gathered there one layer at a
    time, inside the layer (:func:`ungathered`)."""
    rules = current_rules()
    axes = _axes(rules.get("embed")) if rules is not None else ()
    if not axes:
        return tree
    return _Gathered(tree, axes)


def ungathered(tree):
    """The leaves of an :func:`fsdp_gathered` view as stored (their FSDP
    splits kept); any other tree itself."""
    return tree._stored if isinstance(tree, _Gathered) else tree


def unsharded(x, dim: int):
    """``x`` whole along ``dim``: a DTensor's shardings of that dim
    become ``Replicate`` (an all-gather), a plain tensor is itself.  For
    reductions and gathers over a dim DTensor cannot take sharded (the
    cross-entropy's over the vocab)."""
    if not is_dtensor(x):
        return x
    dt = _dt()
    dim %= x.dim()
    want = [dt.Replicate() if isinstance(p, dt.Shard) and p.dim == dim
            else p for p in x.placements]
    return x if want == list(x.placements) else \
        x.redistribute(x.device_mesh, want)


def write_at(cache, value, pos: int, dim: int = 1):
    """``cache`` with ``value`` (size 1 along ``dim``) written at index
    ``pos`` of ``dim``: a clone and an indexed write; on a DTensor split
    along ``dim`` a select over the position, elementwise on every
    shard; on a real rank of a sequence-split cache (:func:`use_seq`) the
    write where the rank's slice holds ``pos``, else the slice as it is."""
    seq = current_seq()
    if seq is not None and not is_dtensor(cache):
        n = cache.shape[dim]
        local = pos - seq.index * n
        if not 0 <= local < n:
            return cache
        pos = local
    if not is_dtensor(cache) or not any(
            p.is_shard(dim) for p, n in zip(cache.placements,
                                            cache.device_mesh.shape)
            if n > 1):
        out = cache.clone()
        head = (slice(None),) * dim
        out[head + (pos,)] = value[head + (0,)].to(cache.dtype)
        return out
    n = cache.shape[dim]
    shape = [1] * cache.dim()
    shape[dim] = n
    hit = (torch.arange(n, device=cache.device) == pos).reshape(shape)
    return torch.where(hit, value.to(cache.dtype), cache)


# ------------------------------------------------- the sequence-split cache

@dataclass
class SeqRank:
    """This process is slice ``index`` of ``n`` real ranks that hold a
    cache split along T in equal slices (rank i: positions [i T_loc, (i +
    1) T_loc)), its ``group`` (the ranks of the split) and its
    ``core.halo.Comm`` (``gloo``; staged through pinned host buffers on a
    card).  A rank's body gets its own from ``GridRank.sequence_parallel``
    (the grid's model group)."""

    n: int
    index: int
    group: object
    comm: object

    def shard_cache(self, tree, dim: int):
        """This rank's slice along ``dim`` of every leaf of a cache tree
        (contiguous copies); raises where the length does not split
        evenly."""
        if isinstance(tree, dict):
            return {k: self.shard_cache(v, dim) for k, v in tree.items()}
        T = tree.shape[dim]
        if T % self.n:
            raise ValueError(f"a cache of {T} positions over {self.n} ranks")
        n = T // self.n
        return tree.narrow(dim, self.index * n, n).contiguous()


@contextmanager
def use_seq(seq: SeqRank | None):
    """Makes ``seq`` current: every cache the decode hands
    :func:`split_kv_attention` and :func:`write_at` is then this rank's
    slice along T."""
    prev = getattr(_state, "seq", None)
    _state.seq = seq
    try:
        yield seq
    finally:
        _state.seq = prev


def current_seq() -> SeqRank | None:
    return getattr(_state, "seq", None)


def _t_split(kv) -> list:
    """The mesh dims (of more than one device) that split the caches
    ``kv`` along T (dim 1); raises unless every cache has the same
    placements and each is a batch (dim 0) or T split or replicated."""
    first = kv[0].placements
    for t in kv:
        if list(t.placements) != list(first):
            raise ValueError(f"caches laid out unlike: {t.placements}, "
                             f"{first}")
    mesh = kv[0].device_mesh
    dims = []
    for i, p in enumerate(first):
        if mesh.size(i) == 1 or p.is_replicate() or p.is_shard(0):
            continue
        if p.is_shard(1):
            dims.append(i)
            continue
        raise ValueError(
            f"split_kv_attention takes a cache split along T (dim 1) or the "
            f"batch (dim 0), got {p} on mesh dim {mesh.mesh_dim_names[i]}")
    return dims


def _offset(x, dim: int, placements) -> int:
    """Where this rank's shard of ``x`` laid out by ``placements`` starts
    along ``dim`` (DTensor's own chunking: ceil(size / n) a shard)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    return compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, placements)[1][dim]


def _combine(o, m, l, all_reduce):
    """The blocks' partials (o, m, l) combined: M = max m over the blocks,
    then one packed sum of o e^(m - M) and l e^(m - M); ``all_reduce(t,
    op)`` reduces over the blocks (``"max"`` / ``"sum"``).  A block with
    no valid position has m = NEG_INF and weight 0; l > 0 wherever one
    block has a key, so the quotient is finite.  Float32."""
    M = all_reduce(m, "max")
    a = torch.exp(m - M)
    packed = all_reduce(torch.cat([(o * a[..., None]).reshape(-1),
                                   (l * a).reshape(-1)]), "sum")
    n = o.numel()
    return packed[:n].reshape(o.shape) \
        / packed[n:].reshape(l.shape)[..., None]


def _funcol_reduce(mesh, dims):
    """``all_reduce(t, op)`` over the mesh dims ``dims`` in turn, as the
    functional collectives DTensor issues (the collective recorder logs
    each, on the mesh dim's group)."""
    ops = torch.ops._c10d_functional

    def all_reduce(t, op):
        for i in dims:
            t = ops.wait_tensor(ops.all_reduce(t.contiguous(), op,
                                               mesh.get_group(i).group_name))
        return t
    return all_reduce


def split_kv_attention(q, kv, kv_len, *, plain, partial, dtype=None):
    """Attention of the queries ``q`` (one tensor or a tuple, each (B, S,
    H, ...)) over the caches ``kv`` (a tuple, each (B, T, ...)) with
    ``kv_len`` (B,) valid lengths (None: all T), as a split softmax
    where the caches are split along T.  ``plain(*q, *kv)`` is the
    unsplit call; ``partial(*q, *kv, t0=, kv_len=)`` a block's float32
    (o, m, l) at global offset t0 (o (B, S, H, dv), m and l (B, S, H);
    ``kernels.flash_attention.attention_partial``).  Returns ``plain``'s
    result where nothing is split, else the float32 combine cast to
    ``dtype`` (None: kept float32):

    * plain tensors, no :func:`use_seq`: ``plain`` (the one-device path,
      K5's launches, every parity test: today's call);
    * plain tensors under :func:`use_seq`: this rank's slice at offset
      ``index * T_loc``, its ``m`` all-reduced with MAX over the rank's
      group, then o and l (packed, one buffer) with SUM, through its
      ``Comm``;
    * DTensors whose caches are split along T over one or more mesh
      dims: q is gathered over those dims (its batch split kept where
      the caches share it), each device's partial runs on its local
      tensors at its offset (DTensor's ceil split), and the max and the
      packed sum are functional all-reduces over exactly those dims; the
      result has q's batch and head placements back (a local slice).  A
      DTensor cache not split along T takes ``plain``; one split
      otherwise than along T or the batch raises (no quiet gather).
    """
    qs = q if isinstance(q, tuple) else (q,)
    if not any(is_dtensor(t) for t in qs + tuple(kv)):
        seq = current_seq()
        if seq is None:
            return plain(*qs, *kv)
        o, m, l = partial(*qs, *kv, t0=seq.index * kv[0].shape[1],
                          kv_len=kv_len)
        import torch.distributed as dist
        ops = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}
        out = _combine(o, m, l, lambda t, op: seq.comm.all_reduce(
            t, op=ops[op], group=seq.group))
        return out if dtype is None else out.to(dtype)
    tdims = _t_split(kv)
    if not tdims:
        return plain(*qs, *kv)
    dt = _dt()
    mesh = kv[0].device_mesh
    want = [dt.Shard(0) if p.is_shard(0) and mesh.size(i) > 1
            else dt.Replicate() for i, p in enumerate(kv[0].placements)]
    q_loc = tuple(t.redistribute(mesh, want).to_local() for t in qs)
    kv_loc = tuple(t.to_local() for t in kv)
    t0 = _offset(kv[0], 1, kv[0].placements)
    if kv_len is not None:   # (B,), plain: this device's rows of it
        b0 = _offset(qs[0], 0, want)
        kv_len = kv_len[b0:b0 + q_loc[0].shape[0]]
    o, m, l = partial(*q_loc, *kv_loc, t0=t0, kv_len=kv_len)
    out = _combine(o, m, l, _funcol_reduce(mesh, tdims))
    if dtype is not None:
        out = out.to(dtype)
    shape = torch.Size(tuple(qs[0].shape[:3]) + (out.shape[-1],))
    out = dt.DTensor.from_local(out, mesh, want, run_check=False,
                                shape=shape,
                                stride=_contiguous_stride(shape))
    back = _plain_heads(qs[0], (0, 2))
    return out if back == want else out.redistribute(mesh, back)


# ------------------------------------------------------------ kernel shards

def _plain_heads(x, dims) -> list:
    """x's placements with every Shard other than on ``dims`` and every
    Partial made Replicate."""
    dt = _dt()
    return [p if isinstance(p, dt.Shard) and p.dim in dims
            else dt.Replicate() for p in x.placements]


def on_shards(fn, q, kv=(), extra=(), *, group: int = 1, head_dim=2):
    """``fn(q, *kv, *extra)`` on local shards; the identity of calling
    ``fn`` on plain tensors.

    ``q`` (B, S, H, ...) keeps a sharding on its batch dim (0) and its
    head dim (``head_dim``); every other placement is made ``Replicate``.
    Each of ``kv`` (B, T, Hk, ...; ``group`` = H / Hk q heads read one)
    takes q's batch sharding; over a mesh dim where q's heads are split,
    it is split alike where Hk divides over it, else replicated (its
    gradient a pending sum there) and cut, on the shard, to the heads the
    shard's q heads read.  ``extra`` (H, ...) take q's head split on their
    dim 0 and are replicated otherwise (their gradient a pending sum over
    q's batch split).  The result has q's placements and q's global shape
    but its last dim."""
    if not is_dtensor(q):
        return fn(q, *kv, *extra)
    dt = _dt()
    mesh = q.device_mesh
    H = q.shape[head_dim]
    qp = _plain_heads(q, (0, head_dim))
    # an uneven head split stays replicated
    qp = [dt.Replicate() if isinstance(p, dt.Shard) and p.dim == head_dim
          and H % mesh.size(i) else p for i, p in enumerate(qp)]
    q_loc = q.redistribute(mesh, qp).to_local()
    # an input replicated over a mesh dim where the shards read different
    # parts of it gets a pending sum of their gradients there
    batch_dims = [i for i, p in enumerate(qp) if p.is_shard(0)]
    kv_loc = []
    for t in kv:
        tp, cut, partial = [], 1, []
        Hk = t.shape[head_dim]
        for i, p in enumerate(qp):
            n = mesh.size(i)
            if isinstance(p, dt.Shard) and p.dim == head_dim:
                if Hk % n == 0:
                    tp.append(p)
                else:
                    tp.append(dt.Replicate())
                    cut *= n
                    partial.append(i)
            else:
                tp.append(p)
        tl = t.redistribute(mesh, tp).to_local(grad_placements=[
            dt.Partial() if i in partial else p for i, p in enumerate(tp)])
        if cut > 1:
            # rank 0's q heads [0, H / cut) read kv heads [0, ceil(H / cut
            # / group))
            need = -(-(H // cut) // group)
            tl = tl.narrow(head_dim, 0, need)
        kv_loc.append(tl)
    ex_loc = []
    for t in extra:
        tp = [dt.Shard(0) if isinstance(p, dt.Shard) and p.dim == head_dim
              else dt.Replicate() for p in qp]
        ex_loc.append(t.redistribute(mesh, tp).to_local(grad_placements=[
            dt.Partial() if i in batch_dims else p
            for i, p in enumerate(tp)]))
    out = fn(q_loc, *kv_loc, *ex_loc)
    shape = tuple(q.shape[:-1]) + (out.shape[-1],)
    return dt.DTensor.from_local(out, mesh, qp, run_check=False,
                                 shape=torch.Size(shape),
                                 stride=_contiguous_stride(shape))


def expert_einsum(eq: str, x, w):
    """``torch.einsum(eq, x, w)`` of a (G, E, C, ...) buffer and the
    experts' (E, ...) weights, on each device's shards where ``x`` is a
    DTensor: x keeps its group (dim 0) and expert (dim 1) splits, w takes
    x's expert split on its dim 0 (replicated elsewhere, its gradient a
    pending sum over x's group split), and the result has x's
    placements."""
    if not is_dtensor(x) or (_replicated(x) and _replicated(w)):
        return torch.einsum(eq, x, w)
    dt = _dt()
    mesh = x.device_mesh
    xp = [p if p.is_shard(0) or p.is_shard(1) else dt.Replicate()
          for p in x.placements]
    wp = [dt.Shard(0) if p.is_shard(1) else dt.Replicate() for p in xp]
    x_loc = x.redistribute(mesh, xp).to_local()
    w_loc = w.redistribute(mesh, wp).to_local(grad_placements=[
        dt.Partial() if xp[i].is_shard(0) else p for i, p in enumerate(wp)])
    out = torch.einsum(eq, x_loc, w_loc)
    ins, res = eq.split("->")
    size = dict(zip(ins.split(",")[0], x.shape))
    size.update(zip(ins.split(",")[1], w.shape))
    shape = torch.Size(size[c] for c in res)
    return dt.DTensor.from_local(out, mesh, xp, run_check=False,
                                 shape=shape,
                                 stride=_contiguous_stride(shape))


# ------------------------------------------------------------------ fallback

# torch functions that act on a DTensor object itself (autograd state,
# attributes), never on its local tensor
_OWN = frozenset({"__get__", "__set__", "requires_grad_", "retain_grad",
                  "backward", "register_hook", "grad", "apply", "detach_",
                  "__deepcopy__", "__reduce_ex__", "__setstate__"})


def _inplace(name: str) -> bool:
    """A torch function's name is an in-place op's (``add_``,
    ``__setitem__``; not ``__getitem__``)."""
    return name == "__setitem__" or (name.endswith("_")
                                     and not name.endswith("__"))


def _replicated(x) -> bool:
    return all(p.is_replicate() or n == 1
               for p, n in zip(x.placements, x.device_mesh.shape))


def _on_local(func, args, kwargs, dts, name):
    """``func`` on the local tensors of replicated DTensors: the op every
    device runs alike, without DTensor's dispatch; tensor results come
    back replicated (an in-place op's target is returned itself)."""
    dt = _dt()
    mesh = dts[0].device_mesh

    def loc(x):
        return x.to_local() if is_dtensor(x) else x
    out = func(*torch.utils._pytree.tree_map(loc, args),
               **torch.utils._pytree.tree_map(loc, kwargs))
    if _inplace(name):
        return args[0]
    rep = [dt.Replicate()] * mesh.ndim

    def wrap(x):
        if isinstance(x, torch.Tensor) and not is_dtensor(x):
            return dt.DTensor.from_local(x, mesh, rep, run_check=False)
        return x
    if isinstance(out, torch.Tensor):
        return wrap(out)
    if isinstance(out, (tuple, list)):
        return type(out)(wrap(x) for x in out)
    return out


class _PendingMean(Exception):
    """A mean over a split dim left as a pending average, which DTensor
    cannot take back in the backward (its gradient arrives as a pending
    sum): the op runs again on its input gathered."""


# shape changes whose backward DTensor may be unable to run on the layout
# the gradient arrives in (an uneven unflatten of a split dim)
_RESHAPES = frozenset({"reshape", "view", "flatten", "unflatten",
                       "reshape_as", "view_as"})


class _GradLike(torch.autograd.Function):
    """The identity on a reshaped DTensor whose gradient is brought back
    to the tensor's own placements before it flows on (the reshape's
    backward then runs on the layout its forward ran on)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and list(g.placements) != list(ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def _reduced(out):
    """``out`` with every pending sum (a ``Partial`` placement) of its
    DTensors reduced at once, in their dtype, as XLA reduces a product's
    partial sums where it makes them."""
    def red(x):
        if not is_dtensor(x) or not any(p.is_partial()
                                        for p in x.placements):
            return x
        if any(p.is_partial() and p.reduce_op != "sum"
               for p in x.placements):
            raise _PendingMean
        dt = _dt()
        return x.redistribute(x.device_mesh, [
            dt.Replicate() if p.is_partial() else p for p in x.placements])
    if is_dtensor(out):
        return red(out)
    if isinstance(out, (tuple, list)):
        return type(out)(red(x) for x in out)
    return out


_policy = threading.local()


@contextmanager
def policy_active():
    """Re-enters the :class:`ReplicateUnsharded` of this thread's
    partitioned step where it is not on the mode stack: a remat recompute
    replays a layer inside the autograd engine, below the
    ``torch.autograd.grad`` call that the mode left."""
    mode = getattr(_policy, "mode", None)
    if mode is None or mode in _function_modes():
        yield
        return
    with mode:
        yield


_DTENSOR_DIR = None


def _from_dtensor(err) -> bool:
    """``err`` was raised in DTensor's own code (its sharding propagation
    or dispatch: an op with no strategy for its inputs' placements, a view
    of an uneven split, an in-place op whose target would change its
    placements), not in the model's."""
    global _DTENSOR_DIR
    if isinstance(err, _PendingMean):
        return True
    if _DTENSOR_DIR is None:
        _DTENSOR_DIR = os.path.dirname(_dt().__file__) + os.sep
    tb = err.__traceback__
    if tb is None:
        return False
    while tb.tb_next is not None:
        tb = tb.tb_next
    return tb.tb_frame.f_code.co_filename.startswith(_DTENSOR_DIR)


def _function_modes() -> list:
    from torch.overrides import _get_current_function_mode_stack
    return _get_current_function_mode_stack()


class ReplicateUnsharded(TorchFunctionMode):
    """The partitioned dry run's policy over DTensor's: a torch function
    whose output holds partial sums has them reduced at once (an
    all-reduce in the output's dtype); one whose DTensor inputs DTensor
    cannot shard runs again on them replicated, first all but their
    leading (batch) dim's split, then whole (an in-place op keeps its
    target; into a plain target its operands come whole and plain).
    Plain tensors mix in as replicated ones.  ``fallbacks`` counts the
    ops that were run again, by name.  An error raised outside DTensor's
    own code, or one the replicated run raises again, propagates."""

    def __init__(self):
        super().__init__()
        self.fallbacks: Counter = Counter()

    def __enter__(self):
        self._outer = getattr(_policy, "mode", None)
        _policy.mode = self
        return super().__enter__()

    def __exit__(self, *exc):
        _policy.mode = self._outer
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = torch.utils._pytree.tree_leaves((args, kwargs))
        dts = [x for x in leaves if is_dtensor(x)]
        if not dts:
            return func(*args, **kwargs)
        name = getattr(func, "__name__", str(func))
        if name not in _OWN and all(_replicated(x) for x in dts):
            return _on_local(func, args, kwargs, dts, name)
        dt = _dt()
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            try:
                return self._kept(name, _reduced(func(*args, **kwargs)))
            except Exception as first:   # noqa: BLE001 (filtered below)
                if not _from_dtensor(first):
                    raise
                inplace = _inplace(name)
                target = args[0] if inplace and args else None
                # an in-place op on a plain tensor takes plain operands
                whole = target is not None and not is_dtensor(target)
                out = first
                # first keep each operand's split of its leading (batch)
                # dim, then replicate it too
                for keep in ((0,), ()):
                    if whole and keep:
                        continue

                    def rep(x):
                        if not is_dtensor(x) or x is target:
                            return x
                        want = [p if isinstance(p, dt.Shard) and p.dim in keep
                                else dt.Replicate() for p in x.placements]
                        if want != list(x.placements):
                            x = x.redistribute(x.device_mesh, want)
                        return x.to_local() if whole else x
                    try:
                        out = _reduced(func(
                            *torch.utils._pytree.tree_map(rep, args),
                            **torch.utils._pytree.tree_map(rep, kwargs)))
                        break
                    except Exception as again:   # noqa: BLE001
                        if not _from_dtensor(again):
                            raise
                        continue
                if out is first:
                    raise first from None
                self.fallbacks[name] += 1
                return self._kept(name, out)

    @staticmethod
    def _kept(name, out):
        """A reshape's DTensor output with its gradient's layout kept."""
        if name in _RESHAPES and is_dtensor(out) and out.requires_grad:
            return _GradLike.apply(out)
        return out
