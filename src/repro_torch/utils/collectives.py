"""Collective accounting: what this process's groups carry, by kind and bytes.

Counterpart of the reference package's ``utils/hlo.py``.  The reference
parses XLA's SPMD-partitioned HLO text for the collectives a step runs;
torch emits no such program.  Here a rank issues its collectives one by
one through ``torch.distributed``, and each reaches the dispatcher as a
``c10d`` op.  :class:`CollectiveRecorder`, a ``TorchDispatchMode``, logs
every such op this process issues while it is active, with its process
group (size and description), its operand's dtype and shape, the
enclosing ``record_function`` scopes (``obs.profiling.scope`` included)
and, where the backend gives the op a future, its wall milliseconds from
the call to completion (``gloo``'s send and receive have none: ``None``).

Kinds and per-device operand bytes have ``hlo.py``'s semantics:

====================  ==========================================  =========================
kind                  ``c10d`` ops                                operand bytes
====================  ==========================================  =========================
``all-reduce``        ``allreduce_``, ``allreduce_coalesced_``    the tensors
``all-gather``        ``allgather_``, ``_allgather_base_``, ...   the input (output / group)
``reduce-scatter``    ``reduce_scatter_``, ``_reduce_scatter_     the output times the group
                      base_``, ...
``all-to-all``        ``alltoall_``, ``alltoall_base_``           the input
``collective-permute`` ``send``                                   the bytes sent
====================  ==========================================  =========================

A ``recv_`` is logged with no kind: its bytes are counted once, at the
sender.  Other ``c10d`` ops (barriers, broadcasts) are logged with no
kind either.

The functional collectives that ``torch.distributed.tensor`` (DTensor)
issues when it redistributes (``_c10d_functional.all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, their ``_coalesced`` forms and the in-place
``all_reduce_``; and ``_dtensor.shard_dim_alltoall``, DTensor's move of a
split from one dim to another, an all-to-all) are logged alike, each
once: their operand is the input
(an all-gather's is the output over the group, a reduce-scatter's the
output times the group, as ``hlo.py`` derives them), their group is
resolved from the op's group name.  ``wait_tensor`` is no collective.
A mode sees a DTensor's local ops only when it lets DTensor handle the
op first: the recorder returns ``NotImplemented`` for every op on a
tensor subclass, so DTensor's redistributions reach it as plain ops.

:func:`collective_bytes` and :func:`top_collectives` are the reference's
functions over a record instead of HLO text; :func:`op_histogram` is its
``op_histogram`` over the aten ops one rank ran (``launch/dryrun.py``
counts them in the partitioned dry run).  Its ``named_scope_counts`` has
its counterpart in ``obs.profiling.scope_counts`` (the ``dd-*`` scopes of
one step).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# c10d op name -> (kind, where its operand is: "tensors" / "input" /
# "output" (times the group size))
_OPS = {
    "allreduce_": ("all-reduce", "tensors"),
    "allreduce_coalesced_": ("all-reduce", "tensors"),
    "allgather_": ("all-gather", "input"),
    "_allgather_base_": ("all-gather", "input"),
    "allgather_coalesced_": ("all-gather", "input"),
    "allgather_into_tensor_coalesced_": ("all-gather", "input"),
    "reduce_scatter_": ("reduce-scatter", "output"),
    "_reduce_scatter_base_": ("reduce-scatter", "output"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "output"),
    "alltoall_": ("all-to-all", "input"),
    "alltoall_base_": ("all-to-all", "input"),
    "send": ("collective-permute", "tensors"),
}

# the functional collectives (namespace _c10d_functional): the input is
# the operand; the group name is the last string argument
_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# HLO's element type names
_DTYPES = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.float64: "f64", torch.int32: "s32", torch.int64: "s64",
    torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred",
}


def _tensors(a) -> list:
    """The tensors of one op argument (a tensor or nested lists)."""
    if isinstance(a, torch.Tensor):
        return [a]
    if isinstance(a, (list, tuple)):
        return [t for x in a for t in _tensors(x)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclass
class Collective:
    """One logged ``c10d`` op."""

    op: str                    # the c10d op's name, e.g. "allreduce_"
    kind: str | None           # one of KINDS, or None (recv, barrier, ...)
    bytes: int                 # per-device operand bytes (hlo.py's rule)
    group: int                 # the process group's size
    group_desc: str            # its description ("default_pg", "model", ...)
    sig: str                   # the operand, e.g. "f32[1024,2048]"
    scope: str                 # the enclosing record_function names, "/"
    ms: float | None = field(default=None)   # call to completion


def subclassed(types) -> bool:
    """An op's ``types`` hold a tensor subclass other than a FakeTensor
    (DTensor's sharding propagation runs on those)."""
    return any(t is not torch.Tensor and t.__name__ != "FakeTensor"
               for t in types)


def _named_group(args):
    """The ``ProcessGroup`` named by a functional collective's last string
    argument, else None."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a for a in args if isinstance(a, str)]
    if not names:
        return None
    try:
        return _resolve_process_group(names[-1])
    except (RuntimeError, ValueError, KeyError):
        return None


def _unbox_group(a):
    """The ``ProcessGroup`` of an op's boxed argument, else None."""
    import torch.distributed as dist

    if isinstance(a, torch.ScriptObject):
        try:
            return dist.ProcessGroup.unbox(a)
        except (RuntimeError, TypeError):
            return None
    return None


class CollectiveRecorder(TorchDispatchMode):
    """``with CollectiveRecorder() as rec: ...`` then ``rec.record``: every
    ``c10d`` op this process issued inside, in issue order (the autograd
    engine's threads included: they inherit the mode)."""

    def __init__(self):
        super().__init__()
        self.record: list[Collective] = []
        self._scopes: dict[int, list] = defaultdict(list)
        self._lock = threading.Lock()

    def _scope(self) -> str:
        return "/".join(self._scopes[threading.get_ident()])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns, name = func.namespace, func._opname
        if ns == "profiler":
            stack = self._scopes[threading.get_ident()]
            if name == "_record_function_enter_new":
                stack.append(args[0])
            elif name == "_record_function_exit" and stack:
                stack.pop()
            return func(*args, **kwargs)
        if subclassed(types):
            return NotImplemented
        if (ns == "_c10d_functional" and name in _FUNCTIONAL) or \
                (ns == "_dtensor" and name == "shard_dim_alltoall"):
            pg = _named_group(args)
            kind, where = _FUNCTIONAL.get(name, "all-to-all"), "functional"
        elif ns == "c10d":
            groups = [g for g in map(_unbox_group, args) if g is not None]
            pg = groups[0] if groups else None
            kind, where = _OPS.get(name, (None, "tensors"))
        else:
            return func(*args, **kwargs)
        size = pg.size() if pg is not None else 1
        if where in ("tensors", "functional"):
            operand = _tensors(args[0])
        elif where == "input":
            operand = _tensors(args[1])
        else:   # the output times the group
            operand = _tensors(args[0])
        nbytes = _nbytes(operand) * (size if where == "output" else 1)
        lead = operand[0] if operand else None
        sig = "" if lead is None else \
            f"{_DTYPES.get(lead.dtype, str(lead.dtype))}" \
            f"[{','.join(str(s) for s in lead.shape)}]"
        entry = Collective(op=name, kind=kind, bytes=int(nbytes),
                           group=int(size),
                           group_desc=pg.group_desc if pg is not None else "",
                           sig=sig, scope=self._scope())
        t0 = time.perf_counter()
        out = func(*args, **kwargs)
        self._time(entry, out, t0)
        with self._lock:
            self.record.append(entry)
        return out

    @staticmethod
    def _time(entry: Collective, out, t0: float) -> None:
        """Set ``entry.ms`` when the op's work completes (``gloo`` runs the
        future's callback on its own thread); left None where the work
        has no future."""
        import torch.distributed as dist

        work = out[-1] if isinstance(out, tuple) else out
        if not isinstance(work, torch.ScriptObject):
            return
        try:
            fut = dist.distributed_c10d.Work.unbox(work).get_future()
        except (RuntimeError, TypeError):
            return

        def done(_):
            entry.ms = (time.perf_counter() - t0) * 1e3
        fut.add_done_callback(done)


# ------------------------------------------------- the reference's functions

def _counted(record, group: str | None = None):
    return [c for c in record if c.kind is not None
            and (group is None or c.group_desc == group)]


def collective_bytes(record, group: str | None = None) -> dict:
    """Per-device operand bytes by collective kind (+ op counts): the
    reference's ``collective_bytes`` over a record; ``group`` keeps only
    the ops of the groups with that description."""
    by_kind: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for c in _counted(record, group):
        by_kind[c.kind] += float(c.bytes)
        counts[c.kind] += 1
    return {"bytes_by_kind": dict(by_kind), "counts": dict(counts),
            "total_bytes": float(sum(by_kind.values()))}


def top_collectives(record, n: int = 12) -> list[dict]:
    """The largest single collectives with their scopes: the reference's
    ``top_collectives``, ``op_name`` the ``record_function`` path."""
    out = [{"kind": c.kind, "bytes": float(c.bytes), "group": c.group,
            "sig": c.sig[:60], "op_name": c.scope[-110:]}
           for c in _counted(record)]
    out.sort(key=lambda d: -d["bytes"])
    return out[:n]


def op_histogram(counts, top: int = 25) -> list[tuple[str, int]]:
    """The reference's ``op_histogram``: ``[(op, count)]``, most frequent
    first (ties by name), of a ``{op name: count}`` of the ops one rank
    ran, the ``top`` first."""
    return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:top]


def by_group(record) -> dict:
    """``{group_desc: {kind: {"count", "bytes", "ms"}}}``: the counted ops
    of each group; ``ms`` sums the ops' completion times (None when any
    op of the kind has none)."""
    out: dict = {}
    for c in _counted(record):
        k = out.setdefault(c.group_desc, {}).setdefault(
            c.kind, {"count": 0, "bytes": 0, "ms": 0.0})
        k["count"] += 1
        k["bytes"] += c.bytes
        k["ms"] = None if k["ms"] is None or c.ms is None else k["ms"] + c.ms
    return out
