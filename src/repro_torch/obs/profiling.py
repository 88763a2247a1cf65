"""Profiling hooks: named scopes, build/load counting, comp-vs-comm split.

Counterpart of the reference package's ``obs/profiling.py``:

* **named-scope annotation scheme** — :func:`scope` opens a
  ``torch.profiler.record_function`` range named from one vocabulary:
  the reference's (:data:`SCOPES`: communication ``dd-comm-halo``, the
  interface exchange; compute ``dd-comp-forward`` / ``dd-comp-update``,
  the megabatched network entry, the loss backward and Adam; the
  ``pinn2-bwd-*`` backward markers) and the port's own
  (:data:`PORT_SCOPES`: the distributed trainer's all-reduce and the LM
  path's ranges, from one layer of the layer loop down to its weight
  casts).  The ranges land in a ``torch.profiler`` trace (host events,
  and device annotations around the kernels they launch), so a trace can
  be split by phase.  Where nothing reads them (no profiler, no dispatch
  mode) a scope is one shared no-op, so scopes may sit inside the layer
  loop; :func:`backward_scope` brackets a block's backward in a range;

* **build/load counter** — :class:`CompileWatcher` counts what the port
  compiles: the CUDA kernels' ``nvcc`` builds and library loads
  (:mod:`repro_torch.kernels.native`).  A wrapper call whose library is
  already loaded builds and loads nothing, so ``backend_compiles == 0``
  over a loop of calls is the no-rebuild assertion;

* **comp-vs-comm walltime splitter** — :func:`comp_comm_split` times a
  chunk with the exchange against the same chunk with the exchange
  ablated (``DDConfig.disable_exchange=True``) in interleaved rounds, the
  reference's protocol; :func:`halo_traffic` gives the analytic per-device
  exchange traffic of a :class:`~repro_torch.core.domain.Topology` (the
  reference parses it from the compiled HLO) and, given one step, the
  ``dd-*`` scopes that step records.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import record_function

# The annotation scheme: one stable name per phase.  Keys are the phase
# vocabulary ("comm", "comp_forward", ...), values the scope names a trace
# shows (the reference's, character for character).
SCOPES = {
    "comm": "dd-comm-halo",
    "comp_forward": "dd-comp-forward",
    "comp_update": "dd-comp-update",
    "bwd_fused": "pinn2-bwd-fused",
    "bwd_ref": "pinn2-bwd-ref",
    "bwd_fused_select": "pinn2-bwd-fused-select",
}
# The port's own ranges, named as benchmark readers and ``chip_smoke.py``
# read them: the distributed trainer's gradient all-reduce and the LM
# path's.  ``lm_layer``: one layer of ``layers.scan_layers`` (forward, and
# its remat recompute); ``moe_ffn``: the MoE layer's forward (router, aux
# counts, dispatch, experts, shared experts); ``moe_ffn.bwd``: its
# backward (:func:`backward_scope`); ``mla_expand``: MLA's latents
# expanded to K5's k and v; ``weight_cast``: one per-call cast of a
# float32 weight to the compute dtype (``layers.cast``).
PORT_SCOPES = {
    "comm_allreduce": "dd-comm-allreduce",
    "adam_update": "adam_update",
    "flash_attention_vjp": "flash_attention_vjp",
    "wkv6_vjp": "wkv6_vjp",
    "fused_head_ce": "fused_head_ce",
    "lm_layer": "lm_layer",
    "moe_ffn": "moe_ffn",
    "moe_ffn.bwd": "moe_ffn.bwd",
    "mla_expand": "mla_expand",
    "weight_cast": "weight_cast",
}
_NAMES = {**SCOPES, **PORT_SCOPES}
_NOOP = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled
_dispatch_modes = torch._C._len_torch_dispatch_stack


def _name(phase: str) -> str:
    try:
        return _NAMES[phase]
    except KeyError:
        raise ValueError(f"unknown profiling phase {phase!r}; "
                         f"known: {sorted(_NAMES)}") from None


def scope(phase: str):
    """``with scope("comm"): ...`` — a ``record_function`` range named from
    the phase vocabulary (unknown phases raise: the scheme only works if
    names stay canonical).

    The range opens only where something reads it: a profiler is on (its
    state reaches the autograd engine's threads) or a dispatch mode is
    active (``utils.collectives.CollectiveRecorder`` reads the scopes
    through the dispatcher).  Otherwise the scope is one shared no-op
    context, a fraction of a microsecond where a ``record_function``
    costs microseconds."""
    name = _name(phase)
    if _profiler_enabled() or _dispatch_modes():
        return record_function(name)
    return _NOOP


class _CloseRange(torch.autograd.Function):
    """The identity on a block's input; its backward, the block's last,
    closes the range that :class:`_OpenRange` opened."""

    @staticmethod
    def forward(ctx, handles, x):
        ctx.handles = handles
        return x

    @staticmethod
    def backward(ctx, grad):
        if ctx.handles:
            torch.ops.profiler._record_function_exit._RecordFunction(
                ctx.handles.pop())
        return None, grad


class _OpenRange(torch.autograd.Function):
    """The identity on a block's outputs; its backward, the block's first,
    opens the range."""

    @staticmethod
    def forward(ctx, handles, name, *outs):
        ctx.handles, ctx.range_name = handles, name
        return outs

    @staticmethod
    def backward(ctx, *grads):
        ctx.handles.append(torch.ops.profiler._record_function_enter_new(
            ctx.range_name, None))
        return (None, None, *grads)


def _unchanged(*outs):
    return outs


def backward_scope(phase: str, x):
    """Bracket a block's backward in the range ``phase``: ``x, finish =
    backward_scope(phase, x)`` on the block's input, then ``return
    finish(*outputs)``.

    Where a profiler is on and ``x`` takes a gradient, ``x`` and the
    outputs pass through identities whose backward nodes close and open
    the range.  The autograd engine runs ready nodes in descending
    sequence number, so the block's own backward nodes run between the
    two, on one engine thread.  Otherwise nothing is inserted: ``x`` and
    the outputs come back as they are."""
    name = _name(phase)
    if not (_profiler_enabled() and torch.is_grad_enabled()
            and x.requires_grad):
        return x, _unchanged
    handles = []
    x = _CloseRange.apply(handles, x)
    return x, lambda *outs: _OpenRange.apply(handles, name, *outs)


# ------------------------------------------------------- build/load count

_counts: dict[str, int] = defaultdict(int)
_seconds: dict[str, float] = defaultdict(float)
_installed = False
# native's event kinds -> the reference's field names
_EVENTS = {"build": "backend_compiles", "load": "traces"}


def _install() -> None:
    """Register the process-wide listener on ``kernels.native`` once (a
    single accumulating listener + snapshot deltas, as the reference does
    with ``jax.monitoring``)."""
    global _installed
    if _installed:
        return
    from repro_torch.kernels import native

    def _listener(kind: str, seconds: float) -> None:
        key = _EVENTS.get(kind)
        if key is not None:
            _counts[key] += 1
            _seconds[key] += seconds

    native.listeners.append(_listener)
    _installed = True


def compile_counts() -> dict:
    """Process-lifetime build/load counts (monotone; diff two snapshots or
    use :class:`CompileWatcher` for scoped deltas)."""
    _install()
    return {"backend_compiles": _counts["backend_compiles"],
            "traces": _counts["traces"],
            "compile_seconds": round(_seconds["backend_compiles"], 6)}


class CompileWatcher:
    """Scoped build/load delta: ``with CompileWatcher() as w: ...`` then
    ``w.backend_compiles`` / ``w.traces`` / ``w.compile_seconds``.

    What the fields count in the port (the reference counts XLA events):

    * ``backend_compiles`` — ``nvcc`` runs that built a kernel library
      (a source whose library was already on disk is not rebuilt);
    * ``traces`` — kernel libraries loaded into the process (``ctypes``),
      once per library and process: the wrappers keep the handle;
    * ``compile_seconds`` — the wall seconds of those ``nvcc`` runs.

    Optionally mirrors the delta into a registry (``obs.compile/*``
    counters) and an event log (``compile`` event), as the reference.
    """

    def __init__(self, registry=None, events=None):
        _install()
        self._registry, self._events = registry, events
        self.backend_compiles = self.traces = 0
        self.compile_seconds = 0.0

    def __enter__(self):
        self._c0 = dict(_counts)
        self._s0 = dict(_seconds)
        return self

    def __exit__(self, *exc):
        self.backend_compiles = (_counts["backend_compiles"]
                                 - self._c0.get("backend_compiles", 0))
        self.traces = _counts["traces"] - self._c0.get("traces", 0)
        self.compile_seconds = (_seconds["backend_compiles"]
                                - self._s0.get("backend_compiles", 0.0))
        if self._registry is not None:
            g = self._registry.group("obs.compile",
                                     ("backend_compiles", "traces"))
            g["backend_compiles"] += self.backend_compiles
            g["traces"] += self.traces
        if self._events is not None:
            self._events.emit("compile",
                              backend_compiles=self.backend_compiles,
                              traces=self.traces,
                              compile_seconds=round(self.compile_seconds, 6))
        return False


# ------------------------------------------------------------- comp/comm split

def comp_comm_split(run_total, run_comp_only, iters: int = 5,
                    warmup: int = 1, steps: int = 1,
                    clock=time.perf_counter, tracer=None) -> dict:
    """Wall-time comp-vs-comm split of a chunked training step.

    ``run_total`` runs one chunk WITH the halo exchange; ``run_comp_only``
    runs the identical chunk with the exchange ablated
    (``DDConfig.disable_exchange=True``: the loss consumes the local payload,
    so compute is identical and the difference is the communication term —
    the paper's Fig-6 protocol).  Both callables must block until the card
    has finished (``torch.cuda.synchronize``) and rebind their own state.

    Timed in interleaved rounds (total, comp, total, comp, ...) so drift
    hits both paths equally; ``comm`` is the median of PAIRED per-round
    differences, floored at 0 (a noisy round can go negative).  ``steps``
    divides everything down to per-step seconds.

    ``tracer`` (optional :class:`repro_torch.obs.tracing.Tracer`): each
    timed round lands as a ``train.ablation`` trace with ``train.total`` /
    ``train.comp_only`` child spans.
    """
    for _ in range(max(warmup, 1)):
        run_total()
        run_comp_only()
    t_tot, t_comp = [], []
    for i in range(iters):
        root = (tracer.start_trace("train.ablation", lane="train", round=i)
                if tracer is not None else None)
        t0 = clock()
        run_total()
        t1 = clock()
        t_tot.append(t1 - t0)
        t2 = clock()
        run_comp_only()
        t3 = clock()
        t_comp.append(t3 - t2)
        if root is not None:
            tracer.record("train.total", t0, t1, parent=root, round=i)
            tracer.record("train.comp_only", t2, t3, parent=root, round=i)
            root.end()
    tot, comp = np.asarray(t_tot), np.asarray(t_comp)
    comm = float(np.median(tot - comp))
    return {
        "total_s": float(np.median(tot)) / steps,
        "comp_s": float(np.median(comp)) / steps,
        "comm_s": max(0.0, comm) / steps,
        "comm_frac": max(0.0, comm) / max(float(np.median(tot)), 1e-30),
        "rounds": int(iters),
    }


def scope_counts(step) -> dict[str, int]:
    """The ``dd-*`` scopes that one call of ``step`` records: run it under
    ``torch.profiler`` (host events) and count each scope's ranges."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    counts: dict[str, int] = defaultdict(int)
    for ev in prof.events():
        if ev.name.startswith("dd-"):
            counts[ev.name] += 1
    return dict(sorted(counts.items()))


def halo_traffic(topo, channels: int, itemsize: int = 4,
                 step=None) -> dict:
    """Analytic per-device halo-exchange traffic of one outer step.

    One rank per subdomain (``DistributedDDTrainer``): in slot k a rank
    sends its slot-k payload, ``n_iface`` points of ``channels`` values
    (``pde.n_fields + pde.n_eq``: u and the normal-projected flux or the
    residual), to its partner across that slot when it has one
    (``topo.perms``).  ``collective_permute_ops`` / ``_bytes`` are the
    sends and bytes of the busiest device, ``per_device_bytes`` every
    rank's; the exchange is the step's only collective, so
    ``total_collective_bytes`` equals the permute bytes.  With ``step`` (a
    callable running one outer step), ``scope_op_counts`` holds
    :func:`scope_counts` of it; else it is empty."""
    per_slot = int(topo.n_iface) * int(channels) * int(itemsize)
    sends = [0] * int(topo.n_sub)
    for perm in topo.perms:
        for src, _dst in perm:
            sends[int(src)] += 1
    per_device = [n * per_slot for n in sends]
    return {
        "collective_permute_ops": max(sends) if sends else 0,
        "collective_permute_bytes": float(max(per_device, default=0)),
        "total_collective_bytes": float(max(per_device, default=0)),
        "per_device_bytes": per_device,
        "scope_op_counts": scope_counts(step) if step is not None else {},
    }
