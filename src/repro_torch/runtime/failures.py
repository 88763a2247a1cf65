"""Failure injection + restart harness (fault-tolerance validation).

Counterpart of the reference package's ``runtime/failures.py``.  Real
multi-node jobs die: preemptions, link flaps, kernel panics.  The recovery
contract of this framework is *checkpoint/restart with bitwise
continuation*.  This module provides deterministic fault injection that
proves the contract, at two granularities:

* ``run_with_failures`` — the step-granular harness: drives a training loop,
  killing it (by raising :class:`InjectedFailure` out of the step loop) at
  scheduled steps, then restarting from the latest checkpoint — exactly what
  a cluster supervisor does.

* the **chunk-granular fault matrix** — :class:`Fault` / :class:`FaultInjector`
  drive the trainers' chunk world (one ``run_chunk_guarded`` == one
  scheduling unit), consumed by ``runtime.supervisor.Supervisor``.  Beyond
  crashes it covers the failure modes a crash-only harness can't see:

  ========== ============================================================
  kind        effect at the scheduled chunk
  ========== ============================================================
  crash       :class:`InjectedFailure` AFTER the chunk computes but BEFORE
              its checkpoint — the chunk's progress is lost (mid-chunk
              preemption)
  nan_params  NaN poked into one parameter leaf (one subdomain's slice of
              the stacked axis when ``subdomain`` is set) — the on-device
              guard must trip within ONE chunk
  nan_grads   NaN poked into the first-moment Adam buffer: the loss stays
              finite but the NEXT update poisons the params — caught by
              the guard's param-norm check, not the loss check
  straggler   ``delay`` seconds of sleep before the chunk (simulated slow
              worker; feeds the supervisor's walltime-weighted rebalance)
  ========== ============================================================
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.nets import map_trees, tree_leaves, tree_unflatten


class InjectedFailure(RuntimeError):
    pass


# ----------------------------------------------------------- step-granular


def _like(tree, template):
    """Restored numpy leaves -> the template's types: a tensor leaf comes
    back as a tensor of its dtype on its device, anything else as numpy."""
    return map_trees(lambda a, t: (torch.as_tensor(a, dtype=t.dtype,
                                                   device=t.device)
                                   if isinstance(t, torch.Tensor) else a),
                     tree, template)


def run_with_failures(
    *,
    root: str,
    init_fn: Callable[[], object],
    step_fn: Callable[[object], object],
    total_steps: int,
    ckpt_every: int,
    fail_at: Iterable[int] = (),
    max_restarts: int = 16,
) -> object:
    """Run ``total_steps`` of ``step_fn`` with checkpoints every
    ``ckpt_every`` and injected crashes at the given global step numbers.
    Returns the final state."""
    fail_at = sorted(set(fail_at))
    restarts = 0
    while True:
        # (re)start: restore or init
        template = init_fn()
        start = ckpt.latest_step(root)
        if start is None:
            state, start = template, 0
        else:
            state, _ = ckpt.restore(root, template)
            state = _like(state, template)
        try:
            for s in range(start, total_steps):
                if fail_at and s == fail_at[0] and restarts <= max_restarts:
                    fail_at.pop(0)
                    raise InjectedFailure(f"injected failure at step {s}")
                state = step_fn(state)
                done = s + 1
                if done % ckpt_every == 0 or done == total_steps:
                    ckpt.save(root, done, state)
            return state
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            continue


# ---------------------------------------------------------- chunk-granular

FAULT_KINDS = ("crash", "nan_params", "nan_grads", "straggler")

# serve-side matrix (consumed by FaultyEngine; ``chunk`` = engine dispatch
# index — each evaluate ATTEMPT, so retries shift later indices, mirroring
# the training-side launch-indexed semantics):
#
#   ============= =========================================================
#   kind           effect at the scheduled dispatch
#   ============= =========================================================
#   engine_raise   InjectedFailure out of evaluate (poisoned query / OOM /
#                  crashed backend) — frontend must bisect + quarantine
#   nan_output     evaluation succeeds but one CLAIMED point comes back NaN
#                  (weight corruption) — the serve output guard must trip
#   slow_engine    ``delay`` seconds of injected latency before evaluating
#                  (straggling device / noisy neighbor)
#   compile_storm  drop the engine's per-shape compiled state (see
#                  FaultyEngine: this port's engine keeps none)
#   ============= =========================================================
SERVE_FAULT_KINDS = ("engine_raise", "nan_output", "slow_engine",
                     "compile_storm")

# storage fault family (consumed by runtime.chaos: filesystem corruption of
# durable state — checkpoint generations or exported serve bundles — applied
# when the scheduled chunk/dispatch index comes due):
#
#   ============= =========================================================
#   kind           effect on the targeted generation's files
#   ============= =========================================================
#   bit_flip       one bit flipped at a seeded offset (bit rot / bad sector)
#   truncate       file cut to a seeded fraction of its length (interrupted
#                  write, filesystem shrink-on-crash)
#   torn_write     the file's tail overwritten with zero pages (power loss
#                  mid-write on a non-atomic filesystem)
#   missing_file   arrays.npz removed (lost object / failed replication)
#   ============= =========================================================
STORAGE_FAULT_KINDS = ("bit_flip", "truncate", "torn_write", "missing_file")

ALL_FAULT_KINDS = FAULT_KINDS + SERVE_FAULT_KINDS + STORAGE_FAULT_KINDS


@dataclass(frozen=True)
class Fault:
    """One scheduled fault.  ``chunk`` indexes the supervisor's chunk
    LAUNCHES (attempts, so a retry consumed by an earlier fault shifts later
    indices by design — schedules stay deterministic under recovery).
    Serve-side kinds index engine dispatch attempts instead (see
    SERVE_FAULT_KINDS).  Storage kinds (STORAGE_FAULT_KINDS) fire at the same
    launch/dispatch indices but corrupt durable state on disk: ``target``
    picks the artifact family ("ckpt" checkpoint root | "bundle" exported
    bundle root) and ``index`` the generation, 0 = newest."""

    chunk: int
    kind: str                    # one of ALL_FAULT_KINDS
    subdomain: int | None = None  # nan_*: poison only this stacked slice
    delay: float = 0.0            # straggler/slow_engine: injected seconds
    target: str = "ckpt"          # storage kinds: "ckpt" | "bundle"
    index: int = 0                # storage kinds: generation index, 0=newest

    def __post_init__(self):
        if self.kind not in ALL_FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"train {FAULT_KINDS}, serve {SERVE_FAULT_KINDS}, or "
                f"storage {STORAGE_FAULT_KINDS}")
        if self.kind in STORAGE_FAULT_KINDS and self.target not in (
                "ckpt", "bundle"):
            raise ValueError(
                f"storage fault target {self.target!r} must be 'ckpt' or "
                f"'bundle'")


class FaultInjector:
    """Deterministic chunk-granular fault schedule (consumed once)."""

    def __init__(self, faults: Iterable[Fault] = ()):
        self._due = sorted(faults, key=lambda f: f.chunk)
        self.fired: list[Fault] = []

    def take(self, chunk_idx: int) -> list[Fault]:
        """Faults due at this chunk launch; each fires exactly once."""
        due = [f for f in self._due if f.chunk == chunk_idx]
        if due:
            self._due = [f for f in self._due if f.chunk != chunk_idx]
            self.fired.extend(due)
        return due

    @property
    def exhausted(self) -> bool:
        return not self._due


def parse_faults(spec: str) -> list[Fault]:
    """Parse a CLI fault schedule: ``kind@chunk[:subdomain][*delay]`` items,
    comma-separated — e.g. ``crash@1,nan_params@2:0,straggler@3*0.2``, the
    serve-side ``engine-raise@2,slow-engine@5*0.1``, or the storage family
    ``bit-flip@2,bundle.truncate@3:1`` (``[target.]kind@chunk[:index]``;
    target defaults to ``ckpt``, ``:n`` is the generation index, 0=newest).
    Hyphens and underscores in kind names are interchangeable.

    Unknown kinds and malformed items raise a :class:`ValueError` that lists
    every allowed kind — a silent or cryptic parse here is a debugging trap
    in the middle of a chaos run."""
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        kind, at, rest = item.partition("@")
        kind = kind.replace("-", "_")
        target, dot, bare = kind.partition(".")
        if dot and target in ("ckpt", "bundle"):
            kind = bare
        else:
            target = "ckpt"
        if kind not in ALL_FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in {item!r}; allowed kinds: "
                f"train {FAULT_KINDS}, serve {SERVE_FAULT_KINDS}, "
                f"storage {STORAGE_FAULT_KINDS} "
                f"(syntax: [ckpt.|bundle.]kind@chunk[:subdomain|:index]"
                f"[*delay])")
        rest, _, delay = rest.partition("*")
        rest, _, sub = rest.partition(":")
        if not at or not rest.strip().lstrip("-").isdigit():
            raise ValueError(
                f"malformed fault item {item!r}: expected "
                f"[target.]kind@chunk[:subdomain][*delay] with an integer "
                f"chunk index")
        idx = int(sub) if sub else None
        out.append(Fault(chunk=int(rest), kind=kind,
                         subdomain=idx,
                         delay=float(delay) if delay else 0.25,
                         target=target,
                         index=idx if idx is not None else 0))
    return out


# -------------------------------------------------------------- serve-side


class FaultyEngine:
    """Wrap a serving engine with a deterministic dispatch-indexed fault
    schedule (the serve half of the fault matrix; kinds in
    SERVE_FAULT_KINDS).  Transparent otherwise: attribute access delegates
    to the wrapped engine, so frontends see bundle/counters as usual.

    ``compile_storm`` drops nothing here: the reference clears a cache of
    compiled programs keyed on query shape, but this port's
    :class:`~repro_torch.serve.engine.FieldEngine` keeps no per-shape state —
    its kernels are built once per source and launched at any shape, so
    there is nothing a new shape class would recompile.  The storm is still
    consumed and recorded in ``injector.fired``; it never rebuilds a kernel
    library.

    ``sleep`` is injectable so ``slow_engine`` can advance a virtual clock
    in benchmarks instead of really sleeping."""

    def __init__(self, engine, injector: FaultInjector, sleep=None):
        import time
        self.engine = engine
        self.injector = injector
        self._sleep = sleep if sleep is not None else time.sleep
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def evaluate(self, pts, order: int = 2) -> dict:
        idx = self.calls
        self.calls += 1
        due = self.injector.take(idx)
        for f in due:
            if f.kind == "slow_engine":
                self._sleep(f.delay)
            elif f.kind == "engine_raise":
                raise InjectedFailure(
                    f"injected engine_raise at dispatch {idx}")
        out = self.engine.evaluate(pts, order=order)
        for f in due:
            if f.kind == "nan_output":
                u = np.array(out["u"])  # stitched output: poison one CLAIMED
                finite = np.isfinite(u.reshape(len(u), -1)).all(axis=1)
                row = int(np.argmax(finite)) if finite.any() else 0
                u[row] = np.nan
                out = dict(out, u=u)
        return out


def inject_nan(tree: dict, kind: str, subdomain: int | None = None) -> dict:
    """NaN corruption of a state tree (``{"params", "opt", ...}``).

    ``nan_params`` poisons the first parameter leaf; ``nan_grads`` poisons
    the first Adam first-moment leaf (the next update turns the params
    non-finite, which the on-device guard's param check catches even though
    the loss it just computed was finite).  With ``subdomain`` set, only that
    slice of the stacked leading axis is poisoned, so guard attribution is
    testable.  "First" is in the reference's flatten order (dict keys
    sorted).  The leaf is cloned on its own device and written there: no
    host round trip."""
    if kind not in ("nan_params", "nan_grads"):
        raise ValueError(f"inject_nan: not a NaN fault: {kind!r}")
    target = tree["params"] if kind == "nan_params" else tree["opt"]["m"]
    leaves = tree_leaves(target)
    x = leaves[0].clone(memory_format=torch.contiguous_format)
    if subdomain is not None and x.dim() >= 1 and subdomain < x.shape[0]:
        x[(subdomain,) + (0,) * (x.dim() - 1)] = float("nan")
    else:
        x.view(-1)[0] = float("nan")
    poisoned = tree_unflatten(target, [x] + leaves[1:])
    out = dict(tree)
    if kind == "nan_params":
        out["params"] = poisoned
    else:
        out["opt"] = dict(tree["opt"])
        out["opt"]["m"] = poisoned
    return out
