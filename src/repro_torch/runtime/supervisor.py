"""Chunk-level training supervisor: guarded chunks, rollback, elastic restart.

Counterpart of the reference package's ``runtime/supervisor.py``.  The
paper's premise is long-running distributed DD-PINN jobs; at that scale
restarts are the common case.  This module is the control loop that sits
ABOVE the trainers' chunk loops — what a cluster job actually runs:

::

                      +--------------------------- retry (lr backoff) ---+
                      v                                                  |
    init/resume -> [run chunk (guarded)] ------------ guard trip --------+
         ^            | ok                            \\-- InjectedFailure
         |            v                                   (crash): restore,
         |         [checkpoint cadence + metadata]        retry at full lr
         |            |
         +- elastic --+   (n_old != n_new: nearest-centroid remap,
            restart        fresh moments, Adam count from metadata)

Design decisions:

* **Health lives on the device.**  ``trainer.run_chunk_guarded`` detects
  non-finite loss/params inside the chunk and freezes the carried state with
  ``torch.where`` — the supervisor reads one (n_sub,) verdict per chunk: one
  host synchronisation (``bool(health["ok"])``), none per step.
* **Crash vs divergence are different failures.**  A crash
  (:class:`~repro_torch.runtime.failures.InjectedFailure`, i.e. preemption)
  restores the last good checkpoint and retries AT FULL learning rate —
  replaying the identical chunk reproduces the uninterrupted trajectory
  bitwise (the kernels sum in fixed orders; the checkpoint round trip is
  float32-exact).  A guard trip is a NUMERICS failure: the retry applies
  per-subdomain learning-rate backoff to exactly the subdomains whose
  loss/params went non-finite.
* **Backoff rebuilds nothing.**  ``lr_scale`` is a plain (n_sub,) argument
  of the guarded chunk.
* **Rollback never trusts the disk.**  Every restore goes through
  :func:`repro_torch.checkpoint.integrity.verified_restore`: a corrupt
  latest checkpoint (bit rot, torn write, truncation, lost file) is
  quarantined — renamed, never deleted — and the walk falls back to the
  newest VERIFIED generation.  Corruption/fallback land in the report, the
  ``train.supervisor/*`` counters, and the JSONL event stream.
* **Elastic resume is metadata-driven.**  Every checkpoint carries the
  decomposition signature (n_sub + centroids), the restart/backoff state,
  and the Adam step count; :func:`elastic_resume` restores a checkpoint
  taken at ``n_old`` subdomains into a trainer built for ``n_new`` via
  nearest-centroid :func:`~repro_torch.runtime.elastic.remap_params`, with
  fresh moments and the preserved Adam count.  Checkpoints are the
  reference's layout, so either package resumes the other's.

Restored leaves go to ``trainer.device`` with the dtypes they were saved
with (float32 params and moments, int32 step and Adam count).

**One rank per subdomain** (``DistributedDDTrainer``, and
``DataParallelTrainer`` on several workers): every rank runs its own
Supervisor in lockstep.  Every decision is already collective — the health
verdict is agreed inside the guarded chunk and the fault schedule is the
same on every rank — so all ranks commit or roll back together.  A
checkpoint is the GLOBAL state (``trainer.gather_state``), written by rank
0 in the reference's layout, after which every rank waits at a barrier; a
rollback or resume reads that global checkpoint (rank 0 first, which
quarantines whatever is corrupt, then the others) and takes the rank's
slice (``trainer.shard_state``).  So a distributed run's checkpoint
resumes in ``ReferenceTrainer`` and the other way round.  A NaN fault on
subdomain q poisons only the rank that holds q
(``trainer.fault_target``).  Storage faults of a ``ChaosInjector`` act on
the shared disk: give them to rank 0's injector only.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.checkpoint import ckpt, integrity
from repro_torch.core.nets import map_tree
from repro_torch.core.trainer import TrainState, _fit_count
from repro_torch.obs import MetricsRegistry, Obs
from repro_torch.optim import adam as adam_lib
from repro_torch.runtime import elastic
from repro_torch.runtime.failures import (FaultInjector, InjectedFailure,
                                          inject_nan)


@dataclass(frozen=True)
class SupervisorConfig:
    chunk_steps: int = 100          # outer steps per guarded chunk
    ckpt_every_chunks: int = 1      # checkpoint cadence, in committed chunks
    keep: int = 3                   # keep-last-k checkpoints
    max_restarts: int = 8           # total rollback budget (crash + guard)
    lr_backoff: float = 0.5         # per-subdomain lr scale on a guard trip
    min_lr_scale: float = 1e-3      # give up backing off below this
    walltime_window: int = 16       # chunk walltimes kept in ckpt metadata


@dataclass
class SupervisorReport:
    chunks: int = 0                 # committed chunks
    restarts: int = 0               # rollbacks performed (crash + guard)
    crashes: int = 0                # InjectedFailure recoveries
    guard_trips: int = 0            # on-device guard recoveries
    stragglers: int = 0             # straggler faults absorbed
    corruptions: int = 0            # corrupt generations quarantined
    walltimes: list = field(default_factory=list)   # committed-chunk seconds
    recovery_s: list = field(default_factory=list)  # rollback->retried latency
    fallback_depths: list = field(default_factory=list)  # per-rollback depth
    events: list = field(default_factory=list)      # human-readable log

    def as_dict(self) -> dict:
        return {k: (list(v) if isinstance(v, list) else v)
                for k, v in self.__dict__.items()}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _as_tree(state) -> dict:
    """Trainer state -> checkpointable tree.  TrainState and a trainer's dict
    state share the {"params","opt","step"} layout, so supervisor
    checkpoints stay interchangeable with ``save_train_state`` /
    ``restore_train_state``."""
    if isinstance(state, dict):
        return state
    return {"params": state.params, "opt": state.opt, "step": state.step}


def _from_tree(tree: dict, like):
    if isinstance(like, dict):
        return tree
    return TrainState(params=tree["params"], opt=tree["opt"],
                      step=tree["step"])


def _to_device(tree, device):
    """Restored numpy leaves -> tensors on ``device``, dtypes as saved
    (an empty subtree, e.g. no error-feedback buffer, stays None)."""
    return map_tree(lambda a: None if a is None else
                    torch.as_tensor(np.asarray(a), device=device), tree)


def _global(trainer, state):
    """The global state of a trainer whose ranks each hold a slice
    (collective); a single-process trainer's state as it is."""
    gather = getattr(trainer, "gather_state", None)
    return state if gather is None else gather(state)


def _local(trainer, state):
    """This rank's slice of a global state (see :func:`_global`)."""
    shard = getattr(trainer, "shard_state", None)
    return state if shard is None else shard(state)


def _comm(trainer):
    """The trainer's process-group handle, or None in one process."""
    return getattr(trainer, "comm", None)


def _rank0_first(trainer, read):
    """``read()`` on rank 0, then (after a barrier) on the other ranks:
    rank 0's verified read quarantines a corrupt generation before the
    others look.  A barrier after keeps any rank from writing the next
    generation while another still reads."""
    comm = _comm(trainer)
    if comm is None:
        return read()
    out = read() if comm.rank == 0 else None
    comm.barrier()
    if comm.rank != 0:
        out = read()
    comm.barrier()
    return out


def _restored(tree: dict, like_tree: dict, device) -> dict:
    """Restored numpy leaves on ``device``, the Adam count in the
    template's shape."""
    tree = _to_device(tree, device)
    tree["opt"]["count"] = _fit_count(tree["opt"]["count"],
                                      like_tree["opt"]["count"])
    return tree


def _adam_count(tree: dict):
    c = _np(tree["opt"]["count"])
    return c.tolist() if c.ndim else int(c)


def decomp_signature(decomp) -> dict:
    """What elastic restart needs to survive in metadata: the subdomain
    count and centroids (nearest-centroid remap needs nothing else)."""
    return {
        "n_sub": decomp.n_sub,
        "family": type(decomp).__name__,
        "centroids": [[float(x) for x in decomp.centroid(q)]
                      for q in range(decomp.n_sub)],
    }


class Supervisor:
    """Drive a trainer's guarded chunks with rollback, backoff and
    checkpoints.

    ``trainer`` exposes ``run_chunk_guarded`` and ``device``; ``root`` is the
    checkpoint directory; ``injector`` is an optional chunk-granular
    :class:`FaultInjector`; ``decomp`` (optional) stamps the decomposition
    signature into checkpoint metadata so the run can restart elastically.

    Telemetry: ``obs`` plugs in a shared :class:`~repro_torch.obs.Obs` bundle
    — every walltime/recovery measurement goes through its injectable clock
    (so tests stub time instead of sleeping), the ``train.supervisor/*``
    counters mirror the :class:`SupervisorReport` ints, chunk walltimes and
    recovery latencies feed ``train.supervisor/{chunk_walltime_s,
    recovery_s}`` histograms, and chunk/crash/guard_trip/straggler/rollback
    events stream to the JSONL sink when one is attached.  ``sleep`` is the
    straggler-delay sleeper (stub it together with the clock).  Without
    ``obs`` the supervisor keeps a private registry.
    """

    def __init__(self, trainer, root: str,
                 cfg: SupervisorConfig = SupervisorConfig(),
                 injector: FaultInjector | None = None, decomp=None,
                 obs: Obs | None = None, sleep=time.sleep):
        self.trainer, self.root, self.cfg = trainer, str(root), cfg
        self.injector = injector or FaultInjector()
        self.decomp = decomp
        self.lr_scale: np.ndarray | None = None   # lazy: shape from health
        self.report = SupervisorReport()
        self._restarts = 0
        self.obs = obs if obs is not None else Obs(registry=MetricsRegistry())
        self._clock, self._sleep = self.obs.clock, sleep
        # thread the tracer down: each chunk attempt gets a root span, the
        # trainer's chunk span nests under it, and rollback/recovery land as
        # retrospective children — one trace_id per attempt, surfaced on
        # every JSONL event of that attempt
        self.tracer = self.obs.tracer
        if self.tracer is not None and getattr(trainer, "tracer", 1) is None:
            trainer.tracer = self.tracer
        reg = self.obs.registry
        self._counters = reg.group(
            "train.supervisor",
            ("chunks", "restarts", "crashes", "guard_trips", "stragglers",
             "corruptions"))
        self._h_wall = reg.histogram("train.supervisor/chunk_walltime_s")
        self._h_rec = reg.histogram("train.supervisor/recovery_s")

    def _bump(self, key: str) -> None:
        """One increment, two views: the registry counter and the
        :class:`SupervisorReport` int."""
        self._counters[key] += 1
        setattr(self.report, key, getattr(self.report, key) + 1)

    # ------------------------------------------------------------- checkpoint
    def _metadata(self, state_tree: dict) -> dict:
        return {"supervisor": {
            "restarts": self._restarts,
            "lr_scale": (None if self.lr_scale is None
                         else np.asarray(self.lr_scale).tolist()),
            "adam_count": _adam_count(state_tree),
            "chunk_walltimes":
                self.report.walltimes[-self.cfg.walltime_window:],
            "decomp": decomp_signature(self.decomp) if self.decomp else None,
        }}

    def _save(self, state) -> None:
        tree = _as_tree(_global(self.trainer, state))
        comm = _comm(self.trainer)
        if comm is None or comm.rank == 0:
            ckpt.save(self.root, int(_np(tree["step"])), tree,
                      metadata=self._metadata(tree), keep=self.cfg.keep)
        if comm is not None:
            comm.barrier()

    def _rollback(self, like) -> object:
        self._restarts += 1
        self._bump("restarts")
        if self._restarts > self.cfg.max_restarts:
            raise RuntimeError(
                f"supervisor: restart budget exhausted "
                f"({self.cfg.max_restarts}); last events: "
                f"{self.report.events[-4:]}")
        # verify-then-restore: a poisoned latest checkpoint (bit rot, torn
        # write, lost file) is quarantined and the walk falls back to the
        # newest VERIFIED generation instead of ending the run — corrupt
        # state never reaches the trainer
        tree, _, info = _rank0_first(
            self.trainer, lambda: integrity.verified_restore(
                self.root, _as_tree(like), on_event=self.obs.emit))
        for name, reason in info.quarantined:
            self._bump("corruptions")
            self.report.events.append(
                f"corrupt checkpoint quarantined: {reason}")
        if info.fallback_depth:
            self.report.events.append(
                f"generation fallback depth {info.fallback_depth} "
                f"-> step {info.step}")
        self.report.fallback_depths.append(info.fallback_depth)
        tree = _restored(tree, _as_tree(like), self.trainer.device)
        return _local(self.trainer, _from_tree(tree, like))

    # ---------------------------------------------------------------- backoff
    def _apply_backoff(self, health: dict) -> None:
        ok_sub = np.atleast_1d(_np(health["ok_sub"]))
        if self.lr_scale is None:
            self.lr_scale = np.ones(ok_sub.shape, np.float32)
        scale = np.where(ok_sub, 1.0, self.cfg.lr_backoff).astype(np.float32)
        self.lr_scale = self.lr_scale * scale
        if (self.lr_scale < self.cfg.min_lr_scale).any():
            raise RuntimeError(
                "supervisor: lr backoff hit the floor "
                f"({self.cfg.min_lr_scale}) without recovering — "
                f"lr_scale={self.lr_scale.tolist()}")

    def _lr_scale_arg(self):
        if self.lr_scale is None:
            return None
        ls = np.asarray(self.lr_scale, np.float32)
        # a scalar-shaped guard (one replicated model) takes a 1-vector
        return ls if ls.shape else ls.reshape(-1)

    def _recover(self, state, cause: str, span, tid: dict):
        """Roll back to the newest verified checkpoint; record the
        latency."""
        t_r = self._clock()
        state = self._rollback(state)
        rec = self._clock() - t_r
        self.report.recovery_s.append(rec)
        self._h_rec.record(rec)
        if span is not None:
            self.tracer.record("train.rollback", t_r, t_r + rec,
                               parent=span, cause=cause)
        done = int(_np(_as_tree(state)["step"]))
        self.obs.emit("rollback", step=done, recovery_s=rec, **tid)
        return state, done

    # -------------------------------------------------------------- main loop
    def run(self, state, batch, total_steps: int):
        """Train to ``total_steps``, surviving crashes and divergence.

        Returns ``(state, report)``.  ``state`` follows the trainer's own
        state type (rebind, never reuse the argument)."""
        cfg, tr = self.cfg, self.trainer
        done = int(_np(_as_tree(state)["step"]))
        if ckpt.latest_step(self.root) is None:
            self._save(state)   # the first rollback needs a target
        attempt = 0
        committed = 0
        while done < total_steps:
            n = min(cfg.chunk_steps, total_steps - done)
            faults = self.injector.take(attempt)
            attempt += 1
            t0 = self._clock()
            # one trace per chunk ATTEMPT: the chunk + fault/recovery hops
            # share its trace_id, which also rides every event emitted below
            span = (self.tracer.start_trace("train.chunk", lane="train",
                                            chunk=attempt - 1, steps=n)
                    if self.tracer is not None else None)
            tid = {"trace_id": span.trace_id} if span is not None else {}
            if span is not None:
                span.__enter__()    # active: the trainer's span nests under
            outcome = "committed"
            try:
                try:
                    for f in faults:
                        if f.kind == "straggler":
                            self._bump("stragglers")
                            self.report.events.append(
                                f"straggler +{f.delay:.2f}s at chunk "
                                f"{attempt - 1}")
                            self.obs.emit("straggler", chunk=attempt - 1,
                                          delay_s=float(f.delay), **tid)
                            if span is not None:
                                span.event("train.straggler",
                                           delay_s=float(f.delay))
                            self._sleep(f.delay)
                        elif f.kind in ("nan_params", "nan_grads"):
                            self.report.events.append(
                                f"{f.kind} injected at chunk {attempt - 1} "
                                f"(subdomain {f.subdomain})")
                            if span is not None:
                                span.event("train.fault", kind=f.kind,
                                           subdomain=f.subdomain)
                            owns = getattr(tr, "fault_target", None)
                            if owns is None or owns(f.subdomain):
                                state = _from_tree(
                                    inject_nan(_as_tree(state), f.kind,
                                               f.subdomain), state)
                    state, terms, health = tr.run_chunk_guarded(
                        state, batch, n, self._lr_scale_arg())
                    for f in faults:
                        if f.kind == "crash":
                            # mid-chunk preemption: the chunk computed but
                            # its progress dies before the checkpoint
                            raise InjectedFailure(
                                f"injected crash at chunk {attempt - 1}")
                except InjectedFailure as e:
                    outcome = "crash"
                    self._bump("crashes")
                    self.report.events.append(str(e))
                    self.obs.emit("crash", chunk=attempt - 1, **tid)
                    state, done = self._recover(state, "crash", span, tid)
                    continue
                # the chunk's one host synchronisation
                if not bool(health["ok"]):
                    outcome = "guard_trip"
                    bad = np.flatnonzero(~np.atleast_1d(_np(health["ok_sub"])))
                    good = int(health["good_steps"])
                    self._bump("guard_trips")
                    self.report.events.append(
                        f"guard trip at chunk {attempt - 1}: subdomains "
                        f"{bad.tolist()} non-finite after {good} steps — "
                        f"rolling back with lr backoff x{cfg.lr_backoff}")
                    self.obs.emit("guard_trip", chunk=attempt - 1,
                                  bad_subdomains=bad.tolist(),
                                  good_steps=good, **tid)
                    self._apply_backoff(health)
                    state, done = self._recover(state, "guard_trip", span,
                                                tid)
                    continue
                # committed
                done += n
                committed += 1
                self._bump("chunks")
                wall = self._clock() - t0
                self.report.walltimes.append(wall)
                self._h_wall.record(wall)
                if self.obs.events is not None:
                    # last committed step's mean loss
                    last = _np(terms["loss"])[-1]
                    self.obs.emit("chunk", step=done, steps=n,
                                  loss=float(np.nanmean(last)),
                                  walltime_s=float(wall), **tid)
                if committed % cfg.ckpt_every_chunks == 0 or \
                        done >= total_steps:
                    self._save(state)
            finally:
                if span is not None:
                    span.annotate(outcome=outcome)
                    span.__exit__(None, None, None)
        return state, self.report

    # ------------------------------------------------------------- rebalance
    def rebalance_counts(self, counts, per_sub_walltimes=None) -> list[int]:
        """Straggler-aware point counts for the next (re-)decomposition.

        With measured per-subdomain chunk walltimes the budget is
        reallocated proportionally to measured throughput — paper §7.6's
        idle-worker fix.  Without them, plain leveling."""
        counts = [int(c) for c in counts]
        if per_sub_walltimes is None:
            return elastic.balanced_counts(counts)
        return elastic.balanced_counts(
            counts, elastic.throughput_weights(counts, per_sub_walltimes))


# ------------------------------------------------------------ elastic resume

def elastic_resume(root: str, trainer, decomp, state=None):
    """Restore the latest supervisor checkpoint into ``trainer`` — which may
    be decomposed into a DIFFERENT number of subdomains than the checkpoint.

    Same ``n_sub`` (centroids immaterial): plain bitwise restore.  Different
    ``n_sub``: nearest-centroid :func:`~repro_torch.runtime.elastic.remap_params`
    from the checkpoint metadata's centroid signature (on
    ``trainer.device``), optimizer moments reset, the Adam step count and
    the global step preserved via metadata (so bias correction and lr
    schedules continue instead of restarting cold).

    A trainer whose ranks each hold a slice (``DistributedDDTrainer``)
    resumes the global checkpoint on every rank and keeps its slice.

    Returns ``(state, metadata)``.  ``state`` template defaults to
    ``trainer.init(0)``."""
    like = state if state is not None else trainer.init(0)
    state, meta = _elastic_global(root, trainer, decomp, like)
    return _local(trainer, state), meta


def _elastic_global(root, trainer, decomp, like):
    """:func:`elastic_resume`'s global state (before a rank takes its
    slice)."""
    like_tree = _as_tree(like)
    dev = trainer.device
    # verify first: elastic restarts read whatever generation survived the
    # outage, so the walk quarantines corrupt ones and pins ONE verified step
    # for both reads below
    _, manifest, info = _rank0_first(
        trainer, lambda: integrity.verified_raw_leaves(root))
    meta = manifest["metadata"]
    sup = meta.get("supervisor", {})
    sig = sup.get("decomp")
    n_new = decomp.n_sub

    # paths are shape-agnostic, so restore hands back the checkpoint's own
    # stacked leaves whatever n_sub the template has
    old_tree, _ = ckpt.restore(root, like_tree, step=info.step)
    if sig is None or int(sig["n_sub"]) == n_new:
        return _from_tree(_restored(old_tree, like_tree, dev), like), meta

    old_spec = elastic.CentroidSpec(sig["centroids"])
    new_params, src = elastic.remap_params(
        _to_device(old_tree["params"], dev), old_spec, decomp)
    opt = adam_lib.init_adam(new_params)
    # Adam step count preserved via metadata (per remapped subdomain when the
    # trainer keeps a stacked count vector)
    count = np.asarray(sup.get("adam_count", old_tree["opt"]["count"]))
    if _np(like_tree["opt"]["count"]).ndim == 1:
        count = count[src] if count.ndim == 1 else np.full(n_new, count)
        opt["count"] = torch.as_tensor(count.astype(np.int32), device=dev)
    else:
        opt["count"] = torch.as_tensor(
            np.int32(count.max() if count.ndim else count), device=dev)
    tree = {"params": new_params, "opt": opt,
            "step": torch.as_tensor(np.asarray(old_tree["step"]),
                                    device=dev)}
    return _from_tree(tree, like), meta
