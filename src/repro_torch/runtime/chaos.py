"""Deterministic seeded chaos: storage faults composed with the fault matrices.

Counterpart of the reference package's ``runtime/chaos.py`` (numpy and the
filesystem only, over this package's checkpoint layout, which is the
reference's).  :mod:`repro_torch.runtime.failures` covers compute-side
failures (crashes, NaNs, stragglers, engine faults); this module adds the
STORAGE fault family — corruption of durable state on disk — and a scheduler
that composes all three families into one deterministic schedule, so a
scripted train→crash→restore→export→serve→reload soak can replay bit rot,
torn writes, truncation and lost files against the exact checkpoint/bundle
generations the recovery paths will read next.

Everything is seeded: fault offsets and truncation points come from one
``numpy`` Generator, so a failing soak reproduces byte-for-byte.

* :func:`corrupt_generation` — apply one storage fault
  (:data:`~repro_torch.runtime.failures.STORAGE_FAULT_KINDS`) to the
  ``index``-th newest generation of a checkpoint/bundle root;
* :class:`ChaosInjector` — a
  :class:`~repro_torch.runtime.failures.FaultInjector` that additionally fires storage faults as filesystem side effects when
  their chunk/dispatch index comes due and hands only the compute faults to
  the caller — the supervisor and ``FaultyEngine`` consume it unmodified, so
  the storage family composes with the existing train-chunk and serve
  matrices without touching either;
* :func:`compose` — merge fault schedules from several families into one.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.runtime.failures import (Fault, FaultInjector,
                                          STORAGE_FAULT_KINDS)


def _generation_dir(root: str, index: int) -> str:
    """Path of the ``index``-th newest readable generation (0 = newest)."""
    from repro_torch.checkpoint import integrity

    gens = integrity.generations(root)
    if index >= len(gens):
        raise IndexError(
            f"generation index {index} out of range: {root} has "
            f"{len(gens)} generation(s)")
    return os.path.join(root, gens[index][1])


def corrupt_file(path: str, kind: str, rng: np.random.Generator) -> dict:
    """Apply one storage fault to one file; returns what was done (for the
    soak's injection log).  Offsets/fractions are drawn from ``rng`` so a
    seeded schedule reproduces exactly."""
    size = os.path.getsize(path)
    if kind == "missing_file":
        os.remove(path)
        return {"kind": kind, "path": path}
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path}")
    if kind == "bit_flip":
        off = int(rng.integers(size))
        bit = int(rng.integers(8))
        with open(path, "r+b") as f:
            f.seek(off)
            byte = f.read(1)[0]
            f.seek(off)
            f.write(bytes([byte ^ (1 << bit)]))
        return {"kind": kind, "path": path, "offset": off, "bit": bit}
    if kind == "truncate":
        keep = int(size * float(rng.uniform(0.25, 0.75)))
        os.truncate(path, keep)
        return {"kind": kind, "path": path, "kept": keep, "of": size}
    if kind == "torn_write":
        # power loss mid-write: a prefix of real data, the tail zero pages
        keep = int(size * float(rng.uniform(0.25, 0.75)))
        with open(path, "r+b") as f:
            f.seek(keep)
            f.write(b"\0" * (size - keep))
        return {"kind": kind, "path": path, "torn_at": keep, "of": size}
    raise ValueError(f"unknown storage fault kind {kind!r}; expected one of "
                     f"{STORAGE_FAULT_KINDS}")


def corrupt_generation(root: str, kind: str, index: int = 0,
                       rng: np.random.Generator | None = None,
                       file: str | None = None) -> dict:
    """Corrupt one file of the ``index``-th newest generation under ``root``.

    ``file`` defaults to ``arrays.npz`` (the bulk payload, where real bit rot
    lands); pass ``"manifest.json"`` to attack the metadata side instead.
    Returns the injection record."""
    rng = rng if rng is not None else np.random.default_rng(0)
    d = _generation_dir(root, index)
    rec = corrupt_file(os.path.join(d, file or "arrays.npz"), kind, rng)
    return {**rec, "generation": os.path.basename(d), "index": index}


class ChaosInjector(FaultInjector):
    """Fault schedule spanning compute AND storage families.

    Drop-in for :class:`~repro_torch.runtime.failures.FaultInjector`
    anywhere one is consumed (``Supervisor``, ``FaultyEngine``): :meth:`take`
    applies any
    storage faults due at this launch/dispatch index to their target root
    (``roots["ckpt"]`` / ``roots["bundle"]``) as filesystem side effects,
    records them in ``storage_fired``, and returns only the compute faults —
    the consumer never needs to know the storage family exists.  A storage
    fault whose target has no generation yet (e.g. before the first save) is
    deferred to the next launch rather than lost."""

    def __init__(self, faults=(), roots: dict | None = None, seed: int = 0):
        super().__init__(faults)
        self.roots = dict(roots or {})
        self._rng = np.random.default_rng(seed)
        self.storage_fired: list[dict] = []

    def take(self, chunk_idx: int) -> list[Fault]:
        due = super().take(chunk_idx)
        out = []
        for f in due:
            if f.kind not in STORAGE_FAULT_KINDS:
                out.append(f)
                continue
            root = self.roots.get(f.target)
            if root is None:
                raise ValueError(
                    f"storage fault {f.kind}@{f.chunk} targets "
                    f"{f.target!r} but ChaosInjector has no root for it "
                    f"(roots={sorted(self.roots)})")
            try:
                rec = corrupt_generation(root, f.kind, f.index, self._rng)
            except IndexError:
                # nothing durable to corrupt yet: re-arm for the next launch
                self.fired.remove(f)
                self._due.append(Fault(chunk=chunk_idx + 1, kind=f.kind,
                                       target=f.target, index=f.index))
                self._due.sort(key=lambda x: x.chunk)
                continue
            self.storage_fired.append({**rec, "target": f.target,
                                       "chunk": chunk_idx})
        return out


def compose(*schedules) -> list[Fault]:
    """Merge fault schedules (lists of :class:`Fault`) from any mix of the
    train / serve / storage families into one, ordered by launch index."""
    out: list[Fault] = []
    for s in schedules:
        out.extend(s)
    return sorted(out, key=lambda f: f.chunk)
