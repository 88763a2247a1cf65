"""JSONL event sink with a per-run manifest and a validatable schema.

Every training/serving run can append structured events to one ``.jsonl``
file: the first line is a ``manifest`` event identifying the run (run id,
schema version, torch version/backend, free-form config), every following line
is a timestamped event of a REGISTERED kind.  The schema is deliberately
strict — unknown kinds and missing/['wrongly typed'] required fields FAIL
validation — because the smoke suite treats a malformed event stream as a
broken build (``benchmarks/run.py --smoke`` validates the file it emits).

Event envelope::

    {"t": <seconds, registry clock>, "kind": "<registered kind>", ...fields}

Registered kinds (``EVENT_KINDS``): required field -> type predicate.  Extra
fields are allowed everywhere (forward compatibility); required fields are
not optional.  ``validate_events`` returns the manifest on success and raises
:class:`ObsSchemaError` with the offending line number otherwise.
"""
from __future__ import annotations

import json
import os
import uuid

_num = (int, float)

SCHEMA_VERSION = 1

# kind -> {required field: type-or-tuple}.  "t" is required on every
# non-manifest event by the envelope check, not listed per kind.
EVENT_KINDS: dict[str, dict] = {
    "manifest": {"run_id": str, "schema_version": int},
    "metrics": {"snapshot": dict},              # registry.snapshot() dump
    "chunk": {"step": int, "steps": int, "loss": _num, "walltime_s": _num},
    "guard_trip": {"chunk": int, "bad_subdomains": list, "good_steps": int},
    "crash": {"chunk": int},
    "rollback": {"step": int, "recovery_s": _num},
    "straggler": {"chunk": int, "delay_s": _num},
    "heartbeat": {"status": str},
    "serve_report": {"requests": int, "goodput": _num},
    "compile": {"backend_compiles": int, "traces": int},
    "bench": {"name": str, "value": _num},
    # durable-state integrity (EXPERIMENTS.md §Durability): a generation
    # failed verification / restore fell back past corrupt generations /
    # a watchdog bundle reload swapped (or refused to swap) the live bundle
    "corruption": {"target": str, "reason": str},
    "fallback": {"target": str, "depth": int},
    "bundle_swap": {"swapped": bool, "path": str},
}


class ObsSchemaError(ValueError):
    """An event line violates the JSONL schema (malformed JSON, missing
    manifest, unknown kind, or a missing/mistyped required field)."""


class EventLog:
    """Append-only JSONL writer.  One manifest line at open, one line per
    :meth:`emit`, flushed eagerly (a crashed run keeps every committed
    event).  ``clock`` stamps the ``t`` field — inject the registry clock so
    event times and metric timers share a timebase."""

    def __init__(self, path: str, clock, run_id: str | None = None,
                 config: dict | None = None):
        self.path = str(path)
        self._clock = clock
        self.run_id = run_id or uuid.uuid4().hex[:12]
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "w")
        manifest = {"kind": "manifest", "run_id": self.run_id,
                    "schema_version": SCHEMA_VERSION, "t": float(clock())}
        try:  # torch identity is part of the run identity, but obs must not
            import torch  # hard-require it (the registry/sink are pure python)
            manifest["torch_version"] = torch.__version__
            manifest["backend"] = ("cuda" if torch.cuda.is_available()
                                   else "cpu")
        except ImportError:
            pass
        if config:
            manifest["config"] = config
        self._write(manifest)

    def _write(self, obj: dict) -> None:
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()

    def emit(self, kind: str, **fields) -> None:
        if kind not in EVENT_KINDS:
            raise ObsSchemaError(f"unregistered event kind {kind!r}")
        self._write({"t": float(self._clock()), "kind": kind, **fields})

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path: str) -> list[dict]:
    """Parse a JSONL event file (no validation — see
    :func:`validate_events`)."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ObsSchemaError(f"{path}:{i}: malformed JSON: {e}") from e
    return out


def validate_events(path_or_events) -> dict:
    """Validate a JSONL event stream against the schema.

    Checks: first event is a ``manifest`` with the current schema version;
    every event is a dict with a registered ``kind``; every non-manifest
    event carries a numeric non-negative ``t``; every required field of its
    kind is present with the required type.  Returns the manifest dict.
    Raises :class:`ObsSchemaError` naming the first offending event.
    """
    events = (read_events(path_or_events)
              if isinstance(path_or_events, (str, os.PathLike))
              else list(path_or_events))
    if not events:
        raise ObsSchemaError("empty event stream (no manifest)")
    for i, ev in enumerate(events, 1):
        where = f"event {i}"
        if not isinstance(ev, dict):
            raise ObsSchemaError(f"{where}: not an object: {ev!r}")
        kind = ev.get("kind")
        if kind not in EVENT_KINDS:
            raise ObsSchemaError(f"{where}: unregistered kind {kind!r}")
        if i == 1:
            if kind != "manifest":
                raise ObsSchemaError(
                    f"{where}: first event must be 'manifest', got {kind!r}")
            if ev.get("schema_version") != SCHEMA_VERSION:
                raise ObsSchemaError(
                    f"{where}: schema_version {ev.get('schema_version')!r} "
                    f"!= {SCHEMA_VERSION}")
        elif kind == "manifest":
            raise ObsSchemaError(f"{where}: duplicate manifest")
        else:
            t = ev.get("t")
            if not isinstance(t, _num) or isinstance(t, bool) or t < 0:
                raise ObsSchemaError(f"{where} ({kind}): bad 't': {t!r}")
        check_fields(ev, EVENT_KINDS[kind], f"{where} ({kind})")
    return events[0]


def check_fields(obj: dict, spec: dict, where: str) -> None:
    """Typed required-field check shared by :func:`validate_events` and the
    bench-history validator (:mod:`repro.obs.trajectory`): every field in
    ``spec`` must be present in ``obj`` with the required type (bools never
    satisfy numeric specs); extra fields are always allowed."""
    for fld, typ in spec.items():
        v = obj.get(fld)
        if v is None or isinstance(v, bool) and typ is not bool \
                or not isinstance(v, typ):
            raise ObsSchemaError(
                f"{where}: field {fld!r} missing or not {typ}: {v!r}")
