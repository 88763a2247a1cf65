"""Perf-trajectory store + drift-robust regression gate.

Counterpart of the reference package's ``obs/trajectory.py``, copied
without JAX and without torch: a benchmark's run appends one validated
record to an append-only history file (keyed on git SHA + bench id +
smoke/full mode) at the path its caller gives (there is no default: the
port's benchmark keeps its own history, never the reference's), and
:func:`detect_regressions` compares a fresh run against the trailing
history so a benchmark's smoke run can FAIL when a headline metric got
worse (:func:`gate`).

The detector is **drift-robust**: container CPU-quota wobble moves *every*
metric by a common factor run-to-run, and a naive per-metric threshold either
fires on that noise or is too loose to catch real regressions.  So each
metric's ratio vs its trailing median is divided by the *median ratio across
all metrics of the run* (the common-mode drift estimate — the same
paired-ratio philosophy as ``fig4_cost_profile``, applied across the history
axis): a global 30% slow day cancels out; one benchmark doubling while its
peers hold still does not.  Gating needs ``min_runs`` prior records for a
metric (a cold history never blocks) and only metrics whose UNIT names a
direction are gated — times are lower-better, rates higher-better,
dimensionless counts are informational and skipped.

Record line::

    {"t": ..., "sha": "...", "bench": "...", "mode": "smoke"|"full",
     "rows": [{"name": ..., "value": ..., "unit": ...}, ...]}

validated with the same typed required-field machinery as the obs event
schema (:func:`repro_torch.obs.events.check_fields`) — minus the
manifest-first rule, which an append-only multi-run file cannot satisfy.
Smoke and full runs never share baselines (``mode`` keys the comparison):
a 3-iter smoke value is not evidence about a 10-iter full value.
"""
from __future__ import annotations

import json
import os
import subprocess
import time

from repro_torch.obs.events import ObsSchemaError, check_fields

_num = (int, float)

RECORD_FIELDS: dict = {"t": _num, "sha": str, "bench": str, "mode": str,
                       "rows": list}
ROW_FIELDS: dict = {"name": str, "value": _num, "unit": str}

# unit -> gate direction; anything unlisted is recorded but never gated
LOWER_BETTER = {"s", "ms", "us", "ns"}
HIGHER_BETTER = {"pts/s", "it/s", "steps/s", "req/s", "x", "GB/s",
                 "GFLOP/s", "flops/s"}

DEFAULT_THRESHOLD = 1.5    # drift-adjusted ratio that trips the gate
DEFAULT_MIN_RUNS = 3       # trailing records needed before a metric gates
DEFAULT_WINDOW = 8         # trailing records the baseline median sees


def git_sha(repo: str | None = None) -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=repo, capture_output=True, text=True,
                             timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except Exception:
        return "unknown"


# ------------------------------------------------------------------- storage

def validate_record(rec, where: str = "record") -> None:
    if not isinstance(rec, dict):
        raise ObsSchemaError(f"{where}: not an object: {rec!r}")
    check_fields(rec, RECORD_FIELDS, where)
    if rec["mode"] not in ("smoke", "full"):
        raise ObsSchemaError(f"{where}: mode {rec['mode']!r} not "
                             f"smoke|full")
    for j, row in enumerate(rec["rows"]):
        if not isinstance(row, dict):
            raise ObsSchemaError(f"{where}.rows[{j}]: not an object")
        check_fields(row, ROW_FIELDS, f"{where}.rows[{j}]")


def read_history(path: str) -> list[dict]:
    """Parse + validate the history file (missing file -> empty history)."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ObsSchemaError(
                    f"{path}:{i}: malformed JSON: {e}") from e
            validate_record(rec, f"{path}:{i}")
            out.append(rec)
    return out


def _as_rows(rows) -> list[dict]:
    """Accept benchmark ``(name, value, unit)`` tuples or row dicts."""
    out = []
    for r in rows:
        if isinstance(r, dict):
            out.append({"name": r["name"], "value": r["value"],
                        "unit": r.get("unit", "")})
        else:
            name, value, unit = r
            out.append({"name": str(name), "value": value, "unit": str(unit)})
    # gate arithmetic needs numbers; drop string-valued rows (e.g. labels)
    return [r for r in out if isinstance(r["value"], _num)
            and not isinstance(r["value"], bool)]


def append_record(path: str, bench: str, rows, mode: str,
                  sha: str | None = None, clock=time.time,
                  **extra) -> dict:
    """Validate and append one run record; returns the record."""
    rec = {"t": float(clock()), "sha": sha or git_sha(),
           "bench": str(bench), "mode": str(mode),
           "rows": _as_rows(rows), **extra}
    validate_record(rec)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return rec


# ------------------------------------------------------------------ detection

def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def detect_regressions(history: list[dict], rows, mode: str,
                       threshold: float = DEFAULT_THRESHOLD,
                       min_runs: int = DEFAULT_MIN_RUNS,
                       window: int = DEFAULT_WINDOW) -> dict:
    """Compare a fresh run's ``rows`` against trailing same-mode history.

    Per gateable metric: ``raw = value / trailing-median`` oriented so >1 is
    WORSE (rates inverted).  Each metric's common-mode drift estimate is the
    median of the OTHER metrics' raw ratios (leave-one-out, so a metric's
    own regression cannot launder itself into "drift"), clamped to [0.5, 2]
    (quota wobble is modest; a x3 "drift" is a real problem);
    ``adjusted = raw / drift`` trips the gate when it exceeds ``threshold``.
    Returns a report dict whose ``regressions`` list is empty on a pass::

        {"checked": N, "gated": M, "drift": d,
         "regressions": [{name, value, baseline, raw_ratio,
                          adjusted_ratio, unit, n_baseline}, ...]}
    """
    rows = _as_rows(rows)
    base: dict[str, list] = {}
    for rec in history:
        if rec["mode"] != mode:
            continue
        for row in rec["rows"]:
            base.setdefault(row["name"], []).append(row["value"])

    ratios = []
    for row in rows:
        unit, v = row["unit"], row["value"]
        if unit in LOWER_BETTER:
            worse_up = True
        elif unit in HIGHER_BETTER:
            worse_up = False
        else:
            continue
        hist = base.get(row["name"], [])[-window:]
        if len(hist) < min_runs:
            continue
        b = _median(hist)
        if b == 0 or v == 0:
            continue
        raw = (v / b) if worse_up else (b / v)
        ratios.append({"name": row["name"], "value": v, "baseline": b,
                       "unit": unit, "raw_ratio": raw,
                       "n_baseline": len(hist)})

    overall = _median([r["raw_ratio"] for r in ratios]) if ratios else 1.0
    regressions = []
    for i, r in enumerate(ratios):
        others = [x["raw_ratio"] for j, x in enumerate(ratios) if j != i]
        drift = min(2.0, max(0.5, _median(others))) if others else 1.0
        adj = r["raw_ratio"] / drift
        if adj > threshold:
            regressions.append({**r, "raw_ratio": round(r["raw_ratio"], 4),
                                "adjusted_ratio": round(adj, 4),
                                "drift": round(drift, 4),
                                "baseline": round(r["baseline"], 6)})
    return {"checked": len(rows), "gated": len(ratios),
            "drift": round(overall, 4), "regressions": regressions}


class PerfRegressionError(AssertionError):
    """The regression gate tripped; ``report`` carries the full detail."""

    def __init__(self, report: dict, bench: str):
        self.report = report
        lines = [f"perf regression gate tripped for {bench!r} "
                 f"(common-mode drift x{report['drift']}):"]
        for r in report["regressions"]:
            lines.append(
                f"  {r['name']}: {r['value']} {r['unit']} vs trailing "
                f"median {r['baseline']} — x{r['adjusted_ratio']} "
                f"drift-adjusted (raw x{r['raw_ratio']}, "
                f"n={r['n_baseline']})")
        super().__init__("\n".join(lines))


def gate(path: str, bench: str, rows, mode: str,
         threshold: float = DEFAULT_THRESHOLD,
         min_runs: int = DEFAULT_MIN_RUNS, window: int = DEFAULT_WINDOW,
         sha: str | None = None, clock=time.time) -> dict:
    """A benchmark's smoke-run entry point: check ``rows`` against trailing
    history, RAISE :class:`PerfRegressionError` on a trip (without recording
    the bad run — a regressed record would poison its own baseline), append
    the record on a pass.  Returns the detection report with ``recorded``
    set."""
    history = read_history(path)
    report = detect_regressions(history, rows, mode, threshold=threshold,
                                min_runs=min_runs, window=window)
    report["bench"], report["mode"] = bench, mode
    if report["regressions"]:
        raise PerfRegressionError(report, bench)
    append_record(path, bench, rows, mode, sha=sha, clock=clock)
    report["recorded"] = True
    report["history_runs"] = len(history) + 1
    return report
