"""Chrome-trace / Perfetto export: span trees -> an openable timeline file.

Converts :mod:`repro_torch.obs.tracing` spans into the Chrome trace-event JSON
format (the ``traceEvents`` array understood by ``chrome://tracing`` and
https://ui.perfetto.dev — drag the file in, or Perfetto's "Open trace").
Three layers:

* :func:`to_chrome` — spans (+ optional flow arrows) -> the trace document.
  Lanes become named "threads"; within a lane, concurrent traces are packed
  into parallel sub-tracks (waterfall layout) so the strict B/E begin/end
  nesting the format requires always holds; flow arrows (``ph: s/f``) draw
  the halo-exchange arcs between neighbor subdomain lanes;
* :func:`halo_flow_events` / :func:`training_timeline` — synthesize the
  per-subdomain lanes and neighbor halo arrows for a training trace from
  the chunk spans, the decomposition's neighbor table, and (optionally) the
  analytic byte counts of :func:`repro.obs.profiling.halo_traffic` (reference package).  The
  compiled chunk is ONE fused dispatch — XLA does not emit per-subdomain
  host timings — so these lanes are an analytic rendering: real chunk wall
  times, topology-true arrows, byte-true weights;
* :func:`validate_chrome_trace` — the structural contract the smoke suite
  and tests enforce: well-formed events, non-decreasing timestamps, every
  B matched by an E (per thread, stack-ordered), every flow start matched
  by a flow finish.  A trace that Perfetto would render wrong FAILS here.

Timestamps are rebased to the earliest span and expressed in microseconds,
as the format requires.
"""
from __future__ import annotations

import json
import os


def _as_dict(span) -> dict:
    """Normalize a tracing.Span or a plain dict to the exporter's record."""
    if isinstance(span, dict):
        d = dict(span)
        d.setdefault("lane", None)
        d.setdefault("attrs", {})
        d.setdefault("trace_id", "t0")
        d.setdefault("parent_id", None)
        d.setdefault("span_id", id(span))
        return d
    return {"name": span.name, "lane": span.lane, "t0": span.t0,
            "t1": span.t1 if span.t1 is not None else span.t0,
            "trace_id": span.trace_id, "span_id": span.span_id,
            "parent_id": span.parent_id, "attrs": dict(span.attrs)}


def _pack_slots(extents: list[tuple[str, float, float]]) -> dict[str, int]:
    """Greedy waterfall: assign each trace (keyed by id, with [t0, t1]
    extent) the first slot whose previous occupant has ended."""
    slot_end: list[float] = []
    out: dict[str, int] = {}
    for key, t0, t1 in sorted(extents, key=lambda e: (e[1], e[2])):
        for i, end in enumerate(slot_end):
            if end <= t0:
                out[key], slot_end[i] = i, t1
                break
        else:
            out[key] = len(slot_end)
            slot_end.append(t1)
    return out


def _emit_tree(spans: list[dict], ts, out: list[dict], pid: int,
               tid: int) -> None:
    """Emit B/E pairs for one laminar family (one trace on one lane), DFS
    order, clamping children into parents and serializing overlapping
    siblings so the stack discipline the format requires always holds."""
    by_parent: dict = {}
    ids = {s["span_id"] for s in spans}
    for s in spans:
        pk = s["parent_id"] if s["parent_id"] in ids else None
        by_parent.setdefault(pk, []).append(s)

    def walk(parent_key, lo, hi):
        cursor = lo
        for s in sorted(by_parent.get(parent_key, []),
                        key=lambda x: (x["t0"], x["span_id"])):
            t0 = min(max(s["t0"], cursor), hi)
            t1 = min(max(s["t1"], t0), hi)
            args = {"trace_id": s["trace_id"], **s["attrs"]}
            if s["attrs"].get("instant"):
                out.append({"ph": "i", "s": "t", "name": s["name"],
                            "pid": pid, "tid": tid, "ts": ts(t0),
                            "args": args})
            else:
                out.append({"ph": "B", "name": s["name"], "pid": pid,
                            "tid": tid, "ts": ts(t0), "args": args})
                walk(s["span_id"], t0, t1)
                out.append({"ph": "E", "name": s["name"], "pid": pid,
                            "tid": tid, "ts": ts(t1)})
            cursor = max(cursor, t1)

    lo = min(s["t0"] for s in spans)
    hi = max(s["t1"] for s in spans)
    walk(None, lo, hi)


def to_chrome(spans, flows=(), process_name: str = "repro") -> dict:
    """Build a Chrome trace document from spans and optional flow arrows.

    ``spans``: tracing.Span objects or dicts with at least
    ``{name, lane, t0, t1}``.  ``flows``: dicts
    ``{name, id?, src, dst, t_src, t_dst, ...attrs}`` where src/dst are lane
    names — rendered as Perfetto flow arcs between the lanes.
    """
    recs = [_as_dict(s) for s in spans]
    if not recs:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    origin = min(r["t0"] for r in recs)
    ts = lambda t: round((t - origin) * 1e6, 3)  # noqa: E731 — us, rebased

    # lane -> trace groups -> waterfall slots (tid per lane-slot)
    lanes: dict[str, dict[str, list[dict]]] = {}
    for r in recs:
        lane = r["lane"] or "main"
        lanes.setdefault(lane, {}).setdefault(r["trace_id"], []).append(r)

    events: list[dict] = []
    tid_of: dict[tuple[str, int], int] = {}
    pid = 1
    for lane in sorted(lanes):
        groups = lanes[lane]
        extents = [(tr, min(s["t0"] for s in ss),
                    max(s["t1"] for s in ss)) for tr, ss in groups.items()]
        slots = _pack_slots(extents)
        for tr in sorted(groups, key=lambda tr: slots[tr]):
            tid_of.setdefault((lane, slots[tr]), len(tid_of) + 1)
    body: list[dict] = []
    for lane in sorted(lanes):
        groups = lanes[lane]
        extents = [(tr, min(s["t0"] for s in ss),
                    max(s["t1"] for s in ss)) for tr, ss in groups.items()]
        slots = _pack_slots(extents)
        for tr, ss in groups.items():
            _emit_tree(ss, ts, body, pid, tid_of[(lane, slots[tr])])

    flow_evs: list[dict] = []
    for i, fl in enumerate(flows):
        src_tid = tid_of.get((fl["src"], 0))
        dst_tid = tid_of.get((fl["dst"], 0))
        if src_tid is None or dst_tid is None:
            continue  # flow references a lane with no spans — undrawable
        fid = int(fl.get("id", i + 1))
        args = {k: v for k, v in fl.items()
                if k not in ("name", "id", "src", "dst", "t_src", "t_dst")}
        flow_evs.append({"ph": "s", "cat": "halo", "name": fl["name"],
                         "id": fid, "pid": pid, "tid": src_tid,
                         "ts": ts(fl["t_src"]), "args": args})
        flow_evs.append({"ph": "f", "bp": "e", "cat": "halo",
                         "name": fl["name"], "id": fid, "pid": pid,
                         "tid": dst_tid,
                         "ts": ts(max(fl["t_dst"], fl["t_src"])),
                         "args": args})

    body.extend(flow_evs)
    body.sort(key=lambda e: e["ts"])  # stable: per-tid emit order survives

    meta = [{"ph": "M", "name": "process_name", "pid": pid, "ts": 0,
             "args": {"name": process_name}}]
    for (lane, slot), tid in sorted(tid_of.items(), key=lambda kv: kv[1]):
        label = lane if slot == 0 else f"{lane}#{slot + 1}"
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "ts": 0, "args": {"name": label}})
    return {"traceEvents": meta + body, "displayTimeUnit": "ms"}


# ------------------------------------------------- training-timeline synthesis

def halo_flow_events(pairs, t0: float, t1: float, total_bytes: int = 0,
                     rounds: int = 1, name: str = "dd-comm-halo") -> list[dict]:
    """Flow arrows for the directed neighbor ``pairs`` [(src, dst), ...]
    across ``rounds`` evenly spaced exchange instants inside [t0, t1],
    splitting ``total_bytes`` (e.g. the ``collective_permute_bytes`` of the
    analytic HLO parse) evenly across arrows."""
    pairs = [tuple(p) for p in pairs]
    if not pairs or t1 <= t0:
        return []
    n = len(pairs) * max(1, rounds)
    per = int(total_bytes // n) if total_bytes else 0
    dt = (t1 - t0) / (max(1, rounds) + 1)
    hop = min(dt * 0.25, (t1 - t0) * 0.02)
    out, fid = [], 0
    for r in range(max(1, rounds)):
        t = t0 + (r + 1) * dt
        for (src, dst) in pairs:
            fid += 1
            out.append({"name": name, "id": fid, "src": f"sub{src}",
                        "dst": f"sub{dst}", "t_src": t, "t_dst": t + hop,
                        "bytes": per})
    return out


def training_timeline(chunk_spans, topo, halo: dict | None = None,
                      rounds_per_chunk: int = 1):
    """Per-subdomain lanes + halo arrows for a supervised training trace.

    ``chunk_spans``: committed chunk-level spans (one per supervisor chunk or
    run_chunk dispatch).  ``topo``: a ``core.domain.Topology`` (its
    ``neighbor`` table gives the directed edges).  ``halo``: the dict from
    :func:`repro.obs.profiling.halo_traffic` (reference package) on the lowered chunk HLO, used
    to weight the arrows with real byte counts (0 when absent, e.g. the
    reference trainer whose gather is not a collective).

    Returns ``(lane_spans, flows)`` to pass to :func:`to_chrome` alongside
    the host-side spans.
    """
    import numpy as np

    nb = np.asarray(topo.neighbor)
    n_sub = nb.shape[0]
    pairs = [(i, int(j)) for i in range(n_sub) for j in nb[i] if j >= 0]
    total_bytes = int((halo or {}).get("collective_permute_bytes", 0))

    lane_spans: list[dict] = []
    flows: list[dict] = []
    for k, sp in enumerate(chunk_spans):
        d = _as_dict(sp)
        t0, t1 = d["t0"], d["t1"]
        for i in range(n_sub):
            lane_spans.append({
                "name": d["name"], "lane": f"sub{i}", "t0": t0, "t1": t1,
                "trace_id": d["trace_id"], "span_id": f"sub{i}.{k}",
                "parent_id": None,
                "attrs": {"subdomain": i, **d["attrs"]}})
        flows.extend(halo_flow_events(pairs, t0, t1, total_bytes,
                                      rounds=rounds_per_chunk))
    return lane_spans, flows


# ----------------------------------------------------------------- validation

class ChromeTraceError(ValueError):
    """The document violates the Chrome trace-event structural contract."""


def validate_chrome_trace(doc) -> dict:
    """Structural validation: the contract ``run.py --smoke`` and the tests
    enforce on every exported trace.

    Checks: a ``traceEvents`` list of well-formed events (``ph``/``pid``/
    ``tid``/``name``, numeric non-negative ``ts``); timestamps non-decreasing
    in file order (metadata aside); per-thread B/E stack discipline with
    name-matched pairs and nothing left open; every flow start (``s``)
    finished (``f``) at a later-or-equal ts.  Returns a summary dict.
    """
    if isinstance(doc, str):
        with open(doc) as f:
            doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"),
                                                   list):
        raise ChromeTraceError("no traceEvents array")
    evs = doc["traceEvents"]
    if not evs:
        raise ChromeTraceError("empty traceEvents")

    stacks: dict = {}
    flows_open: dict = {}
    last_ts = None
    counts = {"B": 0, "E": 0, "i": 0, "s": 0, "f": 0, "M": 0}
    tids = set()
    for i, ev in enumerate(evs):
        where = f"event {i}"
        if not isinstance(ev, dict):
            raise ChromeTraceError(f"{where}: not an object")
        ph = ev.get("ph")
        if ph not in counts:
            raise ChromeTraceError(f"{where}: unknown ph {ph!r}")
        counts[ph] += 1
        if not isinstance(ev.get("name"), str) or \
                not isinstance(ev.get("pid"), int):
            raise ChromeTraceError(f"{where}: missing name/pid")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ChromeTraceError(f"{where}: bad ts {ts!r}")
        if last_ts is not None and ts < last_ts:
            raise ChromeTraceError(
                f"{where}: ts {ts} < previous {last_ts} — not sorted")
        last_ts = ts
        tid = ev.get("tid")
        if not isinstance(tid, int):
            raise ChromeTraceError(f"{where}: bad tid {tid!r}")
        tids.add((ev["pid"], tid))
        key = (ev["pid"], tid)
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            st = stacks.get(key)
            if not st:
                raise ChromeTraceError(f"{where}: E with empty stack on "
                                       f"pid/tid {key}")
            top = st.pop()
            if top != ev["name"]:
                raise ChromeTraceError(
                    f"{where}: E {ev['name']!r} does not match open B "
                    f"{top!r} on pid/tid {key}")
        elif ph == "s":
            flows_open[ev.get("id")] = ts
        elif ph == "f":
            fid = ev.get("id")
            if fid not in flows_open:
                raise ChromeTraceError(f"{where}: flow finish {fid!r} with "
                                       f"no start")
            if ts < flows_open.pop(fid):
                raise ChromeTraceError(f"{where}: flow {fid!r} finishes "
                                       f"before it starts")
    for key, st in stacks.items():
        if st:
            raise ChromeTraceError(f"unclosed B spans on pid/tid {key}: {st}")
    if flows_open:
        raise ChromeTraceError(f"unfinished flows: {sorted(flows_open)}")
    if counts["B"] != counts["E"]:
        raise ChromeTraceError(
            f"unmatched B/E: {counts['B']} begins, {counts['E']} ends")
    return {"events": len(evs), "span_pairs": counts["B"],
            "instants": counts["i"], "flows": counts["s"],
            "lanes": len(tids)}


def export_chrome_trace(path: str, spans, flows=(),
                        process_name: str = "repro") -> dict:
    """Build, validate, and write a Chrome trace JSON; returns the
    validation summary.  An export that Perfetto could not render raises
    instead of writing a broken artifact."""
    doc = to_chrome(spans, flows, process_name=process_name)
    summary = validate_chrome_trace(doc)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return summary
