"""Resilient PINN field-serving process (the paper's §7.6 field as a service).

  python -m repro_torch.launch.serve_field --bundle exported_dir --rate 50 \
      --duration 10 --deadline 0.5 [--device cuda]

Counterpart of the reference package's ``launch/serve_field.py``.  Drives a
:class:`~repro_torch.serve.resilience.ResilientFrontend` over an exported
field bundle (or a built-in demo bundle) under Poisson-arrival traffic, with
the production lifecycle:

* **health/readiness heartbeat** — one JSON line per ``--heartbeat`` seconds
  on stderr (breaker state, queue pressure, ladder level, staged latency
  percentiles); ``--status-file`` additionally publishes the same snapshot
  atomically for external probes;
* **metrics + JSONL events** — ``--obs-jsonl`` streams schema-validated
  events (manifest, heartbeats, final serve_report + metrics snapshot);
* **graceful draining** — SIGINT/SIGTERM (or the end of ``--duration``) stops
  admission, flushes every queued request, then prints a final JSON report;
* **watchdog bundle reload** — SIGHUP re-reads ``--bundle`` from disk,
  verifies the newest generation's integrity envelope and hot-swaps it into
  the live engine; a corrupt candidate is refused and the old bundle keeps
  serving.

The engine runs on ``--device`` (default ``cuda``; it raises when no card is
present — pass ``--device cpu`` to serve on the CPU).  ``--faults`` wraps
the engine in :class:`~repro_torch.runtime.FaultyEngine`: a dispatch-indexed
serve fault schedule (``engine-raise@3,nan-output@5,slow-engine@7*0.05``)
that the resilience layer must absorb.

Exit code 0 iff every admitted ticket was answered (the resilience
invariant).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import numpy as np


def _demo_bundle(kind: str = "usmap", seed: int = 0):
    """In-process demo bundles so the server runs without a prior export."""
    from repro_torch.core import CartesianDecomposition, us_map_decomposition
    from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig,
                                       stacked_init)
    from repro_torch.core.pdes import Burgers1D, HeatConduction2D
    from repro_torch.serve import FieldBundle

    if kind == "cart":
        dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
        cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 12, 2)})
        params, codes = stacked_init(cfg, dec.n_sub, seed)
        return FieldBundle(model_cfg=cfg, params=params, decomp=dec,
                           act_codes=codes.numpy(), pde=Burgers1D())
    dec = us_map_decomposition()
    acts = ["tanh", "sin", "cos", "tanh", "sin", "cos", "tanh", "sin",
            "cos", "tanh"]
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 3),
                                     "k": MLPConfig(2, 1, 24, 3)})
    params, codes = stacked_init(cfg, dec.n_sub, seed, acts)
    return FieldBundle(model_cfg=cfg, params=params, decomp=dec,
                       act_codes=codes.numpy(), pde=HeatConduction2D())


def _cloud_sampler(decomp, seed: int):
    """Workload mix: mostly fresh random clouds, ~30% repeated dashboard
    grids (cache-hit traffic), sizes spanning two orders of magnitude."""
    rng = np.random.default_rng(seed)
    if getattr(decomp, "polygons", None) is not None:
        verts = np.concatenate(decomp.polygons)
        lo, hi = verts.min(axis=0), verts.max(axis=0)
    else:
        lo = np.array([b[0] for b in decomp.bounds], float)
        hi = np.array([b[1] for b in decomp.bounds], float)
    side = 16
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], side),
                         np.linspace(lo[1], hi[1], side))
    dashboards = [np.stack([gx.ravel(), gy.ravel()], axis=1)]

    def sample():
        if rng.uniform() < 0.3:
            return dashboards[0]
        n = int(rng.choice((32, 128, 512)))
        return rng.uniform(lo, hi, size=(n, 2))

    return sample


def _write_status(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)   # atomic: probes never read a torn file


def _latency_summary(frontend) -> dict:
    """Compact staged-latency block for heartbeats/status: p50/p99/count per
    stage (full histogram snapshots stay in ``stats()['latency']``)."""
    out = {}
    for stage, h in frontend.stats()["latency"].items():
        out[stage] = {"p50": h["p50"], "p99": h["p99"], "count": h["count"]}
    return out


def reload_bundle(frontend, bundle_dir: str, max_fallback: int = 0) -> dict:
    """Verify-then-hot-swap the serving bundle (the watchdog reload).

    Loads the newest generation under ``bundle_dir`` with verification ON;
    on success the live engine's bundle is swapped in place and the result
    cache invalidated.  On ANY verification/decode failure the swap is
    REFUSED: the frontend keeps serving the old bundle untouched, and the
    returned report (plus a ``corruption`` obs event when a sink is
    attached) records why.  Returns ``{"swapped": bool, "path",
    "step"|"error"}``.
    """
    from repro_torch.serve.export import CorruptBundleError, load_bundle

    obs = getattr(frontend, "obs", None)
    try:
        bundle = load_bundle(bundle_dir, max_fallback=max_fallback)
    except (CorruptBundleError, FileNotFoundError, ValueError) as e:
        if obs is not None:
            obs.emit("corruption", target="bundle", reason=str(e))
            obs.emit("bundle_swap", swapped=False, path=str(bundle_dir))
        return {"swapped": False, "path": str(bundle_dir), "error": str(e)}
    step = int(bundle.metadata.get("step", -1)) if isinstance(
        bundle.metadata, dict) and "step" in bundle.metadata else None
    frontend.engine.swap_bundle(bundle)
    # the inner ServeFrontend owns the result cache (ResilientFrontend wraps
    # one as ._fe); a bare ServeFrontend is its own cache owner
    getattr(frontend, "_fe", frontend).invalidate_cache()
    if obs is not None:
        obs.emit("bundle_swap", swapped=True, path=str(bundle_dir))
    return {"swapped": True, "path": str(bundle_dir),
            **({"step": step} if step is not None else {})}


def run_server(frontend, sample_cloud, *, rate: float, duration: float,
               deadline: float | None = None, heartbeat: float = 1.0,
               status_file: str | None = None, seed: int = 0,
               max_requests: int | None = None, trace_path: str | None = None,
               bundle_dir: str | None = None,
               clock=time.monotonic, sleep=time.sleep) -> dict:
    """The serving loop: Poisson admission -> poll/flush -> heartbeat ->
    drain.  Returns the final report dict (also printed as JSON).

    Heartbeats and the status file carry the frontend health snapshot plus a
    ``latency`` block and — when the frontend's obs carries a tracer — a
    ``trace`` block.  ``trace_path`` exports the span buffer as Chrome-trace
    JSON at shutdown (open it at https://ui.perfetto.dev)."""
    rng = np.random.default_rng(seed + 1)
    stop = {"sig": None, "reload": False}
    tracer = getattr(getattr(frontend, "obs", None), "tracer", None)
    reloads = {"swapped": 0, "refused": 0, "last": None}

    def _on_signal(signum, _frame):
        stop["sig"] = signum

    def _on_hup(_signum, _frame):
        stop["reload"] = True   # handled on the loop, not in the handler

    old = {s: signal.signal(s, _on_signal)
           for s in (signal.SIGINT, signal.SIGTERM)}
    if bundle_dir is not None and hasattr(signal, "SIGHUP"):
        old[signal.SIGHUP] = signal.signal(signal.SIGHUP, _on_hup)
    tickets: list[int] = []
    t0 = clock()
    next_arrival, next_beat = t0, t0
    try:
        while stop["sig"] is None and clock() - t0 < duration and \
                (max_requests is None or len(tickets) < max_requests):
            if stop["reload"]:
                stop["reload"] = False
                rep = reload_bundle(frontend, bundle_dir)
                reloads["swapped" if rep["swapped"] else "refused"] += 1
                reloads["last"] = rep
                print(json.dumps({"reload": rep}), file=sys.stderr, flush=True)
            now = clock()
            if now >= next_arrival:
                tickets.append(frontend.submit(sample_cloud(),
                                               deadline=deadline))
                next_arrival += rng.exponential(1.0 / rate)
            else:
                frontend.poll()
                sleep(min(max(next_arrival - now, 0.0), 0.005))
            if now >= next_beat:
                h = {**frontend.health(),
                     "latency": _latency_summary(frontend)}
                if bundle_dir is not None:
                    h["reloads"] = dict(reloads)
                if tracer is not None:
                    h["trace"] = tracer.stats()
                print(json.dumps({"t": round(now - t0, 3), **h}),
                      file=sys.stderr, flush=True)
                if status_file:
                    _write_status(status_file, h)
                obs = getattr(frontend, "obs", None)
                if obs is not None:
                    obs.emit("heartbeat", status=h["status"])
                next_beat += heartbeat
    finally:
        for s, h in old.items():
            signal.signal(s, h)

    # graceful shutdown: stop admitting, answer everything queued, report
    health = frontend.drain()
    results = [frontend.result(t) for t in tickets]
    lat = sorted(r.latency for r in results if r.ok and r.latency is not None)
    pct = lambda p: (round(lat[min(len(lat) - 1,
                                   int(p / 100 * len(lat)))], 4)
                     if lat else None)
    by_status: dict = {}
    for r in results:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    report = {
        "requests": len(tickets),
        "by_status": by_status,
        "p50_s": pct(50), "p99_s": pct(99),
        "latency": _latency_summary(frontend),
        "goodput": (sum(1 for r in results if r.ok) / len(tickets)
                    if tickets else 1.0),
        "degraded_frac": (sum(1 for r in results if r.degraded) / len(tickets)
                          if tickets else 0.0),
        "drained": health,
        "stats": {k: v for k, v in frontend.stats().items()
                  if k != "frontend"},
        "signal": stop["sig"],
    }
    if bundle_dir is not None:
        report["reloads"] = dict(reloads)
    if tracer is not None:
        report["trace"] = tracer.stats()
        if trace_path:
            from repro_torch.obs import export_chrome_trace
            report["trace"]["export"] = export_chrome_trace(
                trace_path, tracer.spans(),
                process_name="serve_field")
            report["trace"]["path"] = trace_path
    if status_file:
        _write_status(status_file, {**health, "final": True,
                                    "latency": report["latency"],
                                    **({"trace": tracer.stats()}
                                       if tracer is not None else {})})
    obs = getattr(frontend, "obs", None)
    if obs is not None:
        obs.emit("serve_report", requests=len(tickets),
                 goodput=report["goodput"])
        if obs.events is not None:
            obs.emit("metrics", snapshot=obs.registry.snapshot())
    print(json.dumps(report, indent=1))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve a PINN field bundle with resilience "
                    "(admission control, deadlines, degraded modes)")
    ap.add_argument("--bundle", default=None,
                    help="exported bundle dir (repro_torch.serve.export); "
                         "omit for --demo")
    ap.add_argument("--demo", default="usmap", choices=("usmap", "cart"),
                    help="built-in demo bundle when --bundle is omitted")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (default cuda; "
                         "raises when no card is present)")
    ap.add_argument("--rate", type=float, default=20.0, help="requests/s")
    ap.add_argument("--duration", type=float, default=5.0, help="seconds")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline seconds")
    ap.add_argument("--order", type=int, default=2, choices=(1, 2))
    ap.add_argument("--max-requests", type=int, default=None)
    ap.add_argument("--queue-requests", type=int, default=256)
    ap.add_argument("--queue-points", type=int, default=1 << 20)
    ap.add_argument("--queue-age", type=float, default=0.02,
                    help="flush once the queue head is this old (s)")
    ap.add_argument("--faults", default=None,
                    help="serve fault matrix, e.g. "
                         "'engine-raise@3,nan-output@5,slow-engine@7*0.2,"
                         "compile-storm@9'")
    ap.add_argument("--heartbeat", type=float, default=1.0)
    ap.add_argument("--status-file", default=None,
                    help="atomically published health JSON for probes")
    ap.add_argument("--obs-jsonl", default=None,
                    help="stream schema-validated obs events (manifest, "
                         "heartbeats, serve_report, metrics) to this JSONL")
    ap.add_argument("--trace", default=None,
                    help="export the span buffer as Chrome-trace JSON here "
                         "at shutdown (open in Perfetto / chrome://tracing)")
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="fraction of traces recorded (ids propagate on all)")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable span tracing entirely")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.obs import make_obs
    from repro_torch.serve import (FieldEngine, ResilienceConfig,
                                   ResilientFrontend)
    from repro_torch.serve.export import load_bundle

    bundle = (load_bundle(args.bundle) if args.bundle
              else _demo_bundle(args.demo, args.seed))
    cfg = ResilienceConfig(order=args.order if bundle.pde is not None else 1,
                           max_queue_requests=args.queue_requests,
                           max_queue_points=args.queue_points,
                           max_queue_age=args.queue_age,
                           default_deadline=args.deadline)
    obs = make_obs(args.obs_jsonl or None, clock=time.monotonic,
                   run_id=f"serve-{args.seed}",
                   config={"rate": args.rate, "duration": args.duration,
                           "order": cfg.order, "device": args.device,
                           "faults": args.faults},
                   trace=not args.no_trace, trace_sample=args.trace_sample)
    try:
        # the engine shares the obs so its serve.engine/* metrics land in the
        # same registry and its span nests under the frontend's microbatch
        # span
        engine = FieldEngine(bundle, device=args.device, obs=obs)
        if args.faults:
            from repro_torch.runtime import (FaultInjector, FaultyEngine,
                                             parse_faults)
            engine = FaultyEngine(engine,
                                  FaultInjector(parse_faults(args.faults)))
        fe = ResilientFrontend(engine, cfg, seed=args.seed, obs=obs)
        sampler = _cloud_sampler(bundle.decomp, args.seed)
        fe.query(sampler())   # warmup (kernel build/load) outside the traffic
        report = run_server(fe, sampler, rate=args.rate,
                            duration=args.duration, deadline=args.deadline,
                            heartbeat=args.heartbeat,
                            status_file=args.status_file, seed=args.seed,
                            max_requests=args.max_requests,
                            trace_path=args.trace,
                            bundle_dir=args.bundle)
    finally:
        obs.close()
    return 0 if report["drained"]["unanswered"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
