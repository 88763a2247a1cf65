"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell from the root of a checkout.  Everything is found by name:
the cell in ``portbench/workloads/<cell>.json`` (its configuration, entry,
traffic parameters, the end-to-end metrics it reports and the limits of
its check), the configuration in ``portbench/configs/<config>.json``, the
entry in ``portbench/entries/<entry>.py`` and each per-layer metric in
``portbench/metrics/<metric>.py``.

A run sets up (import, kernel build or load, weights from the seed,
warm-up: ``setup_s``), then runs whole items (requests or steps) back to
back, one caller, until ``--seconds`` have passed, and divides by the time
from the first item's start to the last one's end.  With ``--trace 1`` the
window's whole items of its first ``TRACE_SECONDS`` run under
``torch.profiler`` and the per-layer metrics are read from that trace:
each reader names the host spans it reads, and where one reads their
input shapes, a few more items are traced with shapes recorded.  Once the
window has closed and the peak memory has been read, the program's state
is freed and the check compares what the window produced with the plain
reference (``portbench/reference``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1``
also ``breakdown``), and last ``checks``: each number compared with its
limit, which also end standard error.  A run exits non-zero and prints no
result where no card is found, and where JAX or the JAX package is loaded
in the process once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a traced run profiles the window's first items, up to this many seconds
# (parsing a trace costs some seconds a second traced), without input
# shapes (recording them slows the host by a third); where a reader reads
# shapes, the next SHAPED_ITEMS items run under a second profiler that
# records them
TRACE_SECONDS = 10.0
SHAPED_ITEMS = 2


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_names() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "metrics"))
                  if f.endswith(".py") and not f.startswith("_"))


def readers(cell: dict) -> dict:
    """The per-layer readers of the cell: those of the metrics that move
    one of its end-to-end metrics."""
    out = {}
    for name in metric_names():
        mod = load_module("metrics", name)
        if mod.MOVES in cell["end_to_end"]:
            out[name] = mod
    return out


def span_names(mods) -> tuple[frozenset, frozenset]:
    """The host spans the readers ``mods`` read (each lists them in its
    ``SPANS``), and those whose input shapes they read (``SHAPED``)."""
    spans, shaped = set(), set()
    for mod in mods:
        spans |= set(getattr(mod, "SPANS", ()))
        shaped |= set(getattr(mod, "SHAPED", ()))
    return frozenset(spans), frozenset(shaped)


def _profiler(device, shapes: bool):
    """An open ``torch.profiler`` session, its dropped first device
    records taken by pad kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import PAD

    cuda = device.type == "cuda"
    prof = profile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else []), record_shapes=shapes)
    prof.__enter__()
    if cuda:
        for _ in range(PAD):
            torch.cuda._sleep(2000)
        torch.cuda.synchronize(device)
    return prof


def forbidden_modules(names=None) -> list[str]:
    """Top-level names, taken whole, of the loaded modules (or of
    ``names``) that are JAX or the JAX package (``repro_torch`` is
    neither)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


class Context:
    """What a per-layer reader sees of a traced window."""

    def __init__(self, cell, model, items, window_s, trace, shaped=None,
                 shaped_items=0):
        self.entry = cell["entry"]
        self.model = model
        self.batch, self.seq = cell["params"]["batch"], cell["params"]["seq"]
        self.items = items
        self.window_s = window_s
        self.trace = trace
        self.busy_s = trace.busy_s()
        # the items traced with their input shapes, after ``trace``'s
        self.shaped, self.shaped_items = shaped, shaped_items


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             fault: str | None = None, cell: dict | None = None,
             model: dict | None = None) -> dict:
    """One run of the cell ``name`` on ``device``: the result's fields.
    ``cell`` and ``model`` replace the files' (tests run small ones on the
    CPU); ``fault`` is planted in the timed path (tests of the check)."""
    import torch

    from portbench.trace import Trace

    cell = cell or load_json("workloads", name)
    model = model or load_json("configs", cell["config"])["model"]
    cuda = device.type == "cuda"
    entry = load_module("entries", cell["entry"])
    runner = entry.Runner(cell, model, seed, device, fault)
    runner.setup()
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    gc.collect()
    gc.freeze()   # set-up's objects: no collection walks them in the window
    setup_s = time.perf_counter() - T_START

    mods = readers(cell) if trace else {}
    spans_read, shaped_read = span_names(mods.values())
    # items the window must hold (a training cell's checked steps)
    least = getattr(runner, "min_items", 1)
    spans, failed = [], 0
    prof = shaped_prof = traced = shaped_from = None
    shaped_n = 0
    if trace:
        prof = _profiler(device, False)
    w0 = time.perf_counter()
    while True:
        s = time.perf_counter()
        ok = runner.item(len(spans))
        e = time.perf_counter()
        spans.append((s, e))
        failed += not ok
        if shaped_prof is not None and not shaped_n and \
                len(spans) - shaped_from >= SHAPED_ITEMS:
            shaped_prof.__exit__(None, None, None)
            shaped_n = len(spans) - shaped_from
        if prof is not None and traced is None and \
                (e - w0 >= min(seconds, TRACE_SECONDS)):
            prof.__exit__(None, None, None)
            traced = (len(spans), e - spans[0][0])
            if shaped_read:
                shaped_prof, shaped_from = _profiler(device, True), len(spans)
        if e - w0 >= seconds and len(spans) >= least and \
                (not trace or traced and (not shaped_read or shaped_n)):
            break
    window_s = spans[-1][1] - spans[0][0]
    gc.unfreeze()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    peak = max(setup_peak, window_peak) if cuda else 0

    metrics = {"setup_s": (setup_s, "s")}
    metrics.update(runner.end_to_end(spans, window_s, window_peak))
    out = {"attempted": len(spans), "failed": failed}
    if trace:
        tr = Trace(prof, spans=spans_read)
        del prof
        shaped_tr = None
        if shaped_prof is not None:
            shaped_tr = Trace(shaped_prof, shaped=shaped_read)
            del shaped_prof
        ctx = Context(cell, model, *traced, tr, shaped_tr, shaped_n)
        if cuda and ctx.busy_s <= 0:
            raise RuntimeError("the profiler saw no device time in the "
                               "window")
        metrics = {}
        for mname, reader in mods.items():
            value = reader.read(ctx)
            if value is not None:
                metrics[mname] = (value, reader.UNIT)
        out["busy_s"], out["trace_window_s"] = ctx.busy_s, ctx.window_s
        out["breakdown"] = tr.breakdown(top=40)
        with open(os.path.join(HERE, "traces", f"{name}.{seed}.json"),
                  "w") as f:
            json.dump({"items": len(spans), "traced_items": traced[0],
                       "shaped_items": shaped_n, **out}, f, indent=1)
        out["breakdown"] = {k: v[:10] for k, v in out["breakdown"].items()}
        del tr, shaped_tr, ctx
    else:
        missing = sorted(set(cell["end_to_end"]) - set(metrics))
        if missing:
            raise RuntimeError(f"the window gave no {missing} (too few "
                               f"items: {len(spans)})")
        metrics = {k: v for k, v in metrics.items()
                   if k in cell["end_to_end"]}
    out["metrics"] = {k: {"value": v, "unit": u}
                      for k, (v, u) in metrics.items()}
    out["memory_peak_bytes"] = peak

    runner.close_window()
    if cuda:
        torch.cuda.empty_cache()
    readings = runner.readings()
    limits = cell["check"]
    out["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                     for k in limits}
    out["correct"] = failed == 0 and all(
        readings[k] <= limits[k] for k in limits)
    return out


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_json("workloads", args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA card(s) wanted, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)   # the host's work is launches: one thread
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device, cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in the process: {bad}", file=sys.stderr)
        return 4

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell["chips"], "memory_peak_bytes": res["memory_peak_bytes"],
           "power_limit": _power_limit()}
    if args.trace:
        dev["busy_s"], dev["window_s"] = res["busy_s"], res["trace_window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"], "device": dev}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
