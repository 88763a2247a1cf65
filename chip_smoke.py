#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout.  Phases, in order; a failure in any of them
ends the run with a non-zero exit code and no result line:

1. **build** — compile every CUDA source under ``src/repro_torch/csrc/``
   (one ``nvcc`` per source, all started together) and print the seconds
   and each instantiation's registers and spills;
2. **kernels** — hold each kernel against its plain PyTorch version on the
   card (float32, rtol = atol = 1e-5) over activations tanh/sin/cos,
   d_in 1-3, widths 20/24/40/80/128 at depths 2-5, d2 directions all / a
   strict subset / none, n_sub 1 and 4, ragged point counts; then time the
   kernel (CUDA graph of back-to-back launches), its wrapper call and the
   plain version with CUDA events at the serving shapes (n_sub=4,
   m = 64/512/4096 points per subdomain) and a dense grid (m = 262,144),
   beside each shape's bound;
3. **serve** — export the 2x2 space-time Burgers XPINN bundle
   (``MLPConfig(2, 1, 24, 4)``, weights from a seed) and serve it with
   ``repro_torch.launch.serve_field.main`` at ``--order 2`` and
   ``--order 1``, the kernels' launch counts set to 0 just before each run
   and read just after; then evaluate one fixed cloud (inside, interface and
   outside points) through the engine and hold it against the plain
   recurrence on the card;
4. **report** — one ``{"kernels": [...]}`` line, the card's name and power
   limit from ``nvidia-smi``, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

The bound of a shape is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its matrix-product FLOPs (two per
multiply-add, pruned second-order streams not counted) over 67 TFLOP/s, the
H100 SXM's float32 rate outside the tensor cores.

The script imports nothing of the JAX package.  Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

SEED = 0
TOL = 1e-5               # rtol and atol, float32 kernel vs float32 plain
FP32_FLOPS = 67e12       # H100 SXM, float32 outside the tensor cores
HBM_BYTES = 3.35e12      # H100 SXM, bytes/s
SOURCE = "src/repro_torch/csrc/pinn_mlp_fwd.cu"
REPLACES = {"pinn_mlp_fwd1": "src/repro/kernels/pinn_mlp.py:82",
            "pinn_mlp_fwd2": "src/repro/kernels/pinn_mlp.py:148"}
# the main path's shape (width, depth, points per subdomain): the served
# Burgers net at a serving batch; timing() runs it with n_sub=4, d_in=2
MAIN = (24, 4, 512)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# --------------------------------------------------------------------- build

def build_phase() -> None:
    from repro_torch.kernels import native

    t0 = time.perf_counter()
    info = native.build()
    secs = time.perf_counter() - t0
    check(set(info) == {p.stem for p in native.sources()},
          f"built {sorted(info)}")
    logs = "".join(v["log"] for v in info.values())
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", logs)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", logs)]
    print(json.dumps({"build_s": round(secs, 2),
                      "sources": {k: round(v["seconds"], 2)
                                  for k, v in info.items()},
                      "instantiations": len(regs),
                      "registers_max": max(regs, default=None),
                      "spill_bytes_max": max(spills, default=None)}))


# ------------------------------------------------------------------- kernels

def _net(gen, n_sub, n, d_in, width, depth, n_out, dev):
    """Seeded random inputs and packed weight stacks on the card."""
    import torch
    from repro_torch.kernels import ops

    dims = [d_in] + [width] * depth + [n_out]
    Ws = [torch.randn((n_sub, a, b), generator=gen) * (2.0 / (a + b)) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn((n_sub, b), generator=gen) for b in dims[1:]]
    a = 0.9 + 0.2 * torch.rand((n_sub, depth), generator=gen)
    x = 2.0 * torch.rand((n_sub, n, d_in), generator=gen) - 1.0
    w, b, av = ops.pack_mlp(Ws, bs, a)
    return [t.to(dev).contiguous() for t in (x, w, b, av)]


def _run(kernel: bool, args, n_out, act, d2):
    from repro_torch.kernels import pinn_mlp as K

    if d2 == ():
        fn = K.pinn_mlp_fwd1 if kernel else K.pinn_mlp_fwd1_plain
        return fn(*args, n_out=n_out, act=act)
    fn = K.pinn_mlp_fwd2 if kernel else K.pinn_mlp_fwd2_plain
    return fn(*args, n_out=n_out, act=act, d2_dirs=d2)


def _compare(got, want, d_in, d2) -> tuple[float, float]:
    import torch

    abs_err = rel_err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"shape {tuple(g.shape)} != "
                                  f"{tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), "non-finite kernel output")
        diff = (g - w).abs()
        check(bool((diff <= TOL + TOL * w.abs()).all()),
              f"kernel disagrees: max abs {float(diff.max()):.3e}")
        abs_err = max(abs_err, float(diff.max()))
        rel_err = max(rel_err, float((diff / (w.abs() + TOL)).max()))
    if d2 not in (None, ()):   # pruned second-derivative rows: exact zeros
        for j in range(d_in):
            if j not in d2:
                check(not bool(got[2][:, j].any()), f"d2u row {j} not zero")
    return abs_err, rel_err


def sweep(dev) -> dict:
    import torch

    gen = torch.Generator().manual_seed(SEED)
    worst = {"pinn_mlp_fwd1": 0.0, "pinn_mlp_fwd2": 0.0}
    subsets = {1: (None, ()), 2: (None, (1,), ()), 3: (None, (0, 2), ())}
    n_cases = 0
    for act in ("tanh", "sin", "cos"):
        for d_in in (1, 2, 3):
            n_out = 1 if d_in == 2 else 3
            for width, depth in ((20, 2), (24, 4), (40, 3), (80, 5),
                                 (128, 5)):
                sizes = [(1, 1013), (4, 517)]
                if width == 24:
                    sizes += [(4, 5), (4, 64)]
                for d2 in subsets[d_in]:
                    for n_sub, n in sizes:
                        args = _net(gen, n_sub, n, d_in, width, depth,
                                    n_out, dev)
                        got = _run(True, args, n_out, act, d2)
                        want = _run(False, args, n_out, act, d2)
                        torch.cuda.synchronize()
                        ae, re_ = _compare(got, want, d_in, d2)
                        name = "pinn_mlp_fwd1" if d2 == () else \
                            "pinn_mlp_fwd2"
                        worst[name] = max(worst[name], ae)
                        n_cases += 1
                        print(f"{name[-4:]} {act:4s} d{d_in} w{width}x"
                              f"{depth} d2={'all' if d2 is None else d2} "
                              f"{n_sub}x{n} abs {ae:.1e} rel {re_:.1e}")
    print(json.dumps({"sweep_cases": n_cases, "tol": TOL,
                      "max_abs_err": worst}))
    return worst


def bound(n_sub, m, d_in, width, depth, n_out, d2) -> tuple[float, str]:
    """Least time (ms) for the work of one call, and what bounds it."""
    dims = [d_in] + [width] * depth + [n_out]
    order2 = d2 != ()
    streams = 1 + d_in + (0 if not order2 else
                          d_in if d2 is None else len(d2))
    flops = 2 * d_in * width          # input layer: h (tangents are rows)
    for a, b in zip(dims[1:-1], dims[2:]):
        flops += streams * 2 * a * b
    flops *= n_sub * m
    n_params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:])) + depth
    rows_out = 1 + d_in + (d_in if order2 else 0)
    nbytes = 4 * n_sub * (m * d_in + n_params + m * n_out * rows_out)
    t_bytes, t_ops = nbytes / HBM_BYTES, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def _events_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device time per launch: ``reps`` launches captured in one CUDA graph
    and replayed, so host launch cost is out of the measurement."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    g.replay()
    e.record()
    e.synchronize()
    del g
    return s.elapsed_time(e) / reps


def timing(dev) -> dict:
    import torch

    gen = torch.Generator().manual_seed(SEED + 1)
    out = {}
    shapes = [(24, 4, m) for m in (64, 512, 4096, 262144)]
    shapes += [(w, 5, m) for w in (80, 128) for m in (4096, 262144)]
    for width, depth, m in shapes:
        d_in, n_out, act, n_sub = 2, 1, "tanh", 4
        args = _net(gen, n_sub, m, d_in, width, depth, n_out, dev)
        dense = m > 100_000
        for name, d2 in (("pinn_mlp_fwd1", ()), ("pinn_mlp_fwd2", (0,))):
            kern = lambda: _run(True, args, n_out, act, d2)
            plain = lambda: _run(False, args, n_out, act, d2)
            bms, by = bound(n_sub, m, d_in, width, depth, n_out, d2)
            row = {"kernel": name, "shape": f"n_sub={n_sub} m={m} "
                   f"w{width}x{depth} d_in={d_in} d2={list(d2)}",
                   "ms": _graph_ms(kern, 20 if dense else 200),
                   "call_ms": _events_ms(kern, 20 if dense else 200),
                   "plain_ms": _events_ms(plain, 3 if dense else 50),
                   "bound_ms": bms, "bound_by": by}
            out[(name, width, depth, m)] = row
            print(json.dumps({"timing": row}))
            torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- serve

def _plain_field(bundle, pts, order, dev) -> dict:
    """The stitched field from the plain recurrence, one subdomain at a time
    (independent of the engine's batching and stitching)."""
    import torch
    from repro_torch.core.nets import act_name, map_tree, params_from_numpy
    from repro_torch.kernels import ref
    from repro_torch.serve import routing

    pde, cfg = bundle.pde, bundle.model_cfg
    ((name, c),) = cfg.nets.items()
    params = params_from_numpy(bundle.params, dev)[name]
    mem = routing.membership_matrix(bundle.decomp, pts, tol=1e-9)
    d2 = pde.d2_dirs if order == 2 else ()
    sums = {}
    for q in range(bundle.n_sub):
        idx = np.nonzero(mem[q])[0]
        if len(idx) == 0:
            continue
        p = map_tree(lambda t: t[q], params)
        a = (c.slope_scale * p["a"] if c.adaptive
             else torch.full_like(p["a"], c.slope_scale))
        x = torch.tensor(pts[idx], dtype=torch.float32, device=dev)
        u, du, d2u = ref.pinn_mlp_ref2(x, p["W"], p["b"], a,
                                       act=act_name(bundle.act_codes[q]),
                                       d2_dirs=d2)
        vals = {"u": u, "grad_u": du.movedim(0, 1),
                "flux": pde.flux_from_derivs(x, u, du)}
        if order == 2:
            vals["residual"] = pde.residual_from_derivs(x, u, du, d2u)
        for k, v in vals.items():
            acc = sums.setdefault(k, np.zeros((len(pts),) + v.shape[1:]))
            acc[idx] += v.double().cpu().numpy()
    n = mem.sum(axis=0)
    return {k: np.where((n > 0).reshape((-1,) + (1,) * (v.ndim - 1)),
                        v / np.maximum(n, 1).reshape((-1,) + (1,) *
                                                     (v.ndim - 1)), np.nan)
            for k, v in sums.items()}


def serve_phase(dev) -> dict:
    from repro_torch.core import CartesianDecomposition
    from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig,
                                       stacked_init)
    from repro_torch.core.pdes import Burgers1D
    from repro_torch.kernels import pinn_mlp as K
    from repro_torch.launch import serve_field
    from repro_torch.serve import FieldEngine, export_bundle, load_bundle

    dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 4)})
    params, codes = stacked_init(cfg, dec.n_sub, SEED)
    launches = {k: 0 for k in K.launches}
    with tempfile.TemporaryDirectory() as tmp:
        bdir = os.path.join(tmp, "burgers_2x2")
        export_bundle(bdir, params, cfg, dec, act_codes=codes,
                      pde=Burgers1D())
        for order, kernel in ((2, "pinn_mlp_fwd2"), (1, "pinn_mlp_fwd1")):
            argv = ["--bundle", bdir, "--device", "cuda", "--max-requests",
                    "200", "--rate", "2000", "--order", str(order)]
            buf = io.StringIO()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = serve_field.main(argv)
            secs = time.perf_counter() - t0
            counts = dict(K.launches)
            report = json.loads(buf.getvalue())
            check(rc == 0, f"serve_field --order {order} exited {rc}")
            check(report["drained"]["unanswered"] == 0,
                  f"order {order}: unanswered tickets")
            check(report["goodput"] == 1.0,
                  f"order {order}: goodput {report['goodput']}")
            check(counts[kernel] > 0,
                  f"order {order}: {kernel} was never launched")
            for k in launches:
                launches[k] += counts[k]
            print(json.dumps({"serve": {
                "order": order, "seconds": round(secs, 3),
                "requests": report["requests"],
                "by_status": report["by_status"],
                "goodput": report["goodput"],
                "degraded_frac": report["degraded_frac"],
                "p50_s": report["p50_s"], "p99_s": report["p99_s"],
                "dispatch_p50_s": report["latency"]["dispatch_s"]["p50"],
                "dispatches": report["latency"]["dispatch_s"]["count"],
                "launches": counts}}))
        bundle = load_bundle(bdir)

    # one fixed cloud through the engine on the card
    eng = FieldEngine(bundle)
    check(eng.device.type == "cuda", f"engine on {eng.device}")
    rng = np.random.default_rng(SEED)
    inside = np.concatenate([dec.sample_interior(q, 300, rng)
                             for q in range(dec.n_sub)])
    iface = np.concatenate([
        np.stack([np.zeros(25), np.linspace(0.02, 0.98, 25)], axis=1),
        np.stack([np.linspace(-0.98, 0.98, 25), np.full(25, 0.5)], axis=1),
        [[0.0, 0.5]]])
    outside = np.array([[1.5, 0.5], [0.0, -0.2], [-3.0, 4.0]])
    pts = np.concatenate([inside, iface, outside])
    for order in (2, 1):
        got = eng.evaluate(pts, order=order)
        want = _plain_field(bundle, pts, order, eng.device)
        claims = eng.last_claims
        check(int((claims >= 2).sum()) == len(iface),
              f"interface claims {int((claims >= 2).sum())}")
        check(sorted(got) == sorted(want), f"keys {sorted(got)}")
        err = 0.0
        for k, v in got.items():
            inn, out = v[claims > 0], v[claims == 0]
            check(bool(np.isfinite(inn).all()), f"{k}: non-finite inside")
            check(bool(np.isnan(out).all()), f"{k}: outside not NaN")
            diff = np.abs(inn - want[k][claims > 0])
            check(bool((diff <= TOL + TOL * np.abs(want[k][claims > 0]))
                       .all()), f"order {order} {k}: max abs "
                                f"{float(diff.max()):.3e}")
            err = max(err, float(diff.max()))
        print(json.dumps({"engine_vs_plain": {
            "order": order, "points": len(pts), "max_abs_err": err,
            "tol": TOL, "outside_nan": int((claims == 0).sum())}}))
    return launches


# -------------------------------------------------------------------- report

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every phase's numbers to this JSON")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on a "
                         "card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {ROOT}; "
                         "run it from a checkout of the repository")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in
    torch.backends.cudnn.allow_tf32 = False         # full float32
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    build_phase()
    worst = sweep(dev)
    times = timing(dev)
    launches = serve_phase(dev)

    kernels = []
    for name in ("pinn_mlp_fwd1", "pinn_mlp_fwd2"):
        t = times[(name, *MAIN)]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": t["shape"]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"kernels": kernels, "nvidia_smi": smi,
                       "timing": list(times.values()),
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
