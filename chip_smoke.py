#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout.  Phases, in order; a failure in any of them
ends the run with a non-zero exit code and no result line:

1. **build** — compile every CUDA source under ``src/repro_torch/csrc/``
   (one ``nvcc`` per source, all started together) and print the seconds
   and each instantiation's registers and spills;
2. **kernels** — hold each forward kernel (K1/K2) against its plain PyTorch
   version on the card (float32, rtol = atol = 1e-5) over activations
   tanh/sin/cos, d_in 1-3, widths 20/24/40/80/128 at depths 2-5, d2
   directions all / a strict subset / none, n_sub 1 and 4, ragged point
   counts; then the training kernels: K3 (outputs and every spill, same
   tolerance) and K4 (per-leaf error scaled by max(1, max |want|) <= 1e-5,
   the reference's rule) over widths 20/24/80/128 at depths 1/4/3/5, with
   K4 launched twice and held bitwise equal, and ``torch.autograd.grad``
   through ``ops.pinn_mlp_forward2`` on the card against the CPU;
3. **timing** — each kernel (CUDA graph of back-to-back launches), its
   wrapper call and its plain version with CUDA events beside the shape's
   bound: K1/K2 at the serving shapes (n_sub=4, m = 64/512/4096 points per
   subdomain) and a dense grid (m = 262,144); K3/K4 at the quickstart's
   training megabatch (n_sub=4, m = 1120) at width 24 x 4 and 80 x 5;
4. **serve** — export the 2x2 space-time Burgers XPINN bundle
   (``MLPConfig(2, 1, 24, 4)``, weights from a seed) and serve it with
   ``repro_torch.launch.serve_field.main`` at ``--order 2`` and
   ``--order 1``, the kernels' launch counts set to 0 just before each run
   and read just after; then evaluate one fixed cloud (inside, interface and
   outside points) through the engine and hold it against the plain
   recurrence on the card;
5. **train** — ``repro_torch.launch.quickstart.main`` trains the same
   XPINN on the card for 1500 steps (chunks of 250), counts set to 0 just
   before and read just after: it must reach rel-L2 < 0.5 against
   Cole-Hopf with one K3 and one K4 launch per loss evaluation and no plain
   version run on a CUDA tensor; then 10 steps from one init on the card
   and on the CPU are held together, and the ms per training step is split
   into forward kernel, backward kernel and everything else;
6. **report** — one ``{"kernels": [...]}`` line (K1-K4), the card's name
   and power limit from ``nvidia-smi``, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

The bound of a shape is the larger of its bytes (inputs read once, outputs
written once; for K3 the spills are outputs, for K4 inputs) over 3.35 TB/s
and its matrix-product FLOPs (two per multiply-add, pruned second-order
streams not counted; K4 does two products per stream and layer) over
67 TFLOP/s, the H100 SXM's float32 rate outside the tensor cores.

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
SOURCES = {"pinn_mlp_fwd1": "src/repro_torch/csrc/pinn_mlp_fwd.cu",
           "pinn_mlp_fwd2": "src/repro_torch/csrc/pinn_mlp_fwd.cu",
           "pinn_mlp_fwd2_res": "src/repro_torch/csrc/pinn_mlp_fwd.cu",
           "pinn_mlp_bwd2": "src/repro_torch/csrc/pinn_mlp_bwd.cu"}
REPLACES = {"pinn_mlp_fwd1": "src/repro/kernels/pinn_mlp.py:82",
            "pinn_mlp_fwd2": "src/repro/kernels/pinn_mlp.py:148",
            "pinn_mlp_fwd2_res": "src/repro/kernels/pinn_mlp.py:166",
            "pinn_mlp_bwd2": "src/repro/kernels/pinn_mlp.py:184"}
# the serving path's shape (width, depth, points per subdomain): the served
# Burgers net at a serving batch; timing() runs it with n_sub=4, d_in=2
MAIN = (24, 4, 512)
# 10-step trajectory, card (kernels) against the CPU (plain versions): the
# loss terms within TRAJ_RTOL (relative), the params within TRAJ_ATOL.
# Adam's first step moves every parameter by lr * sign(gradient) whatever
# the gradient's size, so a component whose gradient sat at rounding level
# could differ by 2 * lr = 4e-3 after one step; 1e-5 says no component took
# a different direction, and the rest differs by float32 rounding only.
TRAJ_RTOL = 1e-4
TRAJ_ATOL = 1e-5


RECORD: list = []   # every result line of this run, for --out


def emit(obj: dict) -> None:
    """Print one result line and keep it for ``--out``."""
    RECORD.append(obj)
    print(json.dumps(obj))


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
    emit({"build_s": round(secs, 2),
                      "sources": {k: round(v["seconds"], 2)
                                  for k, v in info.items()},
                      "instantiations": len(regs),
                      "registers_max": max(regs, default=None),
                      "spill_bytes_max": max(spills, default=None)})


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
    emit({"sweep_cases": n_cases, "tol": TOL,
                      "max_abs_err": dict(worst)})
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
            emit({"timing": row})
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
            emit({"serve": {
                "order": order, "seconds": round(secs, 3),
                "requests": report["requests"],
                "by_status": report["by_status"],
                "goodput": report["goodput"],
                "degraded_frac": report["degraded_frac"],
                "p50_s": report["p50_s"], "p99_s": report["p99_s"],
                "dispatch_p50_s": report["latency"]["dispatch_s"]["p50"],
                "dispatches": report["latency"]["dispatch_s"]["count"],
                "launches": counts}})
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
        emit({"engine_vs_plain": {
            "order": order, "points": len(pts), "max_abs_err": err,
            "tol": TOL, "outside_nan": int((claims == 0).sum())}})
    return launches


# ------------------------------------------------------------------ training

def _leaf_err(got, want) -> float:
    """|got - want| / max(1, max |want|): the reference's per-leaf scaled
    error for the reverse sweep (tests/test_kernels_pinn_mlp.py:330-335)."""
    if want.numel() == 0:
        return 0.0
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def _run_train(kernel: bool, args, n_out, act, d2, cts):
    """K3 then K4 (or their plain versions) on the same inputs."""
    from repro_torch.kernels import pinn_mlp as K

    x, w, b, av = args
    fwd = K.pinn_mlp_fwd2_res if kernel else K.pinn_mlp_fwd2_res_plain
    bwd = K.pinn_mlp_bwd2 if kernel else K.pinn_mlp_bwd2_plain
    outs = fwd(x, w, b, av, n_out=n_out, act=act, d2_dirs=d2)
    return outs, bwd(x, w, av, outs[3], *cts, n_out=n_out, act=act,
                     d2_dirs=d2)


def _cotangents(gen, n_sub, n, d_in, n_out, dev):
    import torch

    return [torch.randn(s, generator=gen).to(dev) for s in
            ((n_sub, n, n_out), (n_sub, d_in, n, n_out),
             (n_sub, d_in, n, n_out))]


def train_sweep(dev) -> dict:
    """K3 against its plain version (outputs and every spill, rtol = atol =
    TOL) and K4 against its plain version on the same spills and random
    cotangents (per-leaf scaled error <= TOL), K4 launched twice and held
    bitwise; then the autograd boundary on the card against the CPU."""
    import torch
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(SEED + 2)
    worst = {"pinn_mlp_fwd2_res": 0.0, "pinn_mlp_bwd2": 0.0}
    scaled = 0.0
    subsets = {1: (None, ()), 2: (None, (0,), ()), 3: (None, (0, 2), ())}
    n_cases = 0
    for act in ("tanh", "sin", "cos"):
        for d_in in (1, 2, 3):
            n_out = 1 if d_in == 2 else 3
            for width, depth in ((20, 1), (24, 4), (80, 3), (128, 5)):
                for d2 in subsets[d_in]:
                    for n_sub, n in ((1, 1013), (4, 517)):
                        args = _net(gen, n_sub, n, d_in, width, depth,
                                    n_out, dev)
                        cts = _cotangents(gen, n_sub, n, d_in, n_out, dev)
                        got, gbar = _run_train(True, args, n_out, act, d2,
                                               cts)
                        want, wbar = _run_train(False, args, n_out, act, d2,
                                                cts)
                        again = _run_train(True, args, n_out, act, d2,
                                           cts)[1]
                        torch.cuda.synchronize()
                        ae, _ = _compare(got, want, d_in, d2)
                        be = max(_leaf_err(g, w) for g, w in zip(gbar, wbar))
                        babs = max(float((g - w).abs().max())
                                   for g, w in zip(gbar, wbar) if w.numel())
                        check(be <= TOL, f"K4 disagrees: {be:.3e}")
                        check(all(torch.equal(g, a)
                                  for g, a in zip(gbar, again)),
                              "K4 is not bitwise deterministic")
                        worst["pinn_mlp_fwd2_res"] = max(
                            worst["pinn_mlp_fwd2_res"], ae)
                        worst["pinn_mlp_bwd2"] = max(worst["pinn_mlp_bwd2"],
                                                     babs)
                        scaled = max(scaled, be)
                        n_cases += 1
                        print(f"res+bwd {act:4s} d{d_in} w{width}x{depth} "
                              f"d2={'all' if d2 is None else d2} "
                              f"{n_sub}x{n} K3 abs {ae:.1e} K4 {be:.1e}")
    # autograd through the packed call: card (K3 + K4) against the CPU
    args = [t.cpu() for t in _net(gen, 4, 1120, 2, 24, 4, 1, dev)]
    x, w, b, av = args
    dims = [2, 24, 24, 24, 24, 1]
    Ws = [w[:, l, :i, :o] for l, (i, o) in enumerate(zip(dims[:-1],
                                                           dims[1:]))]
    bs = [b[:, l, :o] for l, o in enumerate(dims[1:])]
    a = av[:, :4]
    cts = _cotangents(gen, 4, 1120, 2, 1, "cpu")
    grads = {}
    for d in ("cpu", dev):
        ins = [t.to(d).clone().requires_grad_() for t in [x, *Ws, *bs, a]]
        outs = ops.pinn_mlp_forward2(ins[0], ins[1:6], ins[6:11], ins[11],
                                     act="tanh", d2_dirs=(0,), bwd="fused")
        grads[str(d)] = torch.autograd.grad(outs, ins,
                                            [c.to(d) for c in cts])
    ag = max(_leaf_err(g.cpu(), c) for g, c in zip(grads[str(dev)],
                                                   grads["cpu"]))
    check(ag <= TOL, f"autograd boundary card vs CPU: {ag:.3e}")
    emit({"train_sweep_cases": n_cases, "tol": TOL,
                      "max_abs_err": worst, "k4_max_scaled_err": scaled,
                      "autograd_card_vs_cpu": ag})
    return worst


def train_bound(n_sub, m, d_in, width, depth, n_out, ns, kernel):
    """Least time (ms) of one K3 or K4 call, what bounds it, and the counts.

    K3: K2's bytes and FLOPs plus the spills, depth * (1 + d_in + ns) * m
    rows of the padded width.  K4: reads x, the weights, the spills and the
    cotangents of u, du and the kept d2u rows, writes x-bar and the W-bar,
    b-bar, a-bar stacks; per hidden layer two matrix products on every
    stream (W-bar and the W^T product), plus x-bar and W-bar_0."""
    wp = -(-width // 4) * 4
    dims = [d_in] + [width] * depth + [n_out]
    streams = 1 + d_in + ns
    spill = depth * streams * m * wp
    n_params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:])) + depth
    if kernel == "pinn_mlp_fwd2_res":
        flops = 2 * d_in * width
        for a, b in zip(dims[1:-1], dims[2:]):
            flops += streams * 2 * a * b
        words = m * d_in + n_params + m * n_out * (1 + 2 * d_in) + spill
    else:
        flops = 2 * 2 * d_in * width       # x-bar and W-bar_0
        for a, b in zip(dims[1:-1], dims[2:]):
            flops += 2 * streams * 2 * a * b
        words = (m * d_in + n_params + spill + m * n_out * streams
                 + m * d_in + n_params)
    flops *= n_sub * m
    nbytes = 4 * n_sub * words
    t_bytes, t_ops = nbytes / HBM_BYTES, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", nbytes, flops)


def train_timing(dev, m_main: int) -> dict:
    """K3 and K4 at the quickstart megabatch (n_sub=4, width 24 x 4,
    d2_dirs=(0,)) and at width 80 x 5, same rows: device ms (CUDA graph of
    launches), wrapper-call ms, plain-version ms, bound."""
    import torch

    from repro_torch.kernels import pinn_mlp as K

    gen = torch.Generator().manual_seed(SEED + 3)
    out = {}
    for width, depth in ((24, 4), (80, 5)):
        d_in, n_out, act, n_sub, d2 = 2, 1, "tanh", 4, (0,)
        args = _net(gen, n_sub, m_main, d_in, width, depth, n_out, dev)
        cts = _cotangents(gen, n_sub, m_main, d_in, n_out, dev)
        res = K.pinn_mlp_fwd2_res(*args, n_out=n_out, act=act, d2_dirs=d2)[3]
        x, w, b, av = args
        calls = {
            "pinn_mlp_fwd2_res": (
                lambda: K.pinn_mlp_fwd2_res(*args, n_out=n_out, act=act,
                                            d2_dirs=d2),
                lambda: K.pinn_mlp_fwd2_res_plain(*args, n_out=n_out,
                                                  act=act, d2_dirs=d2)),
            "pinn_mlp_bwd2": (
                lambda: K.pinn_mlp_bwd2(x, w, av, res, *cts, n_out=n_out,
                                        act=act, d2_dirs=d2),
                lambda: K.pinn_mlp_bwd2_plain(x, w, av, res, *cts,
                                              n_out=n_out, act=act,
                                              d2_dirs=d2))}
        for name, (kern, plain) in calls.items():
            bms, by, nbytes, flops = train_bound(n_sub, m_main, d_in, width,
                                                 depth, n_out, len(d2), name)
            row = {"kernel": name, "shape": f"n_sub={n_sub} m={m_main} "
                   f"w{width}x{depth} d_in={d_in} d2={list(d2)}",
                   "ms": _graph_ms(kern, 200),
                   "call_ms": _events_ms(kern, 200),
                   "plain_ms": _events_ms(plain, 20), "bound_ms": bms,
                   "bound_by": by, "bytes": nbytes, "flops": flops}
            out[(name, width, depth, m_main)] = row
            emit({"timing": row})
    return out


def _train_setup(device, seed=SEED):
    """The quickstart's model, batch and trainer on ``device``."""
    from repro_torch.core import (Burgers1D, CartesianDecomposition, DDConfig,
                                  ReferenceTrainer, XPINN, build_topology)
    from repro_torch.core.nets import MLPConfig, SubdomainModelConfig
    from repro_torch.data import make_batch

    pde = Burgers1D()
    dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
    topo = build_topology(dec, n_iface=20)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 4)})
    batch = make_batch(dec, topo, pde, n_res=1000, n_bnd=80,
                       rng=np.random.default_rng(seed))
    trainer = ReferenceTrainer(pde, cfg, topo,
                               DDConfig(method=XPINN, residual_path="fused"),
                               lrs=2e-3, device=device)
    return trainer, batch.device_arrays(trainer.device)


def _rows(b) -> int:
    """Megabatch rows per subdomain: residual, interface and data points."""
    return int(b.res_pts.shape[1] + b.iface_pts.shape[1] * b.iface_pts.shape[2]
               + b.data_pts.shape[1])


def train_phase(dev) -> dict:
    """The quickstart on the card through the port's entry point, its
    launch counts, a 10-step card-vs-CPU trajectory and the step time."""
    import torch
    from repro_torch.core import TrainState
    from repro_torch.core.nets import map_tree, tree_leaves
    from repro_torch.kernels import pinn_mlp as K
    from repro_torch.launch import quickstart
    from repro_torch.optim.adam import init_adam

    steps = 1500
    buf = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = quickstart.main(["--device", "cuda", "--steps", str(steps),
                              "--chunk", "250"])
    secs = time.perf_counter() - t0
    counts, plain = dict(K.launches), dict(K.plain_calls)
    report = json.loads(buf.getvalue().strip().splitlines()[-1])["quickstart"]
    check(rc == 0, f"quickstart exited {rc}")
    check(report["rel_l2"] < 0.5, f"rel-L2 {report['rel_l2']:.4f} >= 0.5")
    for k in ("pinn_mlp_fwd2_res", "pinn_mlp_bwd2"):
        check(counts[k] == steps, f"{k}: {counts[k]} launches for {steps} "
                                  "loss evaluations")
    check(counts["pinn_mlp_fwd1"] > 0, "rel-L2 evaluation never ran K1")
    check(not any(plain.values()), f"plain versions on CUDA tensors: {plain}")
    emit({"train": {
        "seconds": round(secs, 3), "rel_l2": report["rel_l2"],
        "chunks": [{"step": r["step"], "steps_per_s": r["steps_per_s"],
                    "rel_l2": r["rel_l2"]} for r in report["chunks"]],
        "launches": counts, "plain_calls_on_cuda": plain}})

    # 10 steps from one init on the card (kernels) and on the CPU (plain)
    tr_gpu, b_gpu = _train_setup(dev)
    tr_cpu, b_cpu = _train_setup("cpu")
    s_cpu = tr_cpu.init(SEED)
    p_gpu = map_tree(lambda t: t.to(dev), s_cpu.params)
    s_gpu = TrainState(params=p_gpu, opt=init_adam(p_gpu),
                       step=s_cpu.step.to(dev))
    s_gpu, t_gpu = tr_gpu.run_chunk(s_gpu, b_gpu, 10)
    s_cpu, t_cpu = tr_cpu.run_chunk(s_cpu, b_cpu, 10)
    term_err = max(float(((t_gpu[k].cpu() - t_cpu[k]).abs()
                          / t_cpu[k].abs().clamp(min=1e-6)).max())
                   for k in t_cpu)
    par_err = max(float((g.cpu() - c).abs().max()) for g, c in
                  zip(tree_leaves(s_gpu.params), tree_leaves(s_cpu.params)))
    check(term_err <= TRAJ_RTOL, f"10-step terms card vs CPU: {term_err:.3e}")
    check(par_err <= TRAJ_ATOL, f"10-step params card vs CPU: {par_err:.3e}")

    # ms per training step at the quickstart shape, over a chunk
    trainer, b = _train_setup(dev)
    state = trainer.init(SEED)
    state, _ = trainer.run_chunk(state, b, 20)       # warm-up
    torch.cuda.synchronize()
    n = 200
    t0 = time.perf_counter()
    state, terms = trainer.run_chunk(state, b, n)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    emit({"train_check": {
        "traj_term_rel_err": term_err, "traj_param_abs_err": par_err,
        "traj_rtol": TRAJ_RTOL, "traj_atol": TRAJ_ATOL,
        "step_ms": step_ms, "m_per_sub": _rows(b)}})
    return {"launches": counts, "step_ms": step_ms}


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
    worst.update(train_sweep(dev))
    _, b_main = _train_setup("cpu")
    m_train = _rows(b_main)
    times = timing(dev)
    times.update(train_timing(dev, m_train))
    launches = serve_phase(dev)
    train = train_phase(dev)
    for k, v in train["launches"].items():
        launches[k] = launches.get(k, 0) + v
    t3 = times[("pinn_mlp_fwd2_res", 24, 4, m_train)]
    t4 = times[("pinn_mlp_bwd2", 24, 4, m_train)]
    emit({"train_step": {
        "step_ms": train["step_ms"], "forward_kernel_ms": t3["ms"],
        "backward_kernel_ms": t4["ms"],
        "other_ms": train["step_ms"] - t3["ms"] - t4["ms"]}})

    kernels = []
    shapes = {"pinn_mlp_fwd1": MAIN, "pinn_mlp_fwd2": MAIN,
              "pinn_mlp_fwd2_res": (24, 4, m_train),
              "pinn_mlp_bwd2": (24, 4, m_train)}
    for name, shape in shapes.items():
        t = times[(name, *shape)]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
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
                       "results": RECORD,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    emit({"kernels": kernels})
    print(smi.splitlines()[0])
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
