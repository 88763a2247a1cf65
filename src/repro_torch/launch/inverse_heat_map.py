"""Inverse heat conduction on a 10-region irregular map (paper §7.6, Figs 11-13).

Counterpart of the reference's ``examples/inverse_heat_map.py``: the
variable conductivity K(x, y) is inferred from temperature observations.
Each of the 10 irregular (non-convex) polygonal regions gets TWO networks
(a T-net ``u`` and a K-net ``k``, ``MLPConfig(2, 1, 40, 3)`` each) with
the per-region activations of the paper's Table 3 and heterogeneous
residual-point counts; XPINN residual and solution continuity stitch the
regions.  Adam at lr 6e-3, data weight 40, seed 0.

    PYTHONPATH=src python -m repro_torch.launch.inverse_heat_map [--steps 2000]
    PYTHONPATH=src python -m repro_torch.launch.inverse_heat_map \
        --export /tmp/field --serve-demo

Train -> export -> serve: ``--export DIR`` freezes the trained networks and
the geometry into a serve bundle, ``--serve-demo`` loads it back
(``serve.load_bundle``) and serves a dense K(x, y) grid through the
stitched engine (``serve.FieldEngine``) behind the caching frontend
(``serve.ServeFrontend(order=2)``), cold and cached; points outside the map
come back NaN.  ``--supervised`` routes training through the
fault-tolerant chunk supervisor with elastic ``--resume``; ``--inject``
drives its fault matrix.

With the Table-3 mixed activations the run launches no kernel, as in the
reference: training takes the per-point jvp path (the fused path needs one
shared activation) and serving the select path, which is plain tensor
code.  :func:`build_problem` with one shared activation and
``residual_path="fused"`` trains through K3/K4 instead.  It runs on the
CUDA card unless ``--device cpu`` is given.  Prints the reference's lines,
then the serve demo's, and last one JSON object with the final rel-L2 of
(T, K), the per-chunk rows and the serve numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import (DDConfig, HeatConduction2D, LossWeights,
                              ReferenceTrainer, XPINN, build_topology,
                              evaluate_l2, restore_train_state,
                              save_train_state, us_map_decomposition)
from repro_torch.core.domain import Decomposition, Topology
from repro_torch.core.nets import MLPConfig, SubdomainModelConfig
from repro_torch.data import make_batch
from repro_torch.data.points import StackedBatch

# paper Table 3 (scaled /10, as in the reference example): residual points
# and activation per region
TABLE3_COUNTS = [300, 400, 500, 400, 300, 400, 80, 300, 500, 400]
TABLE3_ACTS = ["tanh", "sin", "cos", "tanh", "sin", "cos", "tanh", "sin",
               "cos", "tanh"]
N_IFACE = 16
REPORT_EVERY = 250


@dataclass
class Problem:
    pde: HeatConduction2D
    decomp: Decomposition
    topo: Topology
    model_cfg: SubdomainModelConfig
    batch: StackedBatch
    trainer: ReferenceTrainer
    act_codes: list

    def rel_l2(self, params) -> float:
        """rel-L2 of (T, K) stacked against the exact fields."""
        return evaluate_l2(self.decomp, self.model_cfg, params,
                           self.trainer.act_codes, self.pde,
                           device=self.trainer.device)


def build_problem(width: int = 40, counts=TABLE3_COUNTS,
                  act_codes=TABLE3_ACTS, balance: bool = False,
                  residual_path: str = "jvp", device=None,
                  seed: int = 0) -> Problem:
    """The example's problem: the us_map's 10 regions, 16 interface points
    per edge, nets u and k of ``MLPConfig(2, 1, width, 3)``, ``counts``
    residual points per region (``balance``: their mean everywhere), 48
    boundary and 150 interior observation points, XPINN with data weight
    40, lr 6e-3, points and weights from ``seed``.  The paper's size is
    ``width=80`` and ``counts=10 * TABLE3_COUNTS``."""
    pde = HeatConduction2D()
    decomp = us_map_decomposition()
    topo = build_topology(decomp, n_iface=N_IFACE)
    model_cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, width, 3),
                                           "k": MLPConfig(2, 1, width, 3)})
    batch = make_batch(decomp, topo, pde, list(counts), n_bnd=48,
                       rng=np.random.default_rng(seed), n_interior_data=150,
                       balance=balance)
    trainer = ReferenceTrainer(
        pde, model_cfg, topo,
        DDConfig(method=XPINN, weights=LossWeights(data=40.0),
                 residual_path=residual_path),
        act_codes=list(act_codes), lrs=6e-3, device=device)
    return Problem(pde, decomp, topo, model_cfg, batch, trainer,
                   list(act_codes))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def grid_points(decomp, grid_n: int = 80) -> np.ndarray:
    """A ``grid_n`` x ``grid_n`` grid over the map's bounding box, (N, 2)."""
    verts = np.concatenate(decomp.polygons)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], grid_n),
                         np.linspace(lo[1], hi[1], grid_n))
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def serve_demo(export_dir: str, grid_n: int = 80, device=None) -> dict:
    """Load the exported bundle and serve the inferred K(x, y) field on a
    ``grid_n`` x ``grid_n`` grid over the map's bounding box: cold, then
    the repeated grid from the frontend's cache."""
    from repro_torch.serve import FieldEngine, ServeFrontend, load_bundle

    bundle = load_bundle(export_dir)
    engine = FieldEngine(bundle, device=device)
    frontend = ServeFrontend(engine, order=2)
    grid = grid_points(bundle.decomp, grid_n)

    t0 = time.perf_counter()
    out = frontend.query(grid)            # cold: one dispatch
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out2 = frontend.query(grid)           # repeated dashboard grid: cache hit
    t_hot = time.perf_counter() - t0
    assert all(np.array_equal(out[k], out2[k], equal_nan=True) for k in out)

    inside = ~np.isnan(out["u"][:, 0])
    ex = bundle.pde.exact(grid[inside])
    kd = out["u"][inside, 1] - ex[:, 1]
    rel = float(np.linalg.norm(kd) / np.linalg.norm(ex[:, 1]))
    res = np.abs(out["residual"][inside, 0])
    n = len(grid)
    hot = max(t_hot, 1e-9)
    stats = frontend.stats()
    print(f"[serve] {n} grid points ({inside.sum()} inside the map): "
          f"cold {n / t_cold:,.0f} pts/s, cached {n / hot:,.0f} pts/s "
          f"({t_cold / hot:.0f}x)")
    print(f"[serve] served K field rel_L2 vs exact: {rel:.4f}; "
          f"residual error-proxy median {np.median(res):.3e} "
          f"p99 {np.quantile(res, 0.99):.3e}")
    print(f"[serve] frontend stats: {stats}")
    return {"points": n, "inside": int(inside.sum()),
            "cold_pts_per_s": n / t_cold, "cached_pts_per_s": n / hot,
            "k_rel_l2": rel, "residual_median": float(np.median(res)),
            "residual_p99": float(np.quantile(res, 0.99)),
            "dispatches": engine.n_dispatches, "frontend": stats}


def _supervised(args, prob: Problem, state, b, done):
    from repro_torch.runtime import (FaultInjector, Supervisor,
                                     SupervisorConfig, elastic_resume,
                                     parse_faults)

    if args.resume:
        state, _ = elastic_resume(args.resume, prob.trainer, prob.decomp)
        done = int(state.step)
        print(f"[inverse] elastic resume from {args.resume} at step {done}")
    chunk = max(args.chunk, 1)
    cfg_sup = SupervisorConfig(
        chunk_steps=chunk,
        ckpt_every_chunks=(max(1, args.save_every // chunk)
                           if args.save_every else 1))
    injector = (FaultInjector(parse_faults(args.inject))
                if args.inject else None)
    sup = Supervisor(prob.trainer, args.ckpt, cfg_sup, injector,
                     decomp=prob.decomp)
    state, report = sup.run(state, b, args.steps)
    for ev in report.events:
        print(f"[supervisor] {ev}")
    print(f"[supervisor] chunks={report.chunks} restarts={report.restarts}"
          f" crashes={report.crashes} guard_trips={report.guard_trips} "
          f"stragglers={report.stragglers}")
    rep = report.as_dict()
    summary = {k: v for k, v in rep.items() if isinstance(v, int)}
    summary.update(walltimes=rep["walltimes"], recovery_s=rep["recovery_s"],
                   events=rep["events"])
    return state, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--balance", action="store_true",
                    help="equalize per-region residual points (straggler fix)")
    ap.add_argument("--chunk", type=int, default=250,
                    help="outer steps per chunk")
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint the TrainState every N steps (0 = off)")
    ap.add_argument("--ckpt", default="ckpt_inverse",
                    help="checkpoint directory for --save-every")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="resume from the latest checkpoint under DIR")
    ap.add_argument("--supervised", action="store_true",
                    help="route training through the fault-tolerant chunk "
                         "supervisor (checkpoints to --ckpt, recovers crashes "
                         "and NaN divergence; --resume becomes elastic)")
    ap.add_argument("--inject", default=None, metavar="SPEC",
                    help="fault schedule for --supervised: comma-separated "
                         "kind@chunk[:subdomain][*delay] items")
    ap.add_argument("--export", default=None, metavar="DIR",
                    help="freeze the trained field into a serve bundle")
    ap.add_argument("--serve-demo", action="store_true",
                    help="after training, load the --export bundle and serve "
                         "a dense K(x,y) grid (cold vs cached)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    if args.serve_demo and not args.export:
        ap.error("--serve-demo requires --export DIR")
    if args.inject and not args.supervised:
        ap.error("--inject requires --supervised")

    prob = build_problem(balance=args.balance, device=args.device)
    trainer, dev = prob.trainer, prob.trainer.device
    print(f"[inverse] 10 irregular regions, "
          f"{int(prob.topo.edge_mask.sum()) // 2} interfaces, max degree "
          f"{prob.topo.max_degree}")
    state = trainer.init(0)
    done = 0
    if args.resume and not args.supervised:
        state = restore_train_state(args.resume, state)
        done = int(state.step)
        print(f"[inverse] resumed from {args.resume} at step {done}")
    b = prob.batch.device_arrays(dev)

    rows, summary = [], None
    if args.supervised:
        state, summary = _supervised(args, prob, state, b, done)
    else:
        t_start, t_done = time.perf_counter(), done
        while done < args.steps:
            n = min(max(args.chunk, 1), args.steps - done)
            _sync(dev)
            t0 = time.perf_counter()
            state, terms = trainer.run_chunk(state, b, n)
            loss = float(terms["loss"][-1].sum())   # waits for the chunk
            secs = time.perf_counter() - t0
            prev, done = done, done + n
            if args.save_every and done // args.save_every > \
                    prev // args.save_every:
                save_train_state(args.ckpt, state)
            row = {"step": done, "loss": loss, "steps_per_s": n / secs,
                   "rel_l2": None}
            if done == args.steps or done // REPORT_EVERY > \
                    prev // REPORT_EVERY:
                row["rel_l2"] = err = prob.rel_l2(state.params)
                rate = (done - t_done) / (time.perf_counter() - t_start)
                print(f"[inverse] step {done:5d} loss={loss:9.4f} "
                      f"rel_L2(T,K)={err:.4f} ({rate:.1f} it/s)")
            rows.append(row)

    err = prob.rel_l2(state.params)
    print(f"[inverse] final rel L2 error (T, K stacked) vs exact: {err:.4f}")

    served = path = None
    if args.export:
        from repro_torch.serve import export_bundle

        path = export_bundle(args.export, state.params, prob.model_cfg,
                             prob.decomp, act_codes=prob.act_codes,
                             pde=prob.pde, n_iface=N_IFACE,
                             step=int(state.step),
                             metadata={"rel_l2": err,
                                       "steps": int(state.step)})
        print(f"[inverse] exported field bundle -> {path}")
    if args.serve_demo:
        served = serve_demo(args.export, device=dev)
    out = {"device": str(dev), "steps": int(state.step), "chunks": rows,
           "rel_l2": err, "export": path, "serve": served}
    if summary is not None:
        out["supervisor"] = summary
    print(json.dumps({"inverse": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
