"""Lid-driven cavity with a distributed cPINN (paper §7.4, Fig 5).

Counterpart of the reference's ``examples/navier_stokes_cavity.py``: steady
incompressible Navier-Stokes at Re = 100 on [0, 1]^2, 2 x 2 subdomains
with normal-flux interface continuity (Table 1 fluxes), one net
``MLPConfig(2, 3, 40, 5)`` per subdomain for (u, v, p), Adam at lr 6e-4,
data weight 40, seed 0.  Validates the stitched centerline u-velocity
against Ghia et al.'s reference values.

    PYTHONPATH=src python -m repro_torch.launch.navier_stokes_cavity [--steps 4000]

The problem trains on the per-point jvp path, as in the reference;
:func:`build_problem` with ``residual_path="fused"`` trains it through
K3/K4 (one launch each per step).  It runs on the CUDA card unless
``--device cpu`` is given.  Prints the loss at every multiple of 500
steps, the centerline table and its RMS against Ghia, and last one JSON
object with the per-chunk rows, the centerline and the RMS.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import (CPINN, CartesianDecomposition, DDConfig,
                              LossWeights, NavierStokes2D, ReferenceTrainer,
                              build_topology, nets)
from repro_torch.core.domain import Topology
from repro_torch.core.nets import MLPConfig, SubdomainModelConfig, map_tree
from repro_torch.data import make_batch
from repro_torch.data.points import StackedBatch

# Ghia et al. (1982) Re=100: u along the vertical centerline x=0.5
GHIA_Y = np.array([0.0547, 0.1719, 0.2813, 0.4531, 0.5000, 0.6172, 0.7344,
                   0.8516, 0.9531])
GHIA_U = np.array([-0.0372, -0.1015, -0.1566, -0.2109, -0.2058, -0.1364,
                   0.0033, 0.2315, 0.6872])
REPORT_EVERY = 500   # chunks stop at every multiple of it


@dataclass
class Problem:
    pde: NavierStokes2D
    decomp: CartesianDecomposition
    topo: Topology
    model_cfg: SubdomainModelConfig
    batch: StackedBatch
    trainer: ReferenceTrainer


def build_problem(width: int = 40, residual_path: str = "jvp", device=None,
                  seed: int = 0) -> Problem:
    """The example's problem: 2 x 2 subdomains of the unit square, 32
    interface points per edge, ``MLPConfig(2, 3, width, 5)``, 1500 residual
    and 120 boundary points per subdomain, cPINN with data weight 40, lr
    6e-4, points and weights from ``seed``.  The paper's width is 80."""
    pde = NavierStokes2D(re=100.0)
    decomp = CartesianDecomposition(((0, 1), (0, 1)), 2, 2)
    topo = build_topology(decomp, n_iface=32)
    model_cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 3, width, 5)})
    batch = make_batch(decomp, topo, pde, n_res=1500, n_bnd=120,
                       rng=np.random.default_rng(seed))
    trainer = ReferenceTrainer(
        pde, model_cfg, topo,
        DDConfig(method=CPINN, weights=LossWeights(data=40.0),
                 residual_path=residual_path),
        lrs=6e-4, device=device)
    return Problem(pde, decomp, topo, model_cfg, batch, trainer)


def centerline(prob: Problem, params) -> np.ndarray:
    """The stitched u-velocity at Ghia's points on x = 0.5 (eq. 4): each
    point from the subdomain that contains it (the first of two on an
    interface, as the reference's loop leaves it)."""
    pts = np.stack([np.full_like(GHIA_Y, 0.5), GHIA_Y],
                   axis=1).astype(np.float32)
    pred = np.zeros(len(pts))
    dev = prob.trainer.device
    with torch.no_grad():
        for q in range(prob.decomp.n_sub):
            inside = prob.decomp.subdomain_contains(q, pts)
            if inside.any():
                p_q = map_tree(lambda t: t[q], params)
                u = nets.model_apply(prob.model_cfg, p_q,
                                     torch.as_tensor(pts[inside],
                                                     device=dev),
                                     prob.trainer.act_codes[q])
                pred[inside] = u[:, 0].cpu().numpy()
    return pred


def ghia_rms(pred: np.ndarray) -> float:
    return float(np.sqrt(np.mean((pred - GHIA_U) ** 2)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--chunk", type=int, default=500,
                    help="outer steps per chunk")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    prob = build_problem(device=args.device)
    trainer, dev = prob.trainer, prob.trainer.device
    state = trainer.init(0)
    b = prob.batch.device_arrays(dev)

    rows, done, t_start = [], 0, time.perf_counter()
    while done < args.steps:
        n = min(max(args.chunk, 1), args.steps - done,
                REPORT_EVERY - done % REPORT_EVERY)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, terms = trainer.run_chunk(state, b, n)
        loss = float(terms["loss"][-1].sum())   # waits for the chunk
        secs = time.perf_counter() - t0
        done += n
        rows.append({"step": done, "loss": loss, "steps_per_s": n / secs})
        if done % REPORT_EVERY == 0 or done == args.steps:
            print(f"[cavity] step {done:5d} loss={loss:9.5f} "
                  f"({done / (time.perf_counter() - t_start):.1f} it/s)")

    pred = centerline(prob, state.params)
    rms = ghia_rms(pred)
    print("[cavity]   y      u_pred   u_Ghia")
    for y, up, ug in zip(GHIA_Y, pred, GHIA_U):
        print(f"[cavity] {y:6.4f} {up:8.4f} {ug:8.4f}")
    print(f"[cavity] centerline RMS error vs Ghia: {rms:.4f}")
    print(json.dumps({"cavity": {
        "device": str(dev), "steps": done, "chunks": rows,
        "centerline": pred.tolist(), "ghia_rms": rms}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
