"""Quickstart: solve viscous Burgers with a space-time XPINN (paper §7.5).

Counterpart of the reference's ``examples/quickstart.py``: decompose
(-1, 1) x (0, 1) into nx x nt space-time subdomains, one network each
(``MLPConfig(2, 1, 24, 4)``), train with Adam (lr 2e-3) in chunks of outer
steps, and validate against the Cole-Hopf exact solution (rel-L2 < 0.5, the
reference's bar).

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--steps 1500]

With ``--supervised`` the run goes through the fault-tolerant chunk
supervisor (:mod:`repro_torch.runtime`): guarded chunks checkpointed to
``--ckpt``, crash/NaN recovery, and ELASTIC ``--resume`` — a checkpoint taken
at one ``--nx/--nt`` restarts at another via nearest-centroid parameter
adoption.  ``--inject`` drives the fault matrix (storage faults such as
``ckpt.bit_flip@2`` compose with it)::

    PYTHONPATH=src python -m repro_torch.launch.quickstart --supervised \
        --ckpt /tmp/ck --inject 'crash@1,nan_params@2:0,straggler@3*0.1'
    PYTHONPATH=src python -m repro_torch.launch.quickstart --supervised \
        --ckpt /tmp/ck6 --nx 3 --resume /tmp/ck --steps 2000

It runs on the CUDA card (the fused path launches the K3 forward and the K4
reverse sweep once per step, and the rel-L2 check the K1 kernel through the
serving engine) unless ``--device cpu`` is given.  Prints one line per chunk
(step, loss, rel-L2, steps/s over the chunk's training; under
``--supervised`` the supervisor's events instead) and, last, one JSON
object with the final rel-L2 and the per-chunk rows or, under
``--supervised``, the supervisor's report.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.core import (Burgers1D, CartesianDecomposition, DDConfig,
                              ReferenceTrainer, XPINN, build_topology,
                              evaluate_l2, restore_train_state,
                              save_train_state)
from repro_torch.core.nets import MLPConfig, SubdomainModelConfig
from repro_torch.data import make_batch

BAR = 0.5  # rel-L2 the run must reach (the reference quickstart's assert)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _supervised(args, trainer, decomp, state, b, l2) -> int:
    """Train under the chunk supervisor (``--supervised``)."""
    from repro_torch.runtime import (ChaosInjector, Supervisor,
                                     SupervisorConfig, elastic_resume,
                                     parse_faults)

    resumed = None
    if args.resume:
        state, meta = elastic_resume(args.resume, trainer, decomp)
        sig = (meta.get("supervisor") or {}).get("decomp") or {}
        resumed = {"from": args.resume, "step": int(state.step),
                   "n_sub_from": sig.get("n_sub", decomp.n_sub),
                   "n_sub": decomp.n_sub}
        print(f"[quickstart] elastic resume from {args.resume} at step "
              f"{resumed['step']} (checkpoint n_sub={resumed['n_sub_from']} "
              f"-> {decomp.n_sub})")
    chunk = max(args.chunk, 1)
    cfg_sup = SupervisorConfig(
        chunk_steps=chunk,
        ckpt_every_chunks=(max(1, args.save_every // chunk)
                           if args.save_every else 1))
    # ChaosInjector so storage faults (ckpt.bit_flip@2, ...) compose with
    # the compute matrix in the same --inject spec; without any it behaves
    # exactly like the plain FaultInjector
    injector = (ChaosInjector(parse_faults(args.inject),
                              roots={"ckpt": args.ckpt})
                if args.inject else None)
    sup = Supervisor(trainer, args.ckpt, cfg_sup, injector, decomp=decomp)
    state, report = sup.run(state, b, args.steps)
    for ev in report.events:
        print(f"[supervisor] {ev}")
    print(f"[supervisor] chunks={report.chunks} restarts={report.restarts}"
          f" crashes={report.crashes} guard_trips={report.guard_trips} "
          f"stragglers={report.stragglers} corruptions={report.corruptions}")
    err = l2(state)
    print(f"[quickstart] final rel L2 error vs Cole-Hopf exact: {err:.4f}")
    rep = report.as_dict()
    summary = {k: v for k, v in rep.items() if isinstance(v, int)}
    summary.update(walltimes=rep["walltimes"], recovery_s=rep["recovery_s"],
                   events=rep["events"])
    print(json.dumps({"quickstart": {
        "device": str(trainer.device), "path": args.path,
        "steps": int(state.step), "rel_l2": err,
        "resumed": resumed, "supervisor": summary}}))
    assert err < BAR, "did not converge"
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--nx", type=int, default=2)
    ap.add_argument("--nt", type=int, default=2)
    ap.add_argument("--path", choices=("jvp", "fused"), default="fused",
                    help="residual evaluation: the fused kernels (default) "
                         "or the per-point jvp oracle")
    ap.add_argument("--chunk", type=int, default=250,
                    help="outer steps per chunk (1: one step per call)")
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint the TrainState every N steps (0 = off)")
    ap.add_argument("--ckpt", default="ckpt_quickstart",
                    help="checkpoint directory for --save-every")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="resume from the latest checkpoint under DIR")
    ap.add_argument("--supervised", action="store_true",
                    help="route training through the fault-tolerant chunk "
                         "supervisor: checkpoints to --ckpt, recovers crashes "
                         "and NaN divergence, and makes --resume ELASTIC (the "
                         "checkpoint may have been taken at a different "
                         "--nx/--nt)")
    ap.add_argument("--inject", default=None, metavar="SPEC",
                    help="fault schedule for --supervised: comma-separated "
                         "kind@chunk[:subdomain][*delay] items, e.g. "
                         "'crash@1,nan_params@2:0,straggler@3*0.5'")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    if args.inject and not args.supervised:
        ap.error("--inject requires --supervised")

    pde = Burgers1D()
    decomp = CartesianDecomposition(((-1, 1), (0, 1)), args.nx, args.nt)
    topo = build_topology(decomp, n_iface=20)
    print(f"[quickstart] {decomp.n_sub} space-time subdomains, "
          f"{int(topo.edge_mask.sum()) // 2} interfaces, {topo.n_slots} "
          "exchange slots")

    model_cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 4)})
    batch = make_batch(decomp, topo, pde, n_res=1000, n_bnd=80,
                       rng=np.random.default_rng(0))
    trainer = ReferenceTrainer(pde, model_cfg, topo,
                               DDConfig(method=XPINN,
                                        residual_path=args.path),
                               lrs=2e-3, device=args.device)
    dev = trainer.device
    state = trainer.init(0)
    done = 0
    if args.resume and not args.supervised:
        state = restore_train_state(args.resume, state)
        done = int(state.step)
        print(f"[quickstart] resumed from {args.resume} at step {done}")
    b = batch.device_arrays(dev)
    l2 = lambda st: evaluate_l2(decomp, model_cfg, st.params,
                                trainer.act_codes, pde, device=dev)

    if args.supervised:
        return _supervised(args, trainer, decomp, state, b, l2)

    rows = []
    while done < args.steps:
        n = min(max(args.chunk, 1), args.steps - done)
        _sync(dev)
        t0 = time.perf_counter()
        state, terms = trainer.run_chunk(state, b, n)
        loss = float(terms["loss"][-1].sum())   # waits for the chunk
        secs = time.perf_counter() - t0
        prev, done = done, done + n
        if args.save_every and done // args.save_every > prev // \
                args.save_every:
            save_train_state(args.ckpt, state)
        err = l2(state)
        rows.append({"step": done, "loss": loss, "rel_l2": err,
                     "steps_per_s": n / secs})
        print(f"[quickstart] step {done:5d} loss={loss:8.4f} rel_L2={err:.4f}"
              f" ({n / secs:.1f} steps/s)")

    err = l2(state)
    print(f"[quickstart] final rel L2 error vs Cole-Hopf exact: {err:.4f}")
    print(json.dumps({"quickstart": {"device": str(dev), "path": args.path,
                                     "steps": done, "chunks": rows,
                                     "rel_l2": err}}))
    assert err < BAR, "did not converge"
    return 0


if __name__ == "__main__":
    sys.exit(main())
