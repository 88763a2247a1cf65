"""Training launcher: the paper's PINN experiments (``pinn``) and the LM
architectures (``lm``).

Counterpart of the reference package's ``launch/train.py``::

    PYTHONPATH=src python -m repro_torch.launch.train pinn --pde burgers1d \\
        --method xpinn --nx 4 --nt 2 --steps 2000 --ckpt-dir /tmp/run --resume
    PYTHONPATH=src python -m repro_torch.launch.train pinn --distributed \\
        --nx 2 --nt 2 --steps 20 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train lm --arch llama3.2-1b \\
        --reduced --steps 50 --batch 4 --seq 256 --ckpt-dir /tmp/lm --resume \\
        [--device cpu]

``pinn`` trains any PDE of the registry: ``heat2d_inverse`` on the US-map
decomposition with two nets (u and the conductivity k), the others on a
Cartesian space-time decomposition; it logs the summed loss every
``--log-every`` steps, checkpoints every ``--ckpt-every`` steps (the
reference's ``{"params", "opt"}`` layout and metadata), resumes with
``--resume`` and prints the rel-L2 error against the exact solution at the
end where the PDE has one.

``--distributed`` runs :class:`~repro_torch.core.DistributedDDTrainer`:
one rank per subdomain (``repro_torch.launch.mesh``, ``gloo``), every rank
on the card (they share it) or, with ``--device cpu``, on the CPU.  It
prints the backend, the ranks and each rank's device.  Unlike the
reference, it never falls back to the single-process trainer.  The
residual path is the reference's ``DDConfig`` default (``jvp``).

``lm`` trains any of the seven families (dense, vlm, mla, moe, rwkv,
hybrid, encdec) on the synthetic token pipeline with the reference's
recipe: each step a fresh batch (``make_batch(..., seed=seed * 100003 +
step)``), ``CausalLM.loss`` and its gradient (per-layer remat, the chunked
fused head cross-entropy; on the card K5 or K6 in every layer's forward,
K5 once a stage in zamba2's shared attention, once an encoder layer and
twice a decoder layer in the encoder-decoder), the global norm clipped to
1.0, ``warmup_cosine(warmup=20)`` and Adam.  ``--reduced`` and ``--preset
100m`` are the reference's configs; ``--n-layers`` cuts the depth (the
encoder-decoder's two stacks alike; the card holds seven float32 copies
of the params at the step's peak).  For the VLM ``--seq`` counts its
patches and its tokens, as the reference's batch does, so it must exceed
the config's ``n_patches``; the encoder-decoder's batch adds ``seq //
enc_ratio`` frames.  It
checkpoints ``{"params", "opt"}`` with ``{"step", "arch"}`` every
``--ckpt-every`` steps in the reference's layout (either package resumes
the other's) and resumes with ``--resume``; a resumed run repeats the
uninterrupted one bit for bit on one device.

Both run on the CUDA card unless ``--device cpu`` is given.  The last
line is one JSON object: for ``pinn`` the final summed loss, the rel-L2
error, the steps and the trainer; for ``lm`` (key ``train_lm``) the arch,
the device, the steps, the losses and tokens per second.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import (CartesianDecomposition, DDConfig,
                              DistributedDDTrainer, LossWeights,
                              ReferenceTrainer, TrainState, build_topology,
                              evaluate_l2, us_map_decomposition)
from repro_torch.core.losses import METHODS
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig, map_tree,
                                   tree_leaves, tree_unflatten)
from repro_torch.core.pdes import REGISTRY as PDE_REGISTRY
from repro_torch.core.trainer import _fit_count
from repro_torch.data import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models import expert_parallel as EP
from repro_torch.models import make_batch as make_lm_batch
from repro_torch.obs.profiling import scope
from repro_torch.optim import adam as adam_lib


# ------------------------------------------------------------------------ PINN

def _problem(args):
    """(pde, decomposition, model config, topology, host batch, DDConfig)
    from the flags, as the reference's ``run_pinn`` builds them."""
    pde = PDE_REGISTRY[args.pde]()
    if args.pde == "heat2d_inverse":
        decomp = us_map_decomposition()
        nets = {"u": MLPConfig(2, 1, args.width, args.depth),
                "k": MLPConfig(2, 1, args.width, args.depth)}
        n_interior = args.n_data
    else:
        if args.pde == "burgers1d":
            bounds = ((-1.0, 1.0), (0.0, 1.0))
        elif args.pde == "euler1d":
            bounds = ((0.0, 1.0), (0.0, 0.2))   # Sod shock tube, t in [0, 0.2]
        else:
            bounds = ((0.0, 1.0), (0.0, 1.0))
        decomp = CartesianDecomposition(bounds, args.nx, args.nt)
        nets = {"u": MLPConfig(2, pde.n_fields, args.width, args.depth)}
        n_interior = 0
    topo = build_topology(decomp, args.n_iface)
    model_cfg = SubdomainModelConfig(nets=nets)
    batch = make_batch(decomp, topo, pde, args.n_res, args.n_bnd,
                       np.random.default_rng(args.seed),
                       n_interior_data=n_interior, balance=args.balance)
    dd = DDConfig(method=METHODS[args.method], weights=LossWeights(),
                  couple_gradients=args.couple, local_steps=args.local_steps)
    return pde, decomp, model_cfg, topo, batch, dd


def _rank(trainer) -> int:
    return getattr(trainer, "rank", 0)


def _save(args, trainer, state, step: int) -> None:
    """The reference's checkpoint: the global params and moments, written
    by rank 0 (after which every rank waits)."""
    dist_ = isinstance(trainer, DistributedDDTrainer)
    g = trainer.gather_state(state) if dist_ else state
    if _rank(trainer) == 0:
        ckpt.save(args.ckpt_dir, step, {"params": g.params, "opt": g.opt},
                  {"step": step, "pde": args.pde, "method": args.method})
    if dist_:
        trainer.comm.barrier()


def _restore(args, trainer, state):
    """The latest checkpoint under ``--ckpt-dir`` (global, written by either
    trainer or by the reference) as this trainer's state; its step."""
    dist_ = isinstance(trainer, DistributedDDTrainer)
    like = trainer.gather_state(state) if dist_ else state
    tree, meta = ckpt.restore(args.ckpt_dir,
                              {"params": like.params, "opt": like.opt})
    tree = map_tree(lambda a: torch.as_tensor(np.asarray(a),
                                              device=trainer.device), tree)
    tree["opt"]["count"] = _fit_count(tree["opt"]["count"],
                                      like.opt["count"])
    start = int(meta["step"])
    glob = TrainState(params=tree["params"], opt=tree["opt"],
                      step=torch.tensor(start, dtype=torch.int32,
                                        device=trainer.device))
    return (trainer.shard_state(glob) if dist_ else glob), start


def _train(args, trainer, state, b, problem) -> dict:
    """The reference's step loop: resume, step, log, checkpoint, rel-L2."""
    pde, decomp, model_cfg = problem[:3]
    log = _rank(trainer) == 0
    start = 0
    if args.resume and args.ckpt_dir and \
            ckpt.latest_step(args.ckpt_dir) is not None:
        state, start = _restore(args, trainer, state)
        if log:
            print(f"[train] resumed from step {start}", flush=True)
    t0, terms = time.time(), None
    for s in range(start, args.steps):
        state, terms = trainer.step(state, b)
        if (s + 1) % args.log_every == 0 and log:
            loss = float(terms["loss"].sum())
            print(f"[train] step {s + 1}/{args.steps} loss={loss:.5f} "
                  f"({(s + 1 - start) / (time.time() - t0):.1f} it/s)",
                  flush=True)
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            _save(args, trainer, state, s + 1)
    out = {"loss": float(terms["loss"].sum()) if terms else None,
           "steps": args.steps, "start": start,
           "trainer": type(trainer).__name__,
           "device": str(trainer.device)}
    params = (trainer.gather_state(state).params
              if isinstance(trainer, DistributedDDTrainer) else state.params)
    if log and pde.exact(np.zeros((1, 2))) is not None:
        err = evaluate_l2(decomp, model_cfg, params, trainer.act_codes, pde,
                          device=trainer.device)
        out["rel_l2"] = err
        print(f"[train] rel L2 error vs exact: {err:.4f}", flush=True)
    if isinstance(trainer, DistributedDDTrainer):
        out["staged_bytes"] = trainer.comm.staged_bytes
    return out


def _pinn_rank(mesh, args) -> dict:
    """One rank of ``pinn --distributed``: its subdomain's trainer and
    shard."""
    import torch.distributed as dist

    problem = _problem(args)
    pde, decomp, model_cfg, topo, batch, dd = problem
    dev = mesh.rank_device(dist.get_rank())
    trainer = DistributedDDTrainer(pde, model_cfg, topo, dd, lrs=args.lr,
                                   device=dev)
    print(f"[train] rank {trainer.rank}/{mesh.n_sub}: subdomain "
          f"{trainer.rank} on {dev} ({mesh.backend})", flush=True)
    state = trainer.init(args.seed)
    b = trainer.shard_batch(batch.device_arrays(dev))
    return _train(args, trainer, state, b, problem)


def run_pinn(args) -> dict:
    dev = resolve_device(args.device)
    problem = _problem(args)
    pde, decomp, model_cfg, topo, batch, dd = problem
    if args.distributed:
        from repro_torch.launch import mesh as mesh_lib

        if dev.type == "cuda":   # one nvcc here, not one per rank
            from repro_torch.kernels import native
            native.build()
        with tempfile.TemporaryDirectory(prefix="pinn-ranks-") as store:
            mesh = mesh_lib.make_pinn_mesh(topo.n_sub, store, dev.type)
            devs = sorted({str(mesh.rank_device(r))
                           for r in range(mesh.n_sub)})
            print(f"[train] distributed: backend {mesh.backend}, "
                  f"{mesh.n_sub} ranks (one per subdomain) on "
                  f"{', '.join(devs)}", flush=True)
            return mesh_lib.run_ranks(mesh, _pinn_rank, args)[0]
    trainer = ReferenceTrainer(pde, model_cfg, topo, dd, lrs=args.lr,
                               device=dev)
    state = trainer.init(args.seed)
    return _train(args, trainer, state, batch.device_arrays(dev), problem)


# -------------------------------------------------------------------------- LM

def lm_config(args):
    """The model config of the ``lm`` flags: the arch, ``--reduced``,
    ``--preset 100m`` (the reference's replace) and ``--n-layers``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.preset == "100m":
        cfg = dataclasses.replace(
            cfg.reduced(), n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
            head_dim=64, d_ff=2048, vocab=32000, remat=False)
    if args.n_layers:
        cfg = dataclasses.replace(
            cfg, n_layers=args.n_layers,
            n_dec_layers=args.n_layers if cfg.n_dec_layers else 0)
    return cfg


def lm_train_step(model, params, opt, batch, step: int, peak_lr: float,
                  total: int):
    """One step of the reference's recipe: loss and gradient, the global
    norm clipped to 1.0, ``warmup_cosine(step, peak_lr, warmup=20,
    total)``, Adam.  Returns (params, opt, loss, grad norm).

    On a rank of an expert-parallel grid (``models/expert_parallel.py``,
    ``params`` holding its experts, ``batch`` its data shard) the loss and
    the gradients are averaged over the data group, the norm adds the
    expert leaves over the model group, and Adam updates the rank's
    shard.  With no such context the one-device step, unchanged."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    loss, grads = EP.mean_over_data(loss, list(grads))
    grads = tree_unflatten(params, grads)
    grads, gn = adam_lib.clip_by_global_norm(grads, 1.0,
                                             norm=EP.global_norm(grads))
    lr = adam_lib.warmup_cosine(torch.tensor(step, device=loss.device),
                                peak_lr, warmup=20, total=total)
    with scope("adam_update"):
        params, opt = adam_lib.adam_update(grads, opt, params, lr)
    return params, opt, loss.detach(), gn


def run_lm(args) -> dict:
    dev = resolve_device(args.device)
    cfg = lm_config(args)
    model = build_model(cfg, dev)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    params = model.init(args.seed)
    opt = adam_lib.init_adam(params)

    start = 0
    if args.resume and args.ckpt_dir and \
            ckpt.latest_step(args.ckpt_dir) is not None:
        tree, meta = ckpt.restore(args.ckpt_dir,
                                  {"params": params, "opt": opt})
        tree = map_tree(lambda a: torch.as_tensor(np.asarray(a), device=dev),
                        tree)
        params, opt = tree["params"], tree["opt"]
        start = int(meta["step"])
        print(f"[train] resumed from step {start}", flush=True)

    losses, step_s = [], []
    for s in range(start, args.steps):
        t0 = time.perf_counter()
        batch = make_lm_batch(cfg, shape, "train",
                              seed=args.seed * 100003 + s, device=dev)
        params, opt, loss, gn = lm_train_step(model, params, opt, batch, s,
                                              args.lr, args.steps)
        losses.append(float(loss))   # waits for the step's device work
        step_s.append(time.perf_counter() - t0)
        if (s + 1) % args.log_every == 0:
            print(f"[train] step {s + 1}/{args.steps} loss={losses[-1]:.4f} "
                  f"gnorm={float(gn):.3f} ({len(step_s) / sum(step_s):.2f} "
                  "it/s)", flush=True)
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, s + 1, {"params": params, "opt": opt},
                      {"step": s + 1, "arch": args.arch})
    tokens = args.batch * args.seq * len(step_s)
    return {"arch": args.arch, "device": str(dev), "steps": args.steps,
            "start": start, "layers": cfg.n_layers,
            "final_loss": losses[-1] if losses else None, "losses": losses,
            "step_s": step_s,
            "tokens_per_s": tokens / sum(step_s) if step_s else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)

    pp = sub.add_parser("pinn")
    pp.add_argument("--pde", default="burgers1d", choices=sorted(PDE_REGISTRY))
    pp.add_argument("--method", default="xpinn", choices=["cpinn", "xpinn"])
    pp.add_argument("--nx", type=int, default=4)
    pp.add_argument("--nt", type=int, default=1)
    pp.add_argument("--width", type=int, default=20)
    pp.add_argument("--depth", type=int, default=5)
    pp.add_argument("--n-res", type=int, default=1000)
    pp.add_argument("--n-bnd", type=int, default=80)
    pp.add_argument("--n-iface", type=int, default=20)
    pp.add_argument("--n-data", type=int, default=200)
    pp.add_argument("--steps", type=int, default=500)
    pp.add_argument("--lr", type=float, default=8e-4)
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--couple", action="store_true")
    pp.add_argument("--balance", action="store_true")
    pp.add_argument("--local-steps", type=int, default=1)
    pp.add_argument("--distributed", action="store_true",
                    help="one rank per subdomain (gloo process group)")
    pp.add_argument("--ckpt-dir", default=None)
    pp.add_argument("--ckpt-every", type=int, default=100)
    pp.add_argument("--log-every", type=int, default=50)
    pp.add_argument("--resume", action="store_true")
    pp.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")

    lp = sub.add_parser("lm")
    lp.add_argument("--arch", default="llama3.2-1b")
    lp.add_argument("--reduced", action="store_true")
    lp.add_argument("--preset", default=None, choices=[None, "100m"])
    lp.add_argument("--steps", type=int, default=50)
    lp.add_argument("--batch", type=int, default=4)
    lp.add_argument("--seq", type=int, default=256)
    lp.add_argument("--lr", type=float, default=3e-4)
    lp.add_argument("--seed", type=int, default=0)
    lp.add_argument("--ckpt-dir", default=None)
    lp.add_argument("--ckpt-every", type=int, default=25)
    lp.add_argument("--log-every", type=int, default=10)
    lp.add_argument("--resume", action="store_true")
    lp.add_argument("--n-layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    lp.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")

    args = ap.parse_args(argv)
    if args.mode == "lm":
        print(json.dumps({"train_lm": run_lm(args)}))
        return 0
    out = run_pinn(args)
    print(json.dumps({"train": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
