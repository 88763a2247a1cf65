"""Algorithm 1's trainers: single-process, one rank per subdomain, and the
data-parallel baseline.

Counterpart of the reference package's ``core/trainer.py``:

* :class:`ReferenceTrainer` — every subdomain in one process on a leading
  ``n_sub`` axis; the kernels take that axis in their grid, so a step is
  one batched computation for all subdomains (the reference ``vmap``s);
  the exchange is a gather (:func:`halo.exchange_gather`).
* :class:`DistributedDDTrainer` — one rank per subdomain under
  ``torch.distributed`` (the paper's MPI + X; the reference's
  ``shard_map`` over a ``("sub",)`` mesh).  Each rank holds its own
  subdomain with a leading axis of 1, so the step body, the kernels, Adam
  and the guard are the single-process ones; the exchange is one P2P
  exchange per topology slot (:func:`halo.exchange_p2p`).
* :class:`DataParallelTrainer` — the paper's Fig. 1a baseline: one network
  on every worker, the points sharded, the gradient all-reduced as a mean
  (optionally int8 / top-k compressed with a per-worker error-feedback
  buffer), the learning rate scaled by the world size.

One outer step of the domain-decomposed trainers (:meth:`_DDCommon._outer_body`):

1. one megabatched :func:`losses.network_eval` with autograd on — on the
   fused path one K3 launch per field net for residual, interface and data
   points together (``dd-comp-forward``);
2. the exchange payload is a slice of that same forward, exchanged with the
   neighbours (``dd-comm-halo``) and detached unless ``couple_gradients``;
3. the loss is the sum over (local) subdomains of
   :func:`losses.assemble_subdomain_loss`, and ONE ``backward`` (one K4
   launch per field net) gives every subdomain's gradient: the received
   payload is a constant, so each subdomain's gradient is its own
   (``dd-comp-update``, with Adam);
4. Adam with per-subdomain learning rates.

``local_steps = k`` runs k Adam steps per exchange, each with a fresh
forward on the same frozen payload.

Chunks (``run_chunk``, ``run_chunk_guarded``) are a Python loop of outer
steps.  In one process there is no host synchronisation inside: the loss
terms stay on the device, stacked (steps, n_sub), and the guard decides on
the device with ``torch.where`` over the carried state.  Across ranks each
step's exchange (and, guarded, one MIN all-reduce of the ok flag) passes
through the host; the terms are stitched to (steps, n_sub) by one
all-gather per chunk.

One exception: ``ReferenceTrainer.run_chunk`` on the jvp path on a CUDA
card replays a CUDA graph of one outer step (:class:`_StepGraph`).  The
per-point ``torch.func`` transforms dispatch some 50,000 operations from the
host each step; replayed, a step costs the device's time only, with the
same result bit for bit.  That path launches none of the port's kernels,
so no launch count is lost.  Capturing the fused path's chunk is left to a
later change.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core import fused, halo, losses, nets
from repro_torch.core.domain import Decomposition, Topology
from repro_torch.core.losses import XPINN, LossWeights, SubBatch
from repro_torch.core.nets import (SubdomainModelConfig, map_tree, map_trees,
                                   tree_leaves, tree_unflatten)
from repro_torch.core.pdes import PDE
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs.profiling import scope
from repro_torch.optim import adam as adam_lib
from repro_torch.optim.compress import CompressionConfig, compress_decompress

RESIDUAL_PATHS = ("jvp", "fused")


@dataclass(frozen=True)
class DDConfig:
    method: int = XPINN
    weights: LossWeights = field(default_factory=LossWeights)
    couple_gradients: bool = False   # grads flow through the exchange
    local_steps: int = 1             # k Adam steps per exchange (k=1: Alg. 1)
    adam: adam_lib.AdamConfig = field(default_factory=adam_lib.AdamConfig)
    disable_exchange: bool = False   # ablation: comm replaced by own payload
    residual_path: str = "jvp"       # "jvp" (per-point closures) | "fused"
    backward_path: str = "fused"     # "fused" (K4 reverse sweep) | "ref"
                                     # (recompute oracle); fused path only
    telemetry: bool = False          # per-step metric rows on the terms


@dataclass
class TrainState:
    params: Any
    opt: dict
    step: torch.Tensor


# ------------------------------------------------------------- on-device health

def _sqnorm(tree) -> torch.Tensor:
    """Scalar sum of squares over all leaves (f32); NaN/Inf in any leaf makes
    it non-finite."""
    return sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))


def _stacked_sqnorm(tree) -> torch.Tensor:
    """(n_sub,) per-subdomain sum of squares over stacked (n_sub, ...)
    leaves."""
    return sum(torch.sum(torch.square(x.float()), dim=tuple(range(1, x.dim())))
               for x in tree_leaves(tree))


def _nan_like(terms: dict) -> dict:
    """NaN-filled stand-ins for the loss terms of a frozen step."""
    return {k: torch.full_like(v, float("nan")) for k, v in terms.items()}


def _traced_dispatch(trainer, name: str, steps, call):
    """Host-side chunk span around a public ``run_chunk*`` call.

    ``trainer.tracer is None`` (the default) takes ``call()`` verbatim.
    With a tracer attached the span brackets the chunk and ends after the
    device finished it (one synchronisation per chunk)."""
    tr = getattr(trainer, "tracer", None)
    if tr is None:
        return call()
    with tr.span(name, lane="train", steps=steps,
                 trainer=type(trainer).__name__):
        out = call()
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
    return out


def _telemetry_terms(terms: dict, params, grads, lr, stacked: bool) -> dict:
    """Per-step metric rows on the terms: ``grad_norm`` / ``param_norm``
    (per subdomain on stacked trees), the effective ``lr`` and the RMS
    interface disagreement ``iface_mismatch``."""
    norm = _stacked_sqnorm if stacked else _sqnorm
    t = dict(terms)
    t["grad_norm"] = torch.sqrt(norm(grads))
    t["param_norm"] = torch.sqrt(norm(params))
    t["lr"] = torch.broadcast_to(
        torch.as_tensor(lr, dtype=torch.float32,
                        device=t["loss"].device), t["loss"].shape)
    if "mse_avg" in t:
        t["iface_mismatch"] = torch.sqrt(t["mse_avg"] + t["mse_iface"])
    return t


def _batch_at(batch: SubBatch, i: int) -> SubBatch:
    """Step i of a batch stacked along a leading chunk axis."""
    return SubBatch(**{k: v[i] for k, v in vars(batch).items()})


def _stack_terms(rows: list[dict]) -> dict:
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


class _DDCommon:
    """Shared setup and the outer step: dispatch decisions, learning rates,
    masks, devices.  ``self._sl`` selects the subdomains this process
    holds: all of them (``ReferenceTrainer``) or its rank's one."""

    def __init__(
        self,
        pde: PDE,
        model_cfg: SubdomainModelConfig,
        topo: Topology,
        cfg: DDConfig,
        act_codes: Sequence[str | int] | None = None,
        lrs: float | Sequence[float] = 1e-3,
        width_fracs: dict[str, Sequence[float]] | None = None,
        device=None,
    ):
        self.pde, self.model_cfg, self.topo, self.cfg = pde, model_cfg, topo, cfg
        self.device = resolve_device(device)
        n = topo.n_sub
        self._act_codes_in = act_codes
        # optional repro_torch.obs.Tracer: host-side chunk spans
        self.tracer = None
        # fused-kernel dispatch needs one activation shared by all subdomains
        # (the kernels specialize on it) and a PDE with the batched
        # derivative-bundle methods; an explicitly requested fused path that
        # cannot be honoured is an error, not a silent fallback
        self.res_path = None
        if cfg.backward_path not in ops.BWD_PATHS:
            raise ValueError(f"unknown backward_path {cfg.backward_path!r}")
        if cfg.residual_path == "fused":
            act = (nets.uniform_model_act(model_cfg) if act_codes is None
                   else fused.uniform_act_name(act_codes))
            if act is None:
                raise ValueError(
                    "residual_path='fused' needs one activation shared by all "
                    f"subdomains; got {act_codes}")
            if not type(pde).supports_derivs():
                raise ValueError(
                    f"residual_path='fused': {pde.name} lacks "
                    "residual_from_derivs/flux_from_derivs")
            self.res_path = losses.ResidualPath(act=act,
                                                bwd=cfg.backward_path)
        elif cfg.residual_path not in RESIDUAL_PATHS:
            raise ValueError(f"unknown residual_path {cfg.residual_path!r}")
        lrs = np.full((n,), float(lrs)) if np.isscalar(lrs) else np.asarray(
            lrs)
        if lrs.shape != (n,):
            raise ValueError(f"lrs {lrs.shape} for {n} subdomains")
        self.lrs = torch.as_tensor(lrs, dtype=torch.float32,
                                   device=self.device)
        if act_codes is None:
            codes = [nets.act_code(nets.uniform_model_act(model_cfg))] * n
        else:
            codes = [nets.act_code(c) for c in act_codes]
            if len(codes) != n:
                raise ValueError(f"{len(codes)} act codes for {n} subdomains")
        self.act_codes = torch.as_tensor(codes, dtype=torch.int32,
                                         device=self.device)
        # per-subdomain width masks (paper: per-subdomain architectures)
        self.width_masks = None
        if width_fracs is not None:
            self.width_masks = {}
            for name, fr in width_fracs.items():
                w = model_cfg.nets[name].width
                m = np.zeros((n, w), np.float32)
                for q, f in enumerate(fr):
                    m[q, : max(1, int(round(f * w)))] = 1.0
                self.width_masks[name] = torch.as_tensor(m,
                                                         device=self.device)
        # what this process holds of the per-subdomain vectors
        self._sl = self._local_slice()
        self._lrs = self.lrs[self._sl]
        self._codes = self.act_codes[self._sl]
        self._wmasks = (None if self.width_masks is None else
                        {k: v[self._sl] for k, v in self.width_masks.items()})

    def _local_slice(self) -> slice:
        return slice(None)

    def init(self, seed: int = 0) -> TrainState:
        """Fresh state: weights drawn from ``torch.Generator`` seeded with
        ``seed`` (not the reference's ``jax.random`` numbers)."""
        params, _ = nets.stacked_init(self.model_cfg, self.topo.n_sub, seed,
                                      self._act_codes_in, self.device)
        return TrainState(params=params, opt=adam_lib.init_adam(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=self.device))

    def _net_eval(self, params, batch: SubBatch):
        """All network-dependent quantities of the held subdomains in one
        entry: (res, normal-projected own payload, data_pred)."""
        return losses.network_eval(self.pde, self.model_cfg, self.cfg.method,
                                   params, self._codes, self._wmasks,
                                   batch, self.res_path)

    def _assemble(self, batch: SubBatch, outs, recv):
        res, own, data_pred = outs
        return losses.assemble_subdomain_loss(
            self.pde, self.cfg.method, self.cfg.weights, batch, res, own,
            data_pred, recv["u"], recv["g"])

    # what differs between one process and one rank per subdomain
    def _exchange(self, own: dict) -> dict:
        raise NotImplementedError

    def _agree(self, ok_sub: torch.Tensor) -> torch.Tensor:
        """Every held subdomain healthy, across all processes (0-dim)."""
        return torch.all(ok_sub)

    def _stitch(self, tree: dict, dim: int) -> dict:
        """Per-subdomain rows of every process, along ``dim``."""
        return tree

    def _outer_body(self, params, opt, step, batch: SubBatch, lrs):
        """One outer step (exchange + ``local_steps`` Adam updates).  One
        network entry per loss evaluation: the exchange payload is a slice
        of the differentiated forward."""
        cfg = self.cfg
        terms = grads = None
        for i in range(cfg.local_steps):
            p = map_tree(lambda t: t.detach().requires_grad_(), params)
            with scope("comp_forward"):
                outs = self._net_eval(p, batch)
            if i == 0:  # communicate once per outer step (Algorithm 1)
                own = outs[1]
                if not cfg.couple_gradients:
                    own = {k: v.detach() for k, v in own.items()}
                recv = own if cfg.disable_exchange else self._exchange(own)
            else:  # the received payload stays frozen: a constant now
                recv = {k: v.detach() for k, v in recv.items()}
            with scope("comp_update"):
                total, terms = self._assemble(batch, outs, recv)
                leaves = tree_leaves(p)
                grads = tree_unflatten(p, torch.autograd.grad(total.sum(),
                                                              leaves))
                params, opt = adam_lib.adam_update(
                    grads, opt, map_tree(torch.Tensor.detach, p), lrs,
                    cfg.adam)
        terms = {k: v.detach() for k, v in terms.items()}
        if cfg.telemetry:
            terms = _telemetry_terms(terms, params, grads, lrs, stacked=True)
        return (params, opt, step + 1), terms

    def _step(self, state: TrainState, batch: SubBatch):
        (params, opt, step), terms = self._outer_body(
            state.params, state.opt, state.step, batch, self._lrs)
        return (TrainState(params=params, opt=opt, step=step),
                self._stitch(terms, 0))

    def _loop(self, state, batch_at, steps):
        carry, rows = (state.params, state.opt, state.step), []
        for i in range(steps):
            carry, terms = self._outer_body(*carry, batch_at(i), self._lrs)
            rows.append(terms)
        params, opt, step = carry
        return (TrainState(params=params, opt=opt, step=step),
                self._stitch(_stack_terms(rows), 1))

    # ------------------------------------------------------------ guarded chunk
    def _guarded_body(self, carry, batch: SubBatch, lrs):
        """One outer step under the health guard: the step runs, and its
        result is kept only while every subdomain is healthy — a
        ``torch.where`` over the carried state, decided on the device (and
        agreed across ranks)."""
        (params, opt, step), ok_sub, good = carry
        all_ok = self._agree(ok_sub)
        (p1, o1, s1), terms = self._outer_body(params, opt, step, batch, lrs)
        keep = lambda new, old: torch.where(all_ok, new, old)
        params = map_trees(keep, p1, params)
        opt = map_trees(keep, o1, opt)
        step = keep(s1, step)
        terms = map_trees(keep, terms, _nan_like(terms))
        # health of the step just applied: finite per-subdomain loss AND
        # finite updated params (catches NaN grads/moments the loss can't see)
        healthy = (torch.isfinite(terms["loss"])
                   & torch.isfinite(_stacked_sqnorm(params)))
        # after a trip the NaN terms would flag everyone: keep the trip-time
        # ok vector so the caller sees WHICH subdomains diverged
        ok_sub = torch.where(all_ok, ok_sub & healthy, ok_sub)
        if self.cfg.telemetry:
            terms = dict(terms, step_ok=ok_sub)
        return ((params, opt, step), ok_sub, good + all_ok.to(torch.int32)), \
            terms

    def run_chunk_guarded(self, state: TrainState, batch: SubBatch,
                          steps: int, lr_scale=None):
        """``run_chunk`` with the health guard.  Returns ``(state, terms,
        health)``: ``health["ok_sub"]`` (n_sub,) marks subdomains whose
        loss/params went non-finite, ``health["good_steps"]`` counts applied
        outer steps (the state freezes once tripped; term rows after the trip
        are NaN).  ``lr_scale`` (n_sub,) scales the per-subdomain learning
        rates (recovery backoff)."""
        scale = (torch.ones_like(self.lrs) if lr_scale is None else
                 torch.as_tensor(lr_scale, dtype=torch.float32,
                                 device=self.device))
        lrs = self._lrs * scale[self._sl]

        def call():
            carry = ((state.params, state.opt, state.step),
                     torch.ones(self._lrs.shape, dtype=torch.bool,
                                device=self.device),
                     torch.zeros((), dtype=torch.int32, device=self.device))
            rows = []
            for _ in range(steps):
                carry, terms = self._guarded_body(carry, batch, lrs)
                rows.append(terms)
            (params, opt, step), ok_sub, good = carry
            ok_sub = self._stitch({"ok": ok_sub}, 0)["ok"]
            health = {"ok": torch.all(ok_sub), "ok_sub": ok_sub,
                      "good_steps": good}
            return (TrainState(params=params, opt=opt, step=step),
                    self._stitch(_stack_terms(rows), 1), health)

        return _traced_dispatch(self, "train.run_chunk_guarded", steps, call)


class _StepGraph:
    """One outer step captured in a CUDA graph that updates the state in
    place: replaying it runs the step on the captured batch and learning
    rates, then copies the new params, Adam state and step count over the
    graph's static inputs.  The batch must stay the same tensors (its
    addresses are in the graph)."""

    def __init__(self, trainer, state: TrainState, batch: SubBatch, lrs):
        dev = trainer.device
        clone = lambda t: t.detach().clone()
        self.batch = batch
        self.static = (map_tree(clone, state.params),
                       map_tree(clone, state.opt), clone(state.step))
        # warm-up on a side stream (lazy initialisations stay out of the
        # graph), as torch.cuda.graphs asks
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                trainer._outer_body(*self.static, batch, lrs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out, self.terms = trainer._outer_body(*self.static, batch, lrs)
            map_trees(lambda d, t: d.copy_(t), self.static, out)

    def load(self, state: TrainState) -> None:
        map_trees(lambda d, t: d.copy_(t), self.static,
                  (state.params, state.opt, state.step))

    def step(self) -> dict:
        self.graph.replay()
        return {k: v.clone() for k, v in self.terms.items()}

    def state(self) -> TrainState:
        params, opt, step = map_tree(torch.Tensor.clone, self.static)
        return TrainState(params=params, opt=opt, step=step)


class ReferenceTrainer(_DDCommon):
    """Every subdomain in one process: batched subdomain axis + gather
    exchange."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._halo = halo.gather_index(self.topo, self.device)
        # the jvp path on a card replays a captured step (module docstring)
        self._graphed = self.device.type == "cuda" and self.res_path is None
        self._graph: _StepGraph | None = None

    def _graph_loop(self, state: TrainState, batch: SubBatch, steps: int):
        g = self._graph
        if g is None or g.batch is not batch:
            g = self._graph = _StepGraph(self, state, batch, self._lrs)
        g.load(state)
        rows = [g.step() for _ in range(steps)]
        return g.state(), _stack_terms(rows)

    def _exchange(self, own: dict) -> dict:
        return halo.exchange_tree_gather(own, self.topo, self._halo)

    def step(self, state: TrainState, batch: SubBatch):
        return self._step(state, batch)

    def run_chunk(self, state: TrainState, batch: SubBatch,
                  steps: int | None = None):
        """Run a chunk of outer steps with no host synchronisation inside.

        ``batch`` is either a stacked SubBatch reused every step (``steps``
        gives the chunk length) or, with ``steps=None``, a SubBatch whose
        fields carry an extra LEADING chunk axis (one batch per step, e.g.
        resampled collocation points; ``data.stack_batches``).  Returns
        (state, terms) with every term stacked (steps, n_sub)."""
        if steps is None:
            n = batch.res_pts.shape[0]
            call = lambda: self._loop(state, lambda i: _batch_at(batch, i),
                                      n)
        elif self._graphed:
            call = lambda: self._graph_loop(state, batch, steps)
        else:
            call = lambda: self._loop(state, lambda i: batch, steps)
        return _traced_dispatch(self, "train.run_chunk", steps, call)


def _fit_count(count: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An Adam step count restored for a trainer that keeps one scalar:
    a per-subdomain count (n_sub,) becomes its largest entry (every
    subdomain steps together).  A scalar restored for a per-subdomain
    trainer stays a scalar: its ``shard_state`` repeats it."""
    return count.max() if like.dim() == 0 and count.dim() else count


class DistributedDDTrainer(_DDCommon):
    """One rank per subdomain (Algorithm 1, the paper's MPI + X): the
    counterpart of the reference's ``shard_map`` over the ``("sub",)``
    mesh.  Run it inside a process group of ``topo.n_sub`` ranks
    (:func:`repro_torch.launch.mesh.run_ranks`); rank r holds subdomain r.

    The state is the rank's slice of the stacked state (a leading axis of
    1; the Adam count per subdomain, (1,)).  :meth:`shard_state` /
    :meth:`shard_batch` take that slice of a global stacked tree,
    :meth:`gather_state` all-gathers it back.  Terms and health come back
    stitched to (steps, n_sub) / (n_sub,), like the reference's
    ``out_specs=P(None, "sub")``."""

    def _local_slice(self) -> slice:
        self.comm = halo.Comm(self.device)
        if self.comm.world != self.topo.n_sub:
            raise ValueError(f"{self.topo.n_sub} subdomains need as many "
                             f"ranks; the group has {self.comm.world}")
        self.rank = self.comm.rank
        self._peers = halo.p2p_peers(self.topo, self.rank)
        return slice(self.rank, self.rank + 1)

    def init(self, seed: int = 0) -> TrainState:
        """The rank's slice of ``ReferenceTrainer.init(seed)``'s stacked
        draw, so both trainers start equal."""
        return self.shard_state(super().init(seed))

    def _exchange(self, own: dict) -> dict:
        return halo.exchange_tree_p2p(own, self._peers, self.comm)

    def _agree(self, ok_sub: torch.Tensor) -> torch.Tensor:
        # one MIN all-reduce per step: every rank freezes the moment any
        # rank trips (the reference's pmin)
        ok = self.comm.all_reduce(ok_sub.to(torch.int32).min(),
                                  dist.ReduceOp.MIN)
        return ok > 0

    def _stitch(self, tree: dict, dim: int) -> dict:
        return self.comm.all_gather_cat(tree, dim)

    def step(self, state: TrainState, batch: SubBatch):
        return self._step(state, batch)

    def run_chunk(self, state: TrainState, batch: SubBatch, steps: int):
        """``steps`` outer steps on the rank's shard (the exchange inside
        every step).  Returns (state, terms) with the terms stitched
        (steps, n_sub): one all-gather per chunk."""
        return _traced_dispatch(self, "train.run_chunk", steps,
                                lambda: self._loop(state, lambda i: batch,
                                                   steps))

    def _take(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        return x[self._sl].clone()

    def shard_batch(self, batch: SubBatch) -> SubBatch:
        """The rank's slice of a global stacked batch, on its device."""
        return SubBatch(**{k: self._take(v) for k, v in vars(batch).items()})

    def shard_state(self, state: TrainState) -> TrainState:
        """The rank's slice of a global stacked state (a scalar Adam count,
        as ``ReferenceTrainer`` keeps it, becomes the rank's (1,))."""
        count = torch.as_tensor(state.opt["count"], device=self.device)
        count = (count[self._sl].clone() if count.dim() else
                 torch.full((1,), int(count), dtype=count.dtype,
                            device=self.device))
        take = lambda t: map_tree(self._take, t)
        return TrainState(
            params=take(state.params),
            opt={"m": take(state.opt["m"]), "v": take(state.opt["v"]),
                 "count": count},
            step=torch.as_tensor(state.step, device=self.device).clone())

    def gather_state(self, state: TrainState) -> TrainState:
        """The global stacked state on every rank (one all-gather per
        dtype); the Adam count is (n_sub,), as in the reference."""
        trees = {"params": state.params, "m": state.opt["m"],
                 "v": state.opt["v"]}
        flat = {str(i): t for i, t in enumerate(tree_leaves(trees))}
        flat["count"] = state.opt["count"]
        full = self.comm.all_gather_cat(flat)
        leaves = [full[str(i)] for i in range(len(flat) - 1)]
        g = tree_unflatten(trees, leaves)
        return TrainState(params=g["params"],
                          opt={"m": g["m"], "v": g["v"],
                               "count": full["count"]},
                          step=state.step)

    def fault_target(self, subdomain: int | None) -> bool:
        """Whether this rank holds the element ``inject_nan(tree, kind,
        subdomain)`` poisons in the global stacked tree: subdomain q's
        slice, or subdomain 0's first element when q is None or past the
        end."""
        q = subdomain if (subdomain is not None
                          and subdomain < self.topo.n_sub) else 0
        return q == self.rank


class DataParallelTrainer:
    """The paper's Fig. 1a baseline: one network (``nets.init_model``) on
    every worker, the points sharded (worker r trains on the batch's slice
    r), the gradient all-reduced as a mean, ``lr *= n_workers`` when
    ``scale_lr`` (Goyal et al. [21]).

    With ``compression`` each worker compresses ITS OWN gradient before the
    all-reduce with an error-feedback buffer that is per worker and never
    averaged (state ``err``: the worker's slice, a leading axis of 1).
    ``n_workers > 1`` runs inside a process group of that many ranks
    (:func:`repro_torch.launch.mesh.run_ranks`); ``n_workers=1`` needs none
    (a world of one is the identity).  The state is a dict
    ``{"params", "opt", "err", "step"}``; params and moments are replicated
    (bitwise: every worker applies the same reduced gradient)."""

    def __init__(
        self,
        pde: PDE,
        model_cfg: SubdomainModelConfig,
        n_workers: int,
        weights: LossWeights = LossWeights(),
        lr: float = 1e-3,
        scale_lr: bool = True,
        compression: CompressionConfig | None = None,
        adam_cfg: adam_lib.AdamConfig = adam_lib.AdamConfig(),
        residual_path: str = "jvp",
        backward_path: str = "fused",
        telemetry: bool = False,
        device=None,
    ):
        self.pde, self.model_cfg, self.weights = pde, model_cfg, weights
        self.n = n_workers
        self.lr = lr * (n_workers if scale_lr else 1)
        self.compression = compression
        self.adam_cfg = adam_cfg
        self.telemetry = telemetry
        self.device = resolve_device(device)
        self.act = nets.uniform_model_act(model_cfg)
        self.act_code = nets.act_code(self.act)
        self.res_path = None
        if backward_path not in ops.BWD_PATHS:
            raise ValueError(f"unknown backward_path {backward_path!r}")
        if residual_path == "fused":
            if not type(pde).supports_derivs():
                raise ValueError(f"residual_path='fused': {pde.name} lacks "
                                 "the bundle methods")
            self.res_path = losses.ResidualPath(act=self.act,
                                                bwd=backward_path)
        elif residual_path != "jvp":
            raise ValueError(f"unknown residual_path {residual_path!r}")
        self.comm = None
        self.rank = 0
        if n_workers > 1:
            self.comm = halo.Comm(self.device)
            if self.comm.world != n_workers:
                raise ValueError(f"{n_workers} workers need as many ranks; "
                                 f"the group has {self.comm.world}")
            self.rank = self.comm.rank
        self.tracer = None   # optional repro_torch.obs.Tracer

    def init(self, seed: int = 0) -> dict:
        gen = torch.Generator().manual_seed(seed)
        params = map_tree(lambda t: t.to(self.device),
                          nets.init_model(self.model_cfg, gen))
        err = (map_tree(lambda t: torch.zeros((1,) + t.shape,
                                              dtype=t.dtype,
                                              device=t.device), params)
               if self.compression else None)
        return {"params": params, "opt": adam_lib.init_adam(params),
                "err": err,
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def _shard(self, batch: SubBatch) -> SubBatch:
        """This worker's points: the slice ``rank`` of the batch's leading
        axis (the reference's ``in_specs=P("sub")``)."""
        return SubBatch(**{k: v[self.rank] for k, v in vars(batch).items()})

    def _mean(self, grads, terms: dict):
        """The all-reduce mean of the gradient and the terms: one packed
        buffer, one all-reduce."""
        leaves = tree_leaves(grads)
        keys = list(terms)
        flat = torch.cat([t.reshape(-1) for t in leaves]
                         + [terms[k].reshape(1) for k in keys])
        with record_function("dd-comm-allreduce"):
            flat = self.comm.all_reduce(flat) / self.n
        out, ofs = [], 0
        for t in leaves:
            out.append(flat[ofs:ofs + t.numel()].reshape(t.shape))
            ofs += t.numel()
        mean_terms = {k: flat[ofs + i] for i, k in enumerate(keys)}
        return tree_unflatten(grads, out), mean_terms

    def _local_update(self, params, opt, err, batch: SubBatch, lr):
        """One all-reduce-Adam update for this worker (``err``: its
        error-feedback slice, a leading axis of 1)."""
        p = map_tree(lambda t: t.detach().requires_grad_(), params)
        with scope("comp_forward"):
            total, terms = losses.vanilla_pinn_loss(
                self.pde, self.model_cfg, self.weights, p, self.act_code,
                None, batch, path=self.res_path)
            leaves = tree_leaves(p)
            g = tree_unflatten(p, torch.autograd.grad(total, leaves))
        terms = {k: v.detach() for k, v in terms.items()}
        if self.compression is not None:
            g, e = compress_decompress(g, map_tree(lambda t: t[0], err),
                                       self.compression)
            err = map_tree(lambda t: t[None], e)
        if self.comm is not None:
            g, terms = self._mean(g, terms)
        with scope("comp_update"):
            new_params, new_opt = adam_lib.adam_update(
                g, opt, map_tree(torch.Tensor.detach, p), lr, self.adam_cfg)
        if self.telemetry:
            terms = _telemetry_terms(terms, new_params, g, lr, stacked=False)
        return new_params, new_opt, err, terms

    def step(self, state: dict, batch: SubBatch):
        b = self._shard(batch)
        p, o, e, terms = self._local_update(state["params"], state["opt"],
                                            state["err"], b, self.lr)
        return {"params": p, "opt": o, "err": e,
                "step": state["step"] + 1}, terms

    def run_chunk(self, state: dict, batch: SubBatch, steps: int):
        """``steps`` all-reduce-Adam updates; terms stacked (steps,)."""
        def call():
            b = self._shard(batch)
            p, o, e = state["params"], state["opt"], state["err"]
            rows = []
            for _ in range(steps):
                p, o, e, terms = self._local_update(p, o, e, b, self.lr)
                rows.append(terms)
            return ({"params": p, "opt": o, "err": e,
                     "step": state["step"] + steps}, _stack_terms(rows))

        return _traced_dispatch(self, "train.run_chunk", steps, call)

    def run_chunk_guarded(self, state: dict, batch: SubBatch, steps: int,
                          lr_scale=None):
        """Guarded ``run_chunk``: the state freezes (``torch.where``) at the
        first step whose loss or params go non-finite.  Params and loss are
        replicated after the all-reduce, so every worker reaches the same
        verdict with no extra collective; ``health["ok_sub"]`` is the
        scalar ``ok`` and ``lr_scale`` one scalar."""
        lr = self.lr * (1.0 if lr_scale is None else torch.as_tensor(
            lr_scale, dtype=torch.float32, device=self.device).reshape(()))

        def call():
            b = self._shard(batch)
            args = (state["params"], state["opt"], state["err"])
            ok = torch.ones((), dtype=torch.bool, device=self.device)
            good = torch.zeros((), dtype=torch.int32, device=self.device)
            rows = []
            for _ in range(steps):
                p, o, e, terms = self._local_update(*args, b, lr)
                keep = lambda new, old: torch.where(ok, new, old)
                args = tuple(None if old is None else map_trees(keep, new, old)
                             for new, old in zip((p, o, e), args))
                terms = map_trees(keep, terms, _nan_like(terms))
                healthy = (torch.isfinite(terms["loss"])
                           & torch.isfinite(_sqnorm(args[0])))
                ok, good = ok & healthy, good + ok.to(torch.int32)
                if self.telemetry:
                    terms = dict(terms, step_ok=ok)
                rows.append(terms)
            p, o, e = args
            health = {"ok": ok, "ok_sub": ok, "good_steps": good}
            return ({"params": p, "opt": o, "err": e,
                     "step": state["step"] + good}, _stack_terms(rows),
                    health)

        return _traced_dispatch(self, "train.run_chunk_guarded", steps, call)

    def shard_state(self, state: dict) -> dict:
        """This worker's state from a global one (``err`` stacked over the
        workers, (n_workers, ...))."""
        dev = lambda t: torch.as_tensor(t, device=self.device).clone()
        err = state["err"]
        return {"params": map_tree(dev, state["params"]),
                "opt": map_tree(dev, state["opt"]),
                "err": None if err is None else map_tree(
                    lambda t: dev(t)[self.rank:self.rank + 1], err),
                "step": dev(state["step"])}

    def gather_state(self, state: dict) -> dict:
        """The global state: params and moments as held (replicated), the
        error-feedback slices all-gathered to (n_workers, ...)."""
        err = state["err"]
        if err is not None and self.comm is not None:
            flat = {str(i): t for i, t in enumerate(tree_leaves(err))}
            full = self.comm.all_gather_cat(flat)
            err = tree_unflatten(err, [full[str(i)]
                                       for i in range(len(flat))])
        return dict(state, err=err)


# ------------------------------------------------------------------ checkpoints

def save_train_state(root: str, state: TrainState, keep: int = 3,
                     metadata: dict | None = None) -> str:
    """Checkpoint a :class:`TrainState` (atomic npz + manifest, the
    reference's leaf paths and dtypes)."""
    from repro_torch.checkpoint import ckpt

    tree = {"params": state.params, "opt": state.opt, "step": state.step}
    return ckpt.save(root, int(state.step), tree, metadata=metadata,
                     keep=keep)


def restore_train_state(root: str, like: TrainState,
                        step: int | None = None) -> TrainState:
    """Restore a :class:`TrainState` saved by :func:`save_train_state` (by
    the port or the reference); ``like`` (e.g. ``trainer.init()``) fixes the
    structure, each leaf's dtype and its device, and the shape of the Adam
    count (scalar or per subdomain)."""
    from repro_torch.checkpoint import ckpt

    like_tree = {"params": like.params, "opt": like.opt, "step": like.step}
    tree, _ = ckpt.restore(root, like_tree, step=step)
    tree = map_trees(lambda arr, t: torch.as_tensor(arr, dtype=t.dtype,
                                                    device=t.device),
                     tree, like_tree)
    tree["opt"]["count"] = _fit_count(tree["opt"]["count"],
                                      like.opt["count"])
    return TrainState(params=tree["params"], opt=tree["opt"],
                      step=tree["step"])


# ------------------------------------------------------------------ evaluation

def evaluate_l2(decomp: Decomposition, model_cfg: SubdomainModelConfig,
                params, act_codes, pde: PDE, n_pts: int = 2000,
                seed: int = 0, width_masks=None, device=None) -> float:
    """Relative L2 error of the stitched solution (eq. 4) against
    ``pde.exact``, through the serving engine (:class:`FieldEngine`, order 1:
    one K1 launch per field net on a card) — the route -> evaluate -> stitch
    path production queries take."""
    from repro_torch.serve.engine import FieldEngine
    from repro_torch.serve.export import FieldBundle

    rng = np.random.default_rng(seed)
    m = n_pts // decomp.n_sub + 1
    pts = np.stack([decomp.sample_interior(q, m, rng)
                    for q in range(decomp.n_sub)])        # (n_sub, m, dim)
    ex = pde.exact(pts.reshape(-1, decomp.dim))
    if ex is None:
        raise ValueError("PDE has no exact solution")
    codes = (act_codes.cpu().numpy() if isinstance(act_codes, torch.Tensor)
             else np.asarray(act_codes))
    bundle = FieldBundle(model_cfg=model_cfg,
                         params=map_tree(lambda t: t.detach()
                                         if isinstance(t, torch.Tensor)
                                         else t, params),
                         decomp=decomp, act_codes=codes.astype(np.int32),
                         width_masks=width_masks, pde=None)
    # tol=0: the points lie strictly inside their subdomains
    pred = FieldEngine(bundle, tol=0.0, device=device).evaluate(
        pts.reshape(-1, decomp.dim), order=1)["u"]
    e = (pred.reshape(ex.shape) - ex).ravel()
    r = ex.ravel()
    return float(np.linalg.norm(e) / (np.linalg.norm(r) + 1e-30))
