"""The single-process cPINN/XPINN trainer — the paper's Algorithm 1.

Counterpart of the reference package's ``core/trainer.py``
(``ReferenceTrainer``, its chunk drivers, checkpoints and ``evaluate_l2``).
One process holds every subdomain on a leading ``n_sub`` axis; the kernels
take that axis in their grid, so a step is one batched computation for all
subdomains (the reference ``vmap``s).

One outer step (:meth:`ReferenceTrainer._outer_body`):

1. one megabatched :func:`losses.network_eval` with autograd on — on the
   fused path one K3 launch per field net for residual, interface and data
   points together;
2. the exchange payload is a slice of that same forward, gathered from the
   neighbours (:func:`halo.exchange_gather`) and detached unless
   ``couple_gradients``;
3. the loss is the sum over subdomains of
   :func:`losses.assemble_subdomain_loss`, and ONE ``backward`` (one K4
   launch per field net) gives every subdomain's gradient: the received
   payload is a constant, so each subdomain's gradient is its own;
4. Adam with per-subdomain learning rates.

``local_steps = k`` runs k Adam steps per exchange, each with a fresh
forward on the same frozen payload.

Chunks (``run_chunk``, ``run_chunk_guarded``) are a Python loop of outer
steps with no host synchronisation inside: the loss terms stay on the
device, stacked (steps, n_sub), and the guard decides on the device with
``torch.where`` over the carried state.  Capturing a chunk in a CUDA graph
is left to a later change.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import fused, halo, losses, nets
from repro_torch.core.domain import Decomposition, Topology
from repro_torch.core.losses import XPINN, LossWeights, SubBatch
from repro_torch.core.nets import (SubdomainModelConfig, map_tree, map_trees,
                                   tree_leaves, tree_unflatten)
from repro_torch.core.pdes import PDE
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.optim import adam as adam_lib

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
    """Shared setup: dispatch decisions, learning rates, masks, devices."""

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
        self._halo = halo.gather_index(topo, self.device)

    def init(self, seed: int = 0) -> TrainState:
        """Fresh state: weights drawn from ``torch.Generator`` seeded with
        ``seed`` (not the reference's ``jax.random`` numbers)."""
        params, _ = nets.stacked_init(self.model_cfg, self.topo.n_sub, seed,
                                      self._act_codes_in, self.device)
        return TrainState(params=params, opt=adam_lib.init_adam(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=self.device))

    def _net_eval(self, params, batch: SubBatch):
        """All network-dependent quantities of every subdomain in one entry:
        (res, normal-projected own payload, data_pred)."""
        return losses.network_eval(self.pde, self.model_cfg, self.cfg.method,
                                   params, self.act_codes, self.width_masks,
                                   batch, self.res_path)

    def _assemble(self, batch: SubBatch, outs, recv):
        res, own, data_pred = outs
        return losses.assemble_subdomain_loss(
            self.pde, self.cfg.method, self.cfg.weights, batch, res, own,
            data_pred, recv["u"], recv["g"])


class ReferenceTrainer(_DDCommon):
    """Every subdomain in one process: batched subdomain axis + gather
    exchange."""

    def _outer_body(self, params, opt, step, batch: SubBatch, lrs):
        """One outer step (exchange + ``local_steps`` Adam updates).  One
        network entry per loss evaluation: the exchange payload is a slice
        of the differentiated forward."""
        cfg = self.cfg
        terms = grads = None
        for i in range(cfg.local_steps):
            p = map_tree(lambda t: t.detach().requires_grad_(), params)
            outs = self._net_eval(p, batch)
            if i == 0:  # communicate once per outer step (Algorithm 1)
                own = outs[1]
                if not cfg.couple_gradients:
                    own = {k: v.detach() for k, v in own.items()}
                recv = (own if cfg.disable_exchange else
                        halo.exchange_tree_gather(own, self.topo, self._halo))
            else:  # the received payload stays frozen: a constant now
                recv = {k: v.detach() for k, v in recv.items()}
            total, terms = self._assemble(batch, outs, recv)
            leaves = tree_leaves(p)
            grads = tree_unflatten(p, torch.autograd.grad(total.sum(),
                                                          leaves))
            params, opt = adam_lib.adam_update(
                grads, opt, map_tree(torch.Tensor.detach, p), lrs, cfg.adam)
        terms = {k: v.detach() for k, v in terms.items()}
        if cfg.telemetry:
            terms = _telemetry_terms(terms, params, grads, lrs, stacked=True)
        return (params, opt, step + 1), terms

    def step(self, state: TrainState, batch: SubBatch):
        (params, opt, step), terms = self._outer_body(
            state.params, state.opt, state.step, batch, self.lrs)
        return TrainState(params=params, opt=opt, step=step), terms

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
        else:
            call = lambda: self._loop(state, lambda i: batch, steps)
        return _traced_dispatch(self, "train.run_chunk", steps, call)

    def _loop(self, state, batch_at, steps):
        carry, rows = (state.params, state.opt, state.step), []
        for i in range(steps):
            carry, terms = self._outer_body(*carry, batch_at(i), self.lrs)
            rows.append(terms)
        params, opt, step = carry
        return (TrainState(params=params, opt=opt, step=step),
                _stack_terms(rows))

    # ------------------------------------------------------------ guarded chunk
    def _guarded_body(self, carry, batch: SubBatch, lrs):
        """One outer step under the health guard: the step runs, and its
        result is kept only while every subdomain is healthy — a
        ``torch.where`` over the carried state, decided on the device."""
        (params, opt, step), ok_sub, good = carry
        all_ok = torch.all(ok_sub)
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
        lrs = self.lrs * scale

        def call():
            carry = ((state.params, state.opt, state.step),
                     torch.ones((self.topo.n_sub,), dtype=torch.bool,
                                device=self.device),
                     torch.zeros((), dtype=torch.int32, device=self.device))
            rows = []
            for _ in range(steps):
                carry, terms = self._guarded_body(carry, batch, lrs)
                rows.append(terms)
            (params, opt, step), ok_sub, good = carry
            health = {"ok": torch.all(ok_sub), "ok_sub": ok_sub,
                      "good_steps": good}
            return (TrainState(params=params, opt=opt, step=step),
                    _stack_terms(rows), health)

        return _traced_dispatch(self, "train.run_chunk_guarded", steps, call)


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
    structure, each leaf's dtype and its device."""
    from repro_torch.checkpoint import ckpt

    like_tree = {"params": like.params, "opt": like.opt, "step": like.step}
    tree, _ = ckpt.restore(root, like_tree, step=step)
    tree = map_trees(lambda arr, t: torch.as_tensor(arr, dtype=t.dtype,
                                                    device=t.device),
                     tree, like_tree)
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
