"""Single-dispatch stitched inference: the serving hot path.

Counterpart of the reference package's ``serve/engine.py``.
``FieldEngine.evaluate(pts)`` answers "u / grad u / flux / residual at these N
points" for a frozen :class:`~repro_torch.serve.export.FieldBundle`:

1. **route** (host, vectorized): claim matrix + per-subdomain buckets
   (:mod:`repro_torch.serve.routing`);
2. **evaluate** (device): the bucketed points ``(n_sub, m, dim)`` go through
   ONE batched call per field net — :func:`repro_torch.core.fused.model_bundle`
   (one activation shared by all subdomains: the CUDA kernel, whose grid
   carries the subdomain axis) or :func:`~repro_torch.core.fused.model_bundle_select`
   (heterogeneous Table-3 activations, per-subdomain codes) — never a
   per-subdomain Python loop.  The reference gets the same batching from
   ``jax.jit`` + ``vmap``;
3. **stitch** (host): claims are averaged so interface points are
   single-valued (XPINN eq. 4), unclaimed (outside-domain) points come back
   NaN.

Two entry tiers (``order``): ``order=2`` is the full bundle (residual doubles
as a served error-proxy diagnostic); ``order=1`` carries no second-order
tangent stream at all (``d2_dirs=()``: the first-order kernel).

The engine runs on the CUDA card unless constructed with ``device="cpu"``;
with no card and no explicit device it raises (:mod:`repro_torch.device`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fused
from repro_torch.core.nets import params_from_numpy
from repro_torch.device import resolve_device
from repro_torch.serve import routing
from repro_torch.serve.export import FieldBundle


def _stitch(routed: routing.RoutedQuery, arr: np.ndarray,
            claims: np.ndarray) -> np.ndarray:
    """Average each point's claims: (n_sub, m, ...) -> (N, ...)."""
    flat = arr.reshape((arr.shape[0] * arr.shape[1],) + arr.shape[2:])
    out = np.full((len(routed.pts),) + flat.shape[1:], np.nan, flat.dtype)
    prim = routed.primary
    out[routed.pt_idx[prim]] = flat[routed.rows[prim]]
    if not prim.all():  # interface points: accumulate extra claims, then mean
        np.add.at(out, routed.pt_idx[~prim], flat[routed.rows[~prim]])
        multi = claims > 1
        out[multi] /= claims[multi].reshape((-1,) + (1,) * (out.ndim - 1))
    return out


class FieldEngine:
    """Frozen-field evaluation with one batched network call per field net."""

    def __init__(self, bundle: FieldBundle, tol: float = 1e-9,
                 bucket: int = 64, device=None, obs=None):
        self.device = resolve_device(device)
        self.tol, self.bucket = tol, bucket
        # optional telemetry (repro_torch.obs.Obs): per-evaluate dispatch
        # counter and duration histogram under serve.engine/*
        self.obs = obs
        self.n_dispatches = 0   # device dispatches issued (1 per evaluate)
        self.swap_bundle(bundle)

    def swap_bundle(self, bundle: FieldBundle) -> None:
        """Hot-swap the served bundle in place (the watchdog reload path).

        The engine OBJECT survives, so every wrapper holding a reference
        (``GuardedEngine``, frontends) serves the new field from the next
        dispatch.  Callers owning result caches keyed on query signatures
        must invalidate them — the reload helper in
        :mod:`repro_torch.launch.serve_field` does both, and only AFTER the
        new bundle verified.
        """
        codes = np.asarray(
            bundle.act_codes if bundle.act_codes is not None
            else np.zeros((bundle.n_sub,), np.int32), np.int32)
        if codes.shape != (bundle.n_sub,):
            raise ValueError(f"act_codes shape {codes.shape} != "
                             f"({bundle.n_sub},)")
        self.bundle = bundle
        # weights move to the device once per bundle, not per query
        self._params = params_from_numpy(bundle.params, self.device)
        self._width_masks = (None if bundle.width_masks is None else
                             params_from_numpy(bundle.width_masks,
                                               self.device))
        self._codes = torch.as_tensor(codes, device=self.device)
        # one shared activation -> the kernel path; heterogeneous -> select
        self.uniform_act = fused.uniform_act_name(codes.tolist())
        self.last_claims = None  # (N,) claim counts of the latest evaluate —
        # lets output guards distinguish legit outside-domain NaN from a
        # poisoned claimed point without a second routing pass

    # ------------------------------------------------------------ internals
    def _route(self, pts) -> routing.RoutedQuery:
        return routing.route(self.bundle.decomp, pts, tol=self.tol,
                             bucket=self.bucket)

    def _check_order(self, order: int):
        """The d2 directions for ``order`` (raises on a bundle that cannot
        serve it)."""
        pde = self.bundle.pde
        if order == 2 and pde is None:
            raise ValueError("order=2 (flux/residual) needs a bundle PDE; "
                             "use order=1 for bare field serving")
        if pde is not None and not type(pde).supports_derivs():
            raise ValueError(
                f"bundle PDE {pde.name} lacks the batched *_from_derivs "
                "methods the serving engine assembles flux/residual from; "
                "export the bundle with pde=None for bare field serving")
        # order=1: no second-order stream at all; order=2: the directions the
        # PDE residual consumes
        return () if order == 1 else (pde.d2_dirs if pde is not None else None)

    @torch.inference_mode()
    def _outputs(self, X: torch.Tensor, order: int, d2) -> dict:
        cfg, pde = self.bundle.model_cfg, self.bundle.pde
        if self.uniform_act is not None:
            u, du, d2u = fused.model_bundle(cfg, self._params, X,
                                            self.uniform_act,
                                            self._width_masks, d2_dirs=d2)
        else:
            u, du, d2u = fused.model_bundle_select(cfg, self._params, X,
                                                   self._codes,
                                                   self._width_masks,
                                                   d2_dirs=d2)
        out = {"u": u, "grad_u": du.movedim(-3, -2)}  # (n_sub, m, dim, F)
        if pde is not None:
            out["flux"] = pde.flux_from_derivs(X, u, du)
            if order == 2:
                out["residual"] = pde.residual_from_derivs(X, u, du, d2u)
        return out

    # ------------------------------------------------------------ public API
    def evaluate(self, pts, order: int = 2) -> dict:
        """Stitched field quantities at an arbitrary query cloud.

        Returns numpy arrays in query order: ``u (N, n_fields)``,
        ``grad_u (N, dim, n_fields)``, and — when the bundle carries a PDE —
        ``flux (N, n_eq, dim)`` plus, for ``order=2``, ``residual (N, n_eq)``
        (a served error proxy: large residual = low local confidence).
        Interface points (claimed by >= 2 subdomains) are the two-sided
        average; points outside every subdomain are NaN.
        """
        routed = self._route(pts)
        d2 = self._check_order(order)
        t0 = self.obs.clock() if self.obs is not None else None
        # the engine's span parents to whatever span is active on the shared
        # tracer — under the frontend's live microbatch span it lands at the
        # bottom of the request's trace; standalone it is its own root
        tracer = self.obs.tracer if self.obs is not None else None
        sp = (tracer.span("serve.engine", lane="engine", order=order,
                          points=len(pts)) if tracer is not None else None)
        try:
            X = torch.from_numpy(routed.X).to(self.device)
            outs = self._outputs(X, order, d2)
            claims = routed.claims
            out = {k: _stitch(routed, v.cpu().numpy(), claims)  # blocks
                   for k, v in outs.items()}
        finally:
            if sp is not None:
                sp.end()
        self.n_dispatches += 1
        self.last_claims = claims
        if self.obs is not None:
            reg = self.obs.registry
            reg.counter("serve.engine/dispatches").inc()
            reg.counter("serve.engine/points").inc(len(claims))
            reg.histogram("serve.engine/dispatch_s").record(
                self.obs.clock() - t0)
        return out
