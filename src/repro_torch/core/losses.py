"""cPINN / XPINN loss functions (paper eqs. (5), (6)).

Counterpart of the reference package's ``core/losses.py``.  Algorithm 1
splits each step into a COMPUTE stage (evaluate u, residual F and flux f.n
at the own interface points — needs no neighbour data) and a COMMUNICATE
stage (exchange those quantities), followed by the loss:

* :func:`interface_payload` — everything a subdomain SENDS (per slot): its
  solution ``u`` at the shared interface points plus ``f . n`` (cPINN,
  eq. 5) or the PDE residual ``F`` (XPINN, eq. 6);
* :func:`network_eval` — every network-dependent quantity of a step in ONE
  entry (one fused kernel call per field net on the fused path);
* :func:`assemble_subdomain_loss` — eq. (5)/(6) arithmetic from those
  outputs plus the RECEIVED payload.

The reference writes these for one subdomain and ``vmap``s them; here every
function takes the stacked subdomain axis as its leading axis (params,
points, masks) and returns per-subdomain results, (n_sub, ...).  The fused
path batches it in the kernels' grid; the per-point jvp oracle
(``path=None``) maps ``torch.func.vmap`` over subdomains and points.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import fused, nets
from repro_torch.core.pdes import PDE

CPINN, XPINN = 0, 1
METHODS = {"cpinn": CPINN, "xpinn": XPINN}


@dataclass(frozen=True)
class LossWeights:
    """W_u, W_F, W_I (u-avg), W_I_flux / W_I_F of eqs. (5)/(6)."""

    data: float = 20.0
    residual: float = 1.0
    u_avg: float = 20.0
    iface: float = 1.0


@dataclass(frozen=True)
class ResidualPath:
    """Route residual / payload evaluation through the fused second-order
    kernels (``kernels.ops.pinn_mlp_forward2``).

    ``act`` is the one activation the kernels specialize on (the trainer
    builds a ResidualPath only when every subdomain shares one and the PDE
    has the derivative-bundle methods).  ``bwd`` is the backward of the
    fused entry: ``"fused"`` (K3 + K4) or ``"ref"`` (recompute oracle).
    ``None`` wherever a path is accepted means the per-point jvp oracle."""

    act: str = "tanh"
    bwd: str = "fused"


@dataclass
class SubBatch:
    """Training points, padded + masked so shapes are uniform; every field
    carries the leading n_sub axis (and a chunk axis before it when stacked
    by ``data.stack_batches``)."""

    res_pts: torch.Tensor    # (n_sub, n_res, dim)
    res_mask: torch.Tensor   # (n_sub, n_res)
    data_pts: torch.Tensor   # (n_sub, n_data, dim)
    data_vals: torch.Tensor  # (n_sub, n_data, n_fields)
    data_comp: torch.Tensor  # (n_sub, n_data, n_fields) component selector
    data_mask: torch.Tensor  # (n_sub, n_data)
    iface_pts: torch.Tensor  # (n_sub, K, n_iface, dim)
    iface_nrm: torch.Tensor  # (n_sub, K, n_iface, dim) outward normal
    edge_mask: torch.Tensor  # (n_sub, K)


def _pointwise(fn, cfg, params, act_code, width_masks, pts):
    """``fn(u_fn, x)`` at every point of every subdomain: the per-point
    closure oracle, ``torch.func.vmap`` over the leading subdomain axis
    (params, activation codes, masks, points) and then over the points."""
    def one(p, code, wm, xs):
        u_fn = nets.scalar_field_fn(cfg, p, code, wm)
        return torch.func.vmap(lambda x: fn(u_fn, x))(xs)

    if width_masks is None:
        return torch.func.vmap(lambda p, c, xs: one(p, c, None, xs))(
            params, act_code, pts)
    return torch.func.vmap(one)(params, act_code, width_masks, pts)


def _field(u_fn, x):
    return u_fn(x)


def residual_eval(pde: PDE, cfg, params, act_code, width_masks, pts, path):
    """(n_sub, n, n_eq) PDE residuals — fused-kernel bundle when a
    ResidualPath is given, per-point jvp closures otherwise."""
    if path is not None:
        u, du, d2u = fused.model_bundle(cfg, params, pts, path.act,
                                        width_masks, d2_dirs=pde.d2_dirs,
                                        bwd=path.bwd)
        return pde.residual_from_derivs(pts, u, du, d2u)
    return _pointwise(pde.residual, cfg, params, act_code, width_masks, pts)


def _payload_from_bundle(pde, method, flat, bundle, lead, K, nI, dim):
    ub, dub, d2ub = bundle
    u = ub.reshape(lead + (K, nI, pde.n_fields))
    if method == CPINN:
        g = pde.flux_from_derivs(flat, ub, dub).reshape(
            lead + (K, nI, pde.n_eq, dim))
    else:
        g = pde.residual_from_derivs(flat, ub, dub, d2ub).reshape(
            lead + (K, nI, pde.n_eq))
    return {"u": u, "g": g}


def interface_payload(pde: PDE, cfg, method: int, params, act_code,
                      width_masks, iface_pts: torch.Tensor,
                      path: ResidualPath | None = None) -> dict:
    """Quantities SENT to neighbours: u and (f | F) at the own interface
    points, iface_pts (n_sub, K, n_iface, dim)."""
    lead, (K, nI, dim) = iface_pts.shape[:-3], iface_pts.shape[-3:]
    flat = iface_pts.reshape(lead + (K * nI, dim))
    if path is not None:
        bundle = fused.model_bundle(cfg, params, flat, path.act, width_masks,
                                    d2_dirs=pde.d2_dirs, bwd=path.bwd)
        return _payload_from_bundle(pde, method, flat, bundle, lead, K, nI,
                                    dim)
    args = (cfg, params, act_code, width_masks, flat)
    u = _pointwise(_field, *args).reshape(lead + (K, nI, pde.n_fields))
    if method == CPINN:
        g = _pointwise(pde.flux, *args).reshape(lead + (K, nI, pde.n_eq, dim))
    else:
        g = _pointwise(pde.residual, *args).reshape(lead + (K, nI, pde.n_eq))
    return {"u": u, "g": g}


def payload_dot_normal(payload: dict, iface_nrm: torch.Tensor,
                       method: int) -> dict:
    """Project the cPINN flux tensor onto the sender's outward normal before
    sending, so the wire format is (n_fields + n_eq) scalars per point;
    XPINN payloads are already scalar residuals."""
    if method == CPINN:
        g = torch.einsum("...kned,...knd->...kne", payload["g"], iface_nrm)
        return {"u": payload["u"], "g": g}
    return payload


def network_eval(pde: PDE, cfg, method: int, params, act_code, width_masks,
                 batch: SubBatch, path: ResidualPath | None):
    """Every network-dependent quantity of one training step, in ONE entry.

    Returns (res (n_sub, n_res, n_eq), own payload {u, g} already
    normal-projected, data_pred (n_sub, n_data, n_fields)).  Fused path:
    residual, interface and data points form one megabatch with the static
    segment layout ``[res | iface (K*nI) | data]``, one kernel call per
    field net (:func:`fused.model_bundle_segments`).  jvp path
    (``path=None``): the per-point closure oracle (paper §4.1)."""
    lead, (K, nI, dim) = (batch.iface_pts.shape[:-3],
                          batch.iface_pts.shape[-3:])
    iface_flat = batch.iface_pts.reshape(lead + (K * nI, dim))
    if path is not None:
        res_b, iface_b, data_b = fused.model_bundle_segments(
            cfg, params, (batch.res_pts, iface_flat, batch.data_pts),
            path.act, width_masks, d2_dirs=pde.d2_dirs, bwd=path.bwd)
        res = pde.residual_from_derivs(batch.res_pts, *res_b)
        own = _payload_from_bundle(pde, method, iface_flat, iface_b, lead, K,
                                   nI, dim)
        data_pred = data_b[0]
    else:
        res = _pointwise(pde.residual, cfg, params, act_code, width_masks,
                         batch.res_pts)
        own = interface_payload(pde, cfg, method, params, act_code,
                                width_masks, batch.iface_pts)
        data_pred = _pointwise(_field, cfg, params, act_code, width_masks,
                               batch.data_pts)
    return res, payload_dot_normal(own, batch.iface_nrm, method), data_pred


def assemble_subdomain_loss(pde: PDE, method: int, weights: LossWeights,
                            batch: SubBatch, res, own: dict, data_pred,
                            recv_u, recv_g):
    """Eq. (5)/(6) arithmetic from precomputed network outputs — masking
    and reductions per subdomain, no network entry.  Returns (total
    (n_sub,), terms {loss, mse_data, mse_res, mse_avg, mse_iface} of
    (n_sub,) each)."""
    nI = batch.iface_pts.shape[-2]

    # --- MSE_u: data / boundary mismatch --------------------------------
    w = batch.data_comp * batch.data_mask[..., None]
    mse_data = (torch.sum(w * (data_pred - batch.data_vals) ** 2, (-2, -1))
                / torch.clamp(torch.sum(w, (-2, -1)), min=1.0))

    # --- MSE_F: PDE residual ----------------------------------------------
    mse_res = (torch.sum(batch.res_mask[..., None] * res ** 2, (-2, -1))
               / torch.clamp(torch.sum(batch.res_mask, -1) * pde.n_eq,
                             min=1.0))

    # --- interface terms ---------------------------------------------------
    em = batch.edge_mask[..., None, None]
    # MSE_u_avg: |u_q - {{u}}|^2 = |(u_q - u_nbr)/2|^2 over neighbours q+
    davg = 0.5 * (own["u"] - recv_u)
    mse_avg = torch.sum(em * davg ** 2, (-3, -2, -1)) / (nI * pde.n_fields)
    # cPINN eq. (5): recv = f_q+ . n_q+ = -f_q+ . n;  XPINN eq. (6): F - F+
    diff = own["g"] + recv_g if method == CPINN else own["g"] - recv_g
    mse_iface = torch.sum(em * diff ** 2, (-3, -2, -1)) / (nI * pde.n_eq)

    total = (weights.data * mse_data + weights.residual * mse_res
             + weights.u_avg * mse_avg + weights.iface * mse_iface)
    terms = {"loss": total, "mse_data": mse_data, "mse_res": mse_res,
             "mse_avg": mse_avg, "mse_iface": mse_iface}
    return total, terms


def subdomain_loss(pde: PDE, cfg, method: int, weights: LossWeights, params,
                   act_code, width_masks, batch: SubBatch, recv_u, recv_g,
                   path: ResidualPath | None = None):
    """Eq. (5) (cPINN) or eq. (6) (XPINN) for every subdomain: one
    :func:`network_eval` and the loss against the received payload."""
    res, own, data_pred = network_eval(pde, cfg, method, params, act_code,
                                       width_masks, batch, path)
    return assemble_subdomain_loss(pde, method, weights, batch, res, own,
                                   data_pred, recv_u, recv_g)


def vanilla_pinn_loss(pde: PDE, cfg, weights: LossWeights, params, act_code,
                      width_masks, batch: SubBatch,
                      path: ResidualPath | None = None):
    """Eq. (3): the single-domain PINN loss of ONE unstacked model
    (``nets.init_model``) on one worker's points (the data-parallel
    baseline, Fig. 1a); ``batch`` carries no subdomain axis.

    The model goes through the stacked entries with a subdomain axis of 1
    added and taken off again.  Fused path: residual and data points form
    one ``[res | data]`` megabatch, one K3 launch forward and one K4
    backward per field net.  Returns (total, {loss, mse_data, mse_res})."""
    one = lambda t: t[None]
    p1 = nets.map_tree(one, params)
    wm = None if width_masks is None else {k: one(v)
                                           for k, v in width_masks.items()}
    res_pts, data_pts = one(batch.res_pts), one(batch.data_pts)
    if path is not None:
        res_b, data_b = fused.model_bundle_segments(
            cfg, p1, (res_pts, data_pts), path.act, wm, d2_dirs=pde.d2_dirs,
            bwd=path.bwd)
        res = pde.residual_from_derivs(res_pts, *res_b)[0]
        pred = data_b[0][0]
    else:
        code = torch.as_tensor([int(act_code)], device=res_pts.device)
        pred = _pointwise(_field, cfg, p1, code, wm, data_pts)[0]
        res = _pointwise(pde.residual, cfg, p1, code, wm, res_pts)[0]
    w = batch.data_comp * batch.data_mask[:, None]
    mse_data = (torch.sum(w * (pred - batch.data_vals) ** 2)
                / torch.clamp(torch.sum(w), min=1.0))
    mse_res = (torch.sum(batch.res_mask[:, None] * res ** 2)
               / torch.clamp(torch.sum(batch.res_mask) * pde.n_eq, min=1.0))
    total = weights.data * mse_data + weights.residual * mse_res
    return total, {"loss": total, "mse_data": mse_data, "mse_res": mse_res}
