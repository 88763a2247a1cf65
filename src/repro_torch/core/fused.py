"""Fused derivative-bundle evaluation for plain stacked-MLP subdomain models.

Counterpart of the reference package's ``core/fused.py``: evaluates
(u, du/dx_j, d²u/dx_j²) for EVERY field network of a
:class:`~repro_torch.core.nets.SubdomainModelConfig` with one kernel call per
net, concatenating field outputs like ``nets.model_apply``.  The PDE then
assembles residual / flux from the bundle via ``residual_from_derivs`` /
``flux_from_derivs`` without re-entering the network.

Params and points may carry a leading subdomain axis (stacked params,
x (n_sub, n, dim)); one call then covers every subdomain.

Model-semantics folding (so the kernel stays a plain stacked MLP):

* adaptive slopes: the kernel computes phi(a_l h); ``mlp_apply`` computes
  phi(slope_scale * a_l * h) (a_l = 1 frozen when not adaptive), so we pass
  ``slope_scale * a`` (or ``slope_scale * ones``);
* width masks: ``mlp_apply`` zeroes masked hidden units AFTER each
  activation; multiplying the ROWS of every following weight matrix by the
  mask is exactly equivalent, so masks fold into the packed weight stack.
"""
from __future__ import annotations

import torch

from repro_torch.core.nets import SubdomainModelConfig, act_name
from repro_torch.kernels import ops


def uniform_act_name(act_codes) -> str | None:
    """The single activation name shared by ALL subdomains, or None if they
    differ (kernel dispatch requires a static activation)."""
    if act_codes is None:
        return "tanh"
    names = [act_name(c) for c in act_codes]
    return names[0] if len(set(names)) == 1 else None


def _fold_net(c, p, width_mask):
    """Fold adaptive slopes + width masks into a plain (Ws, bs, a) stack."""
    Ws, bs = list(p["W"]), list(p["b"])
    if c.adaptive:
        a = c.slope_scale * p["a"]
    else:
        a = torch.full_like(p["a"], c.slope_scale)
    if width_mask is not None:
        Ws = [Ws[0]] + [width_mask[..., :, None] * w for w in Ws[1:]]
    return Ws, bs, a


def _concat_fields(per_net):
    return tuple(torch.cat([o[i] for o in per_net], dim=-1) for i in range(3))


def model_bundle(cfg: SubdomainModelConfig, params: dict, x, act: str,
                 width_masks: dict | None = None,
                 d2_dirs: tuple | None = None, bwd: str = "fused"):
    """Fused (u, du, d2u) for the full multi-net subdomain model.

    Returns u (..., n, F), du (..., dim, n, F), d2u (..., dim, n, F) with
    F = cfg.out_dim and d2u the diagonal second derivatives, differentiable
    w.r.t. params (``bwd`` selects the backward of
    ``ops.pinn_mlp_forward2``: the fused reverse sweep or the recompute
    oracle)."""
    (bundle,) = model_bundle_segments(cfg, params, (x,), act, width_masks,
                                      d2_dirs, bwd)
    return bundle


def model_bundle_select(cfg: SubdomainModelConfig, params: dict, x, act_code,
                        width_masks: dict | None = None,
                        d2_dirs: tuple | None = None):
    """Fused (u, du, d2u) with the activation given by an integer code per
    subdomain — the serving path for models whose subdomains declare
    different activations (paper Table 3).  Same folding and output contract
    as :func:`model_bundle`; dispatches to ``ops.pinn_mlp_forward2_select``.
    ``d2_dirs=()`` turns off the second-order tangent stream."""
    outs = []
    for name, c in cfg.nets.items():
        wm = None if width_masks is None else width_masks.get(name)
        Ws, bs, a = _fold_net(c, params[name], wm)
        outs.append(ops.pinn_mlp_forward2_select(x, Ws, bs, a, act_code,
                                                 d2_dirs=d2_dirs))
    return _concat_fields(outs)


def model_bundle_segments(cfg: SubdomainModelConfig, params: dict, x_segs,
                          act: str, width_masks: dict | None = None,
                          d2_dirs: tuple | None = None, bwd: str = "fused"):
    """Megabatched fused bundles: ONE kernel call per field net for ALL point
    segments.  Returns a tuple of per-segment (u, du, d2u) bundles with field
    outputs concatenated like :func:`model_bundle`; each equals a separate
    ``model_bundle`` call on its segment (the math is row-independent)."""
    per_seg = [[] for _ in x_segs]
    for name, c in cfg.nets.items():
        wm = None if width_masks is None else width_masks.get(name)
        Ws, bs, a = _fold_net(c, params[name], wm)
        bundles = ops.pinn_mlp_forward2_segments(x_segs, Ws, bs, a, act=act,
                                                 d2_dirs=d2_dirs, bwd=bwd)
        for segs, b in zip(per_seg, bundles):
            segs.append(b)
    return tuple(_concat_fields(segs) for segs in per_seg)
