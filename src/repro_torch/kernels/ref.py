"""Plain PyTorch versions of the PINN-MLP kernels (the correctness contract).

Counterpart of the reference package's ``kernels/ref.py``.  Every function
takes optional leading batch axes (``...``): x (..., N, d_in), Ws[l]
(..., in, out), bs[l] (..., out), a (..., L); the stacked subdomain axis is
one such batch axis, so one call covers every subdomain.
"""
from __future__ import annotations

import torch

_PHI = {"tanh": torch.tanh, "sin": torch.sin, "cos": torch.cos}


def _bias(b):
    return b[..., None, :]


def _slope(a, l):
    """a[..., l] shaped to broadcast over (..., N, w)."""
    return a[..., l, None, None]


def pinn_mlp_ref(x, Ws, bs, a, act="tanh"):
    """Reference fused forward + input-Jacobian.

    Returns u (..., N, out) and du (..., d_in, N, out), the Jacobian rows by
    exact forward-mode AD (``torch.func.jvp``), one direction at a time.
    """
    phi = _PHI[act]

    def fwd(xi):
        h = xi @ Ws[0] + _bias(bs[0])
        for l in range(len(Ws) - 1):
            h = phi(_slope(a, l) * h)
            h = h @ Ws[l + 1] + _bias(bs[l + 1])
        return h

    u = fwd(x)
    dus = []
    for j in range(x.shape[-1]):
        v = torch.zeros_like(x)
        v[..., j] = 1.0
        dus.append(torch.func.jvp(fwd, (x,), (v,))[1])
    return u, torch.stack(dus, dim=-3)


def pinn_mlp_ref2(x, Ws, bs, a, act="tanh", d2_dirs=None):
    """Reference forward + input-Jacobian + DIAGONAL input-Hessian.

    The explicit forward-over-forward tangent recurrence of the second-order
    kernel, written as batched tensor ops.  Returns (u (..., N, out),
    du (..., d_in, N, out), d2u (..., d_in, N, out)) with d2u[j] = d²u/dx_j².
    ``d2_dirs`` (None = all) prunes the second-order stream; pruned rows of
    d2u are exact zeros.
    """
    from repro_torch.kernels.pinn_mlp import _act_triple

    return _ref2_impl(x, Ws, bs, a, _act_triple(act), d2_dirs)


def _select_triple(code):
    """(phi, phi', phi'') with the activation chosen by an integer ``code``
    tensor that broadcasts against the pre-activations (all three branches
    are evaluated, then selected)."""
    def sel(t, s, c):
        return torch.where(code == 0, t, torch.where(code == 1, s, c))

    def d2_tanh(z):
        th = torch.tanh(z)
        return -2.0 * th * (1.0 - th * th)

    phi = lambda z: sel(torch.tanh(z), torch.sin(z), torch.cos(z))
    dphi = lambda z: sel(1.0 - torch.tanh(z) ** 2, torch.cos(z), -torch.sin(z))
    d2phi = lambda z: sel(d2_tanh(z), -torch.sin(z), -torch.cos(z))
    return phi, dphi, d2phi


def pinn_mlp_ref2_select(x, Ws, bs, a, code, d2_dirs=None):
    """:func:`pinn_mlp_ref2` with the activation given per call by an integer
    ``code`` (0=tanh, 1=sin, 2=cos): a scalar, or a tensor over the leading
    batch axes (one code per subdomain)."""
    code = torch.as_tensor(code, device=x.device)
    code = code[(...,) + (None, None)]   # broadcast over (N, w)
    return _ref2_impl(x, Ws, bs, a, _select_triple(code), d2_dirs)


def _ref2_impl(x, Ws, bs, a, triple, d2_dirs):
    phi, dphi, d2phi = triple
    d_in = x.shape[-1]
    sel = tuple(range(d_in)) if d2_dirs is None else tuple(d2_dirs)
    full = sel == tuple(range(d_in))
    h = x @ Ws[0] + _bias(bs[0])
    # the d_in directions on their own axis: (..., d_in, N, width)
    W0 = Ws[0]
    t = W0[..., :d_in, None, :].expand(*W0.shape[:-2], d_in, h.shape[-2],
                                       W0.shape[-1])
    s = h.new_zeros(h.shape[:-2] + (len(sel),) + h.shape[-2:])
    for l in range(len(Ws) - 1):
        al = _slope(a, l)
        z = al * h
        d1 = dphi(z) * al
        if sel:  # empty sel (first-order): s stays the (..., 0, N, w) stream
            d2 = d2phi(z) * (al * al)
            tsel = t if full else torch.stack([t[..., j, :, :] for j in sel],
                                              dim=-3)
            s = d2[..., None, :, :] * tsel * tsel + d1[..., None, :, :] * s
        t = d1[..., None, :, :] * t
        h = phi(z)
        W = Ws[l + 1]
        h = h @ W + _bias(bs[l + 1])
        t = t @ W[..., None, :, :]
        s = s @ W[..., None, :, :]
    if full:
        return h, t, s
    zero = torch.zeros_like(h)
    rows = {j: s[..., k, :, :] for k, j in enumerate(sel)}
    return h, t, torch.stack([rows.get(j, zero) for j in range(d_in)], dim=-3)
