"""Plain PyTorch versions of the PINN-MLP kernels (the correctness contract).

Counterpart of the reference package's ``kernels/ref.py``.  Every function
takes optional leading batch axes (``...``): x (..., N, d_in), Ws[l]
(..., in, out), bs[l] (..., out), a (..., L); the stacked subdomain axis is
one such batch axis, so one call covers every subdomain.  Sums over points
(the parameter cotangents of :func:`_ref2_bwd`) run over the N axis only,
one sum per batch entry.  :func:`attention_ref` is the copy of the
reference's attention oracle.
"""
from __future__ import annotations

import math

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


def _select_quad(code):
    """:func:`_select_triple` extended with the third derivative (the
    reverse sweep of the second-order tangent recurrence differentiates
    phi'' once more); the per-activation third derivatives are
    ``pinn_mlp._act_quad``'s, not a second copy."""
    from repro_torch.kernels.pinn_mlp import _act_quad

    def sel(t, s, c):
        return torch.where(code == 0, t, torch.where(code == 1, s, c))

    d3s = [_act_quad(n)[3] for n in ("tanh", "sin", "cos")]
    d3phi = lambda z: sel(d3s[0](z), d3s[1](z), d3s[2](z))
    return _select_triple(code) + (d3phi,)


def pinn_mlp_ref2_select(x, Ws, bs, a, code, d2_dirs=None):
    """:func:`pinn_mlp_ref2` with the activation given per call by an integer
    ``code`` (0=tanh, 1=sin, 2=cos): a scalar, or a tensor over the leading
    batch axes (one code per subdomain)."""
    code = torch.as_tensor(code, device=x.device)
    code = code[(...,) + (None, None)]   # broadcast over (N, w)
    return _ref2_impl(x, Ws, bs, a, _select_triple(code), d2_dirs)


def _ref2_impl(x, Ws, bs, a, triple, d2_dirs, save=False):
    """The second-order tangent recurrence.  With ``save=True`` it also
    returns the reverse sweep's residuals, per activation stage l the
    streams ENTERING it: ``(hs, ts, ss)`` with hs[l] (..., N, w), ts[l]
    (..., d_in, N, w) and ss[l] (..., len(sel), N, w), the kept
    second-order streams only."""
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
    hs, ts, ss = [], [], []
    for l in range(len(Ws) - 1):
        if save:
            hs.append(h)
            ts.append(t)
            ss.append(s)
        al = _slope(a, l)
        z = al * h
        d1 = dphi(z) * al
        if sel:  # empty sel (first-order): s stays the (..., 0, N, w) stream
            d2 = d2phi(z) * (al * al)
            tsel = _rows(t, sel, full)
            s = d2[..., None, :, :] * tsel * tsel + d1[..., None, :, :] * s
        t = d1[..., None, :, :] * t
        h = phi(z)
        W = Ws[l + 1]
        h = h @ W + _bias(bs[l + 1])
        t = t @ W[..., None, :, :]
        s = s @ W[..., None, :, :]
    if full:
        outs = (h, t, s)
    else:
        zero = torch.zeros_like(h)
        rows = {j: s[..., k, :, :] for k, j in enumerate(sel)}
        outs = (h, t, torch.stack([rows.get(j, zero) for j in range(d_in)],
                                  dim=-3))
    if save:
        return outs, (hs, ts, ss)
    return outs


def _rows(t, sel, full):
    """The rows of a (..., d_in, N, w) stream for the kept directions."""
    return t if full else torch.stack([t[..., j, :, :] for j in sel], dim=-3)


def _ref2_bwd(x, Ws, a, res, quad, d2_dirs, cts):
    """Hand-derived reverse sweep of :func:`_ref2_impl` (closed form, not
    autograd): one backward pass over the saved per-layer residuals gives
    every cotangent, with no forward recompute.

    Per activation stage ``g = phi(z)``, ``z = a h`` with tangent rules
    ``t~ = phi'(z)·a·t`` and ``s~ = phi''(z)·a²·t² + phi'(z)·a·s`` the
    cotangent flow (p_k = phi^(k)(z)) is

        h̄  = ḡ·p1·a  +  Σ_j t̄~_j·t_j·p2·a²
                       +  Σ_k s̄~_k·(t_k²·p3·a³ + s_k·p2·a²)
        t̄_j = t̄~_j·p1·a  (+ s̄~_j·2·p2·a²·t_j   for selected j)
        s̄_k = s̄~_k·p1·a
        ā   = Σ ḡ·p1·h + Σ_j t̄~_j·t_j·(p2·h·a + p1)
            + Σ_k s̄~_k·(t_k²·(p3·h·a² + 2·p2·a) + s_k·(p2·h·a + p1))

    and through each affine layer ``(h, t, s) @ W`` everything multiplies by
    ``Wᵀ`` while ``W̄ = gᵀh̄ + Σ t~ᵀt̄ + Σ s~ᵀs̄``.  The input layer closes with
    ``x̄ = h̄₀ W₀ᵀ``, ``W̄₀ = xᵀh̄₀ + row_j Σ_n t̄₀``, ``b̄₀ = Σ_n h̄₀``
    (``t₀,j`` is row j of W₀ broadcast; ``s₀ = 0``).

    ``res`` is the ``save=True`` payload of :func:`_ref2_impl`; ``cts`` the
    (ū, d̄u, d̄2u) cotangents (pruned d̄2u rows are never read).  Returns
    (x̄, W̄s, b̄s, ā) with ā (..., L).
    """
    phi, dphi, d2phi, d3phi = quad
    hs, ts, ss = res
    d_in = x.shape[-1]
    sel = tuple(range(d_in)) if d2_dirs is None else tuple(d2_dirs)
    full = sel == tuple(range(d_in))
    cu, cdu, cd2u = cts
    L = len(Ws) - 1
    T = lambda m: m.transpose(-1, -2)
    bar_h, bar_t = cu, cdu
    # pruned d2u rows are constant zeros: their cotangents never reach inputs
    bar_s = (_rows(cd2u, sel, full) if sel
             else cu.new_zeros(cu.shape[:-2] + (0,) + cu.shape[-2:]))
    cWs, cbs = [None] * (L + 1), [None] * (L + 1)
    ca_rev = []
    for l in reversed(range(L)):
        W, al = Ws[l + 1], _slope(a, l)
        h, t, s = hs[l], ts[l], ss[l]
        z = al * h
        p1, p2, p3 = dphi(z), d2phi(z), d3phi(z)
        d1 = p1 * al
        d2v = p2 * (al * al)
        # (..., len(sel), N, w); with no kept direction the empty s stream
        tsel = _rows(t, sel, full) if sel else s
        d1b, d2b = d1[..., None, :, :], d2v[..., None, :, :]
        g = phi(z)
        t_tl = d1b * t                          # t~ entering the affine layer
        s_tl = d2b * tsel * tsel + d1b * s      # s~ entering the affine layer
        # ---- affine layer l+1 --------------------------------------------
        cWs[l + 1] = (T(g) @ bar_h
                      + torch.einsum("...jnw,...jnv->...wv", t_tl, bar_t)
                      + torch.einsum("...jnw,...jnv->...wv", s_tl, bar_s))
        cbs[l + 1] = bar_h.sum(-2)
        WT = T(W)
        bar_g = bar_h @ WT
        bar_tt = bar_t @ WT[..., None, :, :]
        bar_st = bar_s @ WT[..., None, :, :]
        # ---- activation stage l ------------------------------------------
        # d(phi' a)/da and d(phi'' a²)/da
        e1 = (p2 * h * al + p1)[..., None, :, :]
        e2 = (p3 * h * (al * al) + 2.0 * p2 * al)[..., None, :, :]
        ca_rev.append((bar_g * p1 * h).sum((-2, -1))
                      + (bar_tt * t * e1).sum((-3, -2, -1))
                      + (bar_st * (tsel * tsel * e2 + s * e1))
                      .sum((-3, -2, -1)))
        bar_h = (bar_g * d1
                 + (bar_tt * t).sum(-3) * d2v
                 + (bar_st * (tsel * tsel)).sum(-3) * (p3 * al ** 3)
                 + (bar_st * s).sum(-3) * d2v)
        new_bar_t = bar_tt * d1b
        if sel:
            upd = bar_st * (2.0 * d2b) * tsel
            if full:
                new_bar_t = new_bar_t + upd
            else:
                rows = list(new_bar_t.unbind(-3))
                for k, j in enumerate(sel):
                    rows[j] = rows[j] + upd[..., k, :, :]
                new_bar_t = torch.stack(rows, dim=-3)
        bar_t = new_bar_t
        bar_s = bar_st * d1b
    # ---- input affine layer ----------------------------------------------
    cx = bar_h @ T(Ws[0])
    cWs[0] = T(x) @ bar_h + bar_t.sum(-2)
    cbs[0] = bar_h.sum(-2)
    ca = (torch.stack(ca_rev[::-1], dim=-1) if ca_rev
          else a.new_zeros(a.shape[:-1] + (0,)))
    return cx, cWs, cbs, ca


def pinn_mlp_ref2_vjp(x, Ws, bs, a, act="tanh", d2_dirs=None):
    """Hand-derived closed-form VJP of :func:`pinn_mlp_ref2`: the plain
    version of the fused reverse sweep, derived from the recurrence and not
    through autograd.

    Returns ``((u, du, d2u), vjp_fn)`` with
    ``vjp_fn((ū, d̄u, d̄2u)) -> (x̄, W̄s, b̄s, ā)``.
    """
    from repro_torch.kernels.pinn_mlp import _act_quad

    quad = _act_quad(act)
    outs, res = _ref2_impl(x, Ws, bs, a, quad[:3], d2_dirs, save=True)
    return outs, lambda cts: _ref2_bwd(x, Ws, a, res, quad, d2_dirs, cts)


def attention_ref(q, k, v, causal=True):
    """Plain softmax attention oracle. q: (B,H,S,dh); k/v: (B,Hk,T,dh).

    A copy of the reference's oracle, mask included: it aligns the causal
    mask BOTTOM-RIGHT (``tril(k=T-S)``), where the flash-attention kernel
    and the models align it top-left; the two agree only when S == T."""
    B, H, S, dh = q.shape
    Hk, T = k.shape[1], k.shape[2]
    G = H // Hk
    kk = torch.repeat_interleave(k, G, dim=1)
    vv = torch.repeat_interleave(v, G, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kk.float()) / math.sqrt(dh)
    if causal:
        mask = torch.tril(torch.ones((S, T), dtype=torch.bool,
                                     device=q.device), diagonal=T - S)
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vv.float()).to(q.dtype)
