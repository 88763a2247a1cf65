"""Public PINN-MLP entries: packing, batching and dispatch to the kernels.

Counterpart of the reference package's ``kernels/ops.py`` forward entries.
Every entry takes either one network (x (N, d_in), Ws[l] (in, out)) or a
stack of them with a leading subdomain axis (x (n_sub, N, d_in), Ws[l]
(n_sub, in, out)) — the reference gets that axis from ``jax.vmap`` over the
``pallas_call``; here it is the kernel's second grid axis, so one call is
one launch for every subdomain.  No point padding: the kernel masks the
ragged tail itself.

Dispatch: CPU tensors run the plain recurrence (``kernels.ref``); CUDA
tensors run the hand-written kernel (``kernels.pinn_mlp``).  The
heterogeneous-activation entry (:func:`pinn_mlp_forward2_select`) is plain
tensor code on both devices, as in the reference (which has no kernel for
it either).  These entries are forward-only; the backward kernels come with
the training path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import pinn_mlp, ref


def width_pad(Ws) -> int:
    """Padded layer width of a stack: the widest layer, rounded up to the
    kernel's multiple of 4 (the reference pads to the TPU's 128 lanes)."""
    w = max(max(W.shape[-2], W.shape[-1]) for W in Ws)
    return -(-w // 4) * 4


def pack_mlp(Ws, bs, a):
    """Pad + stack an MLP into the kernel's layout.

    Returns (w_stack (..., L, wp, wp), b_stack (..., L, wp), a_vec (..., L))
    with L = len(Ws) and wp = :func:`width_pad` (the slope of the output
    layer, ``a_vec[..., L-1]``, is an unused zero)."""
    wp = width_pad(Ws)
    w_stack = torch.stack([F.pad(W, (0, wp - W.shape[-1], 0, wp - W.shape[-2]))
                           for W in Ws], dim=-3)
    b_stack = torch.stack([F.pad(b, (0, wp - b.shape[-1])) for b in bs],
                          dim=-2)
    a_vec = F.pad(a, (0, len(Ws) - a.shape[-1]))
    return w_stack, b_stack, a_vec


def _prepare(x, Ws, bs, a):
    """(x, packed stacks, unbatched?) with a leading subdomain axis."""
    single = x.dim() == 2
    w, b, av = pack_mlp(Ws, bs, a)
    if single:
        x, w, b, av = x[None], w[None], b[None], av[None]
    return x.contiguous(), w, b, av, single


def _unbatch(outs, single):
    return tuple(o[0] for o in outs) if single else tuple(outs)


def pinn_mlp_forward(x, Ws, bs, a, act="tanh"):
    """Fused PINN MLP forward + input-Jacobian (K1).

    Returns (u (..., N, out), du (..., d_in, N, out))."""
    x, w, b, av, single = _prepare(x, Ws, bs, a)
    outs = pinn_mlp.pinn_mlp_fwd1(x, w, b, av, n_out=Ws[-1].shape[-1],
                                  act=act)
    return _unbatch(outs, single)


def pinn_mlp_forward2(x, Ws, bs, a, act="tanh", d2_dirs=None):
    """Fused PINN MLP forward + input-Jacobian + diagonal input-Hessian (K2).

    Returns (u (..., N, out), du (..., d_in, N, out), d2u (..., d_in, N, out))
    with d2u[j] = d²u/dx_j².  ``d2_dirs`` (None = all) prunes the
    second-order stream to the listed directions; the other rows are exact
    zeros.  With ``d2_dirs=()`` no second-order stream is carried at all:
    the first-order kernel runs and d2u is zeros.
    """
    n_out = Ws[-1].shape[-1]
    sel = None if d2_dirs is None else tuple(d2_dirs)
    x, w, b, av, single = _prepare(x, Ws, bs, a)
    if sel == ():
        u, du = pinn_mlp.pinn_mlp_fwd1(x, w, b, av, n_out=n_out, act=act)
        outs = (u, du, torch.zeros_like(du))
    else:
        outs = pinn_mlp.pinn_mlp_fwd2(x, w, b, av, n_out=n_out, act=act,
                                      d2_dirs=sel)
    return _unbatch(outs, single)


def pinn_mlp_forward2_select(x, Ws, bs, a, code, d2_dirs=None):
    """Second-order bundle with the activation chosen per subdomain by an
    integer ``code`` (0=tanh, 1=sin, 2=cos; a scalar, or one per subdomain
    when batched) — the serving path for heterogeneous (paper Table 3)
    activations.  Always the plain recurrence (``ref.pinn_mlp_ref2_select``),
    as in the reference.  ``d2_dirs=()`` disables the second-order stream."""
    return ref.pinn_mlp_ref2_select(x, Ws, bs, a, code,
                                    None if d2_dirs is None
                                    else tuple(d2_dirs))


def pinn_mlp_forward2_segments(x_segs, Ws, bs, a, act="tanh", d2_dirs=None):
    """ONE fused call for several point sets sharing d_in: the segments are
    concatenated along the point axis, evaluated by one
    :func:`pinn_mlp_forward2` and sliced back.  The math is row-independent,
    so each bundle equals a separate call on its segment.  Returns a tuple of
    (u, du, d2u) bundles, one per segment."""
    sizes = [int(x.shape[-2]) for x in x_segs]
    u, du, d2u = pinn_mlp_forward2(torch.cat(list(x_segs), dim=-2), Ws, bs,
                                   a, act=act, d2_dirs=d2_dirs)
    out, ofs = [], 0
    for n in sizes:
        out.append((u[..., ofs:ofs + n, :], du[..., ofs:ofs + n, :],
                    d2u[..., ofs:ofs + n, :]))
        ofs += n
    return tuple(out)
