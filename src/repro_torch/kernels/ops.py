"""Public PINN-MLP entries: packing, batching and dispatch to the kernels.

Counterpart of the reference package's ``kernels/ops.py`` forward entries.
Every entry takes either one network (x (N, d_in), Ws[l] (in, out)) or a
stack of them with a leading subdomain axis (x (n_sub, N, d_in), Ws[l]
(n_sub, in, out)) — the reference gets that axis from ``jax.vmap`` over the
``pallas_call``; here it is the kernel's second grid axis, so one call is
one launch for every subdomain.  No point padding: the kernel masks the
ragged tail itself.

Dispatch: CPU tensors run the plain recurrence (``kernels.ref``); CUDA
tensors run the hand-written kernels (``kernels.pinn_mlp``).  The
heterogeneous-activation entry (:func:`pinn_mlp_forward2_select`) is plain
tensor code on both devices, as in the reference (which has no kernel for
it either).

Training: :func:`pinn_mlp_forward2` is differentiable w.r.t. (x, Ws, bs, a)
through :class:`_Forward2`, a ``torch.autograd.Function`` around the PACKED
call ``(x, w_stack, b_stack, a_vec) -> (u, du, d2u)`` — the counterpart of
the reference's ``jax.custom_vjp`` (``ops.py:177-248`` there).  Packing
(``F.pad`` / ``torch.stack``), the model folding and the segment ``cat`` /
slices around it stay ordinary torch code, differentiated by autograd.
Two backward paths (``bwd``):

* ``"fused"`` (default): the forward runs K3, which also spills the streams
  of every activation stage, and the backward runs K4, the hand-derived
  reverse sweep over them (on CPU tensors: their plain versions);
* ``"ref"``: the forward saves only its inputs and the backward recomputes
  through autograd of the plain recurrence — the counterpart of the
  reference's ``jax.vjp`` through ``ref.pinn_mlp_ref2``; taken only when
  asked for.

Inference (no tensor needs a gradient, or grad mode off) runs the
forward-only kernels K1/K2 and saves nothing.

The LLM kernels' entries keep the reference's signatures:
:func:`flash_attention` (K5, ``kernels.flash_attention``) and :func:`wkv6`
(K6, ``kernels.wkv6``); both are forward-only, as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import pinn_mlp, ref
from repro_torch.kernels import wkv6 as _wkv6


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


BWD_PATHS = ("fused", "ref")  # the backward paths of pinn_mlp_forward2


class _Forward2(torch.autograd.Function):
    """Differentiable packed second-order call (K3 forward, K4 backward).

    ``forward(x, w_stack, b_stack, a_vec, n_out, act, sel, bwd)`` on the
    kernels' layout (leading subdomain axis); ``sel`` is the tuple of kept
    second-order directions.  Returns (u, du, d2u); the backward returns
    (x̄, W̄ stack, b̄ stack, ā)."""

    @staticmethod
    def forward(ctx, x, w, b, av, n_out, act, sel, bwd):
        ctx.n_out, ctx.act, ctx.sel, ctx.bwd = n_out, act, sel, bwd
        if bwd == "ref":
            ctx.save_for_backward(x, w, b, av)
            if sel == ():
                u, du = pinn_mlp.pinn_mlp_fwd1(x, w, b, av, n_out=n_out,
                                               act=act)
                return u, du, torch.zeros_like(du)
            return pinn_mlp.pinn_mlp_fwd2(x, w, b, av, n_out=n_out, act=act,
                                          d2_dirs=sel)
        u, du, d2u, res = pinn_mlp.pinn_mlp_fwd2_res(
            x, w, b, av, n_out=n_out, act=act, d2_dirs=sel)
        ctx.save_for_backward(x, w, av, res)
        return u, du, d2u

    @staticmethod
    def backward(ctx, cu, cdu, cd2u):
        # pruned d2u rows are constants (exact zeros), so their cotangents
        # must not flow (the reference masks them, ops.py:230-233): both
        # backwards below read only the rows of the kept directions
        n_out, act, sel = ctx.n_out, ctx.act, ctx.sel
        if ctx.bwd == "ref":
            x, w, b, av = ctx.saved_tensors
            with torch.enable_grad():
                ins = [t.detach().requires_grad_() for t in (x, w, b, av)]
                outs = pinn_mlp.pinn_mlp_fwd2_plain(
                    *ins, n_out=n_out, act=act, d2_dirs=sel)
                pairs = [(o, c) for o, c in zip(outs, (cu, cdu, cd2u))
                         if o.requires_grad]
                grads = torch.autograd.grad([o for o, _ in pairs], ins,
                                            [c for _, c in pairs],
                                            allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g
                     for g, t in zip(grads, ins)]
        else:
            x, w, av, res = ctx.saved_tensors
            cx, cw, cb, ca = pinn_mlp.pinn_mlp_bwd2(
                x, w, av, res, cu.contiguous(), cdu.contiguous(),
                cd2u.contiguous(), n_out=n_out, act=act, d2_dirs=sel)
            grads = [cx, cw, cb, ca]
        return (*grads, None, None, None, None)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def pinn_mlp_forward2(x, Ws, bs, a, act="tanh", d2_dirs=None, bwd="fused"):
    """Fused PINN MLP forward + input-Jacobian + diagonal input-Hessian.

    Returns (u (..., N, out), du (..., d_in, N, out), d2u (..., d_in, N, out))
    with d2u[j] = d²u/dx_j².  ``d2_dirs`` (None = all) prunes the
    second-order stream to the listed directions; the other rows are exact
    zeros.  With ``d2_dirs=()`` no second-order stream is carried at all and
    d2u is zeros.

    Differentiable w.r.t. (x, Ws, bs, a): when any of them needs a gradient
    the call goes through :class:`_Forward2` (K3 + K4 for ``bwd="fused"``,
    the recompute oracle for ``bwd="ref"``); otherwise it runs the
    forward-only kernels (K1 for ``d2_dirs=()``, else K2).
    """
    if bwd not in BWD_PATHS:
        raise ValueError(f"unknown backward path {bwd!r}")
    n_out = Ws[-1].shape[-1]
    sel = None if d2_dirs is None else tuple(d2_dirs)
    x, w, b, av, single = _prepare(x, Ws, bs, a)
    if _needs_grad(x, w, b, av):
        dirs = tuple(range(x.shape[-1])) if sel is None else sel
        outs = _Forward2.apply(x, w, b, av, n_out, act, dirs, bwd)
    elif sel == ():
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


def pinn_mlp_forward2_segments(x_segs, Ws, bs, a, act="tanh", d2_dirs=None,
                               bwd="fused"):
    """ONE fused call for several point sets sharing d_in: the segments are
    concatenated along the point axis, evaluated by one
    :func:`pinn_mlp_forward2` and sliced back.  The math is row-independent,
    so each bundle equals a separate call on its segment.  Returns a tuple of
    (u, du, d2u) bundles, one per segment."""
    sizes = [int(x.shape[-2]) for x in x_segs]
    u, du, d2u = pinn_mlp_forward2(torch.cat(list(x_segs), dim=-2), Ws, bs,
                                   a, act=act, d2_dirs=d2_dirs, bwd=bwd)
    out, ofs = [], 0
    for n in sizes:
        out.append((u[..., ofs:ofs + n, :], du[..., ofs:ofs + n, :],
                    d2u[..., ofs:ofs + n, :]))
        ofs += n
    return tuple(out)


def flash_attention(q, k, v, causal=True):
    """Causal GQA flash attention. q: (B,H,S,dh); k/v: (B,Hk,T,dh).

    The kernel reads the (B, S, H, dh) views of these tensors through their
    strides, so nothing is copied, and it needs neither the reference's
    padding of dh to 128 lanes nor its matching rescale of q
    (``ops.py:361-366`` there): the scale is 1/sqrt(dh) directly.  The
    causal mask is aligned top-left (``kernels.flash_attention``)."""
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def wkv6(r, k, v, w, u, chunk=64):
    """WKV6 linear attention. r/k/v/w: (B, T, H, P); u: (H, P). Returns
    (B, T, H, P).

    No padding of P: the kernel takes any P up to 128 as it is, so the
    reference's rule that padded decay channels get w = 1
    (``ops.py:389-391`` there) has nothing to apply to.  ``chunk`` is the
    plain version's (CPU tensors); the kernel uses its own."""
    return _wkv6.wkv6(r, k, v, w, u, chunk=chunk)
