"""PINN-MLP derivative kernels: the CUDA kernels' wrappers and plain versions.

Counterpart of the reference package's ``kernels/pinn_mlp.py`` Pallas
kernels ``_kernel`` (K1: u and du/dx_j), ``_kernel2`` (K2: u, du/dx_j and
the diagonal d²u/dx_j²), ``_kernel2_res`` (K3: K2 plus the spills of the
reverse sweep, the training forward) and ``_kernel2_bwd`` (K4: the
hand-derived reverse sweep).  K1-K3 are one templated CUDA kernel for
Hopper, ``csrc/pinn_mlp_fwd.cu``; K4 is ``csrc/pinn_mlp_bwd.cu`` (their
headers say what bounds them and how they are laid out).  This module holds

* the activation tables the tangent rules use (:func:`_act_pair`,
  :func:`_act_triple`, :func:`_act_quad`),
* the wrappers :func:`pinn_mlp_fwd1`, :func:`pinn_mlp_fwd2`,
  :func:`pinn_mlp_fwd2_res` and :func:`pinn_mlp_bwd2`: batched over a
  leading subdomain axis, on packed weight stacks (``ops.pack_mlp``).  A
  CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
  raises — there is no fallback;
* their plain PyTorch versions on the same inputs (``*_plain``: the
  recurrence of ``ref._ref2_impl`` and the reverse sweep of
  ``ref._ref2_bwd``), which the CPU tests use and the card check compares
  the kernels with;
* ``launches``: one count per wrapper, raised by one each time the wrapper
  launches its kernel and nowhere else; ``plain_calls``: one count per plain
  version of the calls it took on a CUDA tensor (training on a card leaves
  them at 0).

Spill layout (K3 writes it, K4 reads it): ``res (n_sub, L, S, N, wp)`` for L
hidden layers and S = 1 + d_in + NS streams per layer, in the order h,
t_0..t_{d_in-1}, then the NS kept second-order streams s_k (the k-th entry
of ``d2_dirs``): the streams entering each activation stage.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import native, ref

WMAX = 128  # widest layer the kernels take (the TPU kernel's WPAD)
_ACT_CODE = {"tanh": 0, "sin": 1, "cos": 2}

launches = {"pinn_mlp_fwd1": 0, "pinn_mlp_fwd2": 0, "pinn_mlp_fwd2_res": 0,
            "pinn_mlp_bwd2": 0}
plain_calls = {k + "_plain": 0 for k in launches}


def reset_launch_counts() -> None:
    for counts in (launches, plain_calls):
        for k in counts:
            counts[k] = 0


def _count_plain(name: str, x) -> None:
    if x.is_cuda:
        plain_calls[name] += 1


def _act_pair(name: str):
    if name == "tanh":
        return torch.tanh, lambda z: 1.0 - torch.tanh(z) ** 2
    if name == "sin":
        return torch.sin, torch.cos
    if name == "cos":
        return torch.cos, lambda z: -torch.sin(z)
    raise ValueError(name)


def _act_triple(name: str):
    """(phi, phi', phi'') for the second-order tangent rule."""
    if name == "tanh":
        def d2(z):
            th = torch.tanh(z)
            return -2.0 * th * (1.0 - th * th)
        return torch.tanh, lambda z: 1.0 - torch.tanh(z) ** 2, d2
    if name == "sin":
        return torch.sin, torch.cos, lambda z: -torch.sin(z)
    if name == "cos":
        return torch.cos, lambda z: -torch.sin(z), lambda z: -torch.cos(z)
    raise ValueError(name)


def _act_quad(name: str):
    """(phi and its first three derivatives): the reverse sweep
    differentiates the second-order tangent rule once more."""
    if name == "tanh":
        def d3(z):
            th = torch.tanh(z)
            return (6.0 * th * th - 2.0) * (1.0 - th * th)
        return _act_triple("tanh") + (d3,)
    if name == "sin":
        return _act_triple("sin") + (lambda z: -torch.cos(z),)
    if name == "cos":
        return _act_triple("cos") + (torch.sin,)
    raise ValueError(name)


def _dirs(d2_dirs, d_in: int) -> tuple:
    """The kept second-order directions (None = all)."""
    return tuple(range(d_in)) if d2_dirs is None else tuple(d2_dirs)


# ------------------------------------------------------------ plain versions

def _unpack(w_stack, b_stack, a_vec, d_in: int, n_out: int):
    """Packed stacks -> (Ws, bs, a) lists; hidden widths stay padded (the
    padding is exact: padded rows of every following matrix are zero)."""
    L = w_stack.shape[-3] - 1
    Ws = [w_stack[..., l, :, :] for l in range(L + 1)]
    Ws[0] = Ws[0][..., :d_in, :]
    Ws[L] = Ws[L][..., :n_out]
    bs = [b_stack[..., l, :] for l in range(L + 1)]
    bs[L] = bs[L][..., :n_out]
    return Ws, bs, a_vec[..., :L]


def pinn_mlp_fwd1_plain(x, w_stack, b_stack, a_vec, *, n_out: int,
                        act: str = "tanh"):
    """Plain version of K1 on the wrapper's inputs: (u, du)."""
    _count_plain("pinn_mlp_fwd1_plain", x)
    Ws, bs, a = _unpack(w_stack, b_stack, a_vec, x.shape[-1], n_out)
    # no second-order stream: phi'' is never evaluated
    u, du, _ = ref._ref2_impl(x, Ws, bs, a, _act_pair(act) + (None,), ())
    return u, du


def pinn_mlp_fwd2_plain(x, w_stack, b_stack, a_vec, *, n_out: int,
                        act: str = "tanh", d2_dirs=None):
    """Plain version of K2 on the wrapper's inputs: (u, du, d2u)."""
    _count_plain("pinn_mlp_fwd2_plain", x)
    Ws, bs, a = _unpack(w_stack, b_stack, a_vec, x.shape[-1], n_out)
    return ref._ref2_impl(x, Ws, bs, a, _act_triple(act), d2_dirs)


def pinn_mlp_fwd2_res_plain(x, w_stack, b_stack, a_vec, *, n_out: int,
                            act: str = "tanh", d2_dirs=None):
    """Plain version of K3 on the wrapper's inputs: (u, du, d2u, res), the
    spills ``res`` in the layout of the module docstring.  ``d2_dirs=()``
    keeps no second-order stream (d2u is zeros, res holds h and t)."""
    _count_plain("pinn_mlp_fwd2_res_plain", x)
    d_in = x.shape[-1]
    sel = _dirs(d2_dirs, d_in)
    Ws, bs, a = _unpack(w_stack, b_stack, a_vec, d_in, n_out)
    outs, (hs, ts, ss) = ref._ref2_impl(x, Ws, bs, a, _act_triple(act), sel,
                                        save=True)
    if hs:
        res = torch.stack([torch.cat([h[..., None, :, :], t, s], dim=-3)
                           for h, t, s in zip(hs, ts, ss)], dim=-4)
    else:
        res = x.new_zeros(x.shape[:-2] + (0, 1 + d_in + len(sel),
                                          x.shape[-2], w_stack.shape[-1]))
    return (*outs, res)


def pinn_mlp_bwd2_plain(x, w_stack, a_vec, res, cu, cdu, cd2u, *,
                        n_out: int, act: str = "tanh", d2_dirs=None):
    """Plain version of K4: ``ref._ref2_bwd`` on the packed layout.

    Takes the forward's x and packed stacks, K3's spills and the cotangents
    ū (n_sub, N, n_out), d̄u and d̄2u (n_sub, d_in, N, n_out) (rows of d̄2u
    outside ``d2_dirs`` are not read).  Returns x̄ (n_sub, N, d_in) and the
    W̄ (n_sub, L+1, wp, wp), b̄ (n_sub, L+1, wp) and ā (n_sub, L+1) stacks,
    zero where the packing pads (the first layer's rows past d_in, the last
    layer's columns past n_out, the last slope)."""
    _count_plain("pinn_mlp_bwd2_plain", x)
    d_in, wp = x.shape[-1], w_stack.shape[-1]
    L = w_stack.shape[-3] - 1
    Ws, _, a = _unpack(w_stack, w_stack[..., 0, :], a_vec, d_in, n_out)
    layers = [res[..., l, :, :, :] for l in range(L)]
    saved = ([r[..., 0, :, :] for r in layers],
             [r[..., 1:1 + d_in, :, :] for r in layers],
             [r[..., 1 + d_in:, :, :] for r in layers])
    cx, cWs, cbs, ca = ref._ref2_bwd(x, Ws, a, saved, _act_quad(act),
                                     _dirs(d2_dirs, d_in), (cu, cdu, cd2u))
    cw = torch.stack([F.pad(c, (0, wp - c.shape[-1], 0, wp - c.shape[-2]))
                      for c in cWs], dim=-3)
    cb = torch.stack([F.pad(c, (0, wp - c.shape[-1])) for c in cbs], dim=-2)
    return cx, cw, cb, F.pad(ca, (0, 1))


# ------------------------------------------------------------------ wrappers

def pinn_mlp_fwd1(x, w_stack, b_stack, a_vec, *, n_out: int,
                  act: str = "tanh"):
    """K1: u (n_sub, N, n_out), du (n_sub, d_in, N, n_out).

    x (n_sub, N, d_in); w_stack (n_sub, L+1, wp, wp); b_stack
    (n_sub, L+1, wp); a_vec (n_sub, L+1).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return pinn_mlp_fwd1_plain(x, w_stack, b_stack, a_vec, n_out=n_out,
                                   act=act)
    u, du, _ = _launch(x, w_stack, b_stack, a_vec, n_out, act, (),
                       "pinn_mlp_fwd1")
    return u, du


def pinn_mlp_fwd2(x, w_stack, b_stack, a_vec, *, n_out: int,
                  act: str = "tanh", d2_dirs=None):
    """K2: (u, du, d2u), d2u (n_sub, d_in, N, n_out) the diagonal second
    derivatives of the directions in ``d2_dirs`` (None = all; at least one),
    exact zeros in the other rows.  Same inputs and dispatch as
    :func:`pinn_mlp_fwd1`."""
    sel = _dirs(d2_dirs, x.shape[-1])
    if not sel:
        raise ValueError("pinn_mlp_fwd2 needs at least one d2 direction; "
                         "use pinn_mlp_fwd1 for a first-order bundle")
    if x.device.type == "cpu":
        return pinn_mlp_fwd2_plain(x, w_stack, b_stack, a_vec, n_out=n_out,
                                   act=act, d2_dirs=sel)
    return _launch(x, w_stack, b_stack, a_vec, n_out, act, sel,
                   "pinn_mlp_fwd2")


def pinn_mlp_fwd2_res(x, w_stack, b_stack, a_vec, *, n_out: int,
                      act: str = "tanh", d2_dirs=None):
    """K3, the training forward: (u, du, d2u, res) — K2's outputs plus the
    spills of the reverse sweep (module docstring).  ``d2_dirs=()`` keeps
    no second-order stream: d2u is zeros and the spills hold h and t only.
    Same inputs and dispatch as :func:`pinn_mlp_fwd1`.  On a card it is one
    launch of ``csrc/pinn_mlp_fwd.cu`` (tiles of the rows sized to fill the
    SMs in as few waves as it can; each layer's spills leave by 16-byte
    stores while the next layer's weights arrive by a bulk copy)."""
    sel = _dirs(d2_dirs, x.shape[-1])
    if x.device.type == "cpu":
        return pinn_mlp_fwd2_res_plain(x, w_stack, b_stack, a_vec,
                                       n_out=n_out, act=act, d2_dirs=sel)
    u, du, d2u, res = _launch(x, w_stack, b_stack, a_vec, n_out, act, sel,
                              "pinn_mlp_fwd2_res", save=True)
    return u, du, torch.zeros_like(du) if d2u is None else d2u, res


def pinn_mlp_bwd2(x, w_stack, a_vec, res, cu, cdu, cd2u, *, n_out: int,
                  act: str = "tanh", d2_dirs=None):
    """K4, the fused reverse sweep over K3's spills: (x̄, W̄ stack, b̄ stack,
    ā), shapes and padding as :func:`pinn_mlp_bwd2_plain`.  W̄, b̄ and ā are
    summed over each subdomain's points in a fixed order: two launches on
    the same inputs give bitwise equal results.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise: the sweep of
    ``csrc/pinn_mlp_bwd.cu`` (blocks owning contiguous row tiles, each
    stage's spills and weights arriving by bulk copies a stage ahead, each
    block's W̄/b̄/ā in its own slice of a partials buffer the wrapper
    allocates) and its reduction (the slices in fixed groups of blocks)."""
    sel = _dirs(d2_dirs, x.shape[-1])
    if x.device.type == "cpu":
        return pinn_mlp_bwd2_plain(x, w_stack, a_vec, res, cu, cdu, cd2u,
                                   n_out=n_out, act=act, d2_dirs=sel)
    return _launch_bwd(x, w_stack, a_vec, res, cu, cdu, cd2u, n_out, act,
                       sel)


# ------------------------------------------------------------------- launch

def bind_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``pinn_mlp_fwd.cu``
    (this checkout's, or another revision's for an A/B on the card)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pinn_mlp_fwd.argtypes = [p] * 8 + [i] * 11 + [p]
    lib.pinn_mlp_fwd.restype = i
    lib.pinn_mlp_fwd_error_string.argtypes = [i]
    lib.pinn_mlp_fwd_error_string.restype = ctypes.c_char_p
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The same for a library built from ``pinn_mlp_bwd.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.pinn_mlp_bwd_plan.argtypes = [i] * 8 + [ip, ip]
    lib.pinn_mlp_bwd_plan.restype = i
    lib.pinn_mlp_bwd_part_len.argtypes = [i, i]
    lib.pinn_mlp_bwd_part_len.restype = ctypes.c_longlong
    lib.pinn_mlp_bwd.argtypes = [p] * 12 + [i] * 13 + [p]
    lib.pinn_mlp_bwd.restype = i
    lib.pinn_mlp_bwd_error_string.argtypes = [i]
    lib.pinn_mlp_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library():
    return bind_fwd(native.load("pinn_mlp_fwd"))


@functools.cache
def _library_bwd():
    return bind_bwd(native.load("pinn_mlp_bwd"))


def _check_tensors(name, ref_t, **tensors):
    """Raise unless every tensor lies on ``ref_t``'s device, is float32 and
    contiguous, and needs no gradient (the raw kernels have no autograd:
    only ``ops.pinn_mlp_forward2``'s autograd Function calls them, with grad
    mode off)."""
    for k, t in tensors.items():
        if t.device != ref_t.device:
            raise ValueError(f"{name}: {k} on {t.device}, x on "
                             f"{ref_t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {k} is {t.dtype}; the kernel takes "
                            "float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{name}: the raw CUDA kernel has no autograd; {k} requires "
                "grad (differentiate through ops.pinn_mlp_forward2)")


def _check_shapes(name, x, w_stack, a_vec, n_out, sel):
    """Raise on shapes the kernels do not take."""
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (n_sub, N, d_in), got "
                         f"{tuple(x.shape)}")
    n_sub, _, d_in = x.shape
    L1, wp = w_stack.shape[1], w_stack.shape[-1]
    if w_stack.shape != (n_sub, L1, wp, wp) or a_vec.shape != (n_sub, L1):
        raise ValueError(f"{name}: packed stacks do not match x: "
                         f"{tuple(w_stack.shape)}, {tuple(a_vec.shape)}")
    if wp > WMAX:
        raise ValueError(f"{name}: width {wp} > {WMAX}")
    if wp % 4 or not 1 <= d_in <= 3 or not 1 <= n_out <= wp:
        raise ValueError(f"{name}: unsupported shape (wp={wp}, d_in={d_in}, "
                         f"n_out={n_out})")
    if len(set(sel)) != len(sel) or any(not 0 <= j < d_in for j in sel):
        raise ValueError(f"{name}: bad d2 directions {sel} for d_in={d_in}")


def _check(x, w_stack, b_stack, a_vec, n_out, act, sel, name):
    """Raise on any forward input the kernel does not take: tensors on
    another device than ``x``, a dtype other than float32, non-contiguous
    tensors, tensors that need a gradient, shapes that do not match, layers
    wider than :data:`WMAX`."""
    if act not in _ACT_CODE:
        raise ValueError(f"{name}: unknown activation {act!r}")
    _check_tensors(name, x, x=x, w_stack=w_stack, b_stack=b_stack,
                   a_vec=a_vec)
    _check_shapes(name, x, w_stack, a_vec, n_out, sel)
    if b_stack.shape != w_stack.shape[:-1]:
        raise ValueError(f"{name}: b_stack {tuple(b_stack.shape)} does not "
                         "match w_stack")


def _need_cuda(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA path needs CUDA tensors, got "
                         f"{x.device}")


def _launch(x, w_stack, b_stack, a_vec, n_out, act, sel, name, save=False):
    """K1 (``sel == ()``), K2, or with ``save`` K3: (u, du, d2u), plus the
    spills with ``save``; d2u is None when no second-order stream is
    kept."""
    _need_cuda(x, name)
    _check(x, w_stack, b_stack, a_vec, n_out, act, sel, name)
    n_sub, n_pts, d_in = x.shape
    L1, wp = w_stack.shape[1], w_stack.shape[-1]
    u = x.new_empty((n_sub, n_pts, n_out))
    du = x.new_empty((n_sub, d_in, n_pts, n_out))
    d2u = x.new_empty((n_sub, d_in, n_pts, n_out)) if sel else None
    res = (x.new_empty((n_sub, L1 - 1, 1 + d_in + len(sel), n_pts, wp))
           if save else None)
    outs = (u, du, d2u, res) if save else (u, du, d2u)
    if n_pts == 0:
        return outs
    s = tuple(sel) + (0,) * (3 - len(sel))
    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pinn_mlp_fwd(
            x.data_ptr(), w_stack.data_ptr(), b_stack.data_ptr(),
            a_vec.data_ptr(), u.data_ptr(), du.data_ptr(), ptr(d2u), ptr(res),
            n_sub, n_pts, d_in, wp, L1 - 1, n_out, _ACT_CODE[act], len(sel),
            *s, stream)
    if rc != 0:
        msg = lib.pinn_mlp_fwd_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({rc}: {msg})")
    launches[name] += 1
    return outs


def _launch_bwd(x, w_stack, a_vec, res, cu, cdu, cd2u, n_out, act, sel):
    name = "pinn_mlp_bwd2"
    _need_cuda(x, name)
    if act not in _ACT_CODE:
        raise ValueError(f"{name}: unknown activation {act!r}")
    _check_tensors(name, x, x=x, w_stack=w_stack, a_vec=a_vec, res=res,
                   cu=cu, cdu=cdu, cd2u=cd2u)
    _check_shapes(name, x, w_stack, a_vec, n_out, sel)
    n_sub, n_pts, d_in = x.shape
    L1, wp = w_stack.shape[1], w_stack.shape[-1]
    want = {"res": (res, (n_sub, L1 - 1, 1 + d_in + len(sel), n_pts, wp)),
            "cu": (cu, (n_sub, n_pts, n_out)),
            "cdu": (cdu, (n_sub, d_in, n_pts, n_out)),
            "cd2u": (cd2u, (n_sub, d_in, n_pts, n_out))}
    for k, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {k} is {tuple(t.shape)}, expected "
                             f"{shape}")
    cx = x.new_empty((n_sub, n_pts, d_in))
    cw = x.new_empty((n_sub, L1, wp, wp))
    cb = x.new_empty((n_sub, L1, wp))
    ca = x.new_empty((n_sub, L1))
    if n_pts == 0:
        return cx, cw.zero_(), cb.zero_(), ca.zero_()
    lib = _library_bwd()
    code = _ACT_CODE[act]
    with torch.cuda.device(x.device):
        tile, blocks = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.pinn_mlp_bwd_plan(n_sub, n_pts, d_in, wp, L1 - 1, n_out,
                                   code, len(sel), ctypes.byref(tile),
                                   ctypes.byref(blocks))
        if rc != 0:
            msg = lib.pinn_mlp_bwd_error_string(rc).decode()
            raise ValueError(
                f"{name}: no launch fits this shape ({rc}: {msg}); width "
                f"{wp}, d_in {d_in}, {len(sel)} second-order streams — "
                "use bwd='ref' for it")
        part = x.new_empty((n_sub, blocks.value,
                            lib.pinn_mlp_bwd_part_len(L1 - 1, wp)))
        s = tuple(sel) + (0,) * (3 - len(sel))
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pinn_mlp_bwd(
            x.data_ptr(), w_stack.data_ptr(), a_vec.data_ptr(),
            res.data_ptr(), cu.data_ptr(), cdu.data_ptr(), cd2u.data_ptr(),
            cx.data_ptr(), cw.data_ptr(), cb.data_ptr(), ca.data_ptr(),
            part.data_ptr(), n_sub, n_pts, d_in, wp, L1 - 1, n_out, code,
            len(sel), *s, tile.value, blocks.value, stream)
    if rc != 0:
        msg = lib.pinn_mlp_bwd_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({rc}: {msg})")
    launches[name] += 1
    return cx, cw, cb, ca
