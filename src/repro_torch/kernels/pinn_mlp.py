"""PINN-MLP derivative forward: the CUDA kernel's wrappers and plain versions.

Counterpart of the reference package's ``kernels/pinn_mlp.py`` Pallas
kernels ``_kernel`` (K1: u and du/dx_j) and ``_kernel2`` (K2: u, du/dx_j and
the diagonal d²u/dx_j²).  Both are one templated CUDA kernel for Hopper,
``csrc/pinn_mlp_fwd.cu`` (its header says what bounds it and how it is laid
out); this module holds

* the activation tables the tangent rules use (:func:`_act_pair`,
  :func:`_act_triple`),
* :func:`pinn_mlp_fwd1` / :func:`pinn_mlp_fwd2`, the wrappers: batched over
  a leading subdomain axis, on packed weight stacks (``ops.pack_mlp``).  A
  CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
  raises — there is no fallback;
* :func:`pinn_mlp_fwd1_plain` / :func:`pinn_mlp_fwd2_plain`, the plain
  PyTorch versions on the same inputs (``ref._ref2_impl``'s recurrence),
  which the CPU tests use and the card check compares the kernel with;
* ``launches``: one launch count per instantiation, raised by one each time
  a wrapper launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import native, ref

WMAX = 128  # widest layer the kernel takes (the TPU kernel's WPAD)
_ACT_CODE = {"tanh": 0, "sin": 1, "cos": 2}

launches = {"pinn_mlp_fwd1": 0, "pinn_mlp_fwd2": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


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
    Ws, bs, a = _unpack(w_stack, b_stack, a_vec, x.shape[-1], n_out)
    # no second-order stream: phi'' is never evaluated
    u, du, _ = ref._ref2_impl(x, Ws, bs, a, _act_pair(act) + (None,), ())
    return u, du


def pinn_mlp_fwd2_plain(x, w_stack, b_stack, a_vec, *, n_out: int,
                        act: str = "tanh", d2_dirs=None):
    """Plain version of K2 on the wrapper's inputs: (u, du, d2u)."""
    Ws, bs, a = _unpack(w_stack, b_stack, a_vec, x.shape[-1], n_out)
    return ref._ref2_impl(x, Ws, bs, a, _act_triple(act), d2_dirs)


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
    d_in = x.shape[-1]
    sel = tuple(range(d_in)) if d2_dirs is None else tuple(d2_dirs)
    if not sel:
        raise ValueError("pinn_mlp_fwd2 needs at least one d2 direction; "
                         "use pinn_mlp_fwd1 for a first-order bundle")
    if x.device.type == "cpu":
        return pinn_mlp_fwd2_plain(x, w_stack, b_stack, a_vec, n_out=n_out,
                                   act=act, d2_dirs=sel)
    return _launch(x, w_stack, b_stack, a_vec, n_out, act, sel,
                   "pinn_mlp_fwd2")


@functools.cache
def _library():
    lib = native.load("pinn_mlp_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pinn_mlp_fwd.argtypes = [p] * 7 + [i] * 11 + [p]
    lib.pinn_mlp_fwd.restype = i
    lib.pinn_mlp_fwd_error_string.argtypes = [i]
    lib.pinn_mlp_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, w_stack, b_stack, a_vec, n_out, act, sel, name):
    """Raise on any input the kernel does not take: tensors on another
    device than ``x``, a dtype other than float32, non-contiguous tensors,
    tensors that need a gradient (the kernel is forward-only), shapes that
    do not match, layers wider than :data:`WMAX`."""
    if act not in _ACT_CODE:
        raise ValueError(f"{name}: unknown activation {act!r}")
    args = {"x": x, "w_stack": w_stack, "b_stack": b_stack, "a_vec": a_vec}
    for k, t in args.items():
        if t.device != x.device:
            raise ValueError(f"{name}: {k} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {k} is {t.dtype}; the kernel takes "
                            "float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{name}: the CUDA kernel is forward-only; {k} requires grad")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (n_sub, N, d_in), got "
                         f"{tuple(x.shape)}")
    n_sub, n_pts, d_in = x.shape
    L1, wp = w_stack.shape[1], w_stack.shape[-1]
    if w_stack.shape != (n_sub, L1, wp, wp) or \
            b_stack.shape != (n_sub, L1, wp) or a_vec.shape != (n_sub, L1):
        raise ValueError(f"{name}: packed stacks do not match x: "
                         f"{tuple(w_stack.shape)}, {tuple(b_stack.shape)}, "
                         f"{tuple(a_vec.shape)}")
    if wp > WMAX:
        raise ValueError(f"{name}: width {wp} > {WMAX}")
    if wp % 4 or not 1 <= d_in <= 3 or not 1 <= n_out <= wp:
        raise ValueError(f"{name}: unsupported shape (wp={wp}, d_in={d_in}, "
                         f"n_out={n_out})")
    if len(set(sel)) != len(sel) or any(not 0 <= j < d_in for j in sel):
        raise ValueError(f"{name}: bad d2 directions {sel} for d_in={d_in}")


def _launch(x, w_stack, b_stack, a_vec, n_out, act, sel, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA path needs CUDA tensors, got "
                         f"{x.device}")
    _check(x, w_stack, b_stack, a_vec, n_out, act, sel, name)
    n_sub, n_pts, d_in = x.shape
    L1, wp = w_stack.shape[1], w_stack.shape[-1]
    u = x.new_empty((n_sub, n_pts, n_out))
    du = x.new_empty((n_sub, d_in, n_pts, n_out))
    d2u = x.new_empty((n_sub, d_in, n_pts, n_out)) if sel else None
    if n_pts == 0:
        return u, du, d2u
    s = tuple(sel) + (0,) * (3 - len(sel))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pinn_mlp_fwd(
            x.data_ptr(), w_stack.data_ptr(), b_stack.data_ptr(),
            a_vec.data_ptr(), u.data_ptr(), du.data_ptr(),
            None if d2u is None else d2u.data_ptr(),
            n_sub, n_pts, d_in, wp, L1 - 1, n_out, _ACT_CODE[act], len(sel),
            *s, stream)
    if rc != 0:
        msg = lib.pinn_mlp_fwd_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({rc}: {msg})")
    launches[name] += 1
    return u, du, d2u
