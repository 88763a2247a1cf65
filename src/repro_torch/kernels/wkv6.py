"""RWKV-6 chunked WKV forward (K6): the CUDA kernel's wrapper and plain version.

Counterpart of the reference package's ``kernels/wkv6.py`` Pallas kernel
``_kernel`` (K6), the hot loop of the rwkv6 prefill.  The kernels are
``csrc/wkv6.cu``: a chunk kernel and an output kernel, parallel over
chunks, and between them a scan kernel that carries the state through the
chunks elementwise (the header says what bounds them and how they are laid
out).  This module holds

* :func:`wkv6_chunked` — the chunked WKV6 from a given state, returning the
  final state: a copy of the reference's ``models/ssm.py::_wkv6_chunked``,
  including its ``T // chunk`` reshape, so T must be a multiple of
  ``chunk`` as there; the port's ``models/ssm.py`` takes it from here;
* :func:`wkv6_plain` — the plain version of K6: :func:`wkv6_chunked` from a
  zero state, final state dropped;
* :func:`wkv6` — the wrapper: a CPU tensor goes to the plain version; a
  CUDA tensor launches the kernel or raises — there is no fallback.  It is
  forward-only (prefill) and refuses inputs that need a gradient;
* :func:`wkv6_train` — the training entry, a ``torch.autograd.Function``:
  its forward is the wrapper (K6 on CUDA tensors, the plain version on CPU
  ones), its backward recomputes :func:`wkv6_chunked` with grad enabled
  and returns its VJP (the reference differentiates its XLA
  ``_wkv6_chunked`` too; it has no backward kernel).  Each recompute
  counts in ``recomputes`` (not in ``plain_calls``);
* ``launches``: ``wkv6`` counts the wrapper's launches, ``wkv6_chunk``,
  ``wkv6_scan`` and ``wkv6_out`` those of each device kernel (one each per
  call);
* ``plain_calls``: the plain version's calls on CUDA tensors (prefill on a
  card leaves it at 0);
* :func:`work` — the bytes and FLOPs the function needs for one call (the
  card check's bound and the dry run's count);
* ``meta_calls`` / ``meta_work`` / ``meta_reads``: on meta tensors (the
  dry run, ``launch.dryrun``) the wrapper launches nothing: it makes the
  kernel's output and scratch as empty meta tensors, adds one to
  ``meta_calls``, :func:`work`'s count to ``meta_work`` and the storages
  the kernel would read to ``meta_reads``, never to ``launches``.

Layout: r, k, v, w (B, T, H, P) float32 with w in (0, 1), u (H, P); the
state (B, H, P, P) is keyed [key channel, value channel].
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import native
from repro_torch.obs.profiling import scope

P_MAX = 128   # widest head the kernels take

launches = {"wkv6": 0, "wkv6_chunk": 0, "wkv6_scan": 0, "wkv6_out": 0}
plain_calls = {"wkv6_plain": 0}
recomputes = {"wkv6_vjp": 0}
meta_calls = {"wkv6": 0}
meta_work = {"bytes": 0, "flops": 0}
meta_reads = set()   # ``untyped_storage()._cdata`` of the inputs
_CHUNK = 32   # the kernels' steps per chunk (kC in csrc/wkv6.cu)


def reset_launch_counts() -> None:
    for counts in (launches, plain_calls, recomputes):
        for name in counts:
            counts[name] = 0
    reset_meta_counts()


def reset_meta_counts() -> None:
    """Zero the meta branch's counts alone (the dry run's)."""
    for counts in (meta_calls, meta_work):
        for name in counts:
            counts[name] = 0
    meta_reads.clear()


def work(B, T, H, P) -> tuple[int, int]:
    """(bytes, FLOPs) of one call: r, k, v, w read once, y written once, u
    read once (float32); the recurrence's 4 P^2 FLOP per step and head
    (the state read through r and its rank-1 update)."""
    return 4 * (5 * B * T * H * P + H * P), 4 * P * P * B * T * H


def _scratch_floats(B, T, H, P) -> int:
    """``wkv6_scratch_floats`` of csrc/wkv6.cu: per (batch, head, chunk)
    two (chunk, PP) tiles, a (PP, PP) state and a PP decay, P padded to
    PP in {16, 32, 64, 128}."""
    PP = next(n for n in (16, 32, 64, 128) if P <= n)
    return B * H * -(-T // _CHUNK) * (2 * _CHUNK * PP + PP * PP + PP)


# ------------------------------------------------------------ plain versions

def wkv6_chunked(r, k, v, w, u, state0, chunk):
    """Chunked WKV6.  r/k/v: (B, T, H, P); w: per-step decay in (0, 1)
    (B, T, H, P); u: (H, P) bonus; state0: (B, H, P, P) keyed [key_dim,
    value_dim].  Returns (y (B, T, H, P), final state)."""
    B, T, H, P = r.shape
    nc = T // chunk
    c = chunk
    rl, kl, vl, wl = (a.reshape(B, nc, c, H, P) for a in (r, k, v, w))
    logw = torch.log(wl + 1e-38)
    seg = torch.cumsum(logw, dim=2)                               # (B,nc,c,H,P)

    # intra-chunk: y_i reads the state BEFORE step-i decay applies, so the
    # decay of kv_j at step i is prod_{m=j+1}^{i-1} w_m = exp(esc_i - seg_j)
    esc = seg - logw                                              # exclusive
    diff = esc[:, :, :, None] - seg[:, :, None, :]                # (B,nc,c,c,H,P)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    dec = torch.where(mask[None, None, :, :, None, None], torch.exp(diff),
                      0.0)
    a = torch.einsum("bnihp,bnijhp,bnjhp->bnijh", rl, dec, kl)
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", a, vl)
    bonus = torch.einsum("bnchp,hp,bnchp->bnch", rl, u, kl)
    y_intra = y_intra + bonus[..., None] * vl

    # chunk summary: S_chunk = sum_j decay(j->end) k_j v_j^T
    decay_to_end = torch.exp(seg[:, :, -1:] - seg)                # (B,nc,c,H,P)
    s_chunk = torch.einsum("bnchp,bnchq->bnhpq", kl * decay_to_end, vl)
    chunk_decay = torch.exp(seg[:, :, -1])                        # (B,nc,H,P)

    s, states_in = state0, []
    for n in range(nc):
        states_in.append(s)
        s = s * chunk_decay[:, n, ..., None] + s_chunk[:, n]
    states_in = torch.stack(states_in, dim=1)                     # (B,nc,H,P,P)
    decay_from_start = torch.exp(seg - logw)      # decay BEFORE step i applies
    y_inter = torch.einsum("bnchp,bnhpq->bnchq", rl * decay_from_start,
                           states_in)
    y = (y_intra + y_inter).reshape(B, T, H, P)
    return y, s


def wkv6_plain(r, k, v, w, u, *, chunk=64):
    """Plain version of K6 on the wrapper's inputs: :func:`wkv6_chunked`
    from a zero state with ``min(chunk, T)`` steps per chunk (as the
    reference's ``ops.wkv6``, T must then be a multiple of it)."""
    if r.is_cuda:
        plain_calls["wkv6_plain"] += 1
    B, T, H, P = r.shape
    state0 = r.new_zeros((B, H, P, P))
    return wkv6_chunked(r, k, v, w, u, state0, max(1, min(chunk, T)))[0]


# ------------------------------------------------------------------ wrapper

def wkv6(r, k, v, w, u, *, chunk=64):
    """K6: y (B, T, H, P) of the WKV6 recurrence from a zero state (the
    final state is not returned).

    CPU tensors take the plain version (``chunk`` is its chunk); CUDA
    tensors launch the kernels (any T; their chunk of 32 steps is their
    own, chunking being exact algebra) or raise; meta tensors are counted,
    not launched (``meta_calls``)."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, chunk=chunk)
    return _launch(r, k, v, w, u)


# ----------------------------------------------------------------- training

class _Wkv6Train(torch.autograd.Function):
    """K6 forward, autograd through the chunked plain version in the
    backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        return wkv6(r, k, v, w, u, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        recomputes["wkv6_vjp"] += 1
        with scope("wkv6_vjp"), torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in saved]
            r = leaves[0]
            B, T, H, P = r.shape
            y, _ = wkv6_chunked(*leaves, r.new_zeros((B, H, P, P)),
                                max(1, min(ctx.chunk, T)))
            grads = torch.autograd.grad(y, leaves, dy)
        return (*grads, None)


def wkv6_train(r, k, v, w, u, *, chunk=64):
    """:func:`wkv6` with a backward: K6 (or, on CPU tensors, the plain
    version) computes y; the gradient of r, k, v, w and u is the chunked
    plain version's (``min(chunk, T)`` steps per chunk, so T must be a
    multiple of it), recomputed from the saved inputs."""
    return _Wkv6Train.apply(r, k, v, w, u, chunk)


# ------------------------------------------------------------------- launch

@functools.cache
def _library():
    lib = native.load("wkv6")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wkv6_fwd.argtypes = [p] * 7 + [ll] * 6 + [i] * 4 + [p]
    lib.wkv6_fwd.restype = i
    lib.wkv6_scratch_floats.argtypes = [i] * 4
    lib.wkv6_scratch_floats.restype = ll
    lib.wkv6_error_string.argtypes = [i]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, w, u):
    """Raise on inputs the kernel does not take."""
    name = "wkv6"
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: the CUDA path needs CUDA tensors, got "
                         f"{r.device}")
    if r.dim() != 4:
        raise ValueError(f"{name}: r must be (B, T, H, P), got "
                         f"{tuple(r.shape)}")
    B, T, H, P = r.shape
    for n, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.device != r.device:
            raise ValueError(f"{name}: {n} on {t.device}, r on {r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {n} is {t.dtype}; the kernel takes "
                            "float32")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(f"{name}: the kernel is forward-only "
                                      "(prefill); it has no autograd")
    for n, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape or t.stride() != r.stride():
            raise ValueError(f"{name}: {n} {tuple(t.shape)} / {t.stride()} "
                             f"must match r {tuple(r.shape)} / {r.stride()}")
    if r.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim P must be contiguous")
    if tuple(u.shape) != (H, P) or not u.is_contiguous():
        raise ValueError(f"{name}: u must be contiguous (H, P) = {(H, P)}, "
                         f"got {tuple(u.shape)}")
    if not 1 <= P <= P_MAX:
        raise ValueError(f"{name}: head dim P = {P} (at most {P_MAX})")


def _launch(r, k, v, w, u):
    _check(r, k, v, w, u)
    B, T, H, P = r.shape
    y = torch.empty_like(r)
    if B == 0 or T == 0 or H == 0:
        return y
    if r.device.type == "meta":
        # the dry run: the kernel's allocations, its work counted, no launch
        scratch = torch.empty(_scratch_floats(B, T, H, P),
                              dtype=torch.float32, device=r.device)
        nbytes, flops = work(B, T, H, P)
        meta_calls["wkv6"] += 1
        meta_work["bytes"] += nbytes
        meta_work["flops"] += flops
        meta_reads.update(t.untyped_storage()._cdata
                          for t in (r, k, v, w, u))
        del scratch
        return y
    lib = _library()
    # r e^esc, the intra-chunk y and each chunk's state increment (then
    # the state entering it) and decay: the chunk kernel writes them, the
    # scan and output kernels read them
    scratch = torch.empty(lib.wkv6_scratch_floats(B, T, H, P),
                          dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), scratch.data_ptr(), *r.stride()[:3],
            *y.stride()[:3], B, T, H, P, stream)
    if rc != 0:
        msg = lib.wkv6_error_string(rc).decode()
        raise RuntimeError(f"wkv6: kernel launch failed ({rc}: {msg})")
    for name in launches:
        launches[name] += 1
    return y
