"""Causal GQA flash attention (K5): the CUDA kernel's wrapper and plain version.

Counterpart of the reference package's ``kernels/flash_attention.py``
Pallas kernel ``_kernel`` (K5), the prefill hot spot of the dense models.
The kernel is ``csrc/flash_attention.cu`` (its header says what bounds it
and how it is tiled).  This module holds

* :func:`attention_blocks` — softmax attention over blocks of query rows in
  plain PyTorch, the general function of the models' ``chunked_attention``
  (a query offset, valid cache lengths); it never holds more than one
  block's (block_q, T) scores;
* :func:`flash_attention_plain` — the plain version of K5:
  :func:`attention_blocks` at query offset 0 and no cache lengths;
* :func:`flash_attention` — the wrapper: a CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises — there is no
  fallback;
* ``launches`` / ``plain_calls``: the kernel's launches, and the plain
  version's calls on CUDA tensors (prefill on a card leaves it at 0).

Layout: the model's, q (B, S, H, dh) and k, v (B, T, Hk, dh) with H a
multiple of Hk (query head h reads kv head h // (H / Hk)).  The kernel
reads any strides with a contiguous head dim, so (B, H, S, dh) tensors go
in as ``transpose(1, 2)`` views (``ops.flash_attention``).

Causal alignment: TOP-LEFT.  With ``causal`` key t is visible to query s
iff t <= s, whatever S and T are: the TPU kernel's mask (``k_pos <=
q_pos``) and the model's ``chunked_attention`` at ``q_offset=0``.  The
reference's oracle ``ref.attention_ref`` aligns bottom-right (``tril(k=T -
S)``); the two agree only when S == T, which is the only causal case the
models run.

Dtypes: float32 and bf16 (q, k, v alike).  Scores, softmax and the
products are float32; the output is cast back to the input's dtype.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import native

NEG_INF = -1e30   # masked score (the TPU kernel's NEG_INF; exp stays finite)
DH_MAX = 128      # widest head the kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = {"flash_attention": 0}
plain_calls = {"flash_attention_plain": 0}


def reset_launch_counts() -> None:
    launches["flash_attention"] = 0
    plain_calls["flash_attention_plain"] = 0


# ------------------------------------------------------------ plain versions

def attention_blocks(q, k, v, *, causal=True, q_offset=0, kv_len=None,
                     block_q=512):
    """Softmax attention one block of ``block_q`` query rows at a time.

    q (B, S, H, dh); k (B, T, Hk, dh); v (B, T, Hk, dv).  ``q_offset`` is
    the absolute position of q[:, 0] for the causal mask; ``kv_len`` (B,)
    the valid cache lengths (None: all T).  Scores and softmax in float32;
    each block's output is cast to v's dtype, the result to q's (the
    reference's ``layers.chunked_attention``)."""
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = 1.0 / math.sqrt(dh)
    kf, vf = k.float(), v.float()
    t_idx = torch.arange(T, device=q.device)
    valid = None if kv_len is None else \
        (t_idx[None, :] < kv_len[:, None])[:, None, None, None, :]
    bq = max(1, min(block_q, S))
    outs = []
    for i0 in range(0, S, bq):
        qi = q[:, i0:i0 + bq].float()
        qi = qi.reshape(B, qi.shape[1], Hk, G, dh)
        s = torch.einsum("bqkgd,btkd->bkgqt", qi, kf) * scale
        if causal:
            q_pos = q_offset + i0 + torch.arange(qi.shape[1], device=q.device)
            s = s.masked_fill(t_idx[None, :] > q_pos[:, None], NEG_INF)
        if valid is not None:
            s = s.masked_fill(~valid, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqt,btkd->bqkgd", p, vf).to(v.dtype))
    if not outs:
        return q.new_empty((B, 0, H, v.shape[-1]))
    return torch.cat(outs, dim=1).reshape(B, S, H, v.shape[-1]).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal=True, block_q=512):
    """Plain version of K5 on the wrapper's inputs (top-left causal mask)."""
    if q.is_cuda:
        plain_calls["flash_attention_plain"] += 1
    return attention_blocks(q, k, v, causal=causal, block_q=block_q)


# ------------------------------------------------------------------ wrapper

def flash_attention(q, k, v, *, causal=True, block_q=512):
    """K5: attention of q (B, S, H, dh) over k, v (B, T, Hk, dh), top-left
    causal mask with ``causal``; returns (B, S, H, dh) in q's dtype (on a
    card with q's strides where q is dense).

    CPU tensors take the plain version (``block_q`` bounds its scores'
    memory; the kernel tiles by its own 64 x 64); CUDA tensors launch the
    kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, block_q=block_q)
    return _launch(q, k, v, causal)


# ------------------------------------------------------------------- launch

@functools.cache
def _library():
    lib = native.load("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = ([p] * 4 + [ll] * 12 + [i] * 6
                                        + [ctypes.c_float] + [i] * 2 + [p])
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v):
    """Raise on inputs the kernel does not take."""
    name = "flash_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA path needs CUDA tensors, got "
                         f"{q.device}")
    for n, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {n} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {n} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q (B, S, H, dh), k and v (B, T, Hk, dh); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or H % k.shape[2]:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not 1 <= dh <= DH_MAX or k.shape[1] == 0:
        raise ValueError(f"{name}: head dim {dh} (at most {DH_MAX}) and "
                         f"{k.shape[1]} keys (at least 1)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(f"{name}: the kernel is forward-only "
                                  "(prefill); it has no autograd")


def _launch(q, k, v, causal):
    _check(q, k, v)
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if S == 0 or B == 0:
        return o
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *(t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)),
            B, S, T, H, Hk, dh, 1.0 / math.sqrt(dh), int(causal),
            _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention: kernel launch failed ({rc}: "
                           f"{msg})")
    launches["flash_attention"] += 1
    return o
