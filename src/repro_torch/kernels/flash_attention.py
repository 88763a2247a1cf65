"""GQA flash attention (K5), causal or not: the CUDA kernel's wrapper and
plain version.

Counterpart of the reference package's ``kernels/flash_attention.py``
Pallas kernel ``_kernel`` (K5), the prefill hot spot of the dense models;
the encoder-decoder also sends it its non-causal calls (the encoder's S ==
T, the cross-attention's S queries over T frames).
Two device kernels, chosen by dtype: bf16 goes to
``csrc/flash_attention_sm90.cu`` (wgmma on the tensor cores, fed by TMA or,
where TMA cannot take the strides, by element loads), float32 to
``csrc/flash_attention.cu`` (float32 FMAs on the CUDA cores); their
headers say what bounds them and how they are tiled.  This module holds

* :func:`attention_blocks` — softmax attention over blocks of query rows in
  plain PyTorch, the general function of the models' ``chunked_attention``
  (a query offset, valid cache lengths); it never holds more than one
  block's (block_q, T) scores;
* :func:`attention_partial` / :func:`softmax_partial` — the split
  softmax's partial (o, m, l) over one block of a cache split along T,
  at the block's global offset (``models/partition.py::
  split_kv_attention`` combines the blocks; plain PyTorch, as
  :func:`attention_blocks`: the reference's decode is plain jnp);
* :func:`flash_attention_plain` — the plain version of K5:
  :func:`attention_blocks` at query offset 0 and no cache lengths;
* :func:`flash_attention` — the wrapper: a CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises — there is no
  fallback.  It is forward-only (prefill) and refuses inputs that need a
  gradient;
* :func:`flash_attention_train` — the training entry, a
  ``torch.autograd.Function``: its forward is the wrapper (K5 on CUDA
  tensors, the plain version on CPU ones), its backward recomputes
  :func:`attention_blocks` with grad enabled and returns its VJP.  The
  reference has no backward kernel either: it differentiates its XLA
  attention.  Each recompute counts in ``recomputes`` (not in
  ``plain_calls``, which stays 0 on a card);
* ``launches``: ``flash_attention`` counts the wrapper's launches,
  ``flash_attention_sm90`` / ``flash_attention_f32`` those of each device
  kernel; ``producers`` counts the bf16 kernel's launches by how its tiles
  went in (``tma`` or ``loads``);
* ``plain_calls``: the plain version's calls on CUDA tensors (prefill on a
  card leaves it at 0);
* :func:`work` — the bytes and FLOPs the function needs for one call (the
  card check's bound and the dry run's count);
* ``meta_calls`` / ``meta_work`` / ``meta_reads``: on meta tensors (the
  dry run, ``launch.dryrun``) the wrapper launches nothing: it returns an
  empty output of the kernel's shape and dtype, adds one to
  ``meta_calls``, :func:`work`'s count to ``meta_work`` and the storages
  the kernel would read to ``meta_reads``, never to ``launches``.

Layout: the model's, q (B, S, H, dh), k (B, T, Hk, dh) and v (B, T, Hk,
dv) with H a multiple of Hk (query head h reads kv head h // (H / Hk)) and
dv <= dh.  The kernel reads any strides with a contiguous head dim, so (B,
H, S, dh) tensors go in as ``transpose(1, 2)`` views
(``ops.flash_attention``).  A v narrower than q and k (MLA: dh = 96, dv =
64) goes to the kernel zero-padded to dh, in one launch, and the output is
sliced back to dv: the padded columns are sums of zeros, so the result is
exact, and the scale stays 1/sqrt(dh).

Causal alignment: TOP-LEFT.  With ``causal`` key t is visible to query s
iff t <= s, whatever S and T are: the TPU kernel's mask (``k_pos <=
q_pos``) and the model's ``chunked_attention`` at ``q_offset=0``.  The
reference's oracle ``ref.attention_ref`` aligns bottom-right (``tril(k=T -
S)``); the two agree only when S == T, which is the only causal case the
models run.

Dtypes: float32 and bf16 (q, k, v alike).  Scores and softmax are float32
and the output is cast back to the input's dtype.  The float32 kernel's
products are float32; the bf16 kernel's take P rounded to bf16 into P V
(as every tensor-core flash attention), which moves its output from the
plain version's by at most 2^-8 max |v| (bf16's unit roundoff) before
the output's rounding.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import native

NEG_INF = -1e30   # masked score (the TPU kernel's NEG_INF; exp stays finite)
DH_MAX = 128      # widest head the kernel takes
_DTYPES = (torch.float32, torch.bfloat16)

launches = {"flash_attention": 0, "flash_attention_sm90": 0,
            "flash_attention_f32": 0}
producers = {"tma": 0, "loads": 0}
plain_calls = {"flash_attention_plain": 0}
recomputes = {"flash_attention_vjp": 0}
meta_calls = {"flash_attention": 0}
meta_work = {"bytes": 0, "flops": 0}
meta_reads = set()   # ``untyped_storage()._cdata`` of the inputs


def reset_launch_counts() -> None:
    for counts in (launches, producers, plain_calls, recomputes):
        for name in counts:
            counts[name] = 0
    reset_meta_counts()


def reset_meta_counts() -> None:
    """Zero the meta branch's counts alone (the dry run's)."""
    for counts in (meta_calls, meta_work):
        for name in counts:
            counts[name] = 0
    meta_reads.clear()


def work(B, S, H, Hk, dh, *, T=None, dv=None, causal=True,
         nbytes_el=2) -> tuple[int, int]:
    """(bytes, FLOPs) of one call, S queries over T keys (T = S unless
    given): q and o read and written over S, k and v over T, once each (q,
    k dh wide, v and o dv wide, dh unless given); 2 (dh + dv) FLOP per
    visible (query, key) pair and head (the scores and the P V product).
    Causal (top-left) query s sees min(s + 1, T) keys, S (S + 1) / 2 pairs
    at S == T; a non-causal call sees S T.  A v narrower than dh counts at
    its own width: the kernel's zero-padded columns are not work the
    function needs."""
    dv = dh if dv is None else dv
    T = S if T is None else T
    nbytes = nbytes_el * B * (dh + dv) * (S * H + T * Hk)
    if not causal:
        pairs = S * T
    elif S <= T:
        pairs = S * (S + 1) // 2
    else:
        pairs = T * (T + 1) // 2 + (S - T) * T
    return nbytes, 2 * (dh + dv) * B * H * pairs


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


def softmax_partial(s, *, t0=0, kv_len=None):
    """The split softmax's partial over one block of keys: ``s`` (B, ...,
    Tb) float32 scores of keys at global positions ``t0 + t``, masked to
    ``NEG_INF`` at or past ``kv_len`` (B,) where given; returns (p, m, l):
    m the block's row max (``NEG_INF`` on a block with no key, finite),
    p = exp(s - m) and l its row sum.  On a block that holds no valid
    position every score is ``NEG_INF``: m is too, and the combine's
    weight exp(m - M) is exactly 0 wherever another block holds one."""
    if kv_len is not None:
        t_idx = t0 + torch.arange(s.shape[-1], device=s.device)
        valid = t_idx[None, :] < kv_len[:, None]               # (B, Tb)
        s = s.masked_fill(~valid.reshape((s.shape[0],) + (1,) * (s.dim() - 2)
                                         + (s.shape[-1],)), NEG_INF)
    if s.shape[-1] == 0:
        m = s.new_full(s.shape[:-1], NEG_INF)
    else:
        m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return p, m, p.sum(dim=-1)


def attention_partial(q, k, v, *, t0=0, kv_len=None, scale=None):
    """The split softmax's partial of q (B, S, H, dh) over one block of keys
    k (B, Tb, Hk, dh), v (B, Tb, Hk, dv) at global positions ``t0 + t``
    (no causal mask; ``kv_len`` (B,) the valid cache lengths, None: all
    valid): float32 (o, m, l), o (B, S, H, dv) the unnormalised sum of
    exp(s - m) v, m and l (B, S, H) the row max and sum
    (:func:`softmax_partial`).  The blocks combine to :func:`attention_blocks`'
    softmax (``models/partition.py::split_kv_attention``): M = max m, out
    = sum(o e^(m - M)) / sum(l e^(m - M))."""
    B, S, H, dh = q.shape
    Hk = k.shape[2]
    G = H // Hk
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    qg = q.float().reshape(B, S, Hk, G, dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * scale
    p, m, l = softmax_partial(s, t0=t0, kv_len=kv_len)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    dv = v.shape[-1]
    # (B, Hk, G, S) -> (B, S, H): head h = kv head h // G, group h % G
    return (o.reshape(B, S, H, dv), m.permute(0, 3, 1, 2).reshape(B, S, H),
            l.permute(0, 3, 1, 2).reshape(B, S, H))


def flash_attention_plain(q, k, v, *, causal=True, block_q=512):
    """Plain version of K5 on the wrapper's inputs (top-left causal mask)."""
    if q.is_cuda:
        plain_calls["flash_attention_plain"] += 1
    return attention_blocks(q, k, v, causal=causal, block_q=block_q)


# ------------------------------------------------------------------ wrapper

def flash_attention(q, k, v, *, causal=True, block_q=512):
    """K5: attention of q (B, S, H, dh) over k (B, T, Hk, dh) and v (B, T,
    Hk, dv), dv <= dh, top-left causal mask with ``causal``; returns (B, S,
    H, dv) in q's dtype (on a card with q's strides where q is dense).

    CPU tensors take the plain version (``block_q`` bounds its scores'
    memory; the kernels tile by their own sizes); CUDA tensors launch the
    kernel of their dtype or raise; meta tensors are counted, not launched
    (``meta_calls``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, block_q=block_q)
    return _launch(q, k, v, causal)


# ----------------------------------------------------------------- training

class _FlashAttentionTrain(torch.autograd.Function):
    """K5 forward, autograd through the plain version in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.block_q = causal, block_q
        return flash_attention(q, k, v, causal=causal, block_q=block_q)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        recomputes["flash_attention_vjp"] += 1
        with torch.profiler.record_function("flash_attention_vjp"), \
                torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = attention_blocks(*leaves, causal=ctx.causal,
                                 block_q=ctx.block_q)
            dq, dk, dv = torch.autograd.grad(o, leaves, do)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, *, causal=True, block_q=512):
    """:func:`flash_attention` with a backward: K5 (or, on CPU tensors,
    the plain version) computes the output; the gradient is the plain
    version's, recomputed from the saved q, k, v (``block_q`` bounds its
    scores' memory)."""
    return _FlashAttentionTrain.apply(q, k, v, causal, block_q)


# ------------------------------------------------------------------- launch

@functools.cache
def _library(stem: str):
    """The float32 kernel (``flash_attention``) or the bf16 one
    (``flash_attention_sm90``, whose entry also reports its producer)."""
    lib = native.load(stem)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd = getattr(lib, f"{stem}_fwd")
    err = getattr(lib, f"{stem}_error_string")
    extra = [ctypes.POINTER(i)] if stem == "flash_attention_sm90" else []
    fwd.argtypes = ([p] * 4 + [ll] * 12 + [i] * 6 + [ctypes.c_float] + [i]
                    + extra + [p])
    fwd.restype = i
    err.argtypes = [i]
    err.restype = ctypes.c_char_p
    return fwd, err


def _check(q, k, v):
    """Raise on inputs the kernel does not take."""
    name = "flash_attention"
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: the CUDA path needs CUDA tensors, got "
                         f"{q.device}")
    for n, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {n} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {n} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape[:3] != v.shape[:3] or not 1 <= v.shape[3] <= q.shape[-1]:
        raise ValueError(f"{name}: q (B, S, H, dh), k (B, T, Hk, dh) and v "
                         f"(B, T, Hk, dv), dv <= dh; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
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
    T, Hk, dv = k.shape[1], k.shape[2], v.shape[3]
    if dv < dh:
        # a narrower v (MLA's 64 under a 96-wide q/k head) goes in
        # zero-padded to dh: the output's extra columns are sums of zeros,
        # sliced off below; the scale stays 1/sqrt(dh)
        v = torch.nn.functional.pad(v, (0, dh - dv))
    o = torch.empty_like(q)
    if S == 0 or B == 0:
        return o[..., :dv]
    if q.device.type == "meta":
        # the dry run: the kernel's allocations, its work counted, no launch
        nbytes, flops = work(B, S, H, Hk, dh, T=T, dv=dv, causal=causal,
                             nbytes_el=q.element_size())
        meta_calls["flash_attention"] += 1
        meta_work["bytes"] += nbytes
        meta_work["flops"] += flops
        meta_reads.update(t.untyped_storage()._cdata for t in (q, k, v))
        return o if dv == dh else o[..., :dv]
    bf16 = q.dtype == torch.bfloat16
    stem = "flash_attention_sm90" if bf16 else "flash_attention"
    fwd, err = _library(stem)
    producer = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 *(t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)),
                 B, S, T, H, Hk, dh, 1.0 / math.sqrt(dh), int(causal),
                 *([ctypes.byref(producer)] if bf16 else []), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed ({rc}: "
                           f"{err(rc).decode()})")
    launches["flash_attention"] += 1
    if bf16:
        launches["flash_attention_sm90"] += 1
        producers["tma" if producer.value == 1 else "loads"] += 1
    else:
        launches["flash_attention_f32"] += 1
    return o if dv == dh else o[..., :dv]
