"""GQA flash attention (K5), causal or not: the CUDA kernel's wrapper and
plain version.

Counterpart of the reference package's ``kernels/flash_attention.py``
Pallas kernel ``_kernel`` (K5), the prefill hot spot of the dense models;
the encoder-decoder also sends it its non-causal calls (the encoder's S ==
T, the cross-attention's S queries over T frames).
Three device kernels, chosen by dtype and query length: a bf16 call with
S <= :data:`S_SHORT` goes to ``csrc/flash_attention_short.cu`` (a few
query rows a block, float32 on the CUDA cores, the keys split over blocks
where T is long: a decode step's cross-attention), a longer one to
``csrc/flash_attention_sm90.cu`` (wgmma on the tensor cores, fed by TMA
or, where TMA cannot take the strides, by element loads), float32 to
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
* :func:`kernel_route` — the device kernel a call launches;
* :func:`short_plan` — the short kernel's grid for a call: rows a block,
  row tiles, key splits and keys a split;
* ``launches``: ``flash_attention`` counts the wrapper's launches,
  ``flash_attention_short`` / ``flash_attention_sm90`` /
  ``flash_attention_f32`` those of each device kernel; ``producers``
  counts the sm90 kernel's launches by how its tiles went in (``tma`` or
  ``loads``), ``instances`` by the (q/k width, v width) it was compiled
  for (``64x64``, ``96x64``, ``128x128``);
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
dv <= dh.  The kernels read any strides with a contiguous head dim, so (B,
H, S, dh) tensors go in as ``transpose(1, 2)`` views
(``ops.flash_attention``).  A v narrower than q and k (MLA: dh = 96, dv =
64): the bf16 kernels read it at its own width (MLA's shape has an sm90
instance of its own, q/k 96 over v 64) and write a dv-wide output; the
float32 kernel takes v as wide as q and k, so v goes to it zero-padded to
dh and its output is sliced back to dv (the padded columns are sums of
zeros, so the result is exact).  The scale stays 1/sqrt(dh).

Causal alignment: TOP-LEFT.  With ``causal`` key t is visible to query s
iff t <= s, whatever S and T are: the TPU kernel's mask (``k_pos <=
q_pos``) and the model's ``chunked_attention`` at ``q_offset=0``.  The
reference's oracle ``ref.attention_ref`` aligns bottom-right (``tril(k=T -
S)``); the two agree only when S == T, which is the only causal case the
models run.

Dtypes: float32 and bf16 (q, k, v alike).  Scores and softmax are float32
and the output is cast back to the input's dtype.  The float32 and the
short kernel's products are float32; the sm90 kernel's take P rounded to
bf16 into P V (as every tensor-core flash attention), which moves its
output from the plain version's by at most 2^-8 max |v| (bf16's unit
roundoff) before the output's rounding.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import native
from repro_torch.obs.profiling import scope

NEG_INF = -1e30   # masked score (the TPU kernel's NEG_INF; exp stays finite)
DH_MAX = 128      # widest head the kernel takes
_DTYPES = (torch.float32, torch.bfloat16)
# bf16 calls with at most this many queries take the short kernel: its
# crossover against the sm90 kernel on the H100 (PERF.md, chip_smoke.py's
# k5_crossover): faster at one query over 8 and over 1024 keys, at 16/16
# heads of 64 and 32/8 of 128; slower at two queries over 1024 keys
S_SHORT = 1
SHORT_ROWS = (1, 2)      # the short kernel's rows a block (its instances)
SHORT_SPLIT = 64         # the fewest keys of a split of the short kernel

launches = {"flash_attention": 0, "flash_attention_short": 0,
            "flash_attention_sm90": 0, "flash_attention_f32": 0}
producers = {"tma": 0, "loads": 0}
instances = {"64x64": 0, "96x64": 0, "128x128": 0}
plain_calls = {"flash_attention_plain": 0}
recomputes = {"flash_attention_vjp": 0}
meta_calls = {"flash_attention": 0}
meta_work = {"bytes": 0, "flops": 0}
meta_reads = set()   # ``untyped_storage()._cdata`` of the inputs


def reset_launch_counts() -> None:
    for counts in (launches, producers, instances, plain_calls,
                   recomputes):
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
    its own width: the float32 kernel's zero-padded columns are not work
    the function needs."""
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


def kernel_route(dtype, S) -> str:
    """The device kernel a call of ``dtype`` with S queries launches:
    ``"short"`` (bf16, S <= :data:`S_SHORT`), ``"sm90"`` (bf16) or
    ``"f32"``."""
    if dtype == torch.bfloat16:
        return "short" if S <= S_SHORT else "sm90"
    return "f32"


def short_plan(B, S, T, H, Hk, causal, n_sm) -> tuple[int, int, int, int]:
    """The short kernel's grid for a call on a card of ``n_sm`` SMs: (rows
    a block, row tiles, key splits, keys a split).  A block holds up to 2
    of a kv head's G S query rows (the smallest of :data:`SHORT_ROWS` that
    holds them all).  Without ``causal``, the keys are split, at least
    :data:`SHORT_SPLIT` a split and a multiple of 64, until the grid has
    about four blocks an SM; a causal call sees at most S keys and is never
    split."""
    R = (H // Hk) * S
    rb = next((r for r in SHORT_ROWS if r >= R), SHORT_ROWS[-1])
    n_rt = -(-R // rb)
    n_split = 1
    if not causal:
        n_split = max(1, min(-(-T // SHORT_SPLIT),
                             -(-4 * n_sm // (B * Hk * n_rt))))
    per = -(-T // n_split)          # keys a split, up to a multiple of 64
    per = -(-per // 64) * 64
    return rb, n_rt, -(-T // per), per


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
    H, dv) in q's dtype.  On a card a bf16 output is dense in q's order of
    dimensions (q's strides where q is dense and dv == dh; a contiguous
    output for a contiguous q whatever dv is), a float32 one is the first
    dv columns of an output with q's strides.

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
        with scope("flash_attention_vjp"), torch.enable_grad():
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
    """The float32 kernel (``flash_attention``) or a bf16 one
    (``flash_attention_sm90``, whose entry also reports its producer and
    instance; ``flash_attention_short``, whose entry takes its plan and
    scratch)."""
    return bind(native.load(stem), stem)


def bind(lib, stem: str):
    """(entry, error string) of a loaded K5 library, argument types set."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd = getattr(lib, f"{stem}_fwd")
    err = getattr(lib, f"{stem}_error_string")
    # the bf16 entries also take dv; sm90's reports (producer, DK, DV),
    # short's takes (rows a block, splits, keys a split) and its scratch
    tail = {"flash_attention": [],
            "flash_attention_sm90": [ctypes.POINTER(i)],
            "flash_attention_short": [i] * 3 + [p] * 3}[stem]
    fwd.argtypes = ([p] * 4 + [ll] * 12
                    + [i] * (6 if stem == "flash_attention" else 7)
                    + [ctypes.c_float] + [i] + tail + [p])
    fwd.restype = i
    err.argtypes = [i]
    err.restype = ctypes.c_char_p
    return fwd, err


@functools.cache
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_TICKETS = {}   # device index -> int32 tickets, all 0 between calls


def _tickets(device, n: int):
    """The short kernel's split tickets: zeros kept per device (the last
    block of each ticket sets it back to 0, and the port issues its calls
    on one stream, in order), so a call launches no fill.  Under CUDA
    graph capture a first buffer is not kept: it belongs to the graph's
    pool."""
    t = _TICKETS.get(device.index)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        if not torch.cuda.is_current_stream_capturing():
            _TICKETS[device.index] = t
    return t


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


def _launch(q, k, v, causal, route=None):
    """Check, allocate and launch; ``route`` (``"short"`` or ``"sm90"``,
    bf16 only) overrides the choice by S, to time one kernel against the
    other."""
    _check(q, k, v)
    B, S, H, dh = q.shape
    T, Hk, dv = k.shape[1], k.shape[2], v.shape[3]
    bf16 = q.dtype == torch.bfloat16
    if route is None:
        route = kernel_route(q.dtype, S)
    elif route not in (("short", "sm90") if bf16 else ("f32",)):
        raise ValueError(f"flash_attention: route {route!r} for {q.dtype}")
    if bf16:
        # v at its own width; o (B, S, H, dv) dense in q's dimension order
        # (empty_like keeps the order of a non-dense view), so a contiguous
        # q gives a contiguous o and the model's (B, S, H * dv) a view
        o = torch.empty_like(q[..., :dv])
    else:
        # the float32 kernel's padded route: v zero-padded to dh, the
        # output's extra columns sums of zeros, sliced off on return
        if dv < dh:
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
        return o if o.shape[-1] == dv else o[..., :dv]
    stem = {"short": "flash_attention_short", "sm90": "flash_attention_sm90",
            "f32": "flash_attention"}[route]
    fwd, err = _library(stem)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *(t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)),
            B, S, T, H, Hk, dh, *([dv] if bf16 else []),
            1.0 / math.sqrt(dh), int(causal)]
    chosen = (ctypes.c_int * 3)(-1, -1, -1)   # sm90: producer, DK, DV
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "short":
            rb, n_rt, n_split, per = short_plan(
                B, S, T, H, Hk, causal, _n_sm(q.device.index))
            scratch = [None] * 3
            if n_split > 1:   # each split's float32 (o, m, l) and tickets
                rows = B * Hk * n_rt * n_split * rb
                part_o = torch.empty(rows * dv, dtype=torch.float32,
                                     device=q.device)
                part_ml = torch.empty(rows * 2, dtype=torch.float32,
                                      device=q.device)
                tickets = _tickets(q.device, B * Hk * n_rt)
                scratch = [t.data_ptr() for t in (part_o, part_ml, tickets)]
            args += [rb, n_split, per, *scratch]
        elif route == "sm90":
            args.append(chosen)
        rc = fwd(*args, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed ({rc}: "
                           f"{err(rc).decode()})")
    launches["flash_attention"] += 1
    if route == "sm90":
        launches["flash_attention_sm90"] += 1
        producers["tma" if chosen[0] == 1 else "loads"] += 1
        instances[f"{chosen[1]}x{chosen[2]}"] += 1
    elif route == "short":
        launches["flash_attention_short"] += 1
    else:
        launches["flash_attention_f32"] += 1
    return o if o.shape[-1] == dv else o[..., :dv]
