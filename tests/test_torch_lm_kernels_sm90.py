"""Torch twins of the Hopper designs of K5 (flash attention on the tensor
cores) and K6 (WKV6 split into a chunk, a scan and an output kernel), held
against the port's plain versions and the JAX package's Pallas kernels
(interpret mode, as ``tests/test_kernels.py`` and
``tests/test_kernels_wkv6.py`` run them).

K5's twin repeats ``csrc/flash_attention_sm90.cu``'s loop at the instance
the kernel picks for (dh, dv): 128-row query tiles in two 64-row halves, kv
tiles of 128 rows at every instance, v at its own width (MLA's 96 over 64
has an instance of its own), the walk stopping at the block's last visible
tile
and a half skipping
tiles wholly above its rows, the -1e30 mask only on tiles that cross the
diagonal or the end of T (the twin checks that every other tile has
nothing to mask), exp2 with scale * log2 e folded into one multiply, P
rounded to bf16 before P V and l summing the unrounded p.  On bf16-valued
inputs in float32 its output may differ from the plain version's, which
keeps P in float32, by sum_j |p_j - bf16(p_j)| |v_j| / l <= u max |v|,
where u = 2^-8 is bf16's unit roundoff (8 significant bits), plus float32
rounding of the sums (1e-5 here).

K6's twin repeats ``csrc/wkv6.cu``: a chunk pass, the same for every
chunk of 32 steps (ragged end padded with r = k = v = 0, w = 1), giving the
intra-chunk y with the pairwise exponent (esc the previous step's seg),
r~ = r e^esc, d_n = e^seg_last and
dS_n = (k e^(seg_last - seg))^T v; then the scan, S_{n+1} = diag(d_n) S_n +
dS_n elementwise from S_0 = 0, walking the chunks in order; then the output
pass, y += r~ S_n for every chunk at once.  The split is exact algebra: in
float64 it agrees with the plain version to 1e-10; in float32 with the
Pallas kernel at the reference's 2e-4, under strong decay and a ragged T.
Inputs are drawn with numpy from a seed and handed to both packages.
"""
import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.kernels.wkv6 import wkv6_pallas
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import wkv6 as WK

BF16_U = 2.0 ** -8   # bf16's unit roundoff


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module's tests run: the test workers
    are the parallelism."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


# ------------------------------------------------------------------ K5

def _bf16_valued(rng, shape):
    """float32 values that bf16 holds exactly."""
    x = torch.tensor(rng.normal(0, 1, shape), dtype=torch.float32)
    return x.to(torch.bfloat16).float()


def _sm90_instance(dh, dv):
    """(DK, DV) of the instance ``flash_attention_sm90_fwd`` launches."""
    if dh <= 64:
        return 64, 64
    if dh <= 96 and dv <= 64:
        return 96, 64
    return 128, 128


def _flash_sm90_twin(q, k, v, causal):
    """Torch twin of ``flash_fwd_sm90_kernel``; model layout q (B, S, H, dh),
    k (B, T, Hk, dh), v (B, T, Hk, dv), float32 in and out (B, S, H, dv)."""
    B, S, H, dh = q.shape
    T, Hk, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hk
    bq, bk = 128, 128
    sl2 = math.log2(math.e) / math.sqrt(dh)
    n_q, n_t = -(-S // bq), -(-T // bk)
    qf = F.pad(q.transpose(1, 2), (0, 0, 0, n_q * bq - S))
    kf, vf = (F.pad(t.repeat_interleave(G, dim=2).transpose(1, 2),
                    (0, 0, 0, n_t * bk - T)) for t in (k, v))
    out = torch.zeros((B, H, n_q * bq, dv))
    for qt in range(n_q):
        q0 = qt * bq
        n_kv = min(n_t, (min(q0 + bq, S) - 1) // bk + 1) if causal else n_t
        for half in range(2):
            row_min = q0 + 64 * half
            if row_min >= S:
                continue
            row_max = min(row_min + 63, S - 1)
            rows = torch.arange(row_min, row_min + 64)
            qi = qf[:, :, row_min:row_min + 64]
            m = torch.full((B, H, 64), -1e30)
            l = torch.zeros((B, H, 64))
            acc = torch.zeros((B, H, 64, dv))
            for kt in range(n_kv):
                k0 = kt * bk
                if causal and k0 > row_max:
                    continue   # wholly above this half's rows
                s = qi @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
                cols = torch.arange(k0, k0 + bk)
                dead = (cols >= T)[None, :].expand(64, bk)
                if causal:
                    dead = dead | (cols[None, :] > rows[:, None])
                if k0 + bk > T or (causal and k0 + bk - 1 > row_min):
                    s = s.masked_fill(dead, -1e30)
                else:
                    assert not bool(dead.any())
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2((m - m_new) * sl2)
                p = torch.exp2(s * sl2 - (m_new * sl2)[..., None])
                l = l * alpha + p.sum(-1)
                pv = p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + bk]
                acc = acc * alpha[..., None] + pv
                m = m_new
            out[:, :, row_min:row_min + 64] = acc / l.clamp_min(1e-30)[
                ..., None]
    return out[:, :, :S].transpose(1, 2)


def _narrow(S, T, H, Hk, dh, dv, causal, what):
    """A case whose v is narrower than q and k: ``dh`` is (dh, dv)."""
    return pytest.param(S, T, H, Hk, (dh, dv), causal,
                        id=f"{S}-{T}-{H}-{Hk}-{dh}v{dv}-{causal}-{what}")


@pytest.mark.parametrize("S,T,H,Hk,dh,causal", [
    (128, 128, 4, 2, 64, True),      # one query tile, one kv tile
    (300, 300, 4, 1, 64, True),      # ragged S = T, tiles of 128
    (200, 200, 2, 2, 100, True),     # dh 100: padded to 128
    (130, 130, 2, 1, 128, True),     # dh 128, a second query tile of 2 rows
    # the (128, 128) instance: T not a multiple of 128, GQA 32/8
    (300, 300, 32, 8, 128, True),
    (200, 333, 32, 8, 128, True),
    (333, 200, 32, 8, 128, False),
    (64, 130, 32, 8, 128, True),     # one live half (the other past S)
    (70, 200, 4, 2, 64, True),       # S < T, top-left mask
    (200, 70, 4, 2, 64, True),       # S > T: the half past T's diagonal
    (150, 333, 2, 1, 32, False),     # not causal, ragged end of T
    # MLA's instance, q/k 96 over v 64, kv tiles of 128
    _narrow(300, 300, 4, 4, 96, 64, True, "mla-ragged"),
    _narrow(200, 200, 8, 2, 96, 64, True, "mla-gqa"),
    _narrow(70, 200, 4, 2, 96, 64, True, "mla-s-lt-t"),
    _narrow(150, 333, 4, 2, 96, 64, False, "mla-not-causal"),
    # the other narrow v's: each instance reads v at its own width
    _narrow(200, 200, 4, 2, 64, 32, True, "dk64"),
    _narrow(200, 200, 4, 2, 96, 80, True, "dk128"),
    _narrow(130, 130, 2, 1, 128, 64, True, "dk128-dv64"),
])
def test_flash_sm90_twin_vs_plain(S, T, H, Hk, dh, causal):
    dh, dv = dh if isinstance(dh, tuple) else (dh, dh)
    rng = _rng("sm90", S, T, dh, causal) if dv == dh else \
        _rng("sm90", S, T, dh, dv, causal)
    q = _bf16_valued(rng, (2, S, H, dh))
    k = _bf16_valued(rng, (2, T, Hk, dh))
    v = _bf16_valued(rng, (2, T, Hk, dv))
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    got = _flash_sm90_twin(q, k, v, causal)
    assert got.shape == (2, S, H, dv)
    gap = float((got - want).abs().max())
    assert gap <= BF16_U * float(v.abs().max()) + 1e-5
    assert gap > 0   # P's rounding is modelled, not skipped


def test_flash_sm90_twin_vs_pallas():
    """Small shape against the Pallas kernel run by the interpreter on the
    same bf16-valued inputs, float32 throughout (its P stays float32)."""
    rng = _rng("sm90-pallas")
    q = _bf16_valued(rng, (1, 4, 256, 64))
    k, v = (_bf16_valued(rng, (1, 2, 256, 64)) for _ in range(2))
    want = jops.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                causal=True, bq=64, bk=64)
    got = _flash_sm90_twin(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), True).transpose(1, 2)
    gap = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert gap <= BF16_U * float(v.abs().max()) + 3e-5


# ------------------------------------------------------------------ K6

def _rkvwu(rng, B, T, H, P, w=None):
    r, k, v = (rng.normal(0, 1, (B, T, H, P)).astype(np.float32)
               for _ in range(3))
    w = (rng.uniform(0.2, 0.98, (B, T, H, P)).astype(np.float32) if w is None
         else np.full((B, T, H, P), w, np.float32))
    u = rng.normal(0, 1, (H, P)).astype(np.float32)
    return r, k, v, w, u


def _wkv6_split_twin(r, k, v, w, u, c=32):
    """Torch twin of ``wkv6_chunk_kernel``, ``wkv6_scan_kernel`` and
    ``wkv6_out_kernel``."""
    B, T, H, P = r.shape
    n = -(-T // c)
    pad = (0, 0, 0, 0, 0, n * c - T)
    r, k, v = (F.pad(t, pad).reshape(B, n, c, H, P) for t in (r, k, v))
    lw = torch.log2(F.pad(w, pad, value=1.0) + 1e-38).reshape(B, n, c, H, P)
    seg = torch.cumsum(lw, dim=2)
    esc = F.pad(seg[:, :, :-1], (0, 0, 0, 0, 1, 0))   # seg of the step before
    # chunk pass: every chunk alike, no state
    below = torch.tril(torch.ones((c, c), dtype=torch.bool), diagonal=-1)
    dec = torch.where(below[None, None, :, :, None, None],
                      torch.exp2(esc[:, :, :, None] - seg[:, :, None, :]),
                      0.0)
    a = torch.einsum("bnihp,bnjhp,bnijhp->bnhij", r, k, dec)
    a = a + torch.diag_embed(torch.einsum("bnihp,hp,bnihp->bnhi", r, u, k))
    y = torch.einsum("bnhij,bnjhq->bnihq", a, v)
    rt = r * torch.exp2(esc)
    d = torch.exp2(seg[:, :, -1])                                 # (B,n,H,P)
    ds = torch.einsum("bnjhp,bnjhq->bnhpq",
                      k * torch.exp2(seg[:, :, -1:] - seg), v)
    # scan: S_n, the state entering chunk n, elementwise over (p, q)
    S, states = torch.zeros_like(ds[:, 0]), []
    for i in range(n):
        states.append(S)
        S = d[:, i, ..., None] * S + ds[:, i]
    # output pass: every chunk at once
    y = y + torch.einsum("bnihp,bnhpq->bnihq", rt, torch.stack(states, 1))
    return y.reshape(B, n * c, H, P)[:, :T]


@pytest.mark.parametrize("B,T,H,P,chunk,w", [
    (2, 96, 2, 16, 32, None),    # whole chunks
    (1, 100, 2, 64, 50, None),   # ragged end: 100 = 3 * 32 + 4
    (3, 99, 2, 16, 33, None),    # B = 3, ragged
    (1, 5, 3, 16, 5, None),      # T < c
    (1, 64, 1, 16, 64, 0.05),    # strong decay
    (1, 40, 1, 12, 20, None),    # P not a multiple of 16 (padded)
])
def test_wkv6_split_twin_vs_plain(B, T, H, P, chunk, w):
    arrs = [torch.tensor(a) for a in _rkvwu(_rng("split", B, T, P, w),
                                            B, T, H, P, w=w)]
    assert bool(torch.isfinite(_wkv6_split_twin(*arrs)).all())
    arrs = [a.double() for a in arrs]
    want = WK.wkv6_plain(*arrs, chunk=chunk)
    got = _wkv6_split_twin(*arrs)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wkv6_split_twin_strong_decay_in_float32(seed):
    """Under a strong decay (w = 0.05: |seg| reaches 138 in log2 units over
    a chunk) the float32 twin stays within 2e-5 (1 + |want|) of the plain
    version in float64, a tenth of the reference's bound: its esc is the
    previous step's seg, so the adjacent pair's exponent is exactly 0.
    Taken as seg - log w instead, it rounds at seg's scale and the twin
    misses this bound (the kernel missed 2e-4 on the card)."""
    B, T, H, P = 2, 256, 4, 64
    arrs = [torch.tensor(a) for a in _rkvwu(_rng("strong", seed), B, T, H, P,
                                            w=0.05)]
    want = WK.wkv6_plain(*(a.double() for a in arrs), chunk=64)
    got = _wkv6_split_twin(*arrs).double()
    assert float(((got - want).abs() / (1 + want.abs())).max()) <= 2e-5


@pytest.mark.parametrize("T,w", [(48, None), (48, 0.05), (20, None)])
def test_wkv6_split_twin_vs_pallas(T, w):
    """float32 against ``wkv6_pallas`` by the interpreter (its own chunk
    divides T; the twin's 32 does not)."""
    B, H, P = 2, 2, 16
    arrs = _rkvwu(_rng("split-pallas", T, w), B, T, H, P, w=w)
    if w is not None:
        arrs = arrs[:4] + (np.zeros_like(arrs[4]),)
    r, k, v, w_, u = (jnp.asarray(a) for a in arrs)
    bh = lambda x: x.transpose(0, 2, 1, 3).reshape(B * H, T, P)
    want = wkv6_pallas(bh(r), bh(k), bh(v), bh(w_),
                       jnp.broadcast_to(u[None], (B, H, P)).reshape(B * H, P),
                       chunk=T // 2 if T % 2 == 0 else T, interpret=True)
    want = np.asarray(want).reshape(B, H, T, P).transpose(0, 2, 1, 3)
    got = _wkv6_split_twin(*(torch.tensor(a) for a in arrs))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_launch_counters_name_every_device_kernel():
    """The wrappers count their calls and each device kernel's launches
    apart, and a reset clears all of them."""
    assert set(FA.launches) == {"flash_attention", "flash_attention_short",
                                "flash_attention_sm90",
                                "flash_attention_f32"}
    assert set(FA.producers) == {"tma", "loads"}
    assert set(FA.instances) == {
        f"{dk}x{dv}" for dk, dv in (_sm90_instance(64, 64),
                                    _sm90_instance(96, 64),
                                    _sm90_instance(128, 128))}
    assert set(WK.launches) == {"wkv6", "wkv6_chunk", "wkv6_scan",
                                "wkv6_out"}
    FA.producers["tma"] += 1
    FA.instances["96x64"] += 1
    FA.launches["flash_attention_short"] += 1
    FA.reset_launch_counts()
    WK.reset_launch_counts()
    assert not any(FA.launches.values()) and not any(FA.producers.values())
    assert not any(FA.instances.values())
    assert not any(WK.launches.values())
