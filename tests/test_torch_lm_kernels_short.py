"""Torch twin of K5's short-query kernel (``csrc/flash_attention_short.cu``),
held against the port's plain version, the JAX package's Pallas kernel
(interpret mode, as ``tests/test_kernels.py`` runs it) and the split
softmax's partials (``flash_attention.attention_partial``) and combine
(``models/partition.py::split_kv_attention``'s rule).

The twin repeats the kernel's walk at the grid ``short_plan`` gives: a
block holds up to 2 of a kv head's G S query rows (row r = s G + g), q in
float32 times scale * log2 e so that scores are in log2 units; a key
belongs to a group of L lanes (8 where dh <= 64, else 16: 128 / L groups
a block), a step gives each group 4 consecutive keys and each group runs
its own online softmax (exp2, -1e30 masking of keys past the block's end
or, with ``causal``, past the row's s); the groups of a warp merge
pairwise as the kernel's xor shuffles pair them,
then the four warps in order, by M = max m, o = sum o 2^(m - M), l = sum
l 2^(m - M); where the keys are split over blocks, the splits merge by the
same rule in split order.  P stays float32, so on bf16-valued inputs in
float32 the twin agrees with the plain version to float32 rounding (1e-5
max |v|).  Inputs are drawn with numpy from a seed.
"""
import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as FA

N_SM = 132   # the H100's SMs: the plans the card runs


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


def _bf16_valued(rng, shape):
    """float32 values that bf16 holds exactly."""
    x = torch.tensor(rng.normal(0, 1, shape), dtype=torch.float32)
    return x.to(torch.bfloat16).float()


def _short_parts(q, k, v, causal, n_sm=N_SM):
    """Torch twin of ``flash_short_kernel`` up to its scratch: model layout
    q (B, S, H, dh), k (B, T, Hk, dh), v (B, T, Hk, dv), float32.  Returns
    the plan and, per row tile, each split's merged (o, m, l) over the
    tile's rows (o (B, Hk, rows, dv), m and l (B, Hk, rows), m in log2
    units)."""
    B, S, H, dh = q.shape
    T, Hk, dv = k.shape[1], k.shape[2], v.shape[3]
    G, R = H // Hk, (H // Hk) * S
    rb, n_rt, n_split, per = FA.short_plan(B, S, T, H, Hk, causal, n_sm)
    L = 8 if dh <= 64 else 16            # lanes a key
    kpg = 4                              # keys a group a step
    groups, step = 128 // L, 128 // L * kpg
    sl2 = np.float32(np.float32(1.0 / math.sqrt(dh)) *
                     np.float32(math.log2(math.e)))
    # rows r = s G + g of each kv head, q scaled into log2 units
    qr = (q.reshape(B, S, Hk, G, dh).permute(0, 2, 1, 3, 4)
          .reshape(B, Hk, R, dh)) * float(sl2)
    pad = (0, 0, 0, 0, 0, n_split * per + step - T)   # zero rows past T
    kt, vt = (F.pad(t, pad).transpose(1, 2) for t in (k, v))
    tiles = []
    for rt in range(n_rt):
        rows = torch.arange(rt * rb, min(R, rt * rb + rb))
        srow = rows // G
        qi = qr[:, :, rows]
        parts = []
        for sp in range(n_split):
            t_lo, t_hi = sp * per, min(T, sp * per + per)
            if causal:
                t_hi = min(t_hi, int(srow.max()) + 1)
            # every group's online softmax at once: (B, Hk, rows, groups)
            o = torch.zeros((B, Hk, len(rows), groups, dv))
            m = torch.full((B, Hk, len(rows), groups), -1e30)
            l = torch.zeros((B, Hk, len(rows), groups))
            for t0 in range(t_lo, t_hi, step):
                keys = t0 + torch.arange(step).reshape(groups, kpg)
                kk = kt[:, :, t0:t0 + step].reshape(B, Hk, groups, kpg, dh)
                vv = vt[:, :, t0:t0 + step].reshape(B, Hk, groups, kpg, dv)
                s = torch.einsum("bhrd,bhgjd->bhrgj", qi, kk)
                vis = (keys < t_hi)[None].expand(len(rows), groups, kpg)
                if causal:
                    vis = vis & (keys[None] <= srow[:, None, None])
                s = s.masked_fill(~vis, -1e30)
                mn = torch.maximum(m, s.amax(-1))
                a = torch.exp2(m - mn)
                p = torch.exp2(s - mn[..., None])
                l = l * a + p.sum(-1)
                o = o * a[..., None] + torch.einsum("bhrgj,bhgjd->bhrgd", p,
                                                    vv)
                m = mn
            gs = [(o[..., g, :], m[..., g], l[..., g]) for g in range(groups)]
            # a warp's groups pair as its xor shuffles pair them (distance
            # 1, 2, ... in groups), then the four warps in order
            per_warp, warps = 32 // L, []
            for w in range(4):
                grp = gs[w * per_warp:(w + 1) * per_warp]
                d = 1
                while d < per_warp:
                    grp = [_merge([grp[i], grp[i ^ d]])
                           for i in range(per_warp)]
                    d *= 2
                warps.append(grp[0])
            parts.append(_merge(warps))
        tiles.append(parts)
    return (rb, n_rt, n_split, per), tiles


def _merge(parts):
    """(o, m, l) of blocks merged: M = max m, o = sum o 2^(m - M), l = sum
    l 2^(m - M) (m in log2 units), in the order given."""
    M = torch.stack([m for _, m, _ in parts]).amax(0)
    o = sum(o * torch.exp2(m - M)[..., None] for o, m, _ in parts)
    l = sum(l * torch.exp2(m - M) for _, m, l in parts)
    return o, M, l


def _short_twin(q, k, v, causal, n_sm=N_SM):
    """The twin's output, (B, S, H, dv) float32."""
    B, S, H, dh = q.shape
    Hk, dv = k.shape[2], v.shape[3]
    _, tiles = _short_parts(q, k, v, causal, n_sm)
    outs = []
    for parts in tiles:
        o, _, l = _merge(parts)
        outs.append(o / l.clamp_min(1e-30)[..., None])
    out = torch.cat(outs, dim=2)                         # (B, Hk, G S, dv)
    return (out.reshape(B, Hk, S, H // Hk, dv).permute(0, 2, 1, 3, 4)
            .reshape(B, S, H, dv))


def _inputs(S, T, H, Hk, dh, dv, causal, B=2):
    rng = _rng("short", S, T, H, Hk, dh, dv, causal)
    return (_bf16_valued(rng, (B, S, H, dh)), _bf16_valued(rng, (B, T, Hk, dh)),
            _bf16_valued(rng, (B, T, Hk, dv)))


CASES = [pytest.param(S, T, dh, dv, causal,
                      id=f"S{S}-T{T}-dh{dh}-dv{dv}-{causal}")
         for S in (1, 3, 16) for T in (1, 8, 1000)
         for dh, dv in ((64, 64), (100, 100), (128, 128), (96, 64))
         for causal in (False, True)]


@pytest.mark.parametrize("S,T,dh,dv,causal", CASES)
def test_short_twin_vs_plain(S, T, dh, dv, causal):
    """Every (S, T, head width, causal) of the grid, GQA 4/2 (G S rows up to
    32: sixteen row tiles at S 16), against the plain version in float32 at
    1e-5 max |v|: the twin's P is float32, as the kernel's."""
    q, k, v = _inputs(S, T, 4, 2, dh, dv, causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    got = _short_twin(q, k, v, causal)
    assert got.shape == (2, S, 4, dv)
    assert float((got - want).abs().max()) <= 1e-5 * float(v.abs().max())


@pytest.mark.parametrize("H,Hk,S", [(32, 8, 1), (32, 8, 16), (16, 16, 1),
                                    (40, 40, 3)])
def test_short_twin_gqa_and_row_tiles(H, Hk, S):
    """The configs' head groups (phi3.5-moe / llava 32/8, seamless 16/16,
    minicpm3 40/40): G S rows in tiles of up to 2 (64 rows: 32 tiles)."""
    q, k, v = _inputs(S, 300, H, Hk, 64, 64, False, B=1)
    want = FA.flash_attention_plain(q, k, v, causal=False)
    got = _short_twin(q, k, v, False)
    assert float((got - want).abs().max()) <= 1e-5 * float(v.abs().max())


@pytest.mark.parametrize("S,T,causal", [(1, 8, False), (3, 1000, False),
                                        (16, 200, True), (1, 1, True)])
def test_short_twin_vs_pallas(S, T, causal):
    """Against the Pallas kernel by the interpreter on the same bf16-valued
    inputs, float32 throughout, at 3e-5 (its exp and the twin's exp2 round
    apart; as the sm90 twin's test).  The Pallas kernel aligns its causal
    mask top-left too (``k_pos <= q_pos``)."""
    q, k, v = _inputs(S, T, 4, 2, 64, 64, causal, B=1)
    to_j = lambda t: jnp.asarray(t.transpose(1, 2).numpy())
    want = jops.flash_attention(to_j(q), to_j(k), to_j(v), causal=causal,
                                bq=S, bk=T)
    got = _short_twin(q, k, v, causal)
    gap = float(np.abs(got.transpose(1, 2).numpy() - np.asarray(want)).max())
    assert gap <= 3e-5


@pytest.mark.parametrize("S,T,dh,dv", [(1, 1000, 64, 64), (16, 1000, 128, 128),
                                       (3, 1000, 96, 64)])
def test_short_splits_vs_attention_partial(S, T, dh, dv):
    """Where the plan splits the keys, each split's (o, m, l) is
    ``attention_partial`` of its keys at its offset (m in log2 units), and
    the merge of the splits is the split softmax's combine, M = max m, out
    = sum o e^(m - M) / sum l e^(m - M)."""
    B, H, Hk = 2, 4, 2
    q, k, v = _inputs(S, T, H, Hk, dh, dv, False, B=B)
    (rb, n_rt, n_split, per), tiles = _short_parts(q, k, v, False)
    assert n_split > 1 and (n_split - 1) * per < T <= n_split * per
    G = H // Hk

    def heads(x):
        """(B, Hk, G S, ...) rows r = s G + g to (B, S, H, ...)."""
        x = x.reshape(B, Hk, S, G, *x.shape[3:]).transpose(1, 2)
        return x.reshape(B, S, H, *x.shape[4:])

    os_, ms, ls = [], [], []
    for sp in range(n_split):
        sl = slice(sp * per, min(T, sp * per + per))
        o, m, l = FA.attention_partial(q, k[:, sl], v[:, sl], t0=sl.start)
        os_.append(o)
        ms.append(m)
        ls.append(l)
        # the twin's split partials in the partial's layout (B, S, H, ...)
        to = torch.cat([t[sp][0] for t in tiles], dim=2)
        tm = torch.cat([t[sp][1] for t in tiles], dim=2)
        tl = torch.cat([t[sp][2] for t in tiles], dim=2)
        scale = float(v.abs().max()) * float(l.max())
        assert float((heads(to) - o).abs().max()) <= 1e-5 * scale
        assert float((heads(tm) * math.log(2) - m).abs().max()) <= 1e-5 * \
            float(m.abs().max())
        assert float((heads(tl) - l).abs().max()) <= 1e-5 * float(l.max())
    M = torch.stack(ms).amax(0)
    a = [torch.exp(m - M) for m in ms]
    want = sum(o * w[..., None] for o, w in zip(os_, a)) / \
        sum(l * w for l, w in zip(ls, a))[..., None]
    got = _short_twin(q, k, v, False)
    assert float((got - want).abs().max()) <= 1e-5 * float(v.abs().max())


@pytest.mark.parametrize("B,S,T,H,Hk,causal,want", [
    (4, 1, 8, 16, 16, False, (1, 1, 1, 64)),       # seamless's decode call
    (4, 1, 1024, 16, 16, False, (1, 1, 8, 128)),   # the decode at T 1024
    (1, 1, 1024, 32, 8, False, (2, 2, 16, 64)),    # GQA 4: 2 row tiles
    (1, 16, 1024, 32, 8, False, (2, 32, 3, 384)),  # 64 rows: 32 row tiles
    (1, 3, 4096, 40, 40, True, (2, 2, 1, 4096)),   # causal: one split
    (2, 5, 300, 8, 2, False, (2, 10, 5, 64)),      # G S = 20: 10 row tiles
])
def test_short_plan(B, S, T, H, Hk, causal, want):
    """The grid of the card's calls: rows a block, row tiles, key splits
    (at least 64 keys and a multiple of 64 a split, about four blocks an
    SM, every split holding keys), no split with ``causal``."""
    plan = FA.short_plan(B, S, T, H, Hk, causal, N_SM)
    assert plan == want
    rb, n_rt, n_split, per = plan
    assert rb * n_rt >= (H // Hk) * S and per % 64 == 0
    assert (n_split - 1) * per < T <= n_split * per


def test_kernel_route_by_dtype_and_length():
    """bf16 calls of at most S_SHORT queries take the short kernel, longer
    ones the sm90 kernel, float32 calls the float32 kernel; S_SHORT is set
    from the card's crossover, at most 64."""
    assert 1 <= FA.S_SHORT <= 64
    assert FA.kernel_route(torch.bfloat16, 1) == "short"
    assert FA.kernel_route(torch.bfloat16, FA.S_SHORT) == "short"
    assert FA.kernel_route(torch.bfloat16, FA.S_SHORT + 1) == "sm90"
    assert FA.kernel_route(torch.float32, 1) == "f32"
    assert FA.kernel_route(torch.float32, 4096) == "f32"
