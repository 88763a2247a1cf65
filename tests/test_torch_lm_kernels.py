"""PyTorch port of the LLM kernels against the JAX package: flash attention
(K5, Pallas ``flash_attention._kernel``) and WKV6 (K6, Pallas
``wkv6._kernel``).

On CPU tensors the port's wrappers take the plain versions, so here they are
held against

* the JAX entries ``ops.flash_attention`` / ``ops.wkv6`` with the Pallas
  kernels run by the Pallas interpreter (as ``tests/test_kernels.py`` and
  ``tests/test_kernels_wkv6.py`` run them), at those tests' shapes and their
  own bounds: attention 3e-4 in float32 and 5e-2 in bf16, WKV6 2e-4;
* ``flash_attention_pallas(..., interpret=True)`` for causal S != T, where
  the kernel's mask is aligned top-left (the port keeps that alignment;
  ``ref.attention_ref`` aligns bottom-right, and a test records where the
  two differ);
* the reference's ``models.ssm._wkv6_chunked``.

Torch twins of the CUDA kernels' tiling (K5: 64 x 64 tiles with an online
softmax, the stop at the diagonal tile and a masked ragged tail; K6: its
chunk of 32 steps with a padded ragged tail and the pairwise exponent) are
held against the plain versions here: K5's in float32 at 1e-5 (only the
order of float32 sums differs), K6's in float64 at 1e-10, since in float32
the plain version's own rounding over chunks of 50-64 steps reaches 7e-6 of
max |y| (the chunking is exact algebra, so in float64 the two agree to the
last bits); the float32 twin must stay finite under strong decay.  Inputs
are drawn with numpy from a seed and handed to both packages.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.ssm import _wkv6_chunked as j_wkv6_chunked
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as WK


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


def _qkv(rng, B, H, Hk, S, T, dh):
    """(B, H, S, dh) q and (B, Hk, T, dh) k, v: the reference's layout."""
    return (rng.normal(0, 1, (B, H, S, dh)).astype(np.float32),
            rng.normal(0, 1, (B, Hk, T, dh)).astype(np.float32),
            rng.normal(0, 1, (B, Hk, T, dh)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------------ K5

@pytest.mark.parametrize("B,H,Hk,S,T,dh,causal", [
    (2, 4, 2, 128, 128, 64, True),
    (1, 8, 8, 256, 256, 128, True),
    (2, 4, 1, 128, 256, 64, False),   # cross-attention-style, MQA grouping
    (2, 4, 4, 128, 32, 64, False),    # the encoder-decoder's cross-attention:
                                      # S tokens over S / 4 frames
    (1, 2, 2, 64, 64, 100, True),     # head dim that is not a power of two
])
def test_flash_attention_plain_vs_pallas(B, H, Hk, S, T, dh, causal):
    q, k, v = _qkv(_rng("fa", B, H, S, T, dh), B, H, Hk, S, T, dh)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, bq=64, bk=64)
    before = dict(FA.launches)
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal)
    assert FA.launches == before and got.shape == (B, H, S, dh)
    _close(got, want, 3e-4)


def test_flash_attention_plain_vs_pallas_bf16():
    q, k, v = _qkv(_rng("fa-bf16"), 1, 4, 2, 128, 128, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, causal=True, bq=64, bk=64)
    tq, tk, tv = (torch.tensor(np.asarray(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in (jq, jk, jv))
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), 5e-2)


@pytest.mark.parametrize("S,T", [(64, 128), (128, 64), (32, 96)])
def test_flash_attention_top_left_causal_vs_pallas(S, T):
    """S != T, causal: the port's mask is the Pallas kernel's (top-left)."""
    q, k, v = _qkv(_rng("tl", S, T), 2, 4, 2, S, T, 64)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, bq=32, bk=32,
                                  interpret=True)
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=True)
    _close(got, want, 3e-4)


@pytest.mark.parametrize("S,T", [(64, 64), (64, 128), (128, 64)])
def test_oracle_alignment_differs_from_the_kernel_when_s_ne_t(S, T):
    """``ref.attention_ref`` (copied as is) aligns the causal mask
    bottom-right; the kernel and the port top-left.  They agree when S == T
    and differ otherwise."""
    q, k, v = _qkv(_rng("align", S, T), 1, 2, 2, S, T, 32)
    oracle = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True)
    copy = ref.attention_ref(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), causal=True)
    _close(copy, oracle, 1e-5)
    port = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), causal=True)
    gap = float(np.abs(port.numpy() - np.asarray(oracle)).max())
    if S == T:
        assert gap < 1e-5
    else:
        assert gap > 0.1


def _flash_twin(q, k, v, causal, bq=64, bk=64):
    """Torch twin of the CUDA kernel's loop (``csrc/flash_attention.cu``):
    per query tile of bq rows, kv tiles of bk rows up to the one holding the
    tile's last query (causal, top-left), online softmax in float32, keys
    past T padded with zeros and masked to -1e30, output acc / max(l, 1e-30).
    Model layout: q (B, S, H, dh), k/v (B, T, Hk, dh)."""
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = 1.0 / np.sqrt(dh)
    n_q, n_kv = -(-S // bq), -(-T // bk)
    qf = F.pad(q.float().transpose(1, 2), (0, 0, 0, n_q * bq - S))
    kf, vf = (F.pad(t.float().repeat_interleave(G, dim=2).transpose(1, 2),
                    (0, 0, 0, n_kv * bk - T)) for t in (k, v))
    out = torch.empty_like(qf)
    for qt in range(n_q):
        rows = torch.arange(qt * bq, (qt + 1) * bq)
        qi = qf[:, :, qt * bq:(qt + 1) * bq]
        m = torch.full((B, H, bq), -1e30)
        l = torch.zeros((B, H, bq))
        acc = torch.zeros((B, H, bq, dh))
        last = min(n_kv, ((qt + 1) * bq - 1) // bk + 1) if causal else n_kv
        for kt in range(last):
            cols = torch.arange(kt * bk, (kt + 1) * bk)
            s = qi @ kf[:, :, kt * bk:(kt + 1) * bk].transpose(-1, -2) * scale
            dead = cols[None, :] >= T
            if causal:
                dead = dead | (cols[None, :] > rows[:, None])
            s = s.masked_fill(dead, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vf[:, :, kt * bk:(kt + 1) * bk]
            m = m_new
        out[:, :, qt * bq:(qt + 1) * bq] = acc / l.clamp_min(1e-30)[..., None]
    return out[:, :, :S].transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("S,T,causal,tile", [
    (37, 37, True, 16), (130, 130, True, 64), (50, 130, True, 16),
    (130, 50, True, 16), (70, 200, False, 64), (1, 1, True, 64)])
def test_flash_attention_tiling_twin(S, T, causal, tile):
    rng = _rng("twin", S, T, causal)
    q = torch.tensor(rng.normal(0, 1, (2, S, 8, 64)), dtype=torch.float32)
    k, v = (torch.tensor(rng.normal(0, 1, (2, T, 2, 64)), dtype=torch.float32)
            for _ in range(2))
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    got = _flash_twin(q, k, v, causal, bq=tile, bk=tile)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_flash_attention_cpu_takes_the_plain_version_and_checks():
    q, k, v = (torch.zeros((1, 4, 2, 16)) for _ in range(3))
    before = dict(FA.launches)
    FA.flash_attention(q, k, v)
    assert FA.launches == before and not any(FA.plain_calls.values())
    with pytest.raises(ValueError, match="CUDA"):
        FA._launch(q, k, v, True)


# ------------------------------------------------------------------ K6

def _rkvwu(rng, B, T, H, P, w=None):
    r, k, v = (rng.normal(0, 1, (B, T, H, P)).astype(np.float32)
               for _ in range(3))
    w = (rng.uniform(0.2, 0.98, (B, T, H, P)).astype(np.float32) if w is None
         else np.full((B, T, H, P), w, np.float32))
    u = rng.normal(0, 1, (H, P)).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("B,T,H,P,chunk", [
    (1, 64, 2, 16, 16), (2, 128, 3, 32, 64), (1, 64, 1, 128, 32),
])
def test_wkv6_plain_vs_pallas_and_oracle(B, T, H, P, chunk):
    arrs = _rkvwu(_rng("wkv", B, T, H, P), B, T, H, P)
    want = jops.wkv6(*map(jnp.asarray, arrs), chunk=chunk)
    oracle, _ = j_wkv6_chunked(*map(jnp.asarray, arrs),
                               jnp.zeros((B, H, P, P)), chunk=min(16, T))
    before = dict(WK.launches)
    got = ops.wkv6(*map(torch.tensor, arrs), chunk=chunk)
    assert WK.launches == before
    _close(got, want, 2e-4)
    _close(got, oracle, 2e-4)


def test_wkv6_strong_decay_vs_pallas():
    """w = 0.05: the pairwise exponent form stays finite."""
    arrs = _rkvwu(_rng("strong"), 1, 128, 1, 16, w=0.05)
    arrs = arrs[:4] + (np.zeros_like(arrs[4]),)
    want = jops.wkv6(*map(jnp.asarray, arrs), chunk=64)
    got = ops.wkv6(*map(torch.tensor, arrs), chunk=64)
    assert bool(torch.isfinite(got).all())
    _close(got, want, 2e-4)


def test_wkv6_chunked_copy_carries_the_state_like_the_reference():
    """``wkv6_chunked`` (the copy of ``ssm._wkv6_chunked`` that the plain
    version runs) from a nonzero state: outputs and final state as the
    reference's."""
    rng = _rng("state")
    B, T, H, P = 2, 48, 2, 8
    arrs = _rkvwu(rng, B, T, H, P)
    s0 = rng.normal(0, 1, (B, H, P, P)).astype(np.float32)
    jy, js = j_wkv6_chunked(*map(jnp.asarray, arrs), jnp.asarray(s0),
                            chunk=16)
    ty, ts = WK.wkv6_chunked(*map(torch.tensor, arrs), torch.tensor(s0),
                             chunk=16)
    _close(ty, jy, 2e-4)
    _close(ts, js, 2e-4)


def test_wkv6_ragged_chunk_fails_like_the_reference():
    """T = 20 with chunk 16: the reference's reshape fails, and so does the
    faithful plain version (the kernel takes any T)."""
    arrs = _rkvwu(_rng("ragged"), 1, 20, 1, 8)
    with pytest.raises(TypeError):
        j_wkv6_chunked(*map(jnp.asarray, arrs), jnp.zeros((1, 1, 8, 8)),
                       chunk=16)
    with pytest.raises(RuntimeError):
        WK.wkv6_plain(*map(torch.tensor, arrs), chunk=16)


def _wkv6_twin(r, k, v, w, u, c=32):
    """Torch twin of the chunked recurrence the CUDA kernels compute
    (``csrc/wkv6.cu``; their split into chunk, scan and output kernels has
    its own twin in ``test_torch_lm_kernels_sm90.py``): chunks of c steps
    from a zero state, the ragged tail padded with r = k = v = 0 and w = 1,
    pairwise intra-chunk exponents esc_i - seg_j, the bonus on the diagonal,
    then r e^esc against the carried state and the state update."""
    B, T, H, P = r.shape
    n = -(-T // c)
    pad = (0, 0, 0, 0, 0, n * c - T)
    r, k, v = (F.pad(t, pad) for t in (r, k, v))
    w = F.pad(w, pad, value=1.0)
    S = r.new_zeros((B, H, P, P))
    below = torch.tril(torch.ones((c, c), dtype=torch.bool), diagonal=-1)
    ys = []
    for t0 in range(0, n * c, c):
        rc, kc, vc, wc = (t[:, t0:t0 + c] for t in (r, k, v, w))
        lw = torch.log(wc + 1e-38)
        seg = torch.cumsum(lw, dim=1)
        esc = seg - lw
        dec = torch.where(below[None, :, :, None, None],
                          torch.exp(esc[:, :, None] - seg[:, None, :]), 0.0)
        a = torch.einsum("bihp,bjhp,bijhp->bhij", rc, kc, dec)
        a = a + torch.diag_embed(torch.einsum("bihp,hp,bihp->bhi", rc, u, kc))
        ys.append(torch.einsum("bhij,bjhq->bihq", a, vc)
                  + torch.einsum("bihp,bhpq->bihq", rc * torch.exp(esc), S))
        kd = kc * torch.exp(seg[:, -1:] - seg)
        S = S * torch.exp(seg[:, -1])[..., None] + \
            torch.einsum("bjhp,bjhq->bhpq", kd, vc)
    return torch.cat(ys, dim=1)[:, :T]


@pytest.mark.parametrize("T,chunk,w", [(100, 50, None), (17, 17, None),
                                       (64, 64, 0.05), (1, 1, None)])
def test_wkv6_chunking_twin(T, chunk, w):
    arrs = [torch.tensor(a) for a in
            _rkvwu(_rng("wtwin", T, w), 2, T, 3, 16, w=w)]
    assert bool(torch.isfinite(_wkv6_twin(*arrs)).all())
    arrs = [a.double() for a in arrs]
    want = WK.wkv6_plain(*arrs, chunk=chunk)
    got = _wkv6_twin(*arrs)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_wkv6_cpu_takes_the_plain_version_and_checks():
    arrs = [torch.tensor(a) for a in _rkvwu(_rng("cpu"), 1, 8, 1, 8)]
    before = dict(WK.launches)
    WK.wkv6(*arrs, chunk=8)
    assert WK.launches == before and not any(WK.plain_calls.values())
    with pytest.raises(ValueError, match="CUDA"):
        WK._launch(*arrs)
