"""PyTorch port of the training kernels against the JAX package: the
residual-saving forward K3 (Pallas ``pinn_mlp._kernel2_res``) and the fused
reverse sweep K4 (``pinn_mlp._kernel2_bwd``), their plain versions and the
port's hand-derived ``ref._ref2_bwd``; the autograd boundary
``ops.pinn_mlp_forward2`` is in ``tests/test_torch_train_grads.py``.

On CPU tensors the port's wrappers take the plain versions, so here they are
held against

* the JAX Pallas kernels run by the Pallas interpreter (``interpret=True``,
  as ``tests/test_kernels_pinn_mlp.py`` runs them), with the subdomain axis
  from ``jax.vmap``;
* the JAX hand-derived VJP ``ref.pinn_mlp_ref2_vjp``.

Tolerance: the reference's per-leaf rule for the reverse sweep
(``tests/test_kernels_pinn_mlp.py:330-335``), |got - want| <= 1e-5 * max(1,
max |want|), in float32 where the frameworks sum in another order; 1e-10 on
the same scale in float64 where only the last bits differ.  A torch twin of
K4's summation order (row chunks, tiles, blocks in fixed groups: the part
that differs from the TPU kernel) is checked against the unblocked sweep,
and a Python twin of K4's launch plan against its invariants.  Inputs are
drawn with numpy from a seed and handed to both packages.
"""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.pinn_mlp import (WPAD, pinn_mlp_pallas2_bwd,
                                    pinn_mlp_pallas2_res)
from repro_torch.kernels import ops, pinn_mlp, ref

ACTS = ("tanh", "sin", "cos")
D2 = (None, (0,), ())
BLOCK_N = 32       # two Pallas grid blocks for N = 37: the TPU accumulation


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module's tests run: the test workers
    are the parallelism, and eight threads in each of them oversubscribe
    the cores several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seed(*parts):
    return zlib.adler32(repr(parts).encode())


def _mlp(seed, n_sub, d_in=2, width=20, depth=3, out=2, n=37,
         dtype=np.float32):
    """(x, Ws, bs, a) and cotangents (ū, d̄u, d̄2u), numpy, leading n_sub."""
    rng = np.random.default_rng(seed)
    dims = [d_in] + [width] * depth + [out]
    Ws = [rng.normal(0, np.sqrt(2 / (a + b)), (n_sub, a, b)).astype(dtype)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [rng.normal(0, 0.1, (n_sub, b)).astype(dtype) for b in dims[1:]]
    a = rng.uniform(0.9, 1.1, (n_sub, depth)).astype(dtype)
    x = rng.uniform(-1, 1, (n_sub, n, d_in)).astype(dtype)
    cts = [rng.normal(0, 1, s).astype(dtype) for s in
           ((n_sub, n, out), (n_sub, d_in, n, out), (n_sub, d_in, n, out))]
    return (x, Ws, bs, a), cts


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _leaf_close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.size == 0:
        return
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


@functools.cache
def _jax_res_fn(act, n, d_in):
    """JAX K3 per subdomain (vmapped, jitted), points padded to BLOCK_N
    rows."""
    n_pad = -(-n // BLOCK_N) * BLOCK_N

    def one(xq, Wq, bq, aq):
        w, b, av = jops.pack_mlp(Wq, bq, aq)
        x_pad = jnp.zeros((n_pad, WPAD), xq.dtype).at[:n, :d_in].set(xq)
        return pinn_mlp_pallas2_res(x_pad, w, b, av, d_in=d_in, act=act,
                                    block_n=BLOCK_N, interpret=True)
    return jax.jit(jax.vmap(one))


@functools.cache
def _jax_bwd_fn(act, n, d_in):
    """JAX K4 per subdomain (vmapped, jitted) on JAX K3's residuals."""
    n_pad = -(-n // BLOCK_N) * BLOCK_N

    def one(xq, Wq, aq, hq, tq, sq, c0, c1, c2):
        L1 = len(Wq)
        w = jnp.stack([jnp.zeros((WPAD, WPAD)).at[:W.shape[0], :W.shape[1]]
                       .set(W) for W in Wq])
        av = jnp.zeros((L1,)).at[:aq.shape[0]].set(aq)
        pad = lambda c: jnp.zeros(c.shape[:-2] + (n_pad, WPAD)).at[
            ..., :n, :c.shape[-1]].set(c)
        x_pad = jnp.zeros((n_pad, WPAD)).at[:n, :d_in].set(xq)
        return pinn_mlp_pallas2_bwd(x_pad, w, av, hq, tq, sq, pad(c0),
                                    pad(c1), pad(c2), d_in=d_in, act=act,
                                    block_n=BLOCK_N, interpret=True)
    return jax.jit(jax.vmap(one))


def _jax_res(x, Ws, bs, a, act):
    return _jax_res_fn(act, x.shape[1], x.shape[2])(x, Ws, bs, a)


def _jax_bwd(x, Ws, a, res, cts, act, sel):
    """JAX K4 with the pruned d̄2u rows zeroed first, as the reference's
    custom VJP does."""
    mask = np.zeros((x.shape[2], 1, 1), np.float32)
    mask[list(sel)] = 1.0
    cu, cdu, cd2u = cts
    return _jax_bwd_fn(act, x.shape[1], x.shape[2])(x, Ws, a, *res, cu, cdu,
                                                    cd2u * mask)


def _dims(Ws):
    return [W.shape[-2] for W in Ws] + [Ws[-1].shape[-1]]


@pytest.mark.parametrize("n_sub", [1, 3])
@pytest.mark.parametrize("act", ACTS)
def test_res_and_bwd_plain_match_pallas_interpreter(act, n_sub):
    """K3's plain version (outputs and the unpadded spills) and K4's plain
    version (x̄, W̄, b̄, ā) against the JAX Pallas kernels, for every
    d2_dirs: the TPU kernels carry every direction, the port only the kept
    ones."""
    (x, Ws, bs, a), cts = _mlp(_seed("res", act, n_sub), n_sub)
    n, d_in, L = x.shape[1], x.shape[2], a.shape[1]
    dims = _dims(Ws)
    j_u, j_du, j_d2u, j_h, j_t, j_s = [np.asarray(o) for o in
                                       _jax_res(x, Ws, bs, a, act)]
    xt, Wt, bt, at = _t([x]), _t(Ws), _t(bs), _t([a])
    w, b, av = ops.pack_mlp(Wt, bt, at[0])
    wp = w.shape[-1]
    for d2 in D2:
        sel = tuple(range(d_in)) if d2 is None else d2
        u, du, d2u, res = pinn_mlp.pinn_mlp_fwd2_res(xt[0], w, b, av,
                                                     n_out=dims[-1], act=act,
                                                     d2_dirs=d2)
        _leaf_close(u, j_u[:, :n, :dims[-1]])
        _leaf_close(du, j_du[:, :, :n, :dims[-1]])
        for j in range(d_in):
            want = j_d2u[:, j, :n, :dims[-1]] if j in sel else 0 * u
            _leaf_close(d2u[:, j], want)
        assert res.shape == (n_sub, L, 1 + d_in + len(sel), n, wp)
        _leaf_close(res[:, :, 0], j_h[:, :, :n, :wp])
        _leaf_close(res[:, :, 1:1 + d_in], j_t[:, :, :, :n, :wp])
        for k, j in enumerate(sel):
            _leaf_close(res[:, :, 1 + d_in + k], j_s[:, :, j, :n, :wp])
        # K4: the port's plain sweep on its spills, JAX's kernel on its own
        cx, cw, cb, ca = pinn_mlp.pinn_mlp_bwd2(xt[0], w, av, res, *_t(cts),
                                                n_out=dims[-1], act=act,
                                                d2_dirs=d2)
        j_cx, j_cw, j_cb, j_ca = [np.asarray(o) for o in _jax_bwd(
            x, Ws, a, (j_h, j_t, j_s), cts, act, sel)]
        _leaf_close(cx, j_cx[:, :n, :d_in])
        for l in range(L + 1):
            _leaf_close(cw[:, l, :dims[l], :dims[l + 1]],
                        j_cw[:, l, :dims[l], :dims[l + 1]])
            _leaf_close(cb[:, l, :dims[l + 1]], j_cb[:, l, :dims[l + 1]])
        _leaf_close(ca[:, :L], j_ca.sum(-1)[:, :L])
        assert not ca[:, L].any()           # the unused last slope
        assert not cw[:, 0, d_in:].any()    # packing rows past d_in


@pytest.mark.parametrize("d2", D2, ids=str)
@pytest.mark.parametrize("act", ACTS)
def test_bwd_plain_matches_jax_hand_vjp(act, d2):
    """The packed plain K4 against the reference's hand-derived VJP
    (``ref.pinn_mlp_ref2_vjp``), per subdomain."""
    (x, Ws, bs, a), cts = _mlp(_seed("vjp", act, d2), 2)
    dims, L = _dims(Ws), a.shape[1]
    xt, Wt, bt, at = _t([x])[0], _t(Ws), _t(bs), _t([a])[0]
    w, b, av = ops.pack_mlp(Wt, bt, at)
    *_, res = pinn_mlp.pinn_mlp_fwd2_res(xt, w, b, av, n_out=dims[-1],
                                         act=act, d2_dirs=d2)
    cx, cw, cb, ca = pinn_mlp.pinn_mlp_bwd2(xt, w, av, res, *_t(cts),
                                            n_out=dims[-1], act=act,
                                            d2_dirs=d2)
    for q in range(2):
        _, vjp = jref.pinn_mlp_ref2_vjp(x[q], [W[q] for W in Ws],
                                        [c[q] for c in bs], a[q], act=act,
                                        d2_dirs=d2)
        j_cx, j_cW, j_cb, j_ca = vjp(tuple(c[q] for c in cts))
        _leaf_close(cx[q], j_cx)
        for l in range(L + 1):
            _leaf_close(cw[q, l, :dims[l], :dims[l + 1]], j_cW[l])
            _leaf_close(cb[q, l, :dims[l + 1]], j_cb[l])
        _leaf_close(ca[q, :L], j_ca)


@pytest.mark.parametrize("d2", D2 + ((1,),), ids=str)
@pytest.mark.parametrize("act", ACTS)
def test_ref2_bwd_matches_autograd_f64(act, d2):
    """The port's closed-form ``_ref2_bwd`` against torch autograd of
    ``_ref2_impl`` in float64, batched over two subdomains."""
    (x, Ws, bs, a), cts = _mlp(_seed("f64", act, d2), 2, dtype=np.float64)
    ins = [t.requires_grad_() for t in _t([x] + Ws + bs + [a])]
    L1 = len(Ws)
    xt, Wt, bt, at = ins[0], ins[1:1 + L1], ins[1 + L1:1 + 2 * L1], ins[-1]
    ct = _t(cts)
    outs = ref.pinn_mlp_ref2(xt, Wt, bt, at, act=act, d2_dirs=d2)
    used = [(o, c) for o, c in zip(outs, ct) if o.requires_grad]
    want = torch.autograd.grad([o for o, _ in used], ins,
                               [c for _, c in used], allow_unused=True)
    _, vjp = ref.pinn_mlp_ref2_vjp(xt, Wt, bt, at, act=act, d2_dirs=d2)
    cx, cWs, cbs, ca = vjp(ct)
    for g, w in zip([cx, *cWs, *cbs, ca], want):
        _leaf_close(g.detach(), torch.zeros_like(g) if w is None else w,
                    tol=1e-10)


REDUCE_GROUPS = 8   # pinn_mlp_bwd.cu's kGroups


def _blocked_bwd(x, w, av, res, cts, act, d2, tile_m, n_blocks, ksplit=1):
    """Torch twin of K4's summation order: block b owns the contiguous
    tiles [b*T/B, (b+1)*T/B); within a tile the rows are cut into ``ksplit``
    chunks [j*tm/ksplit, (j+1)*tm/ksplit) (every stream of them), each
    chunk's W̄ summed apart (a thread's registers in the kernel) and the
    chunks added in chunk order; each tile's W̄/b̄/ā goes into the block's
    partial in tile order; the partials are then summed in REDUCE_GROUPS
    contiguous groups of blocks, each in block order, and the groups' sums
    in group order (pinn_mlp_bwd.cu).  x̄ is per row."""
    n = x.shape[1]
    n_tiles = -(-n // tile_m)
    rows = lambda t, lo, hi: t[..., lo:min(hi, n), :]
    cx, parts = [], []
    for blk in range(n_blocks):
        part = None
        for tile in range(blk * n_tiles // n_blocks,
                          (blk + 1) * n_tiles // n_blocks):
            tsum = None
            for j in range(ksplit):
                lo = tile * tile_m + j * tile_m // ksplit
                hi = tile * tile_m + (j + 1) * tile_m // ksplit
                if lo >= min(hi, n):
                    continue
                sl = [rows(t, lo, hi) for t in cts]
                gx, *g = pinn_mlp.pinn_mlp_bwd2_plain(
                    rows(x, lo, hi), w, av, rows(res, lo, hi), *sl,
                    n_out=cts[0].shape[-1], act=act, d2_dirs=d2)
                cx.append(gx)
                tsum = g if tsum is None else [p + q for p, q in
                                               zip(tsum, g)]
            part = tsum if part is None else [p + q for p, q in
                                              zip(part, tsum)]
        parts.append(part)
    total = None   # blocks in GROUPS contiguous groups, each in order
    for g in range(REDUCE_GROUPS):
        gsum = None
        for p in parts[g * n_blocks // REDUCE_GROUPS:
                       (g + 1) * n_blocks // REDUCE_GROUPS]:
            gsum = p if gsum is None else [a + b for a, b in zip(gsum, p)]
        if gsum is not None:
            total = gsum if total is None else [a + b for a, b in
                                                zip(total, gsum)]
    return [torch.cat(cx, dim=1)] + total


@pytest.mark.parametrize("tile_m,n_blocks,ksplit", [
    pytest.param(8, 3, 1, id="8-3"), pytest.param(4, 5, 1, id="4-5"),
    pytest.param(32, 1, 1, id="32-1"), (16, 7, 7), (16, 4, 8), (8, 13, 3),
    (4, 26, 4)])
def test_blocked_reduction_twin(tile_m, n_blocks, ksplit):
    """Per-block partials of row-chunked tiles + fixed-order sums match the
    unblocked sweep within 1e-6 and are bitwise identical across two
    runs."""
    (x, Ws, bs, a), cts = _mlp(_seed("blocked", tile_m), 3, n=101)
    xt, Wt, bt, at = _t([x])[0], _t(Ws), _t(bs), _t([a])[0]
    w, b, av = ops.pack_mlp(Wt, bt, at)
    *_, res = pinn_mlp.pinn_mlp_fwd2_res(xt, w, b, av, n_out=2, act="tanh",
                                         d2_dirs=(0,))
    ct = _t(cts)
    want = pinn_mlp.pinn_mlp_bwd2_plain(xt, w, av, res, *ct, n_out=2,
                                        d2_dirs=(0,))
    got = _blocked_bwd(xt, w, av, res, ct, "tanh", (0,), tile_m, n_blocks,
                       ksplit)
    again = _blocked_bwd(xt, w, av, res, ct, "tanh", (0,), tile_m, n_blocks,
                         ksplit)
    for g, a2, wnt in zip(got, again, want):
        _leaf_close(g, wnt, tol=1e-6)
        assert torch.equal(g, a2)


# Python twin of pinn_mlp_bwd.cu's plan (pick_split, smem_bytes, pick_tile,
# pinn_mlp_bwd_plan, part_len): H100 shared memory per SM and per block
K4_THREADS, K4_MIN_BLOCKS, K4_MAX_SPLIT = 256, 2, 8
SMEM_SM, SMEM_BLOCK, SMEM_RESERVE = 233472, 232448, 1024


def _k4_split(s, tm, wp):
    nq = wp // 4
    n_mt = nq * nq
    n3 = s * tm // 4 * nq
    return next((k for k in range(min(K4_MAX_SPLIT, tm), 1, -1)
                 if -(-n_mt * k // 32) * 32 + n3 <= K4_THREADS), 1)


def _k4_smem(s, tm, wp):
    plane, wsz = tm * wp, wp * wp
    ks = _k4_split(s, tm, wp)
    return 16 + 4 * (2 * (s * plane + wsz) + 3 * s * plane
                     + (ks * wsz if ks > 1 else 0) + K4_THREADS // 32
                     + 3 * tm + 3 * wp)


def _k4_tile(s, wp):
    for tm in (12, 8, 4):
        if SMEM_SM // (_k4_smem(s, tm, wp) + SMEM_RESERVE) >= K4_MIN_BLOCKS:
            return tm
    return next((tm for tm in (12, 8, 4)
                 if _k4_smem(s, tm, wp) <= SMEM_BLOCK), 0)


def _k4_plan(n_sub, n_pts, s, wp, sms, per_sm):
    """(tile rows, blocks per subdomain) for ``per_sm`` resident blocks."""
    tm = _k4_tile(s, wp)
    n_tiles = -(-n_pts // tm)
    return tm, min(n_tiles, -(-per_sm * sms // n_sub))


def _k4_part_len(L, wp):
    return -(-((L + 1) * (wp * wp + wp + 1)) // 4) * 4


@pytest.mark.parametrize("wp", [20, 24, 36, 80, 100, 128])
@pytest.mark.parametrize("s", [2, 4, 7])
def test_k4_plan_twin(s, wp):
    """The plan's twin: every shape fits a block's shared memory, two
    blocks fit an SM up to width 80, no block walks more than one tile
    beyond another, and the partials' slice is the W̄/b̄/ā stacks padded
    to 16 bytes."""
    tm = _k4_tile(s, wp)
    assert tm in (12, 8, 4) and _k4_smem(s, tm, wp) <= SMEM_BLOCK
    if wp <= 80:
        assert SMEM_SM // (_k4_smem(s, tm, wp) + SMEM_RESERVE) >= 2
    nq, ks = wp // 4, _k4_split(s, tm, wp)
    n_mt = nq * nq
    assert -(-n_mt * ks // 32) * 32 + s * tm // 4 * nq <= K4_THREADS \
        or ks == 1
    for n_sub, n_pts in ((1, 1), (4, 1120), (9, 17), (4, tm - 1), (4, tm),
                         (4, tm + 1), (2, 100_000)):
        for per_sm in (1, 2, 3):
            tm_, blocks = _k4_plan(n_sub, n_pts, s, wp, 132, per_sm)
            n_tiles = -(-n_pts // tm_)
            walks = [(b + 1) * n_tiles // blocks - b * n_tiles // blocks
                     for b in range(blocks)]
            assert sum(walks) == n_tiles and min(walks) >= 1
            assert max(walks) - min(walks) <= 1
    L = 4
    n = (L + 1) * (wp * wp + wp + 1)
    assert _k4_part_len(L, wp) % 4 == 0 and 0 <= _k4_part_len(L, wp) - n < 4
    (x, Ws, bs, a), cts = _mlp(_seed("plan", wp), 1, width=wp, depth=L,
                               n=5)
    w, b, av = ops.pack_mlp(_t(Ws), _t(bs), _t([a])[0])
    *_, res = pinn_mlp.pinn_mlp_fwd2_res(_t([x])[0], w, b, av, n_out=2,
                                         d2_dirs=(0,))
    _, cw, cb, ca = pinn_mlp.pinn_mlp_bwd2_plain(_t([x])[0], w, av, res,
                                                 *_t(cts), n_out=2,
                                                 d2_dirs=(0,))
    assert cw[0].numel() + cb[0].numel() + ca[0].numel() == n


def test_cpu_tensors_take_plain_training_versions_and_k4_checks():
    """On CPU tensors K3/K4's wrappers run the plain versions and count no
    launch; K4's launch path refuses CPU tensors and what it does not
    take."""
    (x, Ws, bs, a), cts = _mlp(_seed("cpu-k4"), 2)
    xt, Wt, bt, at = _t([x])[0], _t(Ws), _t(bs), _t([a])[0]
    w, b, av = ops.pack_mlp(Wt, bt, at)
    before = dict(pinn_mlp.launches)
    outs = pinn_mlp.pinn_mlp_fwd2_res(xt, w, b, av, n_out=2, d2_dirs=(1,))
    grads = pinn_mlp.pinn_mlp_bwd2(xt, w, av, outs[3], *_t(cts), n_out=2,
                                   d2_dirs=(1,))
    assert pinn_mlp.launches == before
    assert grads[0].shape == xt.shape and grads[3].shape == av.shape
    with pytest.raises(ValueError, match="CUDA"):
        pinn_mlp._launch_bwd(xt, w, av, outs[3], *_t(cts), 2, "tanh", (1,))
    with pytest.raises(ValueError, match="width"):
        pinn_mlp._check_shapes("k4", xt, torch.zeros(2, 4, 132, 132),
                               torch.zeros(2, 4), 2, (1,))
    with pytest.raises(TypeError):
        pinn_mlp._check_tensors("k4", xt, res=outs[3].double())
    with pytest.raises(ValueError, match="contiguous"):
        pinn_mlp._check_tensors("k4", xt, w=w.transpose(-1, -2))
    with pytest.raises(ValueError, match="d2 directions"):
        pinn_mlp._check_shapes("k4", xt, w, av, 2, (0, 0))
    with pytest.raises(ValueError, match="backward path"):
        ops.pinn_mlp_forward2(xt, Wt, bt, at, bwd="autodiff")
