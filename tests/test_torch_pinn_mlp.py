"""PyTorch port of the second-order PINN-MLP derivative forward (K2, the
Pallas ``pinn_mlp._kernel2``) against the JAX package; the first-order K1
and the wrappers' contract are in ``tests/test_torch_pinn_mlp_k1.py``.

The port's ``kernels.ops`` entries run on CPU tensors here, i.e. through the
plain recurrence beside the CUDA kernel (``repro_torch.kernels.pinn_mlp``).
They are held against

* the JAX package's Pallas kernels ``_kernel`` / ``_kernel2`` run by the
  Pallas interpreter (``interpret=True``, as ``tests/test_kernels_pinn_mlp.py``
  runs them), with the subdomain axis from ``jax.vmap`` as the JAX serving
  engine batches it;
* the JAX plain references ``ref.pinn_mlp_ref`` / ``ref.pinn_mlp_ref2`` /
  ``ref.pinn_mlp_ref2_select``.

Tolerances: 1e-5 (rtol and atol) in float32, where the two frameworks sum
the matrix products in another order; 1e-12 in float64 against the
reference, where only the last bits may differ.  Inputs are drawn with numpy
from a seed and handed to both packages.
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
from repro_torch.kernels import ops

ACTS = ("tanh", "sin", "cos")
D2 = (None, (0,), ())
F32 = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-12, atol=1e-12)


def _seed(*parts):
    return zlib.adler32(repr(parts).encode())


def _mlp(seed, n_sub, d_in, width, depth, out=2, n=37, dtype=np.float32):
    """(x, Ws, bs, a) as numpy arrays with a leading n_sub axis."""
    rng = np.random.default_rng(seed)
    lead = (n_sub,)
    dims = [d_in] + [width] * depth + [out]
    Ws = [rng.normal(0, np.sqrt(2 / (a + b)), lead + (a, b)).astype(dtype)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [rng.normal(0, 0.1, lead + (b,)).astype(dtype) for b in dims[1:]]
    a = rng.uniform(0.9, 1.1, lead + (depth,)).astype(dtype)
    x = rng.uniform(-1, 1, lead + (n, d_in)).astype(dtype)
    return x, Ws, bs, a


def _torch(x, Ws, bs, a):
    t = torch.from_numpy
    return t(x), [t(w) for w in Ws], [t(b) for b in bs], t(a)


def _jax(x, Ws, bs, a):
    j = jnp.asarray
    return j(x), [j(w) for w in Ws], [j(b) for b in bs], j(a)


def _jax_batched(fn, x, Ws, bs, a):
    """``fn`` vmapped over the subdomain axis, as the JAX engine batches."""
    return [np.asarray(o) for o in jax.vmap(fn)(x, Ws, bs, a)]


def _first(x, Ws, bs, a):
    """The first subdomain of a stacked net, keeping the subdomain axis."""
    return x[:1], [w[:1] for w in Ws], [b[:1] for b in bs], a[:1]


def _unbatched_agrees(entry, got, x, Ws, bs, a, **kw):
    """With one subdomain the unbatched entry gives the batched result."""
    one = entry(x[0], [w[0] for w in Ws], [b[0] for b in bs], a[0], **kw)
    for g, o in zip(got, one):
        assert torch.equal(g[0], o)


def _close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)


@functools.cache
def _reference2(act, width, depth, d2_dirs):
    """Inputs on three subdomains and the JAX outputs on them: the Pallas
    interpreter and ``ref.pinn_mlp_ref2`` (computed once per net; the
    n_sub=1 case takes the first subdomain — the math is per subdomain)."""
    arrs = _mlp(_seed(act, width, depth), 3, 2, width, depth)
    pallas = _jax_batched(
        lambda x, W, b, a: jops.pinn_mlp_forward2(
            x, W, b, a, act=act, block_n=40, interpret=True,
            d2_dirs=d2_dirs), *_jax(*arrs))
    plain = _jax_batched(
        lambda x, W, b, a: jref.pinn_mlp_ref2(x, W, b, a, act=act,
                                              d2_dirs=d2_dirs),
        *_jax(*arrs))
    return arrs, pallas, plain


@pytest.mark.parametrize("n_sub", [1, 3])
@pytest.mark.parametrize("d2_dirs", D2, ids=str)
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("width", [12, 24])
@pytest.mark.parametrize("act", ACTS)
def test_forward2_matches_pallas_interpret(act, width, depth, d2_dirs, n_sub):
    """K2 counterpart vs the Pallas interpreter and vs ``ref.pinn_mlp_ref2``
    (float32), batched over n_sub subdomains."""
    arrs, pallas, plain = _reference2(act, width, depth, d2_dirs)
    if n_sub == 1:
        arrs = _first(*arrs)
        pallas, plain = [o[:1] for o in pallas], [o[:1] for o in plain]
    got = ops.pinn_mlp_forward2(*_torch(*arrs), act=act, d2_dirs=d2_dirs)
    _close(got, pallas, F32)
    _close(got, plain, F32)
    if n_sub == 1:
        _unbatched_agrees(ops.pinn_mlp_forward2, got, *_torch(*arrs),
                          act=act, d2_dirs=d2_dirs)
    if d2_dirs is not None:   # pruned rows are exact zeros
        d2u = got[2].numpy()
        for j in range(2):
            if j not in d2_dirs:
                assert not d2u[..., j, :, :].any()


@pytest.mark.parametrize("d2_dirs", D2, ids=str)
@pytest.mark.parametrize("act", ACTS)
def test_forward2_float64_matches_ref(act, d2_dirs):
    """In float64 the port's recurrence is the reference's to 1e-12."""
    arrs = _mlp(_seed("f64", act), 3, 3, 16, 3, dtype=np.float64)
    got = ops.pinn_mlp_forward2(*_torch(*arrs), act=act, d2_dirs=d2_dirs)
    assert got[0].dtype == torch.float64
    with jax.enable_x64(True):
        want = jax.vmap(lambda x, W, b, a: jref.pinn_mlp_ref2(
            x, W, b, a, act=act, d2_dirs=d2_dirs))(*_jax(*arrs))
        want = [np.asarray(w) for w in want]
    assert want[0].dtype == np.float64
    _close(got, want, F64)


@pytest.mark.parametrize("d2_dirs", D2, ids=str)
def test_forward2_select_matches_ref_select(d2_dirs):
    """Per-subdomain activation codes (paper Table 3) vs the JAX select
    reference, one subdomain at a time."""
    n_sub = 4
    codes = np.array([0, 1, 2, 1], np.int32)
    x, Ws, bs, a = _mlp(_seed("select", d2_dirs), n_sub, 2, 12, 2)
    got = ops.pinn_mlp_forward2_select(*_torch(x, Ws, bs, a),
                                       torch.from_numpy(codes),
                                       d2_dirs=d2_dirs)
    for q in range(n_sub):
        want = jops.pinn_mlp_forward2_select(
            *_jax(x[q], [w[q] for w in Ws], [b[q] for b in bs], a[q]),
            jnp.int32(codes[q]), d2_dirs=d2_dirs)
        _close([g[q] for g in got], want, F32)
        # the select path equals the static-activation path bitwise
        static = ops.pinn_mlp_forward2(
            *_torch(x[q], [w[q] for w in Ws], [b[q] for b in bs], a[q]),
            act=ACTS[codes[q]], d2_dirs=d2_dirs)
        for g, s in zip(got, static):
            assert torch.equal(g[q], s)


def test_forward2_segments_equal_separate_calls():
    x, Ws, bs, a = _torch(*_mlp(_seed("segments"), 2, 2, 12, 2, n=30))
    segs = (x[:, :7], x[:, 7:19], x[:, 19:])
    out = ops.pinn_mlp_forward2_segments(segs, Ws, bs, a, act="sin",
                                         d2_dirs=(0,))
    for seg, bundle in zip(segs, out):
        want = ops.pinn_mlp_forward2(seg, Ws, bs, a, act="sin", d2_dirs=(0,))
        for g, w in zip(bundle, want):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def test_pack_mlp_pads_to_multiple_of_four():
    x, Ws, bs, a = _torch(*_mlp(_seed("pack"), 2, 3, 13, 2, out=1))
    w, b, av = ops.pack_mlp(Ws, bs, a)
    assert w.shape == (2, 3, 16, 16) and b.shape == (2, 3, 16)
    assert av.shape == (2, 3) and not av[:, -1].any()
    torch.testing.assert_close(w[:, 1, :13, :13], Ws[1], rtol=0, atol=0)
    assert not w[:, 1, 13:].any() and not w[:, 1, :, 13:].any()
