"""The port's gradient compression (``repro_torch.optim.compress``) against
the JAX package's ``repro.optim.compress`` on the CPU.

Same seeded trees (numpy) through both: int8 quantisation and top-k
masking, the error-feedback accumulator carried over three rounds, ties
at the top-k threshold, and the modelled wire bytes.  Tolerance: the
decompressed gradients and the error accumulators agree to 1e-6 absolute
(float32: the scale and the products may round in another order; measured
differences are 0)."""
import numpy as np
import pytest
import torch

from repro_torch.core.nets import map_tree, tree_leaves
from repro_torch.optim import CompressionConfig, compress_decompress, wire_bytes

TOL = dict(rtol=0, atol=1e-6)
SCHEMES = [("int8", 0.01), ("topk", 0.05), ("topk", 0.3)]


def _tree(rng, scale=1.0):
    """A params-shaped tree: two nets' W / b lists and slopes."""
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"u": {"W": [f(2, 16), f(16, 16), f(16, 1)],
                  "b": [f(16), f(16), f(1)], "a": f(2)},
            "k": {"W": [f(2, 8), f(8, 1)], "b": [f(8), f(1)], "a": f(1)}}


def _both(tree):
    import jax.numpy as jnp
    import jax
    return (jax.tree.map(jnp.asarray, tree),
            map_tree(torch.as_tensor, tree))


def _close(got, want):
    import jax
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("scheme,frac", SCHEMES)
def test_compress_decompress_matches_reference_over_three_rounds(scheme,
                                                                 frac):
    """Error feedback: each round compresses g + e and carries the
    remainder; both packages hold the same accumulators after 3 rounds."""
    from repro.optim import compress as jcomp

    rng = np.random.default_rng(0)
    jcfg = jcomp.CompressionConfig(scheme, topk_frac=frac)
    cfg = CompressionConfig(scheme, topk_frac=frac)
    zeros = map_tree(np.zeros_like, _tree(rng))
    je, te = _both(zeros)
    for rnd in range(3):
        jg, tg = _both(_tree(rng, scale=10.0 ** (rnd - 1)))
        jc, je = jcomp.compress_decompress(jg, je, jcfg)
        tc, te = compress_decompress(tg, te, cfg)
        _close(tc, jc)
        _close(te, je)
    # what was sent plus what is still owed is what was handed in
    for c, e in zip(tree_leaves(tc), tree_leaves(te)):
        assert torch.isfinite(c).all() and torch.isfinite(e).all()


def test_topk_keeps_ties_at_the_threshold_like_reference():
    """Integer magnitudes tie at the k-th largest: ``>=`` keeps every tied
    entry (more than k), in both packages."""
    import jax.numpy as jnp
    from repro.optim import compress as jcomp

    x = np.array([[3, -3, 1, 2], [-2, 3, 0, 1]], np.float32)
    cfg = CompressionConfig("topk", topk_frac=0.25)   # k = 2 of 8
    jc, _ = jcomp.compress_decompress({"w": jnp.asarray(x)},
                                      {"w": jnp.zeros_like(x)},
                                      jcomp.CompressionConfig("topk", 0.25))
    tc, te = compress_decompress({"w": torch.as_tensor(x)},
                                 {"w": torch.zeros(2, 4)}, cfg)
    np.testing.assert_array_equal(tc["w"].numpy(), np.asarray(jc["w"]))
    assert int((tc["w"] != 0).sum()) == 3           # three entries tie at 3
    np.testing.assert_array_equal((tc["w"] + te["w"]).numpy(), x)


def test_int8_rounds_half_to_even_and_clips_like_reference():
    """Values at exactly half a quantisation step round to even in both
    (``jnp.round`` and ``torch.round``); the largest magnitude maps to
    +-127."""
    import jax.numpy as jnp
    from repro.optim import compress as jcomp

    x = np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, 63.5], np.float32)
    jc, je = jcomp.compress_decompress({"w": jnp.asarray(x)},
                                       {"w": jnp.zeros_like(x)},
                                       jcomp.CompressionConfig("int8"))
    tc, te = compress_decompress({"w": torch.as_tensor(x)},
                                 {"w": torch.zeros(7)},
                                 CompressionConfig("int8"))
    np.testing.assert_array_equal(tc["w"].numpy(), np.asarray(jc["w"]))
    np.testing.assert_array_equal(te["w"].numpy(), np.asarray(je["w"]))


@pytest.mark.parametrize("cfg", [None, ("int8", 0.01), ("topk", 0.05),
                                 ("topk", 1e-6)])
def test_wire_bytes_match_reference(cfg):
    from repro.optim import compress as jcomp

    tree = _tree(np.random.default_rng(1))
    jt, tt = _both(tree)
    jcfg = None if cfg is None else jcomp.CompressionConfig(*cfg)
    tcfg = None if cfg is None else CompressionConfig(*cfg)
    assert wire_bytes(tt, tcfg) == jcomp.wire_bytes(jt, jcfg)
