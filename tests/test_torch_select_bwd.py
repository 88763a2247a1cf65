"""The select path's hand-derived backward (``kernels.ops.
pinn_mlp_forward2_select`` through ``ops._Forward2Select``) against the JAX
package's custom VJP of ``repro.kernels.ops.pinn_mlp_forward2_select``, on
the CPU.

Mixed activation codes 0/1/2 over stacked subdomains (paper Table 3), with
the second-order stream whole, pruned to one direction, and off.  Inputs
are drawn with numpy from a seed and handed to both packages; the JAX side
is ``jax.grad`` one subdomain at a time (the reference serves a stack with
``vmap``).  Tolerance: the reference's per-leaf scaled error for the
reverse sweep, |got - want| / max(1, max |want|) <= 1e-5 (float32, the
two frameworks sum in another order).

Bitwise where it holds: per subdomain, the select backward equals the
hand-derived backward of the static-activation path (``ops.
pinn_mlp_forward2``'s plain K4 on a CPU tensor) for that subdomain's
activation, as the two forwards are equal bitwise
(``tests/test_torch_pinn_mlp.py``).  Autograd of the plain recurrence
differentiates another formula, so it is held within the tolerance only.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

ACTS = ("tanh", "sin", "cos")
D2 = (None, (0,), ())
TOL = 1e-5


def _mlp(seed, n_sub, d_in, width, depth, out, n=29):
    rng = np.random.default_rng(seed)
    dims = [d_in] + [width] * depth + [out]
    Ws = [rng.normal(0, np.sqrt(2 / (a + b)), (n_sub, a, b)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [rng.normal(0, 0.1, (n_sub, b)).astype(np.float32) for b in dims[1:]]
    a = rng.uniform(0.9, 1.1, (n_sub, depth)).astype(np.float32)
    x = rng.uniform(-1, 1, (n_sub, n, d_in)).astype(np.float32)
    return [x, *Ws, *bs, a]


def _scaled_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return (float(np.abs(got - want).max())
            / max(1.0, float(np.abs(want).max())))


def _split(leaves, L):
    return leaves[0], leaves[1:1 + L], leaves[1 + L:1 + 2 * L], leaves[-1]


def _torch_grads(entry, leaves, cts, L):
    ins = [torch.from_numpy(t).clone().requires_grad_() for t in leaves]
    x, Ws, bs, a = _split(ins, L)
    outs = entry(x, Ws, bs, a)
    pairs = [(o, torch.from_numpy(c)) for o, c in zip(outs, cts)
             if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in pairs], ins,
                                [c for _, c in pairs], allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, ins)], outs


@pytest.mark.parametrize("d2_dirs", D2, ids=str)
@pytest.mark.parametrize("d_in,out,depth", [(2, 1, 3), (2, 3, 2), (3, 2, 2)])
def test_select_backward_matches_reference_custom_vjp(d2_dirs, d_in, out,
                                                      depth):
    codes = np.array([0, 1, 2, 1, 0], np.int32)
    n_sub, L = len(codes), depth + 1
    seed = zlib.adler32(repr((d2_dirs, d_in, out, depth)).encode())
    leaves = _mlp(seed, n_sub, d_in, 12, depth, out)
    rng = np.random.default_rng(seed + 1)
    n = leaves[0].shape[1]
    cts = [rng.normal(size=s).astype(np.float32) for s in
           ((n_sub, n, out), (n_sub, d_in, n, out), (n_sub, d_in, n, out))]
    got, outs = _torch_grads(
        lambda x, Ws, bs, a: ops.pinn_mlp_forward2_select(
            x, Ws, bs, a, torch.from_numpy(codes), d2_dirs=d2_dirs),
        leaves, cts, L)
    # the forward is the plain select recurrence, bitwise
    plain = ref.pinn_mlp_ref2_select(
        *_split([torch.from_numpy(t) for t in leaves], L),
        torch.from_numpy(codes), d2_dirs)
    for o, p in zip(outs, plain):
        assert torch.equal(o.detach(), p)

    def jloss(q, *lv):
        x, Ws, bs, a = _split(list(lv), L)
        u, du, d2u = jops.pinn_mlp_forward2_select(
            x, Ws, bs, a, jnp.int32(codes[q]), d2_dirs=d2_dirs)
        return (jnp.sum(u * cts[0][q]) + jnp.sum(du * cts[1][q])
                + jnp.sum(d2u * cts[2][q]))

    auto, _ = _torch_grads(
        lambda x, Ws, bs, a: ref.pinn_mlp_ref2_select(
            x, Ws, bs, a, torch.from_numpy(codes), d2_dirs),
        leaves, cts, L)
    worst = worst_auto = 0.0
    for q in range(n_sub):
        want = jax.grad(lambda *lv: jloss(q, *lv),
                        argnums=tuple(range(len(leaves))))(
            *[jnp.asarray(t[q]) for t in leaves])
        for g, w, au in zip(got, want, auto):
            worst = max(worst, _scaled_err(g[q].numpy(), w))
            worst_auto = max(worst_auto, _scaled_err(g[q].numpy(),
                                                     au[q].numpy()))
        # bitwise: the static-activation path's hand-derived backward
        static, _ = _torch_grads(
            lambda x, Ws, bs, a: ops.pinn_mlp_forward2(
                x, Ws, bs, a, act=ACTS[codes[q]], d2_dirs=d2_dirs),
            [t[q:q + 1] for t in leaves], [c[q:q + 1] for c in cts], L)
        for g, s in zip(got, static):
            assert torch.equal(g[q], s[0]), ACTS[codes[q]]
    assert worst <= TOL, worst
    assert worst_auto <= TOL, worst_auto


def test_select_backward_unbatched_and_scalar_code():
    """One network (no subdomain axis) with a scalar code: the same
    gradients as the batched call's first subdomain."""
    leaves = _mlp(5, 1, 2, 10, 2, 1)
    L = 3
    rng = np.random.default_rng(6)
    cts = [rng.normal(size=s).astype(np.float32) for s in
           ((1, 29, 1), (1, 2, 29, 1), (1, 2, 29, 1))]
    batched, _ = _torch_grads(
        lambda x, Ws, bs, a: ops.pinn_mlp_forward2_select(
            x, Ws, bs, a, torch.tensor([1])), leaves, cts, L)
    single, _ = _torch_grads(
        lambda x, Ws, bs, a: ops.pinn_mlp_forward2_select(
            x, Ws, bs, a, 1), [t[0] for t in leaves], [c[0] for c in cts], L)
    for b, s in zip(batched, single):
        np.testing.assert_allclose(b[0].numpy(), s.numpy(), rtol=1e-6,
                                   atol=1e-6)
