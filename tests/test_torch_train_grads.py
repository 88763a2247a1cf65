"""The autograd boundary of the PyTorch port's training path:
``ops.pinn_mlp_forward2`` (a ``torch.autograd.Function`` around the packed
K3 forward / K4 reverse sweep, or the recompute oracle) against ``jax.vjp``
of the JAX package's ``ops.pinn_mlp_forward2`` run by the Pallas
interpreter (``interpret=True``: its K3/K4 Pallas kernels).

Tolerance: the reference's per-leaf rule for the reverse sweep
(``tests/test_kernels_pinn_mlp.py:330-335``), |got - want| <= 1e-5 * max(1,
max |want|), float32.  Inputs are drawn with numpy from a seed.
"""
import jax
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from test_torch_train_kernels import (D2, _leaf_close, _mlp, _seed, _t,
                                     one_torch_thread)  # noqa: F401


@pytest.mark.parametrize("bwd", ["fused", "ref"])
@pytest.mark.parametrize("d2", D2, ids=str)
def test_forward2_grads_match_jax_vjp(d2, bwd):
    """Gradients through ``ops.pinn_mlp_forward2`` (the autograd Function:
    K3/K4's plain versions for bwd="fused", the recompute oracle for "ref")
    against ``jax.vjp`` of the reference's ``pinn_mlp_forward2`` run by the
    Pallas interpreter."""
    (x, Ws, bs, a), cts = _mlp(_seed("grad", d2, bwd), 1, n=29)
    x, Ws, bs, a = x[0], [W[0] for W in Ws], [c[0] for c in bs], a[0]
    cts = [c[0] for c in cts]
    ins = [t.requires_grad_() for t in _t([x] + Ws + bs + [a])]
    L1 = len(Ws)
    outs = ops.pinn_mlp_forward2(ins[0], ins[1:1 + L1],
                                 ins[1 + L1:1 + 2 * L1], ins[-1], act="sin",
                                 d2_dirs=d2, bwd=bwd)
    got = torch.autograd.grad(outs, ins, _t(cts))
    j_outs, vjp = jax.vjp(
        lambda xx, W, b, aa: jops.pinn_mlp_forward2(
            xx, W, b, aa, act="sin", block_n=16, interpret=True, d2_dirs=d2,
            bwd=bwd), x, tuple(Ws), tuple(bs), a)
    for o, j in zip(outs, j_outs):
        _leaf_close(o.detach(), j)
    for g, j in zip(got, jax.tree.leaves(vjp(tuple(cts)))):
        _leaf_close(g, j)
