"""PyTorch port of the first-order PINN-MLP forward (K1, the Pallas
``pinn_mlp._kernel``) against the JAX package, and the CUDA wrappers'
contract on the CPU.

Same inputs, references and tolerances as ``tests/test_torch_pinn_mlp.py``
(whose helpers this file shares): 1e-5 (rtol and atol) in float32.
"""
import functools

import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, pinn_mlp, ref
from test_torch_pinn_mlp import (ACTS, F32, _close, _first, _jax,
                                 _jax_batched, _mlp, _seed, _torch,
                                 _unbatched_agrees)


@functools.cache
def _reference1(act, width, depth):
    """Inputs on three subdomains and the JAX outputs on them: the Pallas
    interpreter and the jvp-based ``ref.pinn_mlp_ref``."""
    arrs = _mlp(_seed("k1", act, width, depth), 3, 2, width, depth)
    pallas = _jax_batched(
        lambda x, W, b, a: jops.pinn_mlp_forward(x, W, b, a, act=act,
                                                 block_n=40, interpret=True),
        *_jax(*arrs))
    jvp = _jax_batched(
        lambda x, W, b, a: jref.pinn_mlp_ref(x, W, b, a, act=act),
        *_jax(*arrs))
    return arrs, pallas, jvp


@pytest.mark.parametrize("n_sub", [1, 3])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("width", [12, 24])
@pytest.mark.parametrize("act", ACTS)
def test_forward_matches_pallas_interpret(act, width, depth, n_sub):
    """K1 counterpart vs the Pallas interpreter and the jvp-based
    ``ref.pinn_mlp_ref`` (float32); the port's own jvp reference agrees."""
    arrs, pallas, jvp = _reference1(act, width, depth)
    if n_sub == 1:
        arrs = _first(*arrs)
        pallas, jvp = [o[:1] for o in pallas], [o[:1] for o in jvp]
    got = ops.pinn_mlp_forward(*_torch(*arrs), act=act)
    _close(got, pallas, F32)
    _close(got, jvp, F32)
    if n_sub == 1:
        _unbatched_agrees(ops.pinn_mlp_forward, got, *_torch(*arrs), act=act)
    _close(ref.pinn_mlp_ref(*_torch(*arrs), act=act), jvp, F32)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers run the plain version and count no
    launch; the CUDA path refuses CPU tensors."""
    x, Ws, bs, a = _torch(*_mlp(_seed("cpu"), 2, 2, 12, 2))
    before = dict(pinn_mlp.launches)
    w, b, av = ops.pack_mlp(Ws, bs, a)
    got = pinn_mlp.pinn_mlp_fwd2(x, w, b, av, n_out=2, act="cos",
                                 d2_dirs=(1,))
    want = pinn_mlp.pinn_mlp_fwd2_plain(x, w, b, av, n_out=2, act="cos",
                                        d2_dirs=(1,))
    for g, s in zip(got, want):
        assert torch.equal(g, s)
    assert pinn_mlp.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        pinn_mlp._launch(x, w, b, av, 2, "cos", (1,), "pinn_mlp_fwd2")


def _packed(width=12, depth=2, n_out=1):
    x, Ws, bs, a = _torch(*_mlp(_seed("check", width), 2, 2, width, depth,
                                out=n_out))
    return (x,) + ops.pack_mlp(Ws, bs, a)


@pytest.mark.parametrize("fault", ["float64", "noncontig", "grad", "wide",
                                   "device", "act", "dirs"])
def test_kernel_input_checks(fault):
    """What the CUDA wrapper refuses (checked here on CPU tensors: the
    checks are the same code the launch path runs first)."""
    x, w, b, av = _packed(width=130 if fault == "wide" else 12)
    act, sel, err = "tanh", (0,), ValueError
    if fault == "float64":
        x, err = x.double(), TypeError
    elif fault == "noncontig":
        w = w.transpose(-1, -2)
    elif fault == "grad":
        av, err = av.requires_grad_(), NotImplementedError
    elif fault == "device":
        b = b.to("meta")
    elif fault == "act":
        act = "relu"
    elif fault == "dirs":
        sel = (0, 0)
    with pytest.raises(err):
        pinn_mlp._check(x, w, b, av, 1, act, sel, "pinn_mlp_fwd2")
    if fault == "wide":   # 128 is the widest the kernel takes
        pinn_mlp._check(*_packed(width=128), 1, act, sel, "pinn_mlp_fwd2")
