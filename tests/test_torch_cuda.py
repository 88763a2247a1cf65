"""The port's CUDA kernels on the card: they build, launch, agree with their
plain versions and refuse what they do not take.  Every test needs an
NVIDIA card and skips without one; on a card run

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: rtol = atol = 1e-5, float32 kernel against the float32 plain
version on the same card (the sums run in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import CartesianDecomposition, us_map_decomposition
from repro_torch.core.nets import MLPConfig, SubdomainModelConfig, stacked_init
from repro_torch.core.pdes import Burgers1D, HeatConduction2D
from repro_torch.kernels import ops, pinn_mlp
from repro_torch.serve import FieldBundle, FieldEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _packed(dev, n_sub=3, n=301, d_in=2, width=24, depth=3, n_out=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    dims = [d_in] + [width] * depth + [n_out]
    Ws = [torch.randn((n_sub, a, b), generator=g) * (2 / (a + b)) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn((n_sub, b), generator=g) for b in dims[1:]]
    a = 0.9 + 0.2 * torch.rand((n_sub, depth), generator=g)
    x = 2 * torch.rand((n_sub, n, d_in), generator=g) - 1
    w, b, av = ops.pack_mlp(Ws, bs, a)
    return [t.to(dev).contiguous() for t in (x, w, b, av)]


@pytest.mark.parametrize("d2_dirs", [None, (1,), ()], ids=str)
@pytest.mark.parametrize("act", ["tanh", "sin", "cos"])
def test_kernel_matches_plain_on_card(dev, act, d2_dirs):
    args = _packed(dev, seed=len(act))
    before = dict(pinn_mlp.launches)
    if d2_dirs == ():
        got = pinn_mlp.pinn_mlp_fwd1(*args, n_out=2, act=act)
        want = pinn_mlp.pinn_mlp_fwd1_plain(*args, n_out=2, act=act)
        name = "pinn_mlp_fwd1"
    else:
        got = pinn_mlp.pinn_mlp_fwd2(*args, n_out=2, act=act,
                                     d2_dirs=d2_dirs)
        want = pinn_mlp.pinn_mlp_fwd2_plain(*args, n_out=2, act=act,
                                            d2_dirs=d2_dirs)
        name = "pinn_mlp_fwd2"
    torch.cuda.synchronize()
    assert pinn_mlp.launches[name] == before[name] + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    if d2_dirs == (1,):
        assert not got[2][:, 0].any()


def test_kernel_widest_layer_and_ragged_tail(dev):
    args = _packed(dev, n_sub=2, n=5, d_in=3, width=128, depth=5, n_out=1)
    got = pinn_mlp.pinn_mlp_fwd2(*args, n_out=1, act="tanh")
    want = pinn_mlp.pinn_mlp_fwd2_plain(*args, n_out=1, act="tanh")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="width"):
        pinn_mlp.pinn_mlp_fwd2(*_packed(dev, width=130), n_out=2)


@pytest.mark.parametrize("width,depth", [(13, 0), (13, 2), (30, 3)])
def test_kernel_odd_widths_and_no_hidden_layer(dev, width, depth):
    """Widths padded to a multiple of 4 (cos: phi(0) = 1 in the padded
    columns must meet zero rows) and the input layer alone."""
    args = _packed(dev, n_sub=2, n=77, width=width, depth=depth, n_out=3)
    for d2 in ((0, 1), ()):
        if d2:
            got = pinn_mlp.pinn_mlp_fwd2(*args, n_out=3, act="cos",
                                         d2_dirs=d2)
            want = pinn_mlp.pinn_mlp_fwd2_plain(*args, n_out=3, act="cos",
                                                d2_dirs=d2)
        else:
            got = pinn_mlp.pinn_mlp_fwd1(*args, n_out=3, act="cos")
            want = pinn_mlp.pinn_mlp_fwd1_plain(*args, n_out=3, act="cos")
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_kernel_refuses_what_it_does_not_take(dev):
    x, w, b, av = _packed(dev)
    with pytest.raises(TypeError):
        pinn_mlp.pinn_mlp_fwd2(x.double(), w, b, av, n_out=2)
    with pytest.raises(ValueError, match="contiguous"):
        pinn_mlp.pinn_mlp_fwd2(x, w.transpose(-1, -2), b, av, n_out=2)
    with pytest.raises(ValueError):
        pinn_mlp.pinn_mlp_fwd2(x, w.cpu(), b, av, n_out=2)
    with pytest.raises(NotImplementedError):
        pinn_mlp.pinn_mlp_fwd1(x, w, b, av.clone().requires_grad_(),
                               n_out=2)


def test_engine_on_card_matches_cpu(dev):
    dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 4)})
    params, codes = stacked_init(cfg, dec.n_sub, 0)
    bundle = FieldBundle(model_cfg=cfg, params=params, decomp=dec,
                         act_codes=codes.numpy(), pde=Burgers1D())
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform((-1, 0), (1, 1), (500, 2)),
                          [[0.0, 0.25], [3.0, 3.0]]])
    eng = FieldEngine(bundle)
    assert eng.device.type == "cuda"
    for order in (1, 2):
        before = dict(pinn_mlp.launches)
        got = eng.evaluate(pts, order=order)
        name = "pinn_mlp_fwd1" if order == 1 else "pinn_mlp_fwd2"
        assert pinn_mlp.launches[name] == before[name] + 1
        want = FieldEngine(bundle, device="cpu").evaluate(pts, order=order)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_engine_two_nets_with_masks_on_card_matches_cpu(dev):
    """us_map, two field nets of different widths, one shared activation
    (the kernel path, one launch per net) and width masks folded in."""
    dec = us_map_decomposition()
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 3, act="sin"),
                                     "k": MLPConfig(2, 1, 16, 2, act="sin")})
    params, codes = stacked_init(cfg, dec.n_sub, 1)
    g = torch.Generator().manual_seed(2)
    masks = {"k": (torch.rand((dec.n_sub, 16), generator=g) < 0.7).float()}
    bundle = FieldBundle(model_cfg=cfg, params=params, decomp=dec,
                         act_codes=codes.numpy(), width_masks=masks,
                         pde=HeatConduction2D())
    rng = np.random.default_rng(1)
    pts = np.concatenate([dec.sample_interior(q, 40, rng)
                          for q in range(dec.n_sub)] + [[[99.0, 99.0]]])
    eng = FieldEngine(bundle)
    assert eng.uniform_act == "sin"
    before = pinn_mlp.launches["pinn_mlp_fwd2"]
    got = eng.evaluate(pts, order=2)
    assert pinn_mlp.launches["pinn_mlp_fwd2"] == before + 2
    want = FieldEngine(bundle, device="cpu").evaluate(pts, order=2)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


# ------------------------------------------- training kernels: K3 and K4

def _cotangents(dev, n_sub, n, d_in, n_out, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev) for shape in
            ((n_sub, n, n_out), (n_sub, d_in, n, n_out),
             (n_sub, d_in, n, n_out))]


def _leaf_close(got, want, tol=1e-5):
    """|got - want| <= tol * max(1, max|want|), per leaf."""
    if want.numel():
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("d2_dirs", [None, (1,), ()], ids=str)
@pytest.mark.parametrize("act", ["tanh", "sin", "cos"])
def test_training_kernels_match_plain_on_card(dev, act, d2_dirs):
    """K3 (outputs and every spill) and K4 (all four cotangents) against
    their plain versions on the card, ragged N, three subdomains."""
    args = _packed(dev, seed=7 + len(act), n=301)
    before = dict(pinn_mlp.launches)
    got = pinn_mlp.pinn_mlp_fwd2_res(*args, n_out=2, act=act,
                                     d2_dirs=d2_dirs)
    want = pinn_mlp.pinn_mlp_fwd2_res_plain(*args, n_out=2, act=act,
                                            d2_dirs=d2_dirs)
    torch.cuda.synchronize()
    assert pinn_mlp.launches["pinn_mlp_fwd2_res"] == \
        before["pinn_mlp_fwd2_res"] + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    x, w, b, av = args
    cts = _cotangents(dev, 3, 301, 2, 2, seed=len(act))
    res = got[3]
    kern = pinn_mlp.pinn_mlp_bwd2(x, w, av, res, *cts, n_out=2, act=act,
                                  d2_dirs=d2_dirs)
    plain = pinn_mlp.pinn_mlp_bwd2_plain(x, w, av, res, *cts, n_out=2,
                                         act=act, d2_dirs=d2_dirs)
    torch.cuda.synchronize()
    assert pinn_mlp.launches["pinn_mlp_bwd2"] == before["pinn_mlp_bwd2"] + 1
    for g, p in zip(kern, plain):
        assert g.shape == p.shape
        _leaf_close(g, p)
    again = pinn_mlp.pinn_mlp_bwd2(x, w, av, res, *cts, n_out=2, act=act,
                                   d2_dirs=d2_dirs)
    for g, a in zip(kern, again):
        assert torch.equal(g, a)   # bitwise: no atomics, fixed order


@pytest.mark.parametrize("width,depth,d_in,n", [(128, 5, 3, 1030),
                                                (24, 4, 2, 100_000),
                                                (13, 0, 1, 50)])
def test_training_kernels_shapes_on_card(dev, width, depth, d_in, n):
    """The widest layer (shared-memory tile choice), many tiles per block
    (the per-block partial loop), and no hidden layer."""
    args = _packed(dev, n_sub=2, n=n, d_in=d_in, width=width, depth=depth,
                   n_out=1)
    got = pinn_mlp.pinn_mlp_fwd2_res(*args, n_out=1, act="tanh")
    want = pinn_mlp.pinn_mlp_fwd2_res_plain(*args, n_out=1, act="tanh")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    x, w, b, av = args
    cts = _cotangents(dev, 2, n, d_in, 1, seed=width)
    kern = pinn_mlp.pinn_mlp_bwd2(x, w, av, got[3], *cts, n_out=1)
    plain = pinn_mlp.pinn_mlp_bwd2_plain(x, w, av, got[3], *cts, n_out=1)
    for g, p in zip(kern, plain):
        _leaf_close(g, p)


@pytest.mark.parametrize("bwd", ["fused", "ref"])
def test_autograd_boundary_on_card_matches_cpu(dev, bwd):
    """torch.autograd.grad through ops.pinn_mlp_forward2 on the card (K3 +
    K4 for bwd="fused") against the same call on the CPU."""
    g = torch.Generator().manual_seed(3)
    dims = [2, 24, 24, 1]
    Ws = [torch.randn((4, a, c), generator=g) * 0.5
          for a, c in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn((4, c), generator=g) for c in dims[1:]]
    a = 0.9 + 0.2 * torch.rand((4, 2), generator=g)
    x = 2 * torch.rand((4, 200, 2), generator=g) - 1
    cts = _cotangents("cpu", 4, 200, 2, 1, seed=5)
    grads = {}
    for d in ("cpu", dev):
        ins = [t.to(d).requires_grad_() for t in [x, *Ws, *bs, a]]
        outs = ops.pinn_mlp_forward2(ins[0], ins[1:4], ins[4:7], ins[7],
                                     act="tanh", d2_dirs=(0,), bwd=bwd)
        grads[str(d)] = [t.cpu() for t in torch.autograd.grad(
            outs, ins, [c.to(d) for c in cts])]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        _leaf_close(got, want)
