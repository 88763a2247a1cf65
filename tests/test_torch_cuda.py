"""The port's CUDA kernels on the card: they build, launch, agree with their
plain versions and refuse what they do not take.  Every test needs an
NVIDIA card and skips without one; on a card run

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: rtol = atol = 1e-5, float32 kernel against the float32 plain
version on the same card (the sums run in another order).  The LLM kernels
(K5 flash attention, K6 WKV6) use the card check's bounds: K5 2e-5 in
float32 and 1e-2 with both outputs in bf16 (one bf16 rounding of values
that agree to float32 precision, and the tensor-core kernel's P in bf16,
at most 2^-8 max |v|), K6 2e-4 (the reference's own bound,
``tests/test_kernels_wkv6.py``: its exponentials and cumulative sums run
in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import CartesianDecomposition, us_map_decomposition
from repro_torch.core.nets import MLPConfig, SubdomainModelConfig, stacked_init
from repro_torch.core.pdes import Burgers1D, HeatConduction2D
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, pinn_mlp
from repro_torch.kernels import wkv6 as WK
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


@pytest.mark.parametrize("n_sub", [1, 4, 9])
@pytest.mark.parametrize("width,depth,d_in,d2_dirs", [(24, 4, 2, (0,)),
                                                      (36, 3, 3, None),
                                                      (100, 3, 1, ())],
                         ids=["w24", "w36", "w100"])
def test_training_kernels_partition_edges_on_card(dev, width, depth, d_in,
                                                  d2_dirs, n_sub):
    """K3 and K4 at the edges of K4's partition: one row, a tile less one,
    a tile, a tile and one (the tile from K4's plan on this card) and the
    quickstart's 1120 rows, where blocks own unequal numbers of tiles;
    widths 36 and 100 have odd numbers of 4-column groups.  K4 twice,
    bitwise."""
    import ctypes

    sel = tuple(range(d_in)) if d2_dirs is None else d2_dirs
    tile, blocks = ctypes.c_int(0), ctypes.c_int(0)
    assert pinn_mlp._library_bwd().pinn_mlp_bwd_plan(
        n_sub, 1, d_in, width, depth, 1, 0, len(sel), ctypes.byref(tile),
        ctypes.byref(blocks)) == 0
    for n in sorted({1, tile.value - 1, tile.value, tile.value + 1, 1120}):
        args = _packed(dev, n_sub=n_sub, n=n, d_in=d_in, width=width,
                       depth=depth, n_out=1, seed=n)
        got = pinn_mlp.pinn_mlp_fwd2_res(*args, n_out=1, d2_dirs=d2_dirs)
        want = pinn_mlp.pinn_mlp_fwd2_res_plain(*args, n_out=1,
                                                d2_dirs=d2_dirs)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        x, w, b, av = args
        cts = _cotangents(dev, n_sub, n, d_in, 1, seed=n + 1)
        kern = pinn_mlp.pinn_mlp_bwd2(x, w, av, got[3], *cts, n_out=1,
                                      d2_dirs=d2_dirs)
        plain = pinn_mlp.pinn_mlp_bwd2_plain(x, w, av, got[3], *cts,
                                             n_out=1, d2_dirs=d2_dirs)
        again = pinn_mlp.pinn_mlp_bwd2(x, w, av, got[3], *cts, n_out=1,
                                       d2_dirs=d2_dirs)
        for g, p, a in zip(kern, plain, again):
            _leaf_close(g, p)
            assert torch.equal(g, a)


# the scenario shapes: the cavity (d_in 2, u/v/p out, depth 5; its
# megabatch is 1500 residual + 2 x 32 interface + 120 boundary rows) and the
# us_map's ten subdomains padded to their largest ragged count (500 + 3 x 16
# + 198 rows in the example, 5000 + 48 + 198 at the paper's counts)
@pytest.mark.parametrize("n_sub,n,width,depth,n_out,d2_dirs", [
    (4, 1684, 40, 5, 3, None), (4, 1684, 80, 5, 3, None),
    (4, 1684, 40, 5, 3, ()), (4, 1684, 80, 5, 3, ()),
    (10, 746, 80, 3, 1, None), (10, 5246, 80, 3, 1, None)],
    ids=["cavity-w40", "cavity-w80", "euler-w40", "euler-w80", "us-map",
         "us-map-paper"])
def test_training_kernels_at_the_scenario_shapes_on_card(
        dev, n_sub, n, width, depth, n_out, d2_dirs):
    """K3 and K4 against their plain versions at the shapes the cavity,
    Euler1D and the us_map train at; K4 twice, bitwise."""
    args = _packed(dev, n_sub=n_sub, n=n, d_in=2, width=width, depth=depth,
                   n_out=n_out, seed=n + width)
    got = pinn_mlp.pinn_mlp_fwd2_res(*args, n_out=n_out, d2_dirs=d2_dirs)
    want = pinn_mlp.pinn_mlp_fwd2_res_plain(*args, n_out=n_out,
                                            d2_dirs=d2_dirs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    x, w, b, av = args
    cts = _cotangents(dev, n_sub, n, 2, n_out, seed=n)
    kern = pinn_mlp.pinn_mlp_bwd2(x, w, av, got[3], *cts, n_out=n_out,
                                  d2_dirs=d2_dirs)
    plain = pinn_mlp.pinn_mlp_bwd2_plain(x, w, av, got[3], *cts,
                                         n_out=n_out, d2_dirs=d2_dirs)
    again = pinn_mlp.pinn_mlp_bwd2(x, w, av, got[3], *cts, n_out=n_out,
                                   d2_dirs=d2_dirs)
    for g, p, a in zip(kern, plain, again):
        _leaf_close(g, p)
        assert torch.equal(g, a)


def test_jvp_chunk_graph_equals_the_eager_loop_on_card(dev):
    """The jvp path's chunk on the card replays a CUDA graph of one outer
    step: the same params, Adam state and terms as the eager step loop,
    bit for bit, over two chunks (the second reuses the graph)."""
    from repro_torch.core import TrainState
    from repro_torch.core.nets import tree_leaves
    from repro_torch.launch import navier_stokes_cavity as nsc

    prob = nsc.build_problem(width=12, device=dev)
    tr = prob.trainer
    assert tr._graphed
    b = prob.batch.device_arrays(dev)
    s0 = tr.init(0)
    graphed, t1 = tr.run_chunk(s0, b, 3)
    graph = tr._graph
    graphed, t2 = tr.run_chunk(graphed, b, 2)
    assert tr._graph is graph
    eager = TrainState(params=s0.params, opt=s0.opt, step=s0.step)
    eager, e1 = tr._loop(eager, lambda i: b, 3)
    eager, e2 = tr._loop(eager, lambda i: b, 2)
    for g, e in zip(tree_leaves((graphed.params, graphed.opt)),
                    tree_leaves((eager.params, eager.opt))):
        assert torch.equal(g, e)
    assert int(graphed.step) == int(eager.step) == 5
    for k in e1:
        assert torch.equal(t1[k], e1[k]) and torch.equal(t2[k], e2[k])


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


def test_supervised_crash_recovery_bitwise_on_card(dev, tmp_path):
    """The runtime on the card: a crash after chunk 1 rolls back to the
    checkpoint and replays through K3/K4, and the result equals three
    uninterrupted chunks bit for bit (params and Adam moments)."""
    from repro_torch.core import (DDConfig, ReferenceTrainer, XPINN,
                                  build_topology)
    from repro_torch.core.nets import tree_leaves
    from repro_torch.data import make_batch
    from repro_torch.runtime import (Fault, FaultInjector, Supervisor,
                                     SupervisorConfig)

    pde = Burgers1D()
    dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
    topo = build_topology(dec, n_iface=8)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 16, 2)})
    tr = ReferenceTrainer(pde, cfg, topo,
                          DDConfig(method=XPINN, residual_path="fused"),
                          device=dev)
    b = make_batch(dec, topo, pde, n_res=48, n_bnd=16,
                   rng=np.random.default_rng(0)).device_arrays(dev)
    before = pinn_mlp.launches["pinn_mlp_bwd2"]
    sup = Supervisor(tr, str(tmp_path / "ckpt"),
                     SupervisorConfig(chunk_steps=3),
                     FaultInjector([Fault(chunk=1, kind="crash")]),
                     decomp=dec)
    s_f, report = sup.run(tr.init(0), b, 9)
    assert report.crashes == 1 and report.chunks == 3
    assert pinn_mlp.launches["pinn_mlp_bwd2"] == before + 12  # 4 attempts
    s_b = tr.init(0)
    for _ in range(3):
        s_b, _ = tr.run_chunk(s_b, b, 3)
    assert s_f.params["u"]["W"][0].is_cuda
    for x, y in zip(tree_leaves((s_f.params, s_f.opt)),
                    tree_leaves((s_b.params, s_b.opt))):
        assert torch.equal(x, y)


def _two_subdomains(cls, device):
    """A 2 x 1 Burgers XPINN on the fused path (n_iface 8, 16 x 2 nets)."""
    from repro_torch.core import DDConfig, XPINN, build_topology
    from repro_torch.data import make_batch

    pde = Burgers1D()
    dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 1)
    topo = build_topology(dec, n_iface=8)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 16, 2)})
    tr = cls(pde, cfg, topo, DDConfig(method=XPINN, residual_path="fused"),
             lrs=[1e-3, 2e-3], device=device)
    b = make_batch(dec, topo, pde, n_res=48, n_bnd=16,
                   rng=np.random.default_rng(0)).device_arrays(device)
    return tr, b


def _two_ranks_rank(mesh):
    """One of two ranks sharing the card: 5 steps through K3/K4."""
    import torch.distributed as dist
    from repro_torch.core import DistributedDDTrainer
    from repro_torch.core.nets import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    tr, b = _two_subdomains(DistributedDDTrainer,
                            mesh.rank_device(dist.get_rank()))
    pinn_mlp.reset_launch_counts()
    s, terms = tr.run_chunk(tr.init(0), tr.shard_batch(b), 5)
    counts = (dict(pinn_mlp.launches), dict(pinn_mlp.plain_calls))
    g = tr.gather_state(s)
    return ([t.cpu().numpy() for t in tree_leaves(g.params)],
            float(terms["loss"][-1].sum()), counts, tr.comm.staged_bytes)


def test_two_ranks_on_card_match_reference_trainer(dev, tmp_path):
    """Two gloo ranks on one card (payloads staged through pinned host
    buffers) against the single-process trainer on the card: params within
    1e-5, the summed loss within 1e-4 relative (the reference's bounds);
    one K3 and one K4 launch per step on each rank, no plain version."""
    from repro_torch.core import ReferenceTrainer
    from repro_torch.core.nets import tree_leaves
    from repro_torch.kernels import native
    from repro_torch.launch import mesh as mesh_lib

    native.build()
    mesh = mesh_lib.make_pinn_mesh(2, str(tmp_path), "cuda", timeout_s=300)
    ranks = mesh_lib.run_ranks(mesh, _two_ranks_rank, deadline_s=600)
    tr, b = _two_subdomains(ReferenceTrainer, dev)
    s, terms = tr.run_chunk(tr.init(0), b, 5)
    params, loss, (counts, plain), staged = ranks[0]
    for got, want in zip(params, tree_leaves(s.params)):
        np.testing.assert_allclose(got, want.cpu().numpy(), rtol=0, atol=1e-5)
    want = float(terms["loss"][-1].sum())
    assert abs(loss - want) < 1e-4 * max(1.0, abs(want))
    for _, _, (c, p), st in ranks:
        assert c["pinn_mlp_fwd2_res"] == c["pinn_mlp_bwd2"] == 5
        assert not any(p.values()) and st > 0


# ------------------------------------------------------------ LLM kernels

def _qkv(dev, B, S, T, H, Hk, dh, dtype, seed, heads_first=False):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, S, H, dh), generator=g)
    k, v = (torch.randn((B, T, Hk, dh), generator=g) for _ in range(2))
    out = [t.to(dev, dtype) for t in (q, k, v)]
    if heads_first:   # (B, H, S, dh) storage, passed as (B, S, H, dh) views
        out = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in out]
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1e-2)], ids=str)
@pytest.mark.parametrize("B,S,T,H,Hk,dh,causal", [
    (2, 37, 37, 8, 2, 64, True), (1, 130, 130, 4, 1, 128, True),
    (1, 64, 64, 2, 2, 100, True), (2, 1, 1, 4, 4, 16, True),
    (1, 50, 130, 4, 2, 64, True), (1, 130, 50, 4, 2, 64, True),
    (2, 70, 200, 4, 1, 64, False)])
@pytest.mark.parametrize("heads_first", [False, True])
def test_flash_attention_matches_plain_on_card(dev, B, S, T, H, Hk, dh,
                                               causal, dtype, tol,
                                               heads_first):
    q, k, v = _qkv(dev, B, S, T, H, Hk, dh, dtype, seed=S * T + dh,
                   heads_first=heads_first)
    before = FA.launches["flash_attention"]
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.launches["flash_attention"] == before + 1
    assert got.dtype == dtype and got.stride() == q.stride()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dh,producer", [(64, "tma"), (128, "tma"),
                                         (100, "loads")])
@pytest.mark.parametrize("S,T,causal", [(200, 200, True), (333, 200, True),
                                        (200, 333, True), (129, 129, True),
                                        (150, 333, False)])
@pytest.mark.parametrize("heads_first", [False, True])
def test_flash_attention_bf16_kernel_on_card(dev, dh, producer, S, T, causal,
                                             heads_first):
    """bf16 goes to the tensor-core kernel: by TMA where the strides allow
    it (dh 64, 128), by element loads where they do not (dh 100: a 200-byte
    row); S and T not multiples of its 128-row tiles."""
    q, k, v = _qkv(dev, 2, S, T, 8, 2, dh, torch.bfloat16, seed=S + T + dh,
                   heads_first=heads_first)
    before = {**FA.launches, **FA.producers}
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    after = {**FA.launches, **FA.producers}
    assert {n for n in after if after[n] != before[n]} == {
        "flash_attention", "flash_attention_sm90", producer}
    assert got.stride() == q.stride()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


def test_flash_attention_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(dev, 1, 8, 8, 2, 2, 16, torch.float32, 0)
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(*_qkv(dev, 1, 8, 8, 2, 2, 160, torch.float32, 0))
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])
    with pytest.raises(NotImplementedError):
        FA.flash_attention(q.requires_grad_(), k, v)


def _rkvwu(dev, B, T, H, P, w_mode, seed):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, P), generator=g) for _ in range(3))
    if w_mode == "uniform":
        w = 0.2 + 0.78 * torch.rand((B, T, H, P), generator=g)
    elif w_mode == "strong":
        w = torch.full((B, T, H, P), 0.05)
    else:   # the init's decay_bias = -6: w = exp(-e^-6), near 1
        w = torch.exp(-torch.exp(-6.0 + 0.01 * torch.randn((B, T, H, P),
                                                           generator=g)))
    u = torch.randn((H, P), generator=g)
    return [t.to(dev) for t in (r, k, v, w, u)]


@pytest.mark.parametrize("w_mode", ["uniform", "strong", "near1"])
@pytest.mark.parametrize("B,T,H,P,chunk", [
    (2, 17, 3, 16, 17), (1, 256, 2, 64, 64), (1, 100, 2, 128, 50),
    (2, 1, 2, 64, 1)])
def test_wkv6_matches_plain_on_card(dev, B, T, H, P, chunk, w_mode):
    r, k, v, w, u = _rkvwu(dev, B, T, H, P, w_mode, seed=T * P)
    before = WK.launches["wkv6"]
    got = WK.wkv6(r, k, v, w, u)
    want = WK.wkv6_plain(r, k, v, w, u, chunk=chunk)
    torch.cuda.synchronize()
    assert WK.launches["wkv6"] == before + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("w_mode", ["uniform", "strong"])
@pytest.mark.parametrize("B,T,H,P,chunk", [
    (1, 5, 2, 16, 5), (2, 31, 2, 128, 31), (2, 33, 3, 16, 11),
    (3, 99, 2, 128, 33), (1, 1000, 2, 64, 50)])
def test_wkv6_ragged_on_card(dev, B, T, H, P, chunk, w_mode):
    """T below the kernels' chunk of 32, T not a multiple of it, B = 3;
    one launch of each of its device kernels per call."""
    r, k, v, w, u = _rkvwu(dev, B, T, H, P, w_mode, seed=T + P)
    before = dict(WK.launches)
    got = WK.wkv6(r, k, v, w, u)
    want = WK.wkv6_plain(r, k, v, w, u, chunk=chunk)
    torch.cuda.synchronize()
    assert all(WK.launches[n] == before[n] + 1 for n in before)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_wkv6_refuses_what_it_does_not_take(dev):
    r, k, v, w, u = _rkvwu(dev, 1, 8, 2, 16, "uniform", 0)
    with pytest.raises(TypeError):
        WK.wkv6(r.double(), k, v, w, u)
    with pytest.raises(ValueError, match="P = 160"):
        WK.wkv6(*_rkvwu(dev, 1, 8, 1, 160, "uniform", 0))
    with pytest.raises(ValueError, match="must match"):
        WK.wkv6(r, k.transpose(1, 2).contiguous().transpose(1, 2), v, w, u)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-3b"])
def test_reduced_prefill_on_card_runs_the_kernels(dev, arch):
    """The reduced model's prefill on the card launches K5 (or K6) once per
    layer, runs no plain version on a CUDA tensor, and its float32 logits
    match the plain path on the card within 1e-4 of max |logit|."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build_model(cfg, dev)
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens.to(dev)}
    FA.reset_launch_counts()
    WK.reset_launch_counts()
    got = model.prefill(params, batch)
    torch.cuda.synchronize()
    name, mod = (("flash_attention", FA) if cfg.family == "dense"
                 else ("wkv6", WK))
    assert mod.launches[name] == cfg.n_layers
    assert not any(FA.plain_calls.values()) and \
        not any(WK.plain_calls.values())
    want = model.prefill(params, batch, plain=True)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
