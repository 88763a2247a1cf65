"""The data-parallel baseline (the paper's Fig. 1a) of the PyTorch port
against the JAX package, on the CPU: ``losses.vanilla_pinn_loss``,
``data.make_vanilla_batch`` and ``core.trainer.DataParallelTrainer``.

Held against the reference on the same inputs (params cross as numpy
arrays, batches come from the same numpy seed): the pooled batch (equal
arrays), the eq. (3) loss and its gradient on both residual paths, and a
one-worker trainer for 5 steps with no compression, int8 and top-k.  Four
workers (``gloo`` ranks on the CPU, one ``FileStore`` per group under
``tmp_path``, a timeout on every collective) run the reference's own
multi-device checks: ``DP_CODE`` (30 steps per scheme, the loss falls) and
``ERRFB_CODE`` (the error-feedback buffer is per worker and differs
across workers).  The four-worker int8 run against the reference's
four-device run is in ``tests/test_torch_distributed.py``, which shares
that reference subprocess.

Tolerances (float32): loss terms 1e-5 relative, gradients and params
1e-5 absolute (the frameworks sum in another order; measured differences
are ~1e-7).  The problem is the reference's ``DP_CODE``: Burgers on a 4 x 1
decomposition, 64 residual and 16 boundary points per worker, a 20 x 3
net, lr 5e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Burgers1D, CartesianDecomposition, build_topology
from repro_torch.core.losses import LossWeights, ResidualPath, vanilla_pinn_loss
from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig, map_tree,
                                   params_from_numpy, tree_leaves,
                                   tree_unflatten)
from repro_torch.core.trainer import DataParallelTrainer
from repro_torch.data import make_batch, make_vanilla_batch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import CompressionConfig

TERMS = dict(rtol=1e-5, atol=1e-6)
F32 = dict(rtol=0, atol=1e-5)
BOUNDS = ((-1, 1), (0, 1))
SCHEMES = [None, ("int8", 0.01), ("topk", 0.05)]
GROUP_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem():
    pde = Burgers1D()
    dec = CartesianDecomposition(BOUNDS, 4, 1)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 20, 3)})
    batch = make_batch(dec, build_topology(dec, 4), pde, n_res=64, n_bnd=16,
                       rng=np.random.default_rng(0))
    return pde, dec, cfg, batch


def _jax_problem():
    from repro.core import Burgers1D as JB
    from repro.core import CartesianDecomposition as JC
    from repro.core import build_topology as jbuild
    from repro.core import nets as jnets
    from repro.data import make_batch as jmake

    pde = JB()
    dec = JC(BOUNDS, 4, 1)
    cfg = jnets.SubdomainModelConfig(nets={"u": jnets.MLPConfig(2, 1, 20, 3)})
    batch = jmake(dec, jbuild(dec, 4), pde, n_res=64, n_bnd=16,
                  rng=np.random.default_rng(0))
    return pde, dec, cfg, batch


def _jax_init(cfg_j, seed=0):
    import jax
    from repro.core import nets as jnets
    return jax.tree.map(np.asarray, jnets.init_model(cfg_j,
                                                     jax.random.PRNGKey(seed)))


def _cfg(scheme):
    return None if scheme is None else CompressionConfig(*scheme)


def _state_from(tr, params_np):
    """A port trainer's fresh state with the reference's weights."""
    st = tr.init(0)
    p = params_from_numpy(params_np, tr.device)
    from repro_torch.optim import init_adam
    return dict(st, params=p, opt=init_adam(p))


def _close(got, want, tol):
    import jax
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


# --------------------------------------------------------------- pieces

def test_make_vanilla_batch_matches_reference():
    from repro.data import make_vanilla_batch as jmv

    pde, dec, _, _ = _problem()
    jpde, jdec, _, _ = _jax_problem()
    got = make_vanilla_batch(dec, pde, 64, 16, np.random.default_rng(3))
    want = jmv(jdec, jpde, 64, 16, np.random.default_rng(3))
    for k, v in vars(got).items():
        w = np.asarray(getattr(want, k))
        assert v.dtype == torch.float32 and tuple(v.shape) == w.shape, k
        np.testing.assert_array_equal(v.numpy(), w)


@pytest.mark.parametrize("path", ["jvp", "fused"])
def test_vanilla_pinn_loss_and_gradient_match_reference(path):
    """Eq. (3) and its gradient for one unstacked model; the fused path is
    one [res | data] megabatch through the stacked kernels (an axis of 1
    added and taken off)."""
    import jax
    from repro.core import losses as jlosses
    from repro.data import make_vanilla_batch as jmv

    pde, dec, cfg, _ = _problem()
    jpde, jdec, jcfg, _ = _jax_problem()
    pj = _jax_init(jcfg, seed=1)
    bj = jmv(jdec, jpde, 64, 16, np.random.default_rng(0))
    bt = make_vanilla_batch(dec, pde, 64, 16, np.random.default_rng(0))
    jpath = None if path == "jvp" else jlosses.ResidualPath(act="tanh")
    tpath = None if path == "jvp" else ResidualPath(act="tanh")

    def jloss(p):
        return jlosses.vanilla_pinn_loss(jpde, jcfg, jlosses.LossWeights(), p,
                                         0, None, bj, path=jpath)

    (jtot, jterms), jg = jax.value_and_grad(jloss, has_aux=True)(pj)
    p = map_tree(lambda t: t.requires_grad_(), params_from_numpy(pj))
    tot, terms = vanilla_pinn_loss(pde, cfg, LossWeights(), p, 0, None, bt,
                                   path=tpath)
    g = tree_unflatten(p, torch.autograd.grad(tot, tree_leaves(p)))
    assert tot.dim() == 0 and set(terms) == set(jterms)
    for k in jterms:
        np.testing.assert_allclose(terms[k].detach().numpy(),
                                   np.asarray(jterms[k]), **TERMS)
    _close(g, jg, F32)


# ------------------------------------------------------------ one worker

@pytest.mark.parametrize("scheme", SCHEMES, ids=["none", "int8", "topk"])
def test_one_worker_trainer_matches_reference(scheme):
    """``n_workers=1`` needs no process group; 5 steps from the reference's
    weights on the fused path equal the reference's (the error-feedback
    buffer too)."""
    from repro.core.trainer import DataParallelTrainer as JDP
    from repro.optim import CompressionConfig as JCC

    pde, dec, cfg, batch = _problem()
    jpde, jdec, jcfg, jbatch = _jax_problem()
    jcomp = None if scheme is None else JCC(*scheme)
    jt = JDP(jpde, jcfg, n_workers=1, compression=jcomp, lr=5e-4,
             residual_path="pallas")
    tt = DataParallelTrainer(pde, cfg, n_workers=1, compression=_cfg(scheme),
                             lr=5e-4, residual_path="fused", device="cpu")
    assert tt.comm is None
    js = jt.init(0)
    ts = _state_from(tt, _jax_init(jcfg))
    import jax
    bj = jax.tree.map(lambda x: x[:1], jbatch.device_arrays())
    bt = batch.device_arrays()
    bt = type(bt)(**{k: v[:1] for k, v in vars(bt).items()})
    for _ in range(5):
        js, jterms = jt.step(js, bj)
        ts, terms = tt.step(ts, bt)
        np.testing.assert_allclose(terms["loss"].numpy(),
                                   np.asarray(jterms["loss"]), **TERMS)
    _close(ts["params"], js["params"], F32)
    _close(ts["opt"], js["opt"], F32)
    if scheme is not None:
        _close(ts["err"], js["err"], F32)
    assert int(ts["step"]) == int(js["step"]) == 5


# ------------------------------------------------------------ four workers

def _dp_rank(mesh) -> dict:
    """One worker of the reference's DP_CODE and ERRFB_CODE."""
    pde, dec, cfg, batch = _problem()
    b = batch.device_arrays()
    out = {"dp": {}}
    for scheme in SCHEMES:
        tr = DataParallelTrainer(pde, cfg, n_workers=mesh.n_sub,
                                 compression=_cfg(scheme), lr=5e-4,
                                 device="cpu")
        st, losses = tr.init(0), []
        for _ in range(30):
            st, terms = tr.step(st, b)
            losses.append(float(terms["loss"]))
        flat = torch.cat([t.reshape(-1) for t in tree_leaves(st["params"])])
        out["dp"][str(scheme)] = {"losses": losses,
                                  "params_all": tr.comm.all_gather(flat)}
    tr = DataParallelTrainer(pde, cfg, n_workers=mesh.n_sub,
                             compression=CompressionConfig("topk", 0.05),
                             lr=5e-4, device="cpu")
    st = tr.init(0)
    out["err_shapes_init"] = [tuple(t.shape) for t in
                              tree_leaves(tr.gather_state(st)["err"])]
    losses = []
    for _ in range(10):
        st, terms = tr.step(st, b)
        losses.append(float(terms["loss"]))
    out["errfb_losses"] = losses
    out["err0"] = tree_leaves(tr.gather_state(st)["err"])[0]
    return out


@pytest.fixture(scope="module")
def four_workers(tmp_path_factory):
    mesh = mesh_lib.make_pinn_mesh(4, str(tmp_path_factory.mktemp("dp")),
                                   "cpu", timeout_s=GROUP_TIMEOUT_S)
    return mesh_lib.run_ranks(mesh, _dp_rank, deadline_s=GROUP_TIMEOUT_S)


@pytest.mark.parametrize("scheme", SCHEMES, ids=["none", "int8", "topk"])
def test_four_workers_converge_with_and_without_compression(four_workers,
                                                            scheme):
    """The reference's DP_CODE: 30 steps on 4 workers lower the loss; the
    all-reduced loss is the same on every worker, and so are the params,
    bitwise (every worker applies the same reduced gradient)."""
    rows = [r["dp"][str(scheme)] for r in four_workers]
    losses = rows[0]["losses"]
    assert losses[-1] < losses[0], (scheme, losses[0], losses[-1])
    for r in rows[1:]:
        assert r["losses"] == losses
    p = rows[0]["params_all"]
    assert float((p - p[0]).abs().max()) == 0.0


def test_error_feedback_is_per_worker(four_workers):
    """The reference's ERRFB_CODE: the error-feedback buffer is stacked per
    worker (never replicated or averaged) and, since each worker compresses
    its own gradient, the slices differ."""
    r0 = four_workers[0]
    assert all(s[0] == 4 for s in r0["err_shapes_init"])
    err0 = r0["err0"]
    diffs = max(float((err0[i] - err0[0]).abs().max()) for i in range(1, 4))
    assert diffs > 0.0
    assert r0["errfb_losses"][-1] < r0["errfb_losses"][0]
