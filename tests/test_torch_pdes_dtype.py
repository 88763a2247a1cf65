"""The PDE oracles keep their input's dtype, and Euler1D trains like the
reference.

Every PDE's ``residual`` and ``flux`` come back float32 for float32 inputs
on both residual paths: the per-point jvp oracle (one point by hand, and
mapped over subdomains and points as the trainer maps it) and the fused
derivative bundle.  Euler1D's flux divides by ``rho + 1e-8``; inside
``torch.func.jvp`` a Python float added to a 0-dim slice gave a float64
tangent, and with it float64 loss terms on the jvp path.

The Euler1D trajectory test runs 10 outer steps of the port's
``ReferenceTrainer`` against the JAX package's from the same params, with
``test_torch_train.py``'s tolerances (1e-5 relative / 1e-6 absolute on the
loss terms, 1e-5 on the params).  The density output's last-layer bias is
raised by 1.5 in both, so rho stays near 1 at every point: where rho is
near 0, ``1/(rho + 1e-8)`` amplifies the frameworks' different matmul
rounding (2.8e-4 relative on ``mse_res`` at step 0 with the plain init),
which says nothing about the port.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import pdes as jpdes
from repro.core import trainer as jtrainer
from repro.core import nets as jnets
from repro.core.domain import (CartesianDecomposition as JCart,
                               build_topology as jbuild)
from repro.data import make_batch as jmake_batch
from repro_torch.core import (XPINN, DDConfig, ReferenceTrainer,
                              build_topology, fused, losses, nets, pdes)
from repro_torch.core.domain import CartesianDecomposition
from repro_torch.core.nets import MLPConfig, SubdomainModelConfig
from repro_torch.data import make_batch
from test_torch_train import (JPATH, PARAMS, TERMS, _close_trees, _np,
                              _state, one_torch_thread)  # noqa: F401

PDES = ["burgers1d", "ns2d", "heat2d_inverse", "euler1d"]


def _stacked(pde, seed=0, n_sub=2, n=7):
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, pde.n_fields, 12, 2)})
    params, codes = nets.stacked_init(cfg, n_sub, seed)
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(0.1, 0.9, (n_sub, n, 2))
                           .astype(np.float32))
    return cfg, params, codes, pts


@pytest.mark.parametrize("name", PDES)
def test_residual_and_flux_keep_float32_on_every_path(name):
    pde = pdes.REGISTRY[name]()
    cfg, params, codes, pts = _stacked(pde)
    # one point by hand: the 0-dim slices the flux maps see
    u_fn = nets.scalar_field_fn(cfg, nets.map_tree(lambda t: t[0], params),
                                int(codes[0]))
    for method in ("residual", "flux"):
        got = getattr(pde, method)(u_fn, pts[0, 0])
        assert got.dtype == torch.float32, (method, got.dtype)
    # the jvp path as the trainer maps it (subdomains, then points)
    res = losses.residual_eval(pde, cfg, params, codes, None, pts, None)
    flux = losses._pointwise(pde.flux, cfg, params, codes, None, pts)
    assert res.shape == (2, 7, pde.n_eq) and res.dtype == torch.float32
    assert flux.shape == (2, 7, pde.n_eq, 2) and flux.dtype == torch.float32
    # the fused path (the kernels' plain versions on the CPU)
    act = nets.uniform_model_act(cfg)
    res_f = losses.residual_eval(pde, cfg, params, codes, None, pts,
                                 losses.ResidualPath(act=act))
    u, du, _ = fused.model_bundle(cfg, params, pts, act, None, d2_dirs=())
    flux_f = pde.flux_from_derivs(pts, u, du)
    assert res_f.dtype == torch.float32 and flux_f.dtype == torch.float32
    np.testing.assert_allclose(_np(res_f), _np(res), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(flux_f), _np(flux), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("path", ["jvp", "fused"])
def test_euler_ten_step_trajectory_matches_reference(path):
    bounds = ((0.0, 1.0), (0.0, 0.2))
    pj, pt = jpdes.Euler1D(), pdes.Euler1D()
    jdec, dec = JCart(bounds, 2, 2), CartesianDecomposition(bounds, 2, 2)
    jtopo, topo = jbuild(jdec, 8), build_topology(dec, 8)
    cfg_j = jnets.SubdomainModelConfig(nets={"u": jnets.MLPConfig(2, 3, 16,
                                                                  2)})
    cfg_t = SubdomainModelConfig(nets={"u": MLPConfig(2, 3, 16, 2)})
    bj = jmake_batch(jdec, jtopo, pj, 32, 16, np.random.default_rng(0))
    bt = make_batch(dec, topo, pt, 32, 16, np.random.default_rng(0))
    jt = jtrainer.ReferenceTrainer(
        pj, cfg_j, jtopo, jtrainer.DDConfig(method=XPINN,
                                            residual_path=JPATH[path]),
        lrs=2e-3)
    tt = ReferenceTrainer(pt, cfg_t, topo,
                          DDConfig(method=XPINN, residual_path=path),
                          lrs=2e-3, device="cpu")
    js = jt.init(0)
    p0 = jax.tree.map(np.array, js.params)
    p0["u"]["b"][-1][:, 0] += 1.5           # rho near 1, away from 0
    js = jtrainer.TrainState(params=jax.tree.map(jax.numpy.asarray, p0),
                             opt=js.opt, step=js.step)
    js, jterms = jt.run_chunk(js, bj.device_arrays(), 10)
    ts, terms = tt.run_chunk(_state(p0), bt.device_arrays(), 10)
    for k in jterms:
        assert terms[k].dtype == torch.float32, (k, terms[k].dtype)
        assert terms[k].shape == (10, 4)
        np.testing.assert_allclose(_np(terms[k]), np.asarray(jterms[k]),
                                   **TERMS)
    _close_trees(ts.params, js.params, PARAMS)
    _close_trees(ts.opt["m"], js.opt["m"], PARAMS)
