"""The pieces of the PyTorch port's training path against the JAX package,
on the CPU: ``data.make_batch``, the per-point PDE oracles, the halo
exchange, Adam with per-subdomain learning rates, and
``losses.network_eval`` + ``assemble_subdomain_loss`` on both residual
paths for XPINN and cPINN.

Inputs: params cross as numpy arrays, batches come from the same numpy
seed.  Tolerances (float32): 1e-5 (the frameworks sum in another order),
1e-4 relative on the per-point PDE oracles (second derivatives through two
nested forward-mode passes); batches and the exchange are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import halo as jhalo
from repro.core import losses as jlosses
from repro.core import nets as jnets
from repro.core import pdes as jpdes
from repro.core.domain import build_topology as jbuild
from repro.core.domain import us_map_decomposition as jus_map
from repro.data import make_batch as jmake_batch
from repro.optim import adam as jadam
from repro_torch.core import (CPINN, XPINN, build_topology, halo, losses,
                              nets, pdes)
from repro_torch.core.domain import us_map_decomposition
from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig,
                                   params_from_numpy)
from repro_torch.data import make_batch
from repro_torch.optim import adam
from test_torch_train import (F32, TERMS, _close_trees, _jax_params, _np,
                              _setup, one_torch_thread)  # noqa: F401


# ------------------------------------------------------------------- data

def test_make_batch_matches_reference():
    """Array-identical batches for the same seed: 2x2 Burgers, and us_map
    heat conduction with interior observations."""
    (_, _, _, _, bj), (_, _, _, _, bt) = _setup(n_res=50)
    for k in vars(bj):
        np.testing.assert_array_equal(getattr(bt, k), getattr(bj, k))
    hj = jmake_batch(jus_map(), jbuild(jus_map(), 6), jpdes.HeatConduction2D(),
                     [30, 40, 35, 30, 40, 25, 30, 45, 30, 40][:jus_map().n_sub],
                     12, np.random.default_rng(3), n_interior_data=7)
    ht = make_batch(us_map_decomposition(), build_topology(
        us_map_decomposition(), 6), pdes.HeatConduction2D(),
        [30, 40, 35, 30, 40, 25, 30, 45, 30, 40][:jus_map().n_sub], 12,
        np.random.default_rng(3), n_interior_data=7)
    for k in vars(hj):
        np.testing.assert_array_equal(getattr(ht, k), getattr(hj, k))
    sb = ht.device_arrays()
    assert sb.res_pts.dtype == torch.float32
    assert sb.res_pts.shape == ht.res_pts.shape


# ----------------------------------------------------------- PDE oracles

@pytest.mark.parametrize("name", ["burgers1d", "ns2d", "heat2d_inverse",
                                  "euler1d"])
def test_pointwise_residual_and_flux_match_reference(name):
    """The per-point forward-mode residual / flux oracles (torch.func.jvp,
    mapped over points with torch.func.vmap) against the reference's
    (jax.jvp under jax.vmap), on one random MLP per PDE."""
    pj, pt = jpdes.REGISTRY[name](), pdes.REGISTRY[name]()
    rng = np.random.default_rng(len(name))
    dims = [2, 12, 12, pj.n_fields]
    params = {"u": {"W": [rng.normal(0, 0.7, (a, b)).astype(np.float32)
                          for a, b in zip(dims[:-1], dims[1:])],
                    "b": [rng.normal(0, 0.1, (b,)).astype(np.float32)
                          for b in dims[1:]],
                    "a": rng.uniform(0.9, 1.1, (2,)).astype(np.float32)}}
    x = rng.uniform(0.1, 0.9, (23, 2)).astype(np.float32)
    cfg_j = jnets.SubdomainModelConfig(
        nets={"u": jnets.MLPConfig(2, pj.n_fields, 12, 2)})
    cfg_t = SubdomainModelConfig(nets={"u": MLPConfig(2, pj.n_fields, 12, 2)})
    fj = jnets.scalar_field_fn(cfg_j, jax.tree.map(jnp.asarray, params), 1)
    ft = nets.scalar_field_fn(cfg_t, params_from_numpy(params), 1)
    xt = torch.from_numpy(x)
    for method in ("residual", "flux"):
        want = jax.vmap(lambda p: getattr(pj, method)(fj, p))(x)
        got = torch.func.vmap(lambda p: getattr(pt, method)(ft, p))(xt)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------- exchange, Adam

def test_exchange_gather_matches_reference():
    (_, _, jtopo, _, _), (_, _, topo, _, _) = _setup()
    rng = np.random.default_rng(1)
    payload = rng.normal(size=(topo.n_sub, topo.n_slots, 8, 3)).astype(
        np.float32)
    want = np.asarray(jhalo.exchange_gather(jnp.asarray(payload), jtopo))
    got = halo.exchange_gather(torch.from_numpy(payload), topo)
    np.testing.assert_array_equal(_np(got), want)
    idx = halo.gather_index(topo)
    tree = halo.exchange_tree_gather({"u": torch.from_numpy(payload)}, topo,
                                     idx)
    np.testing.assert_array_equal(_np(tree["u"]), want)


def test_adam_update_per_subdomain_lr_matches_reference():
    """Three Adam steps with one learning rate per subdomain (broadcast over
    each leaf's leading axis), AdamW decay on."""
    rng = np.random.default_rng(2)
    shapes = {"W": [(4, 2, 5), (4, 5, 1)], "b": [(4, 5), (4, 1)], "a": (4, 3)}
    draw = lambda: {"W": [rng.normal(size=s).astype(np.float32)
                          for s in shapes["W"]],
                    "b": [rng.normal(size=s).astype(np.float32)
                          for s in shapes["b"]],
                    "a": rng.normal(size=shapes["a"]).astype(np.float32)}
    params, grads = draw(), [draw() for _ in range(3)]
    lr = np.array([1e-3, 2e-3, 5e-4, 1e-2], np.float32)
    cj, ct = jadam.AdamConfig(weight_decay=0.01), adam.AdamConfig(
        weight_decay=0.01)
    pj = jax.tree.map(jnp.asarray, params)
    sj = jadam.init_adam(pj)
    pt = params_from_numpy(params)
    st = adam.init_adam(pt)
    for g in grads:
        pj, sj = jadam.adam_update(jax.tree.map(jnp.asarray, g), sj, pj,
                                   jnp.asarray(lr), cj)
        pt, st = adam.adam_update(params_from_numpy(g), st, pt,
                                  torch.from_numpy(lr), ct)
    _close_trees(pt, pj, F32)
    _close_trees(st["m"], sj["m"], F32)
    _close_trees(st["v"], sj["v"], F32)
    assert int(st["count"]) == int(sj["count"]) == 3


# --------------------------------------------------------------- losses

@pytest.mark.parametrize("method", [XPINN, CPINN])
@pytest.mark.parametrize("path", ["jvp", "fused"])
def test_network_eval_and_loss_match_reference(path, method):
    """One megabatched network entry and the eq. (5)/(6) assembly for every
    subdomain, against the reference's per-subdomain functions under
    jax.vmap, with the received payload from each side's exchange."""
    (pj, _, jtopo, cfg_j, bj), (pt, _, topo, cfg_t, bt) = _setup()
    params = _jax_params(cfg_j, topo.n_sub)
    codes = np.zeros((topo.n_sub,), np.int32)
    jpath = None if path == "jvp" else jlosses.ResidualPath(act="tanh")
    tpath = None if path == "jvp" else losses.ResidualPath(act="tanh")
    jb = bj.device_arrays()
    outs_j = jax.vmap(lambda p, c, b: jlosses.network_eval(
        pj, cfg_j, method, p, c, None, b, jpath))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(codes), jb)
    recv_j = jhalo.exchange_tree_gather(outs_j[1], jtopo)
    tot_j, terms_j = jax.vmap(lambda b, r, o, d, ru, rg:
                              jlosses.assemble_subdomain_loss(
                                  pj, method, jlosses.LossWeights(), b, r, o,
                                  d, ru, rg))(jb, outs_j[0], outs_j[1],
                                              outs_j[2], recv_j["u"],
                                              recv_j["g"])
    tb = bt.device_arrays()
    res, own, pred = losses.network_eval(pt, cfg_t, method,
                                         params_from_numpy(params),
                                         torch.from_numpy(codes), None, tb,
                                         tpath)
    recv = halo.exchange_tree_gather(own, topo)
    tot, terms = losses.assemble_subdomain_loss(pt, method,
                                                losses.LossWeights(), tb, res,
                                                own, pred, recv["u"],
                                                recv["g"])
    for g, w in ((res, outs_j[0]), (own["u"], outs_j[1]["u"]),
                 (own["g"], outs_j[1]["g"]), (pred, outs_j[2])):
        np.testing.assert_allclose(_np(g), np.asarray(w), **F32)
    np.testing.assert_allclose(_np(tot), np.asarray(tot_j), **TERMS)
    for k in terms_j:
        np.testing.assert_allclose(_np(terms[k]), np.asarray(terms_j[k]),
                                   **TERMS)
    # the convenience entries: one call each, same numbers
    tot2, _ = losses.subdomain_loss(pt, cfg_t, method, losses.LossWeights(),
                                    params_from_numpy(params),
                                    torch.from_numpy(codes), None, tb,
                                    recv["u"], recv["g"], tpath)
    np.testing.assert_allclose(_np(tot2), _np(tot), **TERMS)
    res2 = losses.residual_eval(pt, cfg_t, params_from_numpy(params),
                                torch.from_numpy(codes), None, tb.res_pts,
                                tpath)
    np.testing.assert_allclose(_np(res2), _np(res), **F32)


