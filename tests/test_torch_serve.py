"""PyTorch port of the field-serving path against the JAX package (CPU).

* the numpy modules the port copies (geometry, routing, topology) give
  array-identical results for the Cartesian grid and the us_map polygons;
* bundles cross between the packages in both directions on disk, and a
  corrupted npz raises the port's ``CorruptBundleError``;
* ``FieldEngine`` answers one cloud (inside, interface and outside points)
  like the JAX engine at orders 1 and 2: the Cartesian Burgers bundle (the
  JAX engine runs its Pallas kernel in the interpreter) and the two-net
  us_map bundle with mixed activations and width masks (the select path);
* ``ResilientFrontend`` answers the same clouds as the JAX one;
* ``launch.serve_field.main`` serves an exported bundle on the CPU;
* the entry points refuse to run without a card unless asked for the CPU.

Engine tolerance: 1e-5 (rtol and atol) in float32 — the two packages sum the
matrix products in another order.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import domain as jdomain
from repro.serve import FieldBundle as JFieldBundle
from repro.serve import FieldEngine as JFieldEngine
from repro.serve import ResilienceConfig as JResilienceConfig
from repro.serve import ResilientFrontend as JResilientFrontend
from repro.serve import export as jexport
from repro.serve import routing as jrouting
from repro_torch.core import domain, nets
from repro_torch.core.nets import MLPConfig, SubdomainModelConfig
from repro_torch.core.pdes import Burgers1D, HeatConduction2D
from repro_torch.launch import serve_field
from repro_torch.serve import export
from repro_torch.serve import (CorruptBundleError, FieldBundle, FieldEngine,
                               ResilienceConfig, ResilientFrontend,
                               export_bundle, load_bundle, routing)

TOL = dict(rtol=1e-5, atol=1e-5)
TABLE3_ACTS = ["tanh", "sin", "cos", "tanh", "sin", "cos", "tanh", "sin",
               "cos", "tanh"]


def _np_params(cfg, n_sub, seed):
    """Stacked params as numpy arrays (non-trivial slopes and biases)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, c in cfg.nets.items():
        out[name] = {
            "W": [rng.normal(0, np.sqrt(2 / (a + b)), (n_sub, a, b))
                  .astype(np.float32) for a, b in c.layer_dims],
            "b": [rng.normal(0, 0.1, (n_sub, b)).astype(np.float32)
                  for _, b in c.layer_dims],
            "a": rng.uniform(0.8, 1.2, (n_sub, c.depth)).astype(np.float32),
        }
    return out


def _jax_twin(bundle: FieldBundle) -> JFieldBundle:
    """The same bundle as the JAX package's object (same numpy arrays)."""
    from repro.core import nets as jnets, pdes as jpdes

    jcfg = jnets.SubdomainModelConfig(nets={
        k: jnets.MLPConfig(**dataclasses.asdict(c))
        for k, c in bundle.model_cfg.nets.items()})
    pde = (None if bundle.pde is None else
           jpdes.REGISTRY[bundle.pde.name](**dataclasses.asdict(bundle.pde)))
    return JFieldBundle(
        model_cfg=jcfg, params=nets.params_to_numpy(bundle.params),
        decomp=jexport.decomp_from_spec(export.decomp_spec(bundle.decomp)),
        act_codes=np.asarray(bundle.act_codes), pde=pde,
        width_masks=(None if bundle.width_masks is None
                     else nets.params_to_numpy(bundle.width_masks)))


def _cart_bundle(seed=0):
    dec = domain.CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 12, 2)})
    return FieldBundle(model_cfg=cfg, params=_np_params(cfg, 4, seed),
                       decomp=dec, act_codes=np.zeros(4, np.int32),
                       pde=Burgers1D())


def _usmap_bundle(seed=1):
    dec = domain.us_map_decomposition()
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 12, 2),
                                     "k": MLPConfig(2, 1, 8, 2)})
    rng = np.random.default_rng(seed + 100)
    masks = {"k": (rng.uniform(size=(dec.n_sub, 8)) < 0.7).astype(np.float32)}
    codes = np.array([nets.act_code(a) for a in TABLE3_ACTS], np.int32)
    return FieldBundle(model_cfg=cfg, params=_np_params(cfg, dec.n_sub, seed),
                       decomp=dec, act_codes=codes, width_masks=masks,
                       pde=HeatConduction2D())


def _cloud(dec, seed=3):
    """Points inside every subdomain, on interfaces, and outside."""
    rng = np.random.default_rng(seed)
    inside = np.concatenate([dec.sample_interior(q, 9, rng)
                             for q in range(dec.n_sub)])
    topo = domain.build_topology(dec, 3)
    iface = topo.iface_points[topo.edge_mask > 0].reshape(-1, dec.dim)
    outside = np.array([[50.0, 50.0], [-40.0, 7.0]])
    return np.concatenate([inside, iface, outside])


# ------------------------------------------------------ copied numpy modules

@pytest.mark.parametrize("kind", ["cartesian", "usmap"])
def test_geometry_routing_topology_identical(kind):
    if kind == "cartesian":
        dec = domain.CartesianDecomposition(((-1, 1), (0, 1)), 3, 2)
        jdec = jdomain.CartesianDecomposition(((-1, 1), (0, 1)), 3, 2)
    else:
        dec, jdec = domain.us_map_decomposition(), jdomain.us_map_decomposition()
    pts = _cloud(dec)
    np.testing.assert_array_equal(
        routing.membership_matrix(dec, pts, tol=1e-9),
        jrouting.membership_matrix(jdec, pts, tol=1e-9))
    r, jr = routing.route(dec, pts), jrouting.route(jdec, pts)
    for f in ("claims", "owner", "X", "rows", "pt_idx", "primary"):
        np.testing.assert_array_equal(getattr(r, f), getattr(jr, f))
    t, jt = domain.build_topology(dec, 5), jdomain.build_topology(jdec, 5)
    assert (t.n_slots, t.perms) == (jt.n_slots, jt.perms)
    for f in ("neighbor", "edge_mask", "iface_points", "iface_normal"):
        np.testing.assert_array_equal(getattr(t, f), getattr(jt, f))
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for q in range(dec.n_sub):
        np.testing.assert_array_equal(dec.sample_interior(q, 7, rng),
                                      jdec.sample_interior(q, 7, jrng))


# ------------------------------------------------------------------ bundles

def _assert_params_equal(a, b):
    fa = nets.params_to_numpy(nets.params_from_numpy(a))
    fb = nets.params_to_numpy(nets.params_from_numpy(b))
    for name in fa:
        for k in ("W", "b"):
            for x, y in zip(fa[name][k], fb[name][k]):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(fa[name]["a"], fb[name]["a"])


def test_bundle_jax_export_port_load(tmp_path):
    jb = _jax_twin(_usmap_bundle())
    jexport.export_bundle(str(tmp_path), jb.params, jb.model_cfg, jb.decomp,
                          act_codes=jb.act_codes, width_masks=jb.width_masks,
                          pde=jb.pde, n_iface=5, step=3,
                          metadata={"note": "x"})
    b = load_bundle(str(tmp_path))
    _assert_params_equal(b.params, jb.params)
    assert isinstance(b.params["u"]["W"][0], torch.Tensor)
    np.testing.assert_array_equal(b.act_codes, jb.act_codes)
    np.testing.assert_array_equal(b.width_masks["k"].numpy(),
                                  jb.width_masks["k"])
    assert b.pde == HeatConduction2D() and b.n_iface == 5
    assert b.metadata == {"note": "x"}
    assert b.model_cfg.nets["k"] == MLPConfig(2, 1, 8, 2)


def test_bundle_port_export_jax_load(tmp_path):
    b = _cart_bundle()
    params = nets.params_from_numpy(b.params)   # tensors go to disk as-is
    export_bundle(str(tmp_path), params, b.model_cfg, b.decomp,
                  act_codes=torch.as_tensor(b.act_codes), pde=b.pde, step=7)
    jb = jexport.load_bundle(str(tmp_path))
    _assert_params_equal(b.params, jb.params)
    assert jb.pde.name == "burgers1d" and jb.pde.nu == b.pde.nu
    assert jb.decomp.bounds == b.decomp.bounds
    # identical manifests: leaf paths, their order and the tree string
    from repro.checkpoint import ckpt as jckpt
    from repro_torch.checkpoint import ckpt

    _, man = ckpt.raw_leaves(str(tmp_path))
    tree = {"params": jb.params}
    assert man["paths"] == jckpt._flatten_with_paths(tree)[0]
    assert man["paths"][0] == "['params']/['u']/['W']/[0]"
    import jax

    assert man["treedef"] == str(jax.tree_util.tree_structure(tree))


def test_corrupt_npz_raises(tmp_path):
    b = _cart_bundle()
    gen = export_bundle(str(tmp_path), b.params, b.model_cfg, b.decomp,
                        pde=b.pde)
    path = os.path.join(gen, "arrays.npz")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(CorruptBundleError) as e:
        load_bundle(str(tmp_path))
    assert "arrays.npz" in e.value.file


# ------------------------------------------------------------------ engine

def _jax_engine(bundle):
    return JFieldEngine(_jax_twin(bundle), block_n=32, interpret=True)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("kind", ["cartesian", "usmap"])
def test_engine_matches_jax_engine(kind, order):
    bundle = _cart_bundle() if kind == "cartesian" else _usmap_bundle()
    pts = _cloud(bundle.decomp)
    eng = FieldEngine(bundle, device="cpu")
    assert eng.uniform_act == ("tanh" if kind == "cartesian" else None)
    got = eng.evaluate(pts, order=order)
    want = _jax_engine(bundle).evaluate(pts, order=order)
    assert sorted(got) == sorted(want)
    claims = eng.last_claims
    assert (claims >= 2).sum() > 0 and (claims == 0).sum() == 2
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        assert np.isnan(got[k][claims == 0]).all()
        assert np.isfinite(got[k][claims > 0]).all()
        np.testing.assert_allclose(got[k], want[k], **TOL)
    assert eng.n_dispatches == 1


def test_engine_interface_average():
    """An interface point is the mean of its claiming subdomains' nets."""
    bundle = _cart_bundle()
    params = nets.params_from_numpy(bundle.params)
    cfg = bundle.model_cfg
    iface = np.stack([np.zeros(5), np.linspace(0.05, 0.45, 5)], axis=1)
    out = FieldEngine(bundle, device="cpu").evaluate(iface, order=1)
    x = torch.as_tensor(iface, dtype=torch.float32)
    ref = lambda q: nets.model_apply(
        cfg, nets.map_tree(lambda t: t[q], params), x, 0).numpy()
    # x=0, y<0.5 sits between subdomains 0 (ix=0,iy=0) and 2 (ix=1,iy=0)
    np.testing.assert_allclose(out["u"], 0.5 * (ref(0) + ref(2)), atol=1e-6)


def test_engine_first_order_tier_and_swap():
    bundle = _cart_bundle()
    eng = FieldEngine(bundle, device="cpu")
    pts = np.array([[0.2, 0.2], [-0.7, 0.9]])
    o1, o2 = eng.evaluate(pts, order=1), eng.evaluate(pts, order=2)
    assert sorted(o1) == ["flux", "grad_u", "u"]
    assert sorted(o2) == ["flux", "grad_u", "residual", "u"]
    for k in o1:
        np.testing.assert_allclose(o1[k], o2[k], rtol=0, atol=1e-6)
    eng.swap_bundle(_cart_bundle(seed=5))
    o3 = eng.evaluate(pts, order=1)
    assert not np.allclose(o3["u"], o1["u"])
    np.testing.assert_allclose(
        o3["u"], FieldEngine(_cart_bundle(seed=5), device="cpu")
        .evaluate(pts, order=1)["u"], rtol=0, atol=0)


def test_engine_order2_without_pde_raises():
    b = dataclasses.replace(_cart_bundle(), pde=None)
    eng = FieldEngine(b, device="cpu")
    assert sorted(eng.evaluate(np.array([[0.1, 0.1]]), order=1)) == \
        ["grad_u", "u"]
    with pytest.raises(ValueError, match="order=2"):
        eng.evaluate(np.array([[0.1, 0.1]]), order=2)


# ---------------------------------------------------------------- frontend

@pytest.mark.parametrize("kind", ["cartesian", "usmap"])
def test_resilient_frontend_matches_jax(kind):
    bundle = _cart_bundle() if kind == "cartesian" else _usmap_bundle()
    fe = ResilientFrontend(FieldEngine(bundle, device="cpu"),
                           ResilienceConfig(order=2))
    jfe = JResilientFrontend(_jax_engine(bundle), JResilienceConfig(order=2))
    clouds = [_cloud(bundle.decomp, seed=s) for s in (7, 8)]
    tickets = [(fe.submit(c), jfe.submit(c)) for c in clouds]
    fe.flush()
    jfe.flush()
    for t, jt in tickets:
        r, jr = fe.result(t), jfe.result(jt)
        assert (r.status, r.order, r.degraded) == \
            (jr.status, jr.order, jr.degraded) == ("served", 2, False)
        for k in jr.data:
            np.testing.assert_allclose(r.data[k], jr.data[k], **TOL)
    assert fe.drain()["unanswered"] == 0


# ------------------------------------------------------------- entry points

def test_serve_field_main_cpu(tmp_path, capsys):
    b = _cart_bundle()
    export_bundle(str(tmp_path / "b"), b.params, b.model_cfg, b.decomp,
                  pde=b.pde)
    rc = serve_field.main(["--bundle", str(tmp_path / "b"), "--device", "cpu",
                           "--max-requests", "20", "--rate", "2000",
                           "--duration", "30", "--heartbeat", "5",
                           "--status-file", str(tmp_path / "status.json")])
    assert rc == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["requests"] == 20 and report["goodput"] == 1.0
    assert report["drained"]["unanswered"] == 0


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = _cart_bundle()
    with pytest.raises(RuntimeError, match="CUDA"):
        FieldEngine(bundle)
    with pytest.raises(RuntimeError, match="CUDA"):
        FieldEngine(bundle, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_field.main(["--demo", "cart", "--max-requests", "1"])
    assert FieldEngine(bundle, device="cpu").device.type == "cpu"


def test_demo_bundles_serve_on_cpu():
    for kind in ("cart", "usmap"):
        b = serve_field._demo_bundle(kind, seed=0)
        sample = serve_field._cloud_sampler(b.decomp, 0)
        out = FieldEngine(b, device="cpu").evaluate(sample(), order=2)
        assert np.isfinite(out["u"][~np.isnan(out["u"][:, 0])]).all()
    # seeded: the same seed gives the same weights
    a = serve_field._demo_bundle("cart", seed=3).params["u"]["W"][0]
    assert torch.equal(a, serve_field._demo_bundle("cart", seed=3)
                       .params["u"]["W"][0])
