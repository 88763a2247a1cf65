"""The paper's remaining PINN scenarios in the port against the JAX
package, on the CPU: the ten-region inverse heat map (§7.6,
``repro_torch.launch.inverse_heat_map``, the reference's
``examples/inverse_heat_map.py``) and the lid-driven cavity cPINN (§7.4,
``repro_torch.launch.navier_stokes_cavity``, the reference's
``examples/navier_stokes_cavity.py``).

Each entry point's problem (its ``build_problem``, at a reduced width and
point count) is held against the same problem built from the JAX package,
from the same numpy params (the reference's init crossed with
``params_from_numpy``), 10 steps in chunks of 5, one module-scoped JAX run
per problem: params within 1e-5, the summed loss within 1e-4 relative, the
validation number (rel-L2 of (T, K); the stitched Ghia centerline) within
1e-4 / 1e-5.  Then the entry points' ``main`` on the CPU: the inverse one's
``--export --serve-demo`` round trip, its supervised crash replay, and
both JSON lines.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.core import TrainState
from repro_torch.core.nets import params_from_numpy, tree_leaves
from repro_torch.launch import inverse_heat_map as ihm
from repro_torch.launch import navier_stokes_cavity as nsc
from repro_torch.optim import adam

PARAMS = dict(rtol=0, atol=1e-5)
LOSS_RTOL = 1e-4
STEPS, CHUNK = 10, 5
INV_WIDTH, INV_COUNTS = 12, [30, 40, 50, 40, 30, 40, 8, 30, 50, 40]
CAV_WIDTH = 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


def _run_jax(trainer, batch):
    """10 steps in chunks of 5 from the reference's init: (init params as
    numpy, final params, summed loss of the last step)."""
    state = trainer.init(0)
    p0 = jax.tree.map(np.asarray, state.params)
    b = batch.device_arrays()
    for _ in range(STEPS // CHUNK):
        state, terms = trainer.run_chunk(state, b, CHUNK)
    return p0, state.params, float(np.asarray(terms["loss"])[-1].sum())


def _run_port(trainer, batch, p0):
    p = params_from_numpy(p0, "cpu")
    state = TrainState(params=p, opt=adam.init_adam(p),
                       step=torch.zeros((), dtype=torch.int32))
    b = batch.device_arrays("cpu")
    for _ in range(STEPS // CHUNK):
        state, terms = trainer.run_chunk(state, b, CHUNK)
    return state.params, float(terms["loss"][-1].sum())


def _close_params(got, want):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), np.asarray(b), **PARAMS)


# ------------------------------------------------------------ inverse (§7.6)

@pytest.fixture(scope="module")
def inverse_ref():
    """The example's problem built from the JAX package (width and counts
    reduced), 10 steps."""
    from repro.core import (DDConfig, HeatConduction2D, LossWeights,
                            ReferenceTrainer, XPINN, build_topology,
                            evaluate_l2, us_map_decomposition)
    from repro.core.nets import MLPConfig, SubdomainModelConfig
    from repro.data import make_batch

    pde = HeatConduction2D()
    decomp = us_map_decomposition()
    topo = build_topology(decomp, n_iface=16)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, INV_WIDTH, 3),
                                     "k": MLPConfig(2, 1, INV_WIDTH, 3)})
    batch = make_batch(decomp, topo, pde, INV_COUNTS, n_bnd=48,
                       rng=np.random.default_rng(0), n_interior_data=150)
    tr = ReferenceTrainer(pde, cfg, topo,
                          DDConfig(method=XPINN,
                                   weights=LossWeights(data=40.0)),
                          act_codes=ihm.TABLE3_ACTS, lrs=6e-3)
    p0, params, loss = _run_jax(tr, batch)
    err = evaluate_l2(decomp, cfg, params, tr.act_codes, pde)
    return p0, params, loss, err


def test_inverse_problem_matches_reference(inverse_ref):
    """Table-3 mixed activations on the jvp path, two nets per region."""
    p0, want, want_loss, want_err = inverse_ref
    prob = ihm.build_problem(width=INV_WIDTH, counts=INV_COUNTS,
                             device="cpu")
    assert prob.trainer.res_path is None      # mixed activations: jvp
    got, loss = _run_port(prob.trainer, prob.batch, p0)
    _close_params(got, want)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert abs(prob.rel_l2(got) - want_err) <= 1e-4


def test_inverse_main_exports_and_serves_on_cpu(tmp_path, capsys):
    """``main`` at the example's defaults, 10 steps: the reference's lines,
    the serve demo, one JSON line; the served K field equals the engine's
    own ``evaluate`` on the same points."""
    from repro_torch.serve import FieldEngine, ServeFrontend, load_bundle

    out_dir = str(tmp_path / "field")
    rc = ihm.main(["--device", "cpu", "--steps", str(STEPS), "--chunk",
                   str(CHUNK), "--export", out_dir, "--serve-demo"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[inverse] 10 irregular regions" in out
    assert "[serve] served K field rel_L2 vs exact" in out
    rep = json.loads(out.strip().splitlines()[-1])["inverse"]
    assert rep["steps"] == STEPS and len(rep["chunks"]) == STEPS // CHUNK
    assert rep["chunks"][-1]["rel_l2"] == rep["rel_l2"]
    srv = rep["serve"]
    assert srv["points"] == 6400 and srv["dispatches"] == 1
    assert srv["frontend"]["cache_hits"] == 1

    bundle = load_bundle(out_dir)
    assert bundle.act_codes.tolist() == [0, 1, 2, 0, 1, 2, 0, 1, 2, 0]
    grid = ihm.grid_points(bundle.decomp, 80)
    served = ServeFrontend(FieldEngine(bundle, device="cpu"),
                           order=2).query(grid)
    direct = FieldEngine(bundle, device="cpu").evaluate(grid, order=2)
    for k in direct:
        np.testing.assert_array_equal(served[k], direct[k])
    inside = ~np.isnan(direct["u"][:, 0])
    ex = bundle.pde.exact(grid[inside])
    rel = (np.linalg.norm(direct["u"][inside, 1] - ex[:, 1])
           / np.linalg.norm(ex[:, 1]))
    assert rel == pytest.approx(srv["k_rel_l2"], rel=1e-12)
    # a point far outside the map is NaN
    far = FieldEngine(bundle, device="cpu").evaluate(np.array([[1e3, 1e3]]))
    assert np.isnan(far["u"]).all()


def test_inverse_supervised_crash_replays_bitwise(tmp_path, capsys):
    """``--supervised --inject crash@1``: the crashed chunk is replayed from
    the checkpoint, and the exported field equals an uninterrupted
    supervised run's bit for bit."""
    from repro_torch.serve import load_bundle

    params = {}
    for name, inject in (("crash", ["--inject", "crash@1"]), ("clean", [])):
        exp = str(tmp_path / f"field_{name}")
        rc = ihm.main(["--device", "cpu", "--steps", str(STEPS), "--chunk",
                       str(CHUNK), "--supervised", "--ckpt",
                       str(tmp_path / f"ck_{name}"), "--export", exp,
                       *inject])
        assert rc == 0
        rep = json.loads(capsys.readouterr().out.strip()
                         .splitlines()[-1])["inverse"]
        assert rep["steps"] == STEPS
        params[name] = (rep["supervisor"],
                        tree_leaves(load_bundle(exp).params))
    sup, got = params["crash"]
    assert (sup["crashes"], sup["restarts"], sup["chunks"]) == (1, 1, 2)
    assert params["clean"][0]["crashes"] == 0
    for a, b in zip(got, params["clean"][1]):
        np.testing.assert_array_equal(a, b)


def test_inverse_main_flag_errors(capsys):
    with pytest.raises(SystemExit):
        ihm.main(["--device", "cpu", "--serve-demo"])
    assert "--serve-demo requires --export" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        ihm.main(["--device", "cpu", "--inject", "crash@1"])
    assert "--inject requires --supervised" in capsys.readouterr().err


def test_inverse_fused_needs_one_activation():
    """The Table-3 mix cannot take the fused path (the reference refuses it
    too); one shared activation can, one K3/K4 pair per net."""
    with pytest.raises(ValueError, match="one activation"):
        ihm.build_problem(width=8, counts=[8] * 10, residual_path="fused",
                          device="cpu")
    prob = ihm.build_problem(width=8, counts=[8] * 10,
                             act_codes=["tanh"] * 10, residual_path="fused",
                             device="cpu")
    assert prob.trainer.res_path.act == "tanh"


# ------------------------------------------------------------- cavity (§7.4)

def _jax_centerline(cfg, params, act_codes, decomp):
    """The example's stitched centerline (model_apply per subdomain)."""
    from repro.core import nets as jnets

    pts = np.stack([np.full_like(nsc.GHIA_Y, 0.5), nsc.GHIA_Y],
                   axis=1).astype(np.float32)
    pred = np.zeros(len(pts))
    for q in range(decomp.n_sub):
        inside = decomp.subdomain_contains(q, pts)
        if inside.any():
            p_q = jax.tree.map(lambda x: x[q], params)
            u = jnets.model_apply(cfg, p_q, jnp.asarray(pts[inside]),
                                  act_codes[q])
            pred[inside] = np.asarray(u[:, 0])
    return pred


@pytest.fixture(scope="module")
def cavity_ref():
    from repro.core import (CPINN, CartesianDecomposition, DDConfig,
                            LossWeights, NavierStokes2D, ReferenceTrainer,
                            build_topology)
    from repro.core.nets import MLPConfig, SubdomainModelConfig
    from repro.data import make_batch

    pde = NavierStokes2D(re=100.0)
    decomp = CartesianDecomposition(((0, 1), (0, 1)), 2, 2)
    topo = build_topology(decomp, n_iface=32)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 3, CAV_WIDTH, 5)})
    batch = make_batch(decomp, topo, pde, n_res=1500, n_bnd=120,
                       rng=np.random.default_rng(0))
    tr = ReferenceTrainer(pde, cfg, topo,
                          DDConfig(method=CPINN,
                                   weights=LossWeights(data=40.0)),
                          lrs=6e-4)
    p0, params, loss = _run_jax(tr, batch)
    return p0, params, loss, _jax_centerline(cfg, params, tr.act_codes,
                                             decomp)


@pytest.mark.parametrize("path", ["jvp", "fused"])
def test_cavity_problem_matches_reference(cavity_ref, path):
    """The example's problem on the jvp path and on the fused path (the
    reference's ``residual_path="pallas"``), against the reference's jvp
    run: params, loss, and the stitched centerline."""
    p0, want, want_loss, want_line = cavity_ref
    prob = nsc.build_problem(width=CAV_WIDTH, residual_path=path,
                             device="cpu")
    got, loss = _run_port(prob.trainer, prob.batch, p0)
    _close_params(got, want)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    line = nsc.centerline(prob, got)
    np.testing.assert_allclose(line, want_line, rtol=0, atol=1e-5)
    assert nsc.ghia_rms(line) == pytest.approx(
        float(np.sqrt(np.mean((want_line - nsc.GHIA_U) ** 2))), abs=1e-5)


def test_cavity_main_on_cpu(capsys):
    """``main`` at the example's defaults, 10 steps: chunks stop at the
    step count, the Ghia table, one JSON line."""
    rc = nsc.main(["--device", "cpu", "--steps", str(STEPS), "--chunk",
                   str(CHUNK)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[cavity] centerline RMS error vs Ghia" in out
    rep = json.loads(out.strip().splitlines()[-1])["cavity"]
    assert rep["steps"] == STEPS and len(rep["chunks"]) == STEPS // CHUNK
    assert len(rep["centerline"]) == len(nsc.GHIA_Y)
    assert np.isfinite(rep["ghia_rms"])
