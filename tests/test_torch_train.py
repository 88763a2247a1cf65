"""The PyTorch port's training slice as a whole against the JAX package, on
the CPU: ``core.trainer.ReferenceTrainer`` (10-step trajectories, chunks,
stacked batches, the guard), train-state checkpoints, ``evaluate_l2`` and
the entry points' device rule.  Its pieces (batches, PDE oracles, exchange,
Adam, losses) are in ``tests/test_torch_train_parts.py``, the convergence
run in ``tests/test_torch_e2e.py``.

Everything is held against the JAX reference on the same inputs: params
cross as numpy arrays (``params_from_numpy``; the two packages draw
different random numbers), batches come from the same numpy seed.

Tolerances (float32): 1e-5 relative / 1e-6 absolute on loss terms, 1e-5 on
params after 10 steps, 1e-5 elsewhere (the frameworks sum in another
order; measured differences are ~1e-7).  Adam's first step moves every
parameter by lr * sign(gradient) whatever the gradient's size, so a
component whose gradient sat at rounding level could differ by 2 * lr =
4e-3; a 1e-5 bound on the params says no component moved the other way.
The JAX chunk is compared within tolerance, never bitwise (under jax 0.9.0
it is not bitwise even with its own step loop).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import halo as jhalo
from repro.core import losses as jlosses
from repro.core import nets as jnets
from repro.core import trainer as jtrainer
from repro.core import pdes as jpdes
from repro.core.domain import (CartesianDecomposition as JCart,
                               build_topology as jbuild,
                               us_map_decomposition as jus_map)
from repro.data import make_batch as jmake_batch
from repro.optim import adam as jadam

from repro_torch.core import (CPINN, XPINN, DDConfig, ReferenceTrainer,
                              TrainState, build_topology, evaluate_l2, halo,
                              losses, nets, pdes, restore_train_state,
                              save_train_state)
from repro_torch.core.domain import (CartesianDecomposition,
                                     us_map_decomposition)
from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig,
                                   params_from_numpy, params_to_numpy,
                                   tree_leaves)
from repro_torch.data import make_batch, stack_batches
from repro_torch.launch import quickstart
from repro_torch.optim import adam

TERMS = dict(rtol=1e-5, atol=1e-6)
PARAMS = dict(rtol=0, atol=1e-5)
F32 = dict(rtol=1e-5, atol=1e-5)
JPATH = {"jvp": "jvp", "fused": "pallas"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module's tests run: the test workers
    are the parallelism, and eight threads in each of them oversubscribe
    the cores several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close_trees(got, want, tol):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)


def _setup(n_res=32, width=16, depth=2, seed=0):
    """A small 2x2 Burgers XPINN on both sides (n_iface = 8, as in
    tests/test_trainer_chunk.py)."""
    pde_j, pde_t = jpdes.Burgers1D(), pdes.Burgers1D()
    dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
    topo = build_topology(dec, 8)
    jdec = JCart(((-1, 1), (0, 1)), 2, 2)
    jtopo = jbuild(jdec, 8)
    cfg_j = jnets.SubdomainModelConfig(nets={"u": jnets.MLPConfig(2, 1, width,
                                                                  depth)})
    cfg_t = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, width, depth)})
    bj = jmake_batch(jdec, jtopo, pde_j, n_res, 16,
                     np.random.default_rng(seed))
    bt = make_batch(dec, topo, pde_t, n_res, 16, np.random.default_rng(seed))
    return (pde_j, jdec, jtopo, cfg_j, bj), (pde_t, dec, topo, cfg_t, bt)


def _jax_params(cfg_j, n_sub, seed=0):
    params, _ = jnets.stacked_init(cfg_j, n_sub, jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


# -------------------------------------------------------------- trainer

def _trainers(path, method, local_steps, **kw):
    (pj, _, jtopo, cfg_j, bj), (pt, _, topo, cfg_t, bt) = _setup(**kw)
    jt = jtrainer.ReferenceTrainer(
        pj, cfg_j, jtopo, jtrainer.DDConfig(method=method,
                                            residual_path=JPATH[path],
                                            local_steps=local_steps),
        lrs=2e-3)
    tt = ReferenceTrainer(pt, cfg_t, topo,
                          DDConfig(method=method, residual_path=path,
                                   local_steps=local_steps),
                          lrs=2e-3, device="cpu")
    return jt, bj.device_arrays(), tt, bt.device_arrays()


def _state(params_np, device="cpu"):
    p = params_from_numpy(params_np, device)
    return TrainState(params=p, opt=adam.init_adam(p),
                      step=torch.zeros((), dtype=torch.int32, device=device))


@pytest.mark.parametrize("path", ["jvp", "fused"])
@pytest.mark.parametrize("method,local_steps", [(XPINN, 1), (CPINN, 2)])
def test_ten_step_trajectory_matches_reference(path, method, local_steps):
    """The slice as a whole: 10 outer steps of the port's ReferenceTrainer
    against the JAX ReferenceTrainer from the same params."""
    jt, jb, tt, tb = _trainers(path, method, local_steps)
    js = jt.init(0)
    p0 = jax.tree.map(np.asarray, js.params)
    js, jterms = jt.run_chunk(js, jb, 10)
    ts, terms = tt.run_chunk(_state(p0), tb, 10)
    for k in jterms:
        assert terms[k].shape == (10, 4)
        np.testing.assert_allclose(_np(terms[k]), np.asarray(jterms[k]),
                                   **TERMS)
    _close_trees(ts.params, js.params, PARAMS)
    _close_trees(ts.opt["m"], js.opt["m"], PARAMS)
    assert int(ts.step) == int(js.step) == 10


def test_run_chunk_matches_step_loop_and_stacked_batches():
    """A chunk is the step loop (bitwise on the CPU), for a constant batch
    and for one batch per step (data.stack_batches)."""
    _, _, tt, tb = _trainers("fused", CPINN, 2)
    p0 = params_to_numpy(tt.init(0).params)
    s1, terms = tt.run_chunk(_state(p0), tb, 3)
    s2 = _state(p0)
    for i in range(3):
        s2, t2 = tt.step(s2, tb)
        for k in t2:
            assert torch.equal(terms[k][i], t2[k])
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        assert torch.equal(a, b)
    (_, _, _, _, _), (pt, dec, topo, _, _) = _setup()
    batches = [make_batch(dec, topo, pt, 32, 16, np.random.default_rng(s))
               .device_arrays() for s in (5, 6, 7)]
    s3, t3 = tt.run_chunk(_state(p0), stack_batches(batches))
    s4 = _state(p0)
    for i, b in enumerate(batches):
        s4, t4 = tt.step(s4, b)
        assert torch.equal(t3["loss"][i], t4["loss"])
    for a, b in zip(tree_leaves(s3.params), tree_leaves(s4.params)):
        assert torch.equal(a, b)
    assert int(s3.step) == 3


def test_run_chunk_guarded_freezes_on_nan():
    """NaN in one subdomain's params: the guard trips on the first step,
    freezes the state, flags the subdomains whose loss went non-finite and
    counts one good step, as the JAX guard does on the same inputs."""
    jt, jb, tt, tb = _trainers("fused", XPINN, 1)
    p0 = params_to_numpy(tt.init(0).params)
    p0["u"]["W"][0][1, 0, 0] = np.nan
    jt.init(0)   # sets the JAX trainer's activation codes
    js, jterms, jh = jt.run_chunk_guarded(
        jtrainer.TrainState(params=jax.tree.map(jnp.asarray, p0),
                            opt=jadam.init_adam(jax.tree.map(jnp.asarray,
                                                             p0)),
                            step=jnp.zeros((), jnp.int32)), jb, 4)
    st, terms, h = tt.run_chunk_guarded(_state(p0), tb, 4)
    # subdomain 1 and its two neighbours, which receive its NaN payload,
    # trip; the diagonal subdomain 2 stays healthy
    assert h["ok_sub"].tolist() == [False, False, True, False] == \
        np.asarray(jh["ok_sub"]).tolist()
    assert int(h["good_steps"]) == int(jh["good_steps"]) == 1
    assert not bool(h["ok"])
    assert torch.isnan(terms["loss"][1:]).all()
    assert torch.isfinite(terms["loss"][0, 2])
    np.testing.assert_allclose(_np(terms["loss"]), np.asarray(jterms["loss"]),
                               **TERMS)
    one, _ = tt.step(_state(p0), tb)
    for a, b in zip(tree_leaves(st.params), tree_leaves(one.params)):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert int(st.step) == 1
    # lr_scale rides as a tensor: scaled rates equal a trainer built with them
    p1 = params_to_numpy(tt.init(1).params)
    scale = np.array([1.0, 0.5, 1.0, 0.25], np.float32)
    s_g, _, h_g = tt.run_chunk_guarded(_state(p1), tb, 2, lr_scale=scale)
    assert bool(h_g["ok"]) and int(h_g["good_steps"]) == 2
    (pt, _, topo, cfg_t, _) = _setup()[1]
    scaled = ReferenceTrainer(pt, cfg_t, topo,
                              DDConfig(method=XPINN, residual_path="fused"),
                              lrs=2e-3 * scale, device="cpu")
    s_s, _ = scaled.run_chunk(_state(p1), tb, 2)
    for a, b in zip(tree_leaves(s_g.params), tree_leaves(s_s.params)):
        assert torch.equal(a, b)


def test_train_state_checkpoint_round_trip_and_reference_restore(tmp_path):
    """save/restore round-trips the port's state bitwise, and a state saved
    by the JAX trainer restores in the port with the same leaves."""
    jt, jb, tt, tb = _trainers("fused", XPINN, 1)
    st, _ = tt.run_chunk(tt.init(3), tb, 2)
    save_train_state(str(tmp_path / "port"), st)
    back = restore_train_state(str(tmp_path / "port"), tt.init(0))
    for a, b in zip(tree_leaves({"p": back.params, "o": back.opt}),
                    tree_leaves({"p": st.params, "o": st.opt})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(back.step) == 2 and back.step.dtype == torch.int32
    js, _ = jt.run_chunk(jt.init(0), jb, 2)
    jtrainer.save_train_state(str(tmp_path / "jax"), js)
    got = restore_train_state(str(tmp_path / "jax"), tt.init(0))
    _close_trees(got.params, js.params, dict(rtol=0, atol=0))
    _close_trees(got.opt, js.opt, dict(rtol=0, atol=0))
    assert got.opt["count"].dtype == torch.int32 and int(got.step) == 2


def test_evaluate_l2_matches_reference():
    (pj, jdec, _, cfg_j, _), (pt, dec, _, cfg_t, _) = _setup()
    params = _jax_params(cfg_j, dec.n_sub, seed=4)
    codes = np.zeros((dec.n_sub,), np.int32)
    want = jtrainer.evaluate_l2(jdec, cfg_j, jax.tree.map(jnp.asarray,
                                                          params), codes, pj)
    got = evaluate_l2(dec, cfg_t, params_from_numpy(params), codes, pt,
                      device="cpu")
    assert got == pytest.approx(want, rel=1e-5)


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """With no card, the trainer, evaluate_l2 and the quickstart raise
    unless the caller asks for the CPU: no silent fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _, _, _, _), (pt, dec, topo, cfg_t, _) = _setup()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReferenceTrainer(pt, cfg_t, topo, DDConfig())
    p = nets.stacked_init(cfg_t, dec.n_sub, 0)[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_l2(dec, cfg_t, p, np.zeros(4, np.int32), pt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main(["--steps", "1"])


def test_fused_path_refuses_what_it_cannot_honour():
    (_, _, _, _, _), (pt, dec, topo, cfg_t, _) = _setup()
    with pytest.raises(ValueError, match="one activation"):
        ReferenceTrainer(pt, cfg_t, topo, DDConfig(residual_path="fused"),
                         act_codes=["tanh", "sin", "tanh", "tanh"],
                         device="cpu")

    class NoBundle(pdes.PDE):
        name, input_dim, n_fields, n_eq = "nobundle", 2, 1, 1

    with pytest.raises(ValueError, match="residual_from_derivs"):
        ReferenceTrainer(NoBundle(), cfg_t, topo,
                         DDConfig(residual_path="fused"), device="cpu")
    with pytest.raises(ValueError, match="backward_path"):
        ReferenceTrainer(pt, cfg_t, topo, DDConfig(backward_path="x"),
                         device="cpu")



def test_telemetry_rows_and_chunk_span_match_reference():
    """Telemetry rows on the terms (grad/param norms, lr, interface
    mismatch) against the JAX trainer's, and a tracer attached to the
    trainer records one span per chunk."""
    from repro_torch.obs import Tracer

    (pj, _, jtopo, cfg_j, bj), (pt, _, topo, cfg_t, bt) = _setup()
    cfg = dict(method=XPINN, telemetry=True)
    jt = jtrainer.ReferenceTrainer(pj, cfg_j, jtopo, jtrainer.DDConfig(
        residual_path="pallas", **cfg), lrs=[1e-3, 2e-3, 3e-3, 4e-3])
    tt = ReferenceTrainer(pt, cfg_t, topo, DDConfig(residual_path="fused",
                                                    **cfg),
                          lrs=[1e-3, 2e-3, 3e-3, 4e-3], device="cpu")
    js = jt.init(0)
    p0 = jax.tree.map(np.asarray, js.params)
    js, jterms = jt.run_chunk(js, bj.device_arrays(), 3)
    tt.tracer = Tracer()
    ts, terms = tt.run_chunk(_state(p0), bt.device_arrays(), 3)
    assert sorted(terms) == sorted(jterms)
    for k in ("grad_norm", "param_norm", "lr", "iface_mismatch"):
        np.testing.assert_allclose(_np(terms[k]), np.asarray(jterms[k]),
                                   rtol=1e-5, atol=1e-6)
    (span,) = tt.tracer.spans()
    assert span.name == "train.run_chunk" and span.attrs["steps"] == 3


def test_clip_and_schedule_match_reference():
    rng = np.random.default_rng(9)
    g = {"W": [rng.normal(size=(3, 4)).astype(np.float32)],
         "a": rng.normal(size=(2,)).astype(np.float32)}
    gj, nj = jadam.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.5)
    gt, nt = adam.clip_by_global_norm(params_from_numpy(g), 0.5)
    assert float(nt) == pytest.approx(float(nj), rel=1e-6)
    _close_trees(gt, gj, F32)
    for s in (0, 5, 50, 200):
        want = jadam.warmup_cosine(jnp.asarray(s), 1e-3, 10, 100)
        got = adam.warmup_cosine(torch.tensor(s), 1e-3, 10, 100)
        assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_couple_gradients_flows_through_the_exchange():
    """``couple_gradients=True`` differentiates through the gathered
    payload, so the first step differs from the uncoupled one; the JAX
    ReferenceTrainer takes the gradient w.r.t. its own outputs only
    (``jax.value_and_grad(assemble_all)(outs, recv)``), so there the flag
    changes nothing (ROADMAP Queue 3)."""
    jt, jb, tt, tb = _trainers("fused", XPINN, 1)
    js0 = jt.init(0)
    p0 = jax.tree.map(np.asarray, js0.params)
    (pj, _, jtopo, cfg_j, _), (pt, _, topo, cfg_t, _) = _setup()
    coupled = ReferenceTrainer(pt, cfg_t, topo,
                               DDConfig(residual_path="fused",
                                        couple_gradients=True),
                               lrs=2e-3, device="cpu")
    a, _ = tt.step(_state(p0), tb)
    c, _ = coupled.step(_state(p0), tb)
    diff = max(float((x - y).abs().max()) for x, y in
               zip(tree_leaves(a.params), tree_leaves(c.params)))
    assert diff > 1e-4
    jc = jtrainer.ReferenceTrainer(pj, cfg_j, jtopo, jtrainer.DDConfig(
        residual_path="pallas", couple_gradients=True), lrs=2e-3)
    jc.init(0)
    ja, _ = jt.step(jtrainer.TrainState(
        params=jax.tree.map(jnp.asarray, p0),
        opt=jadam.init_adam(jax.tree.map(jnp.asarray, p0)),
        step=jnp.zeros((), jnp.int32)), jb)
    jcs, _ = jc.step(jtrainer.TrainState(
        params=jax.tree.map(jnp.asarray, p0),
        opt=jadam.init_adam(jax.tree.map(jnp.asarray, p0)),
        step=jnp.zeros((), jnp.int32)), jb)
    for x, y in zip(jax.tree.leaves(ja.params), jax.tree.leaves(jcs.params)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
