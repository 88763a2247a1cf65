"""The PyTorch port's fault-tolerant runtime (``repro_torch.runtime``) against
the JAX package's ``repro.runtime``, on the CPU.

Held against the reference on the same inputs: the fault schedule parser
(equal ``Fault`` lists, the same errors), ``inject_nan`` (the same leaf and
index poisoned), the storage faults (the same bytes for the same seed), the
elastic remap and rebalancing (equal arrays), the guard's per-subdomain
verdicts, a supervised run with a crash and a NaN trip (equal report ints
and events; params within ``test_torch_train.py``'s trajectory tolerance,
1e-5), checkpoints written by the reference's supervisor and resumed by the
port (bitwise: they are the same float32 bytes), and the serve fault matrix
(the same statuses and counters from the two frontends).  Held against
itself: a guarded chunk equals an unguarded one bitwise, and a crash
recovery equals the uninterrupted run bitwise.  Sizes are the reference's
``tests/test_supervisor.py::_setup``: 2x2 Burgers XPINN, 48 residual points
per subdomain, 16 x 2 nets.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core import trainer as jtrainer
from repro.core import nets as jnets
from repro.core import pdes as jpdes
from repro.core.domain import (CartesianDecomposition as JCart,
                               build_topology as jbuild,
                               us_map_decomposition as jus_map)
from repro.data import make_batch as jmake_batch
from repro.serve import FieldBundle as JFieldBundle
from repro.serve import FieldEngine as JFieldEngine
from repro.serve import ResilienceConfig as JResilienceConfig
from repro.serve import ResilientFrontend as JResilientFrontend
from repro_torch import runtime as rt
from repro_torch.core import (XPINN, DDConfig, ReferenceTrainer, TrainState,
                              build_topology, evaluate_l2, pdes)
from repro_torch.core.domain import (CartesianDecomposition,
                                     us_map_decomposition)
from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig,
                                   map_tree, tree_leaves)
from repro_torch.data import make_batch
from repro_torch.kernels import native, pinn_mlp
from repro_torch.launch import quickstart, serve_field
from repro_torch.serve import (FieldBundle, FieldEngine, ResilienceConfig,
                               ResilientFrontend)
from test_torch_train import (PARAMS, _close_trees, _np, _state,
                              one_torch_thread)  # noqa: F401

BOUNDS = ((-1, 1), (0, 1))


def _setup(nx=2, nt=2, n_res=48, width=16, depth=2, seed=0):
    """The reference's ``_setup`` on both sides: (JAX trainer, batch), (port
    trainer, batch), the port's decomposition."""
    pj, pt = jpdes.Burgers1D(), pdes.Burgers1D()
    jdec, dec = JCart(BOUNDS, nx, nt), CartesianDecomposition(BOUNDS, nx, nt)
    jtopo, topo = jbuild(jdec, 8), build_topology(dec, 8)
    jcfg = jnets.SubdomainModelConfig(nets={"u": jnets.MLPConfig(2, 1, width,
                                                                 depth)})
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, width, depth)})
    jb = jmake_batch(jdec, jtopo, pj, n_res, 16,
                     np.random.default_rng(seed)).device_arrays()
    tb = make_batch(dec, topo, pt, n_res, 16,
                    np.random.default_rng(seed)).device_arrays()
    jt = jtrainer.ReferenceTrainer(pj, jcfg, jtopo,
                                   jtrainer.DDConfig(method=XPINN,
                                                     residual_path="pallas"))
    tt = ReferenceTrainer(pt, cfg, topo,
                          DDConfig(method=XPINN, residual_path="fused"),
                          device="cpu")
    return (jt, jb, jdec), (tt, tb, dec)


def _port(**kw):
    return _setup(**kw)[1]


def _crossed(jt):
    """The port's state built from the reference's init(0) params."""
    return _state(jax.tree.map(np.asarray, jt.init(0).params))


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------------------ fault schedule

SPECS = ["crash@1, nan_params@2:0, straggler@3*0.5,nan_grads@4",
         "straggler@0",
         "engine-raise@3,nan-output@5,slow-engine@7*0.2,compile-storm@9",
         "bit-flip@2,bundle.truncate@3:1,ckpt.torn_write@4,missing-file@5:2",
         "crash@-1,,"]
BAD = ["engine-explode@1", "crash", "crash@x", "bundle.meteor@2",
       "nan_params@", "ckpt.bit_flip"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_faults_matches_reference(spec):
    got, want = rt.parse_faults(spec), jrt.parse_faults(spec)
    assert [vars(f) for f in got] == [vars(f) for f in want]
    assert all(type(f) is rt.Fault for f in got)


@pytest.mark.parametrize("spec", BAD)
def test_parse_faults_errors_match_reference(spec):
    with pytest.raises(ValueError) as want:
        jrt.parse_faults(spec)
    with pytest.raises(ValueError) as got:
        rt.parse_faults(spec)
    assert str(got.value) == str(want.value)


def test_fault_kinds_fault_errors_and_injector_match_reference():
    for name in ("FAULT_KINDS", "SERVE_FAULT_KINDS", "STORAGE_FAULT_KINDS",
                 "ALL_FAULT_KINDS"):
        assert getattr(rt, name) == getattr(jrt, name)
    for kw in ({"kind": "meteor"},
               {"kind": "bit_flip", "target": "disk"}):
        with pytest.raises(ValueError) as want:
            jrt.Fault(chunk=0, **kw)
        with pytest.raises(ValueError) as got:
            rt.Fault(chunk=0, **kw)
        assert str(got.value) == str(want.value)
    faults = rt.parse_faults(SPECS[0])
    inj = rt.FaultInjector(faults)
    assert inj.take(0) == [] and not inj.exhausted
    assert inj.take(1) == [faults[0]]
    assert inj.take(1) == []                      # fires exactly once
    for c in (2, 3, 4):
        inj.take(c)
    assert inj.exhausted and inj.fired == faults
    assert [f.chunk for f in rt.compose(faults[2:], faults[:2])] == \
        [f.chunk for f in jrt.compose(jrt.parse_faults(SPECS[0])[2:],
                                      jrt.parse_faults(SPECS[0])[:2])]
    with pytest.raises(ValueError, match="NaN fault"):
        rt.inject_nan({"params": {}, "opt": {}}, "crash")


@pytest.mark.parametrize("kind,subdomain", [("nan_params", 0),
                                            ("nan_params", 2),
                                            ("nan_params", None),
                                            ("nan_params", 9),
                                            ("nan_grads", 1),
                                            ("nan_grads", None)])
def test_inject_nan_poisons_the_reference_leaf_and_index(kind, subdomain):
    """The reference picks "the first leaf" in jax's flatten order, dict
    keys sorted (``u/W/[0]``, not the insertion-first key)."""
    (jt, _, _), _ = _setup()
    js = jt.init(0)
    p0 = jax.tree.map(np.asarray, js.params)
    # insertion order reversed on the port's side: the order must not matter
    p_rev = {"u": {k: p0["u"][k] for k in ("b", "a", "W")}}
    ts = _state(p_rev)
    jtree = jrt.inject_nan({"params": js.params, "opt": js.opt,
                            "step": js.step}, kind, subdomain)
    ttree = rt.inject_nan({"params": ts.params, "opt": ts.opt,
                           "step": ts.step}, kind, subdomain)
    want = {"params": jtree["params"], "m": jtree["opt"]["m"]}
    got = {"params": ttree["params"], "m": ttree["opt"]["m"]}
    jl, tl = jax.tree.leaves(want), tree_leaves(got)
    assert len(jl) == len(tl)
    n_nan = 0
    for a, b in zip(tl, jl):
        a, b = _np(a), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        n_nan += int(np.isnan(a).sum())
    assert n_nan == 1
    # the untouched tree stays untouched (the poisoned leaf is a clone)
    assert not any(bool(torch.isnan(x).any())
                   for x in tree_leaves((ts.params, ts.opt)))


# ------------------------------------------------------------ storage chaos

@pytest.mark.parametrize("kind", ["bit_flip", "truncate", "torn_write",
                                  "missing_file"])
def test_corrupt_file_same_seed_same_bytes(tmp_path, kind):
    payload = np.random.default_rng(7).bytes(4099)
    paths = {}
    for who in ("ref", "port"):
        paths[who] = str(tmp_path / f"{who}.bin")
        with open(paths[who], "wb") as f:
            f.write(payload)
    want = jrt.corrupt_file(paths["ref"], kind, np.random.default_rng(11))
    got = rt.corrupt_file(paths["port"], kind, np.random.default_rng(11))
    strip = lambda r: {k: v for k, v in r.items() if k != "path"}
    assert strip(got) == strip(want)
    if kind == "missing_file":
        assert not os.path.exists(paths["port"])
        return
    with open(paths["ref"], "rb") as f, open(paths["port"], "rb") as g:
        assert f.read() == g.read()


def test_chaos_injector_corrupts_the_generation_a_restore_would_read(
        tmp_path):
    """A storage fault in a ``--inject`` spec corrupts the newest checkpoint
    generation; the supervisor's rollback quarantines it and falls back."""
    tt, tb, dec = _port()
    root = str(tmp_path / "ckpt")
    inj = rt.ChaosInjector(rt.parse_faults("ckpt.bit_flip@2,crash@2"),
                           roots={"ckpt": root}, seed=3)
    sup = rt.Supervisor(tt, root, rt.SupervisorConfig(chunk_steps=2), inj,
                        decomp=dec)
    s, report = sup.run(tt.init(0), tb, 6)
    assert int(s.step) == 6 and inj.exhausted
    assert len(inj.storage_fired) == 1
    assert inj.storage_fired[0]["kind"] == "bit_flip"
    # the newest generation (step 4) was corrupted: quarantined, and the
    # rollback fell back one generation to step 2
    assert report.crashes == 1 and report.corruptions == 1
    assert report.fallback_depths == [1]
    assert any("quarantined" in e for e in report.events)


# ------------------------------------------------------------ elastic remap

def test_remap_params_matches_reference():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 3, 5)).astype(np.float32)
    cases = [(JCart(BOUNDS, 2, 2), JCart(BOUNDS, 3, 2),
              CartesianDecomposition(BOUNDS, 2, 2),
              CartesianDecomposition(BOUNDS, 3, 2))]
    jus, tus = jus_map(), us_map_decomposition()
    lo = np.min([p.min(axis=0) for p in tus.polygons], axis=0)
    hi = np.max([p.max(axis=0) for p in tus.polygons], axis=0)
    box = ((lo[0], hi[0]), (lo[1], hi[1]))
    cases.append((jrt.CentroidSpec(jrt.decomp_signature(jus)["centroids"]),
                  JCart(box, 3, 2),
                  rt.CentroidSpec(rt.decomp_signature(tus)["centroids"]),
                  CartesianDecomposition(box, 3, 2)))
    assert rt.decomp_signature(tus) == jrt.decomp_signature(jus)
    for jold, jnew, told, tnew in cases:
        n_old = told.n_sub
        tree = {"w": w[:1].repeat(n_old, 0)
                + np.arange(n_old, dtype=np.float32)[:, None, None],
                "b": [np.arange(n_old * 2, dtype=np.float32).reshape(n_old,
                                                                     2)]}
        jp, jsrc = jrt.remap_params(jax.tree.map(jnp.asarray, tree), jold,
                                    jnew)
        tp, tsrc = rt.remap_params(map_tree(torch.from_numpy, tree), told,
                                   tnew)
        assert isinstance(tsrc, np.ndarray)
        np.testing.assert_array_equal(tsrc, jsrc)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        # numpy leaves come back as tensors too
        np_p, _ = rt.remap_params(tree, told, tnew)
        assert all(isinstance(x, torch.Tensor) for x in tree_leaves(np_p))


@pytest.mark.parametrize("counts,weights", [
    ([800, 3000, 3000, 3000, 3000], None),
    ([800, 3000, 3000, 3000, 3000], [0.5, 1.0, 1.0, 1.0, 2.0]),
    ([1000, 1000, 1000, 1000], [1000.0, 1000.0, 1000.0, 250.0]),
    ([10, 20, 30, 41], None),
    ([7, 7, 7], [0.0, 1.0, 3.0])])
def test_balanced_counts_matches_reference(counts, weights):
    assert rt.balanced_counts(counts, weights) == \
        jrt.balanced_counts(counts, weights)


def test_throughput_weights_and_their_errors_match_reference():
    for c, t in (([1000] * 4, [1.0, 1.0, 1.0, 4.0]), ([5, 9], [0.0, 2.0])):
        assert rt.throughput_weights(c, t) == jrt.throughput_weights(c, t)
    for fn, args in ((lambda m: m.balanced_counts, ([1, 2, 3], [1.0, 2.0])),
                     (lambda m: m.balanced_counts, ([1, 2], [-1.0, 1.0])),
                     (lambda m: m.throughput_weights, ([1, 2], [1.0]))):
        with pytest.raises(ValueError) as want:
            fn(jrt)(*args)
        with pytest.raises(ValueError) as got:
            fn(rt)(*args)
        assert str(got.value) == str(want.value)
    tt, _, dec = _port()
    sup = rt.Supervisor(tt, "unused", decomp=dec)
    assert sup.rebalance_counts([1000] * 4, [1.0, 1.0, 1.0, 4.0]) == \
        jrt.balanced_counts([1000] * 4, jrt.throughput_weights(
            [1000] * 4, [1.0, 1.0, 1.0, 4.0]))
    assert sup.rebalance_counts([10, 20, 30, 40]) == [25, 25, 25, 25]


# ------------------------------------------------------------ guarded chunk

def test_guarded_chunk_matches_unguarded_bitwise():
    tt, tb, _ = _port()
    s_u, t_u = tt.run_chunk(tt.init(0), tb, 5)
    s_g, t_g, health = tt.run_chunk_guarded(tt.init(0), tb, 5)
    _bitwise(s_u.params, s_g.params)
    _bitwise(s_u.opt, s_g.opt)
    assert int(s_g.step) == 5
    for k in t_u:
        assert torch.equal(t_u[k], t_g[k])
    assert bool(health["ok"]) and bool(health["ok_sub"].all())
    assert int(health["good_steps"]) == 5


@pytest.mark.parametrize("kind,steps", [("nan_params", 5), ("nan_grads", 3)])
def test_guard_verdicts_match_reference(kind, steps):
    """nan_params at subdomain 0 flags it and its interface neighbours,
    never the diagonal; nan_grads keeps that step's loss finite and is
    caught by the param check alone — the same verdicts as the
    reference's."""
    (jt, jb, _), (tt, tb, _) = _setup()
    ts = _crossed(jt)
    js = jt.init(0)
    jtree = jrt.inject_nan({"params": js.params, "opt": js.opt,
                            "step": js.step}, kind, 0)
    js = jtrainer.TrainState(params=jtree["params"], opt=jtree["opt"],
                             step=jtree["step"])
    ttree = rt.inject_nan({"params": ts.params, "opt": ts.opt,
                           "step": ts.step}, kind, 0)
    ts = TrainState(params=ttree["params"], opt=ttree["opt"],
                    step=ttree["step"])
    js, jterms, jh = jt.run_chunk_guarded(js, jb, steps)
    ts, terms, th = tt.run_chunk_guarded(ts, tb, steps)
    np.testing.assert_array_equal(_np(th["ok_sub"]), np.asarray(jh["ok_sub"]))
    assert bool(th["ok"]) == bool(jh["ok"]) is False
    assert int(th["good_steps"]) == int(jh["good_steps"]) == 1
    assert int(ts.step) == int(js.step) == 1
    np.testing.assert_array_equal(np.isnan(_np(terms["loss"])),
                                  np.isnan(np.asarray(jterms["loss"])))


# ---------------------------------------------------------------- supervisor

def test_supervisor_crash_recovery_bitwise(tmp_path):
    """A crash mid-chunk (computed, checkpoint lost) replays from the last
    checkpoint at full lr: the same trajectory bit for bit."""
    tt, tb, dec = _port()
    inj = rt.FaultInjector([rt.Fault(chunk=1, kind="crash")])
    sup = rt.Supervisor(tt, str(tmp_path / "ckpt"),
                        rt.SupervisorConfig(chunk_steps=3), inj, decomp=dec)
    s_f, report = sup.run(tt.init(0), tb, 9)
    assert report.crashes == 1 and report.restarts == 1
    assert report.chunks == 3 and inj.exhausted
    assert len(report.recovery_s) == 1
    s_b = tt.init(0)
    for _ in range(3):
        s_b, _ = tt.run_chunk(s_b, tb, 3)
    assert int(s_f.step) == int(s_b.step) == 9
    _bitwise(s_f.params, s_b.params)
    _bitwise(s_f.opt, s_b.opt)
    assert s_f.step.dtype == torch.int32
    assert s_f.opt["count"].dtype == torch.int32 and \
        s_f.opt["count"].dim() == 0


def test_supervised_run_with_faults_matches_reference(tmp_path):
    """crash@1 and nan_params@2:0 from the same (crossed) weights: the same
    report ints and events, the same lr backoff, and final params within
    the trajectory tolerance."""
    (jt, jb, jdec), (tt, tb, dec) = _setup()
    ts = _crossed(jt)
    spec = "crash@1,nan_params@2:0,straggler@3*0.01"
    jsup = jrt.Supervisor(jt, str(tmp_path / "j"),
                          jrt.SupervisorConfig(chunk_steps=3),
                          jrt.FaultInjector(jrt.parse_faults(spec)),
                          decomp=jdec)
    tsup = rt.Supervisor(tt, str(tmp_path / "t"),
                         rt.SupervisorConfig(chunk_steps=3),
                         rt.FaultInjector(rt.parse_faults(spec)),
                         decomp=dec)
    js, jrep = jsup.run(jt.init(0), jb, 12)
    ts, trep = tsup.run(ts, tb, 12)
    ints = lambda r: {k: v for k, v in r.as_dict().items()
                      if isinstance(v, int)}
    assert ints(trep) == ints(jrep)
    assert (trep.crashes, trep.guard_trips, trep.restarts,
            trep.stragglers) == (1, 1, 2, 1)
    assert trep.events == jrep.events
    assert trep.fallback_depths == jrep.fallback_depths
    np.testing.assert_array_equal(tsup.lr_scale, jsup.lr_scale)
    assert int(ts.step) == int(js.step) == 12
    _close_trees(ts.params, js.params, PARAMS)
    # the metadata the next restart reads
    jmeta = jrt.supervisor.ckpt.raw_leaves(str(tmp_path / "j"))[1]
    tmeta = rt.supervisor.ckpt.raw_leaves(str(tmp_path / "t"))[1]
    for k in ("restarts", "lr_scale", "adam_count", "decomp"):
        assert tmeta["metadata"]["supervisor"][k] == \
            jmeta["metadata"]["supervisor"][k]


def test_supervisor_straggler_walltimes_and_events(tmp_path):
    from repro_torch.obs import make_obs, read_events, validate_events

    tt, tb, dec = _port()
    path = str(tmp_path / "ev.jsonl")
    obs = make_obs(path, trace=True)
    sup = rt.Supervisor(tt, str(tmp_path / "ckpt"),
                        rt.SupervisorConfig(chunk_steps=2),
                        rt.FaultInjector([rt.Fault(chunk=1, kind="straggler",
                                                   delay=0.05)]),
                        decomp=dec, obs=obs)
    s, report = sup.run(tt.init(0), tb, 6)
    obs.close()
    assert report.stragglers == 1 and report.restarts == 0
    assert int(s.step) == 6 and len(report.walltimes) == 3
    assert report.walltimes[1] >= 0.05
    assert tt.tracer is obs.tracer       # the trainer's span nests under
    validate_events(path)
    kinds = [e["kind"] for e in read_events(path)]
    assert kinds.count("chunk") == 3 and kinds.count("straggler") == 1
    snap = obs.registry.snapshot("train.supervisor")
    assert snap["train.supervisor/chunks"] == 3
    assert snap["train.supervisor/stragglers"] == 1
    assert snap["train.supervisor/chunk_walltime_s"]["count"] == 3


def test_supervisor_restart_budget_and_backoff_floor_raise(tmp_path):
    tt, tb, _ = _port()
    inj = rt.FaultInjector([rt.Fault(chunk=i, kind="crash")
                            for i in range(6)])
    sup = rt.Supervisor(tt, str(tmp_path / "a"),
                        rt.SupervisorConfig(chunk_steps=2, max_restarts=2),
                        inj)
    with pytest.raises(RuntimeError, match="restart budget"):
        sup.run(tt.init(0), tb, 8)
    inj = rt.FaultInjector([rt.Fault(chunk=1, kind="nan_params", subdomain=0),
                            rt.Fault(chunk=2, kind="nan_params",
                                     subdomain=0)])
    sup = rt.Supervisor(tt, str(tmp_path / "b"),
                        rt.SupervisorConfig(chunk_steps=2, lr_backoff=0.5,
                                            min_lr_scale=0.3), inj)
    with pytest.raises(RuntimeError, match="floor"):
        sup.run(tt.init(0), tb, 8)


def test_run_with_failures_equals_uninterrupted(tmp_path):
    tt, tb, _ = _port()
    step = lambda s: tt.step(s, tb)[0]
    got = rt.run_with_failures(root=str(tmp_path / "ck"),
                               init_fn=lambda: vars(tt.init(0)),
                               step_fn=lambda d: vars(step(TrainState(**d))),
                               total_steps=6, ckpt_every=2, fail_at=(3, 5))
    want = tt.init(0)
    for _ in range(6):
        want = step(want)
    assert isinstance(got["step"], torch.Tensor) and int(got["step"]) == 6
    _bitwise(got["params"], want.params)
    _bitwise(got["opt"], want.opt)


# ------------------------------------------------------------ elastic resume

def test_reference_checkpoint_resumes_in_the_port_bitwise(tmp_path):
    """Interchange: the reference's supervisor writes at 2x2; the port's
    elastic_resume gives the reference's elastic_resume's params, count and
    step bit for bit, remapped into 3x2 and restored at 2x2."""
    (jt, jb, jdec), (tt, _, dec) = _setup()
    root = str(tmp_path / "ckpt")
    jsup = jrt.Supervisor(jt, root, jrt.SupervisorConfig(chunk_steps=4),
                          decomp=jdec)
    jsup.run(jt.init(0), jb, 8)
    for nx in (3, 2):
        (jt2, _, jdec2), (tt2, _, dec2) = _setup(nx=nx)
        want, jmeta = jrt.elastic_resume(root, jt2, jdec2)
        got, meta = rt.elastic_resume(root, tt2, dec2)
        assert meta == jmeta
        jl = jax.tree.leaves((want.params, want.opt))
        tl = tree_leaves((got.params, got.opt))
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            assert a.device.type == "cpu"
            assert _np(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        assert got.params["u"]["W"][0].shape[0] == dec2.n_sub
        assert got.opt["count"].dtype == torch.int32 and \
            got.opt["count"].dim() == 0 and int(got.opt["count"]) == 8
        assert got.step.dtype == torch.int32 and int(got.step) == 8


def test_port_checkpoint_remaps_and_preserves_adam_count(tmp_path):
    tt, tb, dec = _port()
    root = str(tmp_path / "ckpt")
    sup = rt.Supervisor(tt, root, rt.SupervisorConfig(chunk_steps=4),
                        decomp=dec)
    state, _ = sup.run(tt.init(0), tb, 8)
    same, _ = rt.elastic_resume(root, tt, dec)
    _bitwise(same.params, state.params)
    _bitwise(same.opt, state.opt)
    tt2, _, dec2 = _port(nx=3)
    resumed, meta = rt.elastic_resume(root, tt2, dec2)
    src = np.argmin(((np.stack([dec2.centroid(q) for q in range(6)])[:, None]
                      - np.stack([dec.centroid(q) for q in range(4)])[None])
                     ** 2).sum(-1), axis=1)
    for old, new in zip(tree_leaves(state.params),
                        tree_leaves(resumed.params)):
        assert torch.equal(old[torch.as_tensor(src)], new)
    for mom in ("m", "v"):
        assert all(float(x.abs().max()) == 0.0
                   for x in tree_leaves(resumed.opt[mom]))
    assert int(resumed.opt["count"]) == 8 and int(resumed.step) == 8
    assert meta["supervisor"]["adam_count"] == 8


def test_elastic_resume_4_to_6_reconverges(tmp_path):
    """A checkpoint taken at 4 subdomains restarts at 6 as a warm start
    (better than a cold init) and re-converges (the reference's
    ``tests/test_elastic.py`` acceptance, on the port)."""
    kw = dict(n_res=64, width=20, depth=3)
    (_, _, _), (tt, tb, dec) = _setup(**kw)
    pde, cfg = tt.pde, tt.model_cfg
    root = str(tmp_path / "ckpt")
    sup = rt.Supervisor(tt, root, rt.SupervisorConfig(chunk_steps=100),
                        decomp=dec)
    state, _ = sup.run(tt.init(0), tb, 400)
    err_old = evaluate_l2(dec, cfg, state.params, tt.act_codes, pde,
                          n_pts=400, device="cpu")
    tt2, tb2, dec2 = _port(nx=3, **kw)
    resumed, _ = rt.elastic_resume(root, tt2, dec2)
    l2 = lambda p: evaluate_l2(dec2, cfg, p, tt2.act_codes, pde, n_pts=400,
                               device="cpu")
    err_cold, err_warm = l2(tt2.init(0).params), l2(resumed.params)
    assert err_warm < err_cold, (err_warm, err_cold)
    resumed, terms = tt2.run_chunk(resumed, tb2, 400)
    err_new = l2(resumed.params)
    assert bool(torch.isfinite(terms["loss"]).all())
    assert err_new < err_warm, (err_new, err_warm)
    assert err_new < max(1.5 * err_old, 0.5), (err_new, err_old)


# -------------------------------------------------------- serve fault matrix

def _tiny_bundles(seed=0):
    jdec = JCart(BOUNDS, 2, 2)
    jcfg = jnets.SubdomainModelConfig(nets={"u": jnets.MLPConfig(2, 1, 16,
                                                                 3)})
    params, codes = jnets.stacked_init(jcfg, jdec.n_sub,
                                       jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    jb = JFieldBundle(model_cfg=jcfg, params=params, decomp=jdec,
                      act_codes=np.asarray(codes), pde=jpdes.Burgers1D())
    tb = FieldBundle(model_cfg=SubdomainModelConfig(
        nets={"u": MLPConfig(2, 1, 16, 3)}), params=params,
        decomp=CartesianDecomposition(BOUNDS, 2, 2),
        act_codes=np.asarray(codes), pde=pdes.Burgers1D())
    return jb, tb


def _run_matrix(n_req, spec, mods, bundle, seed=0):
    """tests/test_resilience.py::_run_matrix on either package: a virtual
    clock, Poisson-free arrivals, flushes every third request."""
    (engine_cls, faulty, injector, parse, rf_cls, cfg_cls) = mods
    now = [0.0]
    vsleep = lambda s: now.__setitem__(0, now[0] + s)
    engine = faulty(engine_cls(bundle), injector(parse(spec)), sleep=vsleep)
    fe = rf_cls(engine, cfg_cls(order=2, default_deadline=5.0,
                                max_queue_age=0.2, retry_backoff=0.01),
                clock=lambda: now[0], sleep=vsleep, seed=seed)
    rng = np.random.default_rng(seed)
    tickets = []
    for i in range(n_req):
        tickets.append(fe.submit(
            rng.uniform([-1, 0], [1, 1], size=(int(rng.choice((8, 24))), 2))))
        now[0] += 0.05
        fe.poll()
        if i % 3 == 2:
            fe.flush()
    fe.drain()
    results = [fe.result(t) for t in tickets]
    assert fe.stats()["answered"] == n_req
    assert fe.health()["unanswered"] == 0
    ok = [r for r in results if r.ok]
    assert ok, "fault matrix starved every request"
    for r in ok:
        assert np.isfinite(r.data["u"]).any()
    return fe, results


@pytest.mark.parametrize("spec", [
    "engine-raise@1,nan-output@3,slow-engine@5*0.01",
    "nan-output@0,engine-raise@2,compile-storm@4,engine-raise@6"])
def test_serve_fault_matrix_matches_reference(spec):
    """Every ticket answered under the fault matrix, with the same statuses,
    orders and counters as the reference's frontend over its engine."""
    jb, tb = _tiny_bundles()
    jfe, jres = _run_matrix(9, spec, (JFieldEngine, jrt.FaultyEngine,
                                      jrt.FaultInjector, jrt.parse_faults,
                                      JResilientFrontend, JResilienceConfig),
                            jb)
    tfe, tres = _run_matrix(9, spec, (lambda b: FieldEngine(b, device="cpu"),
                                      rt.FaultyEngine, rt.FaultInjector,
                                      rt.parse_faults, ResilientFrontend,
                                      ResilienceConfig), tb)
    assert [(r.status, r.order, r.degraded) for r in tres] == \
        [(r.status, r.order, r.degraded) for r in jres]
    s, js = tfe.stats(), jfe.stats()
    for k in ("answered", "guard_trips", "flush_failures", "retries",
              "served", "failed"):
        assert s[k] == js[k], (k, s[k], js[k])
    assert s["frontend"]["quarantined"] == js["frontend"]["quarantined"]
    assert (s["guard_trips"] + s["flush_failures"]
            + s["frontend"]["quarantined"]) >= 1
    assert tfe.engine.injector.exhausted
    for r, j in zip(tres, jres):
        if r.ok:
            np.testing.assert_allclose(r.data["u"], j.data["u"], rtol=1e-5,
                                       atol=1e-5)


def test_compile_storm_drops_nothing_and_builds_nothing(monkeypatch):
    """The port's engine keeps no per-shape state, so a storm leaves it as
    it was: the same weights, the same answers, no kernel library loaded or
    built."""
    def no_build(*a, **k):
        raise AssertionError("a compile storm must not build a kernel")

    monkeypatch.setattr(native, "build", no_build)
    _, tb = _tiny_bundles()
    base = FieldEngine(tb, device="cpu")
    slept = []
    eng = rt.FaultyEngine(FieldEngine(tb, device="cpu"),
                          rt.FaultInjector([rt.Fault(chunk=0,
                                                     kind="slow_engine",
                                                     delay=0.25),
                                            rt.Fault(chunk=1,
                                                     kind="compile_storm")]),
                          sleep=slept.append)
    params = eng.engine._params
    libs = (pinn_mlp._library.cache_info(),
            pinn_mlp._library_bwd.cache_info())
    pts = np.random.default_rng(0).uniform([-1, 0], [1, 1], size=(50, 2))
    eng.evaluate(pts)
    assert slept == [0.25]
    got = eng.evaluate(pts)                      # the storm's dispatch
    want = base.evaluate(pts)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert eng.engine._params is params
    assert (pinn_mlp._library.cache_info(),
            pinn_mlp._library_bwd.cache_info()) == libs
    assert eng.injector.exhausted and eng.calls == 2
    assert [f.kind for f in eng.injector.fired] == ["slow_engine",
                                                    "compile_storm"]
    assert eng.n_dispatches == 2                 # attributes delegate


# ------------------------------------------------------------- entry points

def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_quickstart_supervised_and_elastic_resume_on_cpu(tmp_path, capsys):
    ck, ck6 = str(tmp_path / "ck"), str(tmp_path / "ck6")
    rc = quickstart.main(["--device", "cpu", "--steps", "500", "--chunk",
                          "100", "--supervised", "--ckpt", ck, "--inject",
                          "crash@1,nan_params@2:0,straggler@3*0.01"])
    out = capsys.readouterr().out
    rep = _last_json(out)["quickstart"]
    assert rc == 0 and rep["rel_l2"] < quickstart.BAR
    sup = rep["supervisor"]
    assert (sup["crashes"], sup["guard_trips"], sup["restarts"],
            sup["stragglers"], sup["chunks"]) == (1, 1, 2, 1, 5)
    assert len(sup["recovery_s"]) == 2 and len(sup["events"]) == 4
    assert len(sup["walltimes"]) == 5
    assert rep["steps"] == 500 and rep["resumed"] is None
    rc = quickstart.main(["--device", "cpu", "--steps", "600", "--chunk",
                          "100", "--nx", "3", "--supervised", "--resume", ck,
                          "--ckpt", ck6])
    out = capsys.readouterr().out
    assert "(checkpoint n_sub=4 -> 6)" in out
    rep = _last_json(out)["quickstart"]
    assert rc == 0 and rep["rel_l2"] < quickstart.BAR
    assert rep["resumed"] == {"from": ck, "step": 500, "n_sub_from": 4,
                              "n_sub": 6}
    assert rep["steps"] == 600 and rep["supervisor"]["chunks"] == 1


def test_quickstart_inject_requires_supervised(capsys):
    with pytest.raises(SystemExit):
        quickstart.main(["--device", "cpu", "--inject", "crash@1"])
    assert "--inject requires --supervised" in capsys.readouterr().err


def test_serve_field_with_faults_on_cpu(capsys):
    rc = serve_field.main(["--demo", "cart", "--device", "cpu",
                           "--max-requests", "40", "--heartbeat", "5",
                           "--faults",
                           "engine-raise@3,nan-output@5,slow-engine@7*0.05"])
    assert rc == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["requests"] == 40
    assert report["drained"]["unanswered"] == 0
    assert sum(report["by_status"].values()) == 40
    st = report["stats"]
    assert st["guard_trips"] + st["flush_failures"] + st["retries"] >= 1
