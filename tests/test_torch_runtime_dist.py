"""The fault-tolerant runtime over the port's multi-worker trainers, on the
CPU: ``Supervisor`` and ``elastic_resume`` driving ``DistributedDDTrainer``
(one ``gloo`` rank per subdomain) and ``DataParallelTrainer``.

The distributed cases port the reference's ``DIST_FT_CODE``
(``tests/test_supervisor.py``): a guarded chunk equals an unguarded one,
one NaN subdomain freezes EVERY rank (one MIN all-reduce a step; the
poisoned subdomain and its interface neighbours flagged, the diagonal not),
and a crash replay equals the uninterrupted run — exactly (difference
0.0), where the reference allows 1e-7.  A supervised run under a crash and
a NaN fault equals ``ReferenceTrainer``'s under the same schedule (params
within 1e-5, the same report).  Checkpoints are the global state in the
reference's layout: a distributed run's resumes in ``ReferenceTrainer``
(bitwise) and elastically at 6 subdomains, and a single-process checkpoint
at 2 subdomains resumes elastically in the 4-rank trainer (the per-subdomain
Adam count branch).  The data-parallel trainer on one worker ports
``tests/test_supervisor.py``'s guarded-equals-unguarded and crash-recovery
cases (bitwise against itself) and holds both against the reference
(1e-5).

Sizes are the reference's: 2 x 2 Burgers XPINN, n_iface 8, 48 residual and
16 boundary points per subdomain, 16 x 2 nets, lrs 1e-3 ... 4e-3, fused
path.  Each rank group has its own ``FileStore`` and a collective timeout.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (XPINN, Burgers1D, CartesianDecomposition,
                              DataParallelTrainer, DDConfig,
                              DistributedDDTrainer, ReferenceTrainer,
                              TrainState, build_topology)
from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig,
                                   params_from_numpy, tree_leaves)
from repro_torch.data import make_batch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import init_adam
from repro_torch.runtime import (Fault, FaultInjector, Supervisor,
                                 SupervisorConfig, elastic_resume,
                                 inject_nan, parse_faults, remap_params)

BOUNDS = ((-1, 1), (0, 1))
LRS = [1e-3, 2e-3, 3e-3, 4e-3]
PARAMS = dict(rtol=0, atol=1e-5)
FAULTS = "crash@1,nan_params@2:0"
GROUP_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(nx=2, lrs=LRS):
    pde = Burgers1D()
    dec = CartesianDecomposition(BOUNDS, nx, 2)
    topo = build_topology(dec, n_iface=8)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 16, 2)})
    b = make_batch(dec, topo, pde, n_res=48, n_bnd=16,
                   rng=np.random.default_rng(0)).device_arrays()
    return pde, dec, topo, cfg, b, lrs


def _trainer(cls, nx=2, lrs=LRS):
    pde, dec, topo, cfg, b, lrs = _setup(nx, lrs)
    tr = cls(pde, cfg, topo, DDConfig(method=XPINN, residual_path="fused"),
             lrs=lrs, device="cpu")
    return tr, b, dec


def _diff(a, b) -> float:
    return max(float((x - y).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _np_leaves(tree) -> list:
    return [t.detach().numpy() for t in tree_leaves(tree)]


# ------------------------------------------------------- the 4-rank group

def _ft_rank(mesh, root, ref2_root) -> dict:
    tr, b, dec = _trainer(DistributedDDTrainer)
    bd = tr.shard_batch(b)
    out = {}

    s_u, t_u = tr.run_chunk(tr.init(0), bd, 4)
    s_g, t_g, health = tr.run_chunk_guarded(tr.init(0), bd, 4)
    out["guarded"] = (_diff((s_u.params, s_u.opt), (s_g.params, s_g.opt)),
                      _diff(t_u, {k: t_g[k] for k in t_u}),
                      bool(health["ok"]), int(health["good_steps"]),
                      tuple(health["ok_sub"].shape), int(s_g.step))

    # one NaN subdomain: the rank that holds it is poisoned, every rank
    # freezes at the same step
    st = tr.init(0)
    if tr.fault_target(0):
        tree = inject_nan({"params": st.params, "opt": st.opt,
                           "step": st.step}, "nan_params", 0)
        st = TrainState(params=tree["params"], opt=tree["opt"],
                        step=tree["step"])
    s, terms, health = tr.run_chunk_guarded(st, bd, 4)
    out["consensus"] = (bool(health["ok"]), health["ok_sub"].tolist(),
                        int(health["good_steps"]), int(s.step),
                        terms["loss"].numpy())

    # crash replay: the supervised run with a crash after chunk 1 against
    # the uninterrupted one
    sup = Supervisor(tr, f"{root}/plain", SupervisorConfig(chunk_steps=2),
                     decomp=dec)
    s_a, rep_a = sup.run(tr.init(0), bd, 6)
    sup = Supervisor(tr, f"{root}/crash", SupervisorConfig(chunk_steps=2),
                     FaultInjector([Fault(chunk=1, kind="crash")]),
                     decomp=dec)
    s_b, rep_b = sup.run(tr.init(0), bd, 6)
    out["replay"] = (_diff((s_a.params, s_a.opt), (s_b.params, s_b.opt)),
                     rep_b.crashes, rep_b.chunks, int(s_b.step))
    out["plain_final"] = _np_leaves(tr.gather_state(s_a).params)

    # crash and NaN faults together, for the single-process comparison
    sup = Supervisor(tr, f"{root}/faults", SupervisorConfig(chunk_steps=2),
                     FaultInjector(parse_faults(FAULTS)), decomp=dec)
    s_f, rep_f = sup.run(tr.init(0), bd, 8)
    out["faults"] = (_np_leaves(tr.gather_state(s_f).params),
                     {k: v for k, v in rep_f.as_dict().items()
                      if isinstance(v, int)}, rep_f.events)

    # a 2-subdomain single-process checkpoint, elastically at 4 ranks
    s_e, meta = elastic_resume(ref2_root, tr, dec)
    g = tr.gather_state(s_e)
    out["elastic_in"] = (_np_leaves(g.params), s_e.opt["count"].tolist(),
                         g.opt["count"].tolist(), int(s_e.step),
                         meta["supervisor"]["decomp"]["n_sub"])
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft")
    # the checkpoint the ranks resume elastically: 2 x 2 -> written at
    # 1 x 2 subdomains by the single-process trainer
    tr2, b2, dec2 = _trainer(ReferenceTrainer, nx=1, lrs=LRS[:2])
    Supervisor(tr2, str(root / "ref2"), SupervisorConfig(chunk_steps=3),
               decomp=dec2).run(tr2.init(0), b2, 3)
    mesh = mesh_lib.make_pinn_mesh(4, str(root / "store"), "cpu",
                                   timeout_s=GROUP_TIMEOUT_S)
    ranks = mesh_lib.run_ranks(mesh, _ft_rank, str(root), str(root / "ref2"),
                               deadline_s=2 * GROUP_TIMEOUT_S)
    return ranks, root


def test_guarded_chunk_equals_unguarded_on_every_rank(group):
    ranks, _ = group
    for r in ranks:
        par, terms, ok, good, shape, step = r["guarded"]
        assert par == 0.0 and terms == 0.0
        assert ok and good == 4 and shape == (4,) and step == 4


def test_one_nan_subdomain_freezes_every_rank(group):
    """The consensus guard: subdomain 0 and its interface neighbours go
    non-finite in the first step, the diagonal stays healthy, and every
    rank (also the healthy diagonal) freezes after that step."""
    ranks, _ = group
    for r in ranks:
        ok, ok_sub, good, step, loss = r["consensus"]
        assert not ok and good == 1 and step == 1
        assert ok_sub[0] is False and ok_sub[3] is True
        assert ok_sub == ranks[0]["consensus"][1]
        assert np.isnan(loss[0, 0]) and np.isfinite(loss[0, 3])
        assert np.isnan(loss[1:]).all()


def test_crash_replay_equals_the_uninterrupted_run_exactly(group):
    ranks, _ = group
    for r in ranks:
        diff, crashes, chunks, step = r["replay"]
        assert diff == 0.0, diff
        assert crashes == 1 and chunks == 3 and step == 6


def test_supervised_faults_match_reference_trainer(group, tmp_path):
    """Crash after chunk 1 and NaN in subdomain 0 at chunk 2: the same
    report and events as the single-process supervisor, params within
    1e-5."""
    ranks, _ = group
    tr, b, dec = _trainer(ReferenceTrainer)
    sup = Supervisor(tr, str(tmp_path / "ref"), SupervisorConfig(chunk_steps=2),
                     FaultInjector(parse_faults(FAULTS)), decomp=dec)
    s, rep = sup.run(tr.init(0), b, 8)
    params, ints, events = ranks[0]["faults"]
    assert ints == {k: v for k, v in rep.as_dict().items()
                    if isinstance(v, int)}
    assert ints["crashes"] == 1 and ints["guard_trips"] == 1
    assert events == rep.events
    for got, want in zip(params, tree_leaves(s.params)):
        np.testing.assert_allclose(got, want.numpy(), **PARAMS)
    for r in ranks[1:]:
        assert r["faults"][1] == ints


def test_distributed_checkpoint_resumes_in_reference_trainer(group):
    """Rank 0 wrote the gathered global state in the reference's layout: it
    restores bitwise in the single-process trainer, the per-subdomain Adam
    count becoming its scalar."""
    ranks, root = group
    tr, _, dec = _trainer(ReferenceTrainer)
    s, meta = elastic_resume(str(root / "plain"), tr, dec)
    for got, want in zip(tree_leaves(s.params), ranks[0]["plain_final"]):
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(s.step) == 6 and s.opt["count"].dim() == 0
    assert int(s.opt["count"]) == 6
    assert meta["supervisor"]["adam_count"] == [6, 6, 6, 6]


def test_distributed_checkpoint_resumes_elastically_at_six(group):
    """4 -> 6 subdomains: nearest-centroid adoption of the distributed
    checkpoint's params, fresh moments, the Adam count kept."""
    ranks, root = group
    tr6, _, dec6 = _trainer(ReferenceTrainer, nx=3,
                            lrs=[1e-3] * 6)
    s, meta = elastic_resume(str(root / "plain"), tr6, dec6)
    _, dec4, *_ = _setup()
    want, _ = remap_params(params_from_numpy(
        _tree_like(tr6, ranks[0]["plain_final"])), dec4, dec6)
    for got, w in zip(tree_leaves(s.params), tree_leaves(want)):
        np.testing.assert_array_equal(got.numpy(), w.numpy())
    assert int(s.opt["count"]) == 6 and int(s.step) == 6
    assert all(float(m.abs().max()) == 0.0 for m in tree_leaves(s.opt["m"]))


def _tree_like(tr, leaves):
    from repro_torch.core.nets import tree_unflatten
    return tree_unflatten(tr.init(0).params, [np.asarray(x) for x in leaves])


def test_single_process_checkpoint_resumes_elastically_on_four_ranks(group):
    """A 2-subdomain checkpoint into the 4-rank trainer: the same global
    params as the single-process elastic resume, and the per-subdomain
    Adam count (each rank's (1,)) taken from the adopted subdomain."""
    ranks, root = group
    tr4, _, dec4 = _trainer(ReferenceTrainer)
    s, _ = elastic_resume(str(root / "ref2"), tr4, dec4)
    params, counts = ranks[0]["elastic_in"][:2]
    for got, want in zip(params, tree_leaves(s.params)):
        np.testing.assert_array_equal(got, want.numpy())
    for r in ranks:
        _, local, full, step, n_from = r["elastic_in"]
        assert local == [3] and full == [3, 3, 3, 3]
        assert step == 3 and n_from == 2


# ------------------------------------------------ data parallel, one worker

def _dp(residual_path="fused"):
    pde, dec, topo, cfg, b, _ = _setup()
    tr = DataParallelTrainer(pde, cfg, n_workers=1,
                             residual_path=residual_path, device="cpu")
    bd = type(b)(**{k: v[:1] for k, v in vars(b).items()})
    return tr, bd


def _jax_dp():
    import jax
    from repro.core import Burgers1D as JB
    from repro.core import CartesianDecomposition as JC
    from repro.core import build_topology as jbuild
    from repro.core import nets as jnets
    from repro.core.trainer import DataParallelTrainer as JDP
    from repro.data import make_batch as jmake

    jdec = JC(BOUNDS, 2, 2)
    jcfg = jnets.SubdomainModelConfig(nets={"u": jnets.MLPConfig(2, 1, 16,
                                                                 2)})
    jb = jmake(jdec, jbuild(jdec, 8), JB(), n_res=48, n_bnd=16,
               rng=np.random.default_rng(0)).device_arrays()
    jt = JDP(JB(), jcfg, n_workers=1, residual_path="pallas")
    return jt, jax.tree.map(lambda x: x[:1], jb)


def _port_from(tr, js):
    import jax
    p = params_from_numpy(jax.tree.map(np.asarray, js["params"]))
    return dict(tr.init(0), params=p, opt=init_adam(p))


def _close(got, want):
    import jax
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **PARAMS)


def test_data_parallel_guarded_equals_unguarded_and_reference():
    """``tests/test_supervisor.py``'s guarded-equals-unguarded case for the
    data-parallel trainer: bitwise against itself, 1e-5 against the
    reference's guarded chunk."""
    tr, bd = _dp()
    jt, jbd = _jax_dp()
    js0 = jt.init(0)
    s_u, _ = tr.run_chunk(_port_from(tr, js0), bd, 4)
    s_g, _, health = tr.run_chunk_guarded(_port_from(tr, js0), bd, 4)
    assert _diff((s_u["params"], s_u["opt"]),
                 (s_g["params"], s_g["opt"])) == 0.0
    assert bool(health["ok"]) and int(health["good_steps"]) == 4
    assert int(s_g["step"]) == 4
    js, _, jh = jt.run_chunk_guarded(js0, jbd, 4)
    _close(s_g["params"], js["params"])
    _close(s_g["opt"], js["opt"])


def test_data_parallel_supervised_crash_recovery_bitwise(tmp_path):
    """``tests/test_supervisor.py``'s data-parallel crash recovery: a crash
    after chunk 1 replays to the uninterrupted run bitwise; both within
    1e-5 of the reference's supervised run."""
    from repro.runtime import Fault as JFault
    from repro.runtime import FaultInjector as JFI
    from repro.runtime import Supervisor as JSup
    from repro.runtime import SupervisorConfig as JCfg

    tr, bd = _dp()
    jt, jbd = _jax_dp()
    js0 = jt.init(0)
    s_a, _ = Supervisor(tr, str(tmp_path / "a"),
                        SupervisorConfig(chunk_steps=3)).run(
        _port_from(tr, js0), bd, 9)
    s_b, report = Supervisor(tr, str(tmp_path / "b"),
                             SupervisorConfig(chunk_steps=3),
                             FaultInjector([Fault(chunk=1, kind="crash")])
                             ).run(_port_from(tr, js0), bd, 9)
    assert report.crashes == 1
    assert _diff((s_a["params"], s_a["opt"]),
                 (s_b["params"], s_b["opt"])) == 0.0
    assert int(s_b["step"]) == 9
    js, jrep = JSup(jt, str(tmp_path / "j"), JCfg(chunk_steps=3),
                    JFI([JFault(chunk=1, kind="crash")])).run(js0, jbd, 9)
    assert jrep.crashes == report.crashes
    _close(s_b["params"], js["params"])
