"""The port's profiling hooks (``repro_torch.obs.profiling``) against the
JAX package's (``repro.obs.profiling``), on the CPU: the scope vocabulary,
the comp/comm splitter on fake clocks, the analytic halo traffic against
the bytes four ``gloo`` ranks actually send, the scopes a step records,
and the build/load watcher."""
import numpy as np
import pytest
import torch

from repro_torch.core import (Burgers1D, CartesianDecomposition, DDConfig,
                              DistributedDDTrainer, ReferenceTrainer, XPINN,
                              build_topology)
from repro_torch.core.nets import MLPConfig, SubdomainModelConfig
from repro_torch.data import make_batch
from repro_torch.kernels import native, ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import (MetricsRegistry, SCOPES, CompileWatcher,
                             comp_comm_split, compile_counts, halo_traffic,
                             profiling, scope)

BOUNDS = ((-1, 1), (0, 1))


def _quickstart(n_res=48):
    """The quickstart's problem (2 x 2 Burgers XPINN, 20 interface points
    per edge) at a small width and point count."""
    pde = Burgers1D()
    dec = CartesianDecomposition(BOUNDS, 2, 2)
    topo = build_topology(dec, n_iface=20)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 8, 2)})
    batch = make_batch(dec, topo, pde, n_res=n_res, n_bnd=16,
                       rng=np.random.default_rng(0))
    return pde, topo, cfg, batch


def test_scope_vocabulary_is_the_reference_s_and_rejects_unknown_phases():
    from repro.obs import profiling as jprof

    assert SCOPES == jprof.SCOPES
    with pytest.raises(ValueError, match="unknown profiling phase"):
        scope("halo")
    with pytest.raises(ValueError, match="unknown profiling phase"):
        jprof.scope("halo")
    with scope("comm"):
        pass


class _FakeClock:
    """A clock that only moves when a fake chunk runs."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def runner(self, durations):
        it = iter(durations)

        def run():
            self.t += next(it)
        return run


@pytest.mark.parametrize("iters,warmup,steps", [(5, 1, 1), (4, 2, 100)])
def test_comp_comm_split_matches_reference_on_fake_clocks(iters, warmup,
                                                          steps):
    """The same interleaved protocol and keys: on clocks that advance by
    the same durations, the same numbers (one noisy round where the
    ablated chunk ran longer included)."""
    from repro.obs import profiling as jprof

    rng = np.random.default_rng(iters)
    n = iters + warmup
    tot = list(3.0 + rng.uniform(0, 0.5, n))
    comp = list(2.0 + rng.uniform(0, 0.5, n))
    comp[-1] = tot[-1] + 0.25
    out = {}
    for name, fn in (("port", comp_comm_split),
                     ("ref", jprof.comp_comm_split)):
        clock = _FakeClock()
        out[name] = fn(clock.runner(tot), clock.runner(comp), iters=iters,
                       warmup=warmup, steps=steps, clock=clock)
    assert out["port"] == out["ref"]
    assert set(out["port"]) == {"total_s", "comp_s", "comm_s", "comm_frac",
                                "rounds"}
    assert 0.0 < out["port"]["comm_frac"] < 1.0


def _traffic_rank(mesh):
    """One outer step of ``DistributedDDTrainer`` with every isend's bytes
    counted, then the scopes of a second step."""
    import torch.distributed as dist
    from repro_torch.core import halo

    pde, topo, cfg, batch = _quickstart()
    tr = DistributedDDTrainer(pde, cfg, topo,
                              DDConfig(method=XPINN, residual_path="fused"),
                              lrs=2e-3, device="cpu")
    b = tr.shard_batch(batch.device_arrays("cpu"))
    st = tr.init(0)
    sent, orig = [], halo.dist.batch_isend_irecv

    def counting(p2p_ops):
        sent.extend(op.tensor.numel() * op.tensor.element_size()
                    for op in p2p_ops if op.op is dist.isend)
        return orig(p2p_ops)

    halo.dist.batch_isend_irecv = counting
    try:
        st, _ = tr.step(st, b)
    finally:
        halo.dist.batch_isend_irecv = orig
    scopes = profiling.scope_counts(lambda: tr.step(st, b))
    return {"bytes": sum(sent), "sends": len(sent), "scopes": scopes}


def test_halo_traffic_equals_the_bytes_four_ranks_send(tmp_path):
    """The analytic per-device traffic of the 2 x 2 quickstart topology
    against one ``exchange_p2p`` step of 4 ``gloo`` ranks on the CPU: each
    rank sends 2 slots x 20 points x (u, F) float32 = 320 bytes (the card
    stages them down and up: 640 bytes a rank and step)."""
    pde, topo, _, _ = _quickstart()
    mesh = mesh_lib.make_pinn_mesh(4, str(tmp_path), "cpu", timeout_s=120)
    ranks = mesh_lib.run_ranks(mesh, _traffic_rank, deadline_s=240)
    got = halo_traffic(topo, pde.n_fields + pde.n_eq)
    assert got["per_device_bytes"] == [r["bytes"] for r in ranks]
    assert got["collective_permute_bytes"] == 320.0
    assert got["collective_permute_ops"] == max(r["sends"] for r in ranks)
    assert got["total_collective_bytes"] == got["collective_permute_bytes"]
    for r in ranks:
        # one exchange per step, inside the forward and the update scopes
        assert r["scopes"]["dd-comm-halo"] >= 1
        assert r["scopes"]["dd-comp-forward"] == 1
        assert r["scopes"]["dd-comp-update"] == 1


def test_halo_traffic_records_a_single_process_step_s_scopes():
    """``scope_op_counts``: the ``dd-*`` scopes one ``ReferenceTrainer``
    step records (one gather exchange per payload field, u and F); no
    step, no counts."""
    pde, topo, cfg, batch = _quickstart()
    tr = ReferenceTrainer(pde, cfg, topo,
                          DDConfig(method=XPINN, residual_path="fused"),
                          lrs=2e-3, device="cpu")
    b = batch.device_arrays("cpu")
    st = tr.init(0)
    got = halo_traffic(topo, 2, step=lambda: tr.step(st, b))
    assert got["scope_op_counts"] == {"dd-comm-halo": 2,
                                      "dd-comp-forward": 1,
                                      "dd-comp-update": 1}
    assert halo_traffic(topo, 2)["scope_op_counts"] == {}


def test_select_backward_records_its_scope():
    """The select path's hand-derived backward runs under
    ``pinn2-bwd-fused-select``, the fused backward under
    ``pinn2-bwd-fused``."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 9, 2, generator=gen)
    Ws = [torch.randn(2, 2, 6, generator=gen).requires_grad_(),
          torch.randn(2, 6, 1, generator=gen).requires_grad_()]
    bs = [torch.zeros(2, 6, requires_grad=True),
          torch.zeros(2, 1, requires_grad=True)]
    a = torch.ones(2, 1, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sum(o.sum() for o in ops.pinn_mlp_forward2_select(
            x, Ws, bs, a, torch.tensor([0, 1]))).backward()
        sum(o.sum() for o in ops.pinn_mlp_forward2(x, Ws, bs, a)).backward()
    names = {ev.name for ev in prof.events()}
    assert {SCOPES["bwd_fused_select"], SCOPES["bwd_fused"]} <= names


def test_compile_watcher_counts_nothing_over_cached_calls():
    """A loop of kernel-wrapper calls builds and loads nothing."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 16, 2, generator=gen)
    Ws = [torch.randn(4, 2, 8, generator=gen),
          torch.randn(4, 8, 1, generator=gen)]
    bs = [torch.zeros(4, 8), torch.zeros(4, 1)]
    a = torch.ones(4, 1)
    before = compile_counts()
    with CompileWatcher() as w:
        for _ in range(5):
            ops.pinn_mlp_forward2(x, Ws, bs, a, d2_dirs=(0,))
            ops.pinn_mlp_forward(x, Ws, bs, a)
    assert (w.backend_compiles, w.traces, w.compile_seconds) == (0, 0, 0.0)
    assert compile_counts() == before


def test_compile_watcher_counts_builds_and_loads():
    """What ``kernels.native`` reports (one ``nvcc`` run of 1.5 s, one library
    loaded) lands in the watcher, its registry counters and its event."""
    class _Events:
        def __init__(self):
            self.rows = []

        def emit(self, kind, **fields):
            self.rows.append((kind, fields))

    reg, ev = MetricsRegistry(), _Events()
    with CompileWatcher(registry=reg, events=ev) as w:
        native._notify("build", 1.5)
        native._notify("load")
    assert (w.backend_compiles, w.traces) == (1, 1)
    assert w.compile_seconds == pytest.approx(1.5)
    g = reg.group("obs.compile", ("backend_compiles", "traces"))
    assert (g["backend_compiles"], g["traces"]) == (1, 1)
    assert ev.rows == [("compile", {"backend_compiles": 1, "traces": 1,
                                    "compile_seconds": 1.5})]
