"""The port's collective accounting (``repro_torch.utils.collectives``)
against the JAX package's (``repro.utils.hlo``), on the CPU.

For each of the five kinds, one collective over the model axis of a (2, 4)
``("data", "model")`` grid at a known per-device shape (16 x 8 float32):
the port issues it as rank 1 of a fake 8-rank process group (the
``fake`` backend of ``torch.testing``: every op reaches the dispatcher and
moves nothing) under :class:`CollectiveRecorder`; the reference compiles
the ``shard_map`` program with the same collective (``psum``,
``all_gather``, ``psum_scatter``, ``all_to_all``, ``ppermute``) on 8 fake
CPU devices and parses the HLO.  ``collective_bytes`` must agree kind by
kind, in counts and in bytes.  The expert-parallel forward's model-group
all-reduce is held to the reference's ``psum`` the same way, read with
both packages' ``top_collectives``.

The functional collectives that DTensor issues when it redistributes
(the partitioned dry run's) are held to the same programs: on a
``DeviceMesh`` over the grid's groups, Partial -> Replicate is the
``psum``, Shard -> Replicate the ``all_gather``, Partial -> Shard the
``psum_scatter`` and a split moved from dim 0 to dim 1 the
``all_to_all``, each recorded once with the reference's kind and bytes.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS
from repro_torch.utils import collectives as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, COLS, M = 16, 8, 4
B, S = 4, 16      # the EP forward: T = 64 tokens, T_loc = 32 a data shard

REF_CODE = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.utils import shard_map
from repro.utils.hlo import collective_bytes, top_collectives

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
R, K, M = 16, 8, 4
spec = P(("data", "model"), None)
bodies = {
    "all-reduce": (lambda x: jax.lax.psum(x, "model"), R),
    "all-gather": (lambda x: jax.lax.all_gather(x, "model", tiled=True), R),
    "reduce-scatter": (lambda x: jax.lax.psum_scatter(
        x, "model", scatter_dimension=0, tiled=True), R * M),
    "all-to-all": (lambda x: jax.lax.all_to_all(x, "model", 0, 0,
                                                tiled=True), R),
    "collective-permute": (lambda x: jax.lax.ppermute(
        x, "model", [(i, (i + 1) % M) for i in range(M)]), R),
}
out = {}
for kind, (body, rows) in bodies.items():
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec,
                          check_vma=False))
    x = jnp.zeros((8 * rows, K), jnp.float32)
    out[kind] = collective_bytes(f.lower(x).compile().as_text())

import dataclasses
from repro.configs import get_config
from repro.models import moe as JM
from repro.models.sharding import rules_for, use_rules
from repro.utils import set_mesh
cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(
    n_heads=4, n_kv_heads=4, vocab=512, n_experts=8, top_k=2,
    n_shared_experts=0), dtype="float32")
p = JM.init(jax.random.PRNGKey(0), cfg)
x = jnp.zeros((4, 16, cfg.d_model), jnp.float32)
with set_mesh(mesh), use_rules(rules_for()):
    hlo = jax.jit(lambda p, x: JM.moe_ffn_shardmap(cfg, p, x)[0]).lower(
        p, x).compile().as_text()
out["ep_forward"] = top_collectives(hlo, 50)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", REF_CODE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    import json
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fake_grid():
    """This process as rank 1 of a fake (2, 4) grid: its model group (ranks
    0-3) and data group (ranks 1, 5)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=1, world_size=8)
    try:
        model = [dist.new_group([d * M + m for m in range(M)],
                                group_desc="model") for d in range(2)]
        data = [dist.new_group([d * M + m for d in range(2)],
                               group_desc="data") for m in range(M)]
        yield {"model": model[0], "data": data[1]}
    finally:
        dist.destroy_process_group()


def _issue(kind: str, group):
    """One collective of ``kind`` over ``group`` on a 16 x 8 float32 block
    (reduce-scatter: a 64 x 8 input to a 16 x 8 output), as the reference's
    ``shard_map`` bodies."""
    x = torch.ones(ROWS, COLS)
    if kind == "all-reduce":
        dist.all_reduce(x, group=group)
    elif kind == "all-gather":
        dist.all_gather_into_tensor(torch.empty(M * ROWS, COLS), x,
                                    group=group)
    elif kind == "reduce-scatter":
        dist.reduce_scatter_tensor(x, torch.ones(M * ROWS, COLS),
                                   group=group)
    elif kind == "all-to-all":
        dist.all_to_all_single(torch.empty_like(x), x, group=group)
    else:   # a cyclic shift over the model ranks, as the ppermute
        me = dist.get_rank(group)
        ops = [dist.P2POp(dist.isend, x, group=group, group_peer=(me + 1) % M),
               dist.P2POp(dist.irecv, torch.empty_like(x), group=group,
                          group_peer=(me - 1) % M)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()


@pytest.mark.parametrize("kind", C.KINDS)
def test_collective_bytes_equal_the_reference_hlo(reference, fake_grid,
                                                  kind):
    with C.CollectiveRecorder() as rec:
        _issue(kind, fake_grid["model"])
    got = C.collective_bytes(rec.record)
    assert got == reference[kind]
    assert got["counts"] == {kind: 1}
    [c] = [c for c in rec.record if c.kind is not None]
    assert (c.group, c.group_desc) == (M, "model")
    if kind == "collective-permute":   # the receive is logged, not counted
        assert [c.op for c in rec.record] == ["send", "recv_"]


def test_ep_forward_all_reduce_equals_the_reference_psum(reference,
                                                         fake_grid):
    """``moe_ffn_shardmap``'s forward on rank (0, 1) of the grid: one
    all-reduce over the model group of T_loc x d float32 (32 x 64 x 4 =
    8192 bytes), the reference's ``psum``, inside the scope it runs in.
    No shared expert here: GSPMD shards the reference's over the model
    axis and all-reduces their output too (XLA fuses the two into one
    tuple all-reduce), where the port computes them whole on every rank."""
    from repro_torch.core.halo import Comm
    from repro_torch.models import expert_parallel as EP
    from repro_torch.models import moe as TM
    from repro_torch.obs.profiling import scope

    cfg = dataclasses.replace(
        ARCHS["deepseek-moe-16b"].reduced(n_heads=4, n_kv_heads=4, vocab=512,
                                          n_experts=8, top_k=2,
                                          n_shared_experts=0),
        dtype="float32")
    lp = TM.init(torch.Generator().manual_seed(0), cfg)
    ep = EP.EPRank(data=2, model=M, d=0, m=1, comm=Comm("cpu"),
                   data_group=fake_grid["data"],
                   model_group=fake_grid["model"])
    x = torch.randn(B // 2, S, cfg.d_model)
    with C.CollectiveRecorder() as rec, EP.use_ep(ep), torch.no_grad(), \
            scope("comm"):
        TM.moe_ffn_shardmap(cfg, EP.shard_experts(lp, ep.m, M, axis=0), x)
    want = [t for t in reference["ep_forward"] if t["group"] == M]
    assert want[0]["op_name"].endswith("shard_map/psum")
    got = C.top_collectives(rec.record)
    assert [(t["kind"], t["bytes"], t["group"]) for t in got] == \
        [(t["kind"], t["bytes"], t["group"]) for t in want] == \
        [("all-reduce", float(B // 2 * S * cfg.d_model * 4), M)]
    assert got[0]["sig"] == f"f32[{B // 2 * S},{cfg.d_model}]"
    assert got[0]["op_name"] == "dd-comm-halo"
    assert C.collective_bytes(rec.record, group="data")["counts"] == {}


def test_recorder_logs_scopes_and_groups_and_ignores_other_ops(fake_grid):
    """Nested ``record_function`` scopes give the path; a barrier is logged
    with no kind; ``by_group`` splits kinds by group; leaving the recorder
    stops the log."""
    with C.CollectiveRecorder() as rec:
        with torch.profiler.record_function("outer"):
            with torch.profiler.record_function("inner"):
                dist.all_reduce(torch.ones(3), group=fake_grid["data"])
        dist.all_reduce(torch.ones(5, dtype=torch.bfloat16),
                        group=fake_grid["model"])
        dist.barrier(group=fake_grid["model"])
    dist.all_reduce(torch.ones(2), group=fake_grid["model"])
    assert [c.scope for c in rec.record if c.kind] == ["outer/inner", ""]
    assert [c.sig for c in rec.record if c.kind] == ["f32[3]", "bf16[5]"]
    assert any(c.kind is None for c in rec.record)
    groups = C.by_group(rec.record)
    assert groups["data"]["all-reduce"]["count"] == 1
    assert groups["data"]["all-reduce"]["bytes"] == 12
    assert groups["model"]["all-reduce"]["bytes"] == 10
    assert C.collective_bytes(rec.record)["total_bytes"] == 22.0


_MOVES = {   # kind: (local rows, from, to) over the model mesh dim
    "all-reduce": (ROWS, "partial", "replicate"),
    "all-gather": (ROWS, "shard0", "replicate"),
    "reduce-scatter": (ROWS * M, "partial", "shard0"),
    "all-to-all": (ROWS, "shard0", "shard1"),
}


@pytest.mark.parametrize("kind", list(_MOVES))
def test_dtensor_redistributions_equal_the_reference_hlo(reference,
                                                         fake_grid, kind):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)

    place = {"partial": Partial(), "replicate": Replicate(),
             "shard0": Shard(0), "shard1": Shard(1)}
    mesh = DeviceMesh.from_group([fake_grid["data"], fake_grid["model"]],
                                 "cuda", mesh=torch.arange(8).reshape(2, M),
                                 mesh_dim_names=("data", "model"))
    rows, src, dst = _MOVES[kind]
    x = DTensor.from_local(torch.ones(rows, COLS, device="meta"), mesh,
                           [Replicate(), place[src]], run_check=False)
    with C.CollectiveRecorder() as rec:
        x.redistribute(mesh, [Replicate(), place[dst]])
    got = C.collective_bytes(rec.record)
    assert got == reference[kind]
    assert got["counts"] == {kind: 1}
    [c] = [c for c in rec.record if c.kind is not None]
    assert (c.group, c.group_desc) == (M, "model")
    assert c.op in ("all_reduce", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "shard_dim_alltoall")
