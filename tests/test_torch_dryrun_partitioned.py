"""The partitioned dry run (``lower_cell(..., partitioned=True)``): each
cell's step as rank 0 of a fake process group over DTensors whose local
shards are meta tensors (``models/partition.py``, ``launch/mesh.py``'s
``MeshPlan.fake_group``).

* On a (1, 1) plan it is the one-device trace: FLOPs, bytes, peak,
  kernel calls and argument / output bytes equal, no collective.
* For a reduced llama3.2-1b the collectives by group, kind, count and
  bytes equal a count written here from the config, term by term: the
  prefill and the training step on (1, 4) and (2, 4).
* Every family's train, prefill and decode cell runs on (2, 4) without
  allocating, with the record's partitioned fields and each device's
  K5 / K6 calls (a decode's attention over its sequence-split cache is
  the split softmax, ``tests/test_torch_split_decode.py``).
* ``micro_batches`` keeps the FLOPs and lowers the peak; the op histogram
  counts a dense prefill's products.

The reference's records (collectives, ``bf16_params``, ``extra_rules``)
are held against these in ``tests/test_torch_dryrun.py``; the
expert-parallel cell against the ``gloo`` ranks in
``tests/test_torch_moe_ep.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import LINK_BW, make_production_mesh
from repro_torch.models import partition as PT
from repro_torch.models.sharding import P

FAMILIES = {"dense": "llama3.2-1b", "vlm": "llava-next-mistral-7b",
            "mla": "minicpm3-4b", "moe": "deepseek-moe-16b",
            "rwkv": "rwkv6-3b", "hybrid": "zamba2-1.2b",
            "encdec": "seamless-m4t-large-v2"}
KINDS = ("train", "prefill", "decode")
B, S = 4, 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(arch, kind, shape, cfg=None, **kw):
    cfg = cfg or ARCHS[arch].reduced()
    return dryrun.lower_cell(arch, None, cfg_override=cfg,
                             mesh=make_production_mesh(shape=shape),
                             shape_override=ShapeConfig("t", S, B, kind),
                             **kw)


def _groups(rec) -> dict:
    """``collectives_by_group`` as ``{group: {kind: [count, bytes]}}``."""
    return {g: {k: [v["count"], v["bytes"]] for k, v in kinds.items()}
            for g, kinds in rec["collectives_by_group"].items()}


# ---------------------------------------------------------- the (1, 1) plan

@pytest.mark.parametrize("arch,kind", [(a, "train") for a in FAMILIES.values()]
                         + [("llama3.2-1b", "prefill"),
                            ("llama3.2-1b", "decode"),
                            ("deepseek-moe-16b", "decode")])
def test_one_device_plan_equals_the_trace(arch, kind):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), remat=True)
    _, one = _cell(arch, kind, (1, 1), cfg)
    _, part = _cell(arch, kind, (1, 1), cfg, partitioned=True)
    for k in ("flops", "bytes", "peak_bytes", "kernel_calls", "memory",
              "flops_per_device", "bytes_per_device"):
        assert part[k] == one[k], k
    assert part["peak_bytes_per_device"] == one["peak_bytes"]
    assert part["collectives"] == {"bytes_by_kind": {}, "counts": {},
                                   "total_bytes": 0.0}
    assert part["roofline"]["collective_s"] == 0.0
    assert part["replicated_ops"] == {}


# --------------------------------------------------- the analytic count

def _dense_collectives(cfg, kind, D, M) -> dict:
    """The collectives of rank 0 of a (D, M) plan for a reduced dense
    config's step, by group: ``{group: {kind: [count, bytes]}}``, each
    term below.  Activations are bf16 (2 bytes), the master weights and
    the cross-entropy float32."""
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ff, V, L = cfg.d_ff, cfg.padded_vocab, cfg.n_layers
    rows = B // D                       # batch rows a device holds
    act = rows * S * d * 2              # one (rows, S, d) bf16 activation
    groups: dict = {}

    def add(group, kind_, count, nbytes):
        row = groups.setdefault(group, {}).setdefault(kind_, [0, 0])
        row[0] += count
        row[1] += count * nbytes

    # the embedding: the table's vocab split moved to its d dim (an
    # all-to-all of its float32 shard, d gathered over data first), the
    # lookup's d split then gathered (act_embed is replicated)
    add("model", "all-to-all", 1, V // M * d * 4)
    add("model", "all-gather", 1, rows * S * d // M * 2)
    # Hk = 2 heads do not split over M = 4: k and v gathered over the
    # model axis before the heads reshape, each layer
    if Hk % M:
        add("model", "all-gather", 2 * L, rows * S * Hk * hd // M * 2)
    # Megatron's pair: the attention's and the MLP's output partial sums,
    # all-reduced at the product, each layer
    add("model", "all-reduce", 2 * L, act)
    if D > 1:   # ZeRO-3: every weight's embed (data) split gathered, f32
        add("data", "all-gather", 1, V // M * d // D * 4)    # the table
        add("data", "all-gather", 1, d // D * 4)             # final norm
        for n in (d // D, d // D,                            # the norms
                  d // D * H * hd // M, d // D * Hk * hd // M,
                  d // D * Hk * hd // M, H * hd // M * d // D,
                  d // D * ff // M, d // D * ff // M, ff // M * d // D):
            add("data", "all-gather", L, n * 4)
    if kind == "prefill":
        return groups
    ck = min(512, S)
    # the chunked cross-entropy: each chunk's vocab split logits
    # gathered (float32), forward and in the backward's recompute
    add("model", "all-gather", 2 * (-(-S // ck)), rows * ck * V // M * 4)
    # k's and v's gradients: each shard's q heads read one of the Hk
    # gathered heads, so the gathered k and v get pending sums over the
    # model axis, all-reduced, each layer
    if Hk % M:
        add("model", "all-reduce", 2 * L, rows * S * Hk * hd * 2)
    # the table's gradient moved back from its d split to its vocab split
    add("model", "all-to-all", 1, V * d // M * 4)
    # the clip's global norm: one float32 square sum a model-split leaf
    # (the tied table and the 7 stacked weights of q, k, v, o and the MLP)
    add("model", "all-reduce", 1 + 7, 4)
    if D == 1:
        # the backward: the gradient into each layer's attention and MLP
        # inputs, and the head's into the final hidden state
        add("model", "all-reduce", 2 * L + 1, act)
        return groups
    # with a data axis the weights are gathered over it (ZeRO-3) and
    # DTensor's backward plan keeps the residual stream's gradient a
    # pending sum over the model axis, reduced only where a product or a
    # split layout needs it:
    # the loss's token mean over the data-split batch
    add("data", "all-reduce", 1, 4)
    # each norm weight's gradient (float32 d: two a layer and the final
    # one) a pending sum over both axes, all-reduced on each
    for axis in ("data", "model"):
        add(axis, "all-reduce", 2 * L + 1, d * 4)
    # each of the MLP's and the attention's output products, each layer:
    # its bf16 input (rows x S, n) and weight (n, d) gathered over the
    # model axis for the backward, the weight's whole float32 gradient
    # reduce-scattered over data (its d split), then over model
    for n in (ff, H * hd):
        add("model", "all-gather", L, rows * S * n // M * 2)
        add("model", "all-gather", L, n // M * d * 2)
        add("data", "reduce-scatter", L, n * d * 4)
        add("model", "reduce-scatter", L, n * d // D * 4)
    # the gradients into the MLP hidden (rows, S, ff), whole and pending
    # over the model axis, reduce-scattered to its ff split by the
    # SwiGLU's two products; the attention output's (rows, S, H hd) to
    # its head split (the reshape's gradient layout), each layer
    add("model", "reduce-scatter", 2 * L, rows * S * ff * 2)
    add("model", "reduce-scatter", L, rows * S * H * hd * 2)
    # the other weights' gradients, local over the model axis, pending
    # over the data-split batch: reduce-scattered over data (their d
    # split), each layer: the MLP's two input products, q, k and v
    for n, count in ((ff // M, 2), (Hk * hd // M, 2), (H * hd // M, 1)):
        add("data", "reduce-scatter", count * L, d * n * 4)
    # the embedding: its output's gradient (rows, S, d), pending over the
    # model axis, reduce-scattered to the lookup's d split; the
    # scatter-add gathers the tokens (int32) and the gradient rows over
    # data; the table's gradient, pending over data, reduce-scattered to
    # its embed split after its all-to-all
    add("model", "reduce-scatter", 1, act)
    add("data", "all-gather", 1, rows * S * 4)
    add("data", "all-gather", 1, rows * S * d // M * 4)
    add("data", "reduce-scatter", 1, V // M * d * 4)
    # the clip: one float32 square sum a data-split leaf (the table, the
    # final norm, the two stacked norms and the 7 stacked weights)
    add("data", "all-reduce", 1 + 1 + 2 + 7, 4)
    return groups


@pytest.mark.parametrize("kind,shape", [("prefill", (1, 4)),
                                        ("prefill", (2, 4)),
                                        ("train", (1, 4)),
                                        ("train", (2, 4))])
def test_dense_collectives_equal_the_analytic_count(kind, shape):
    cfg = ARCHS["llama3.2-1b"].reduced()
    _, rec = _cell("llama3.2-1b", kind, shape, cfg, partitioned=True)
    want = _dense_collectives(cfg, kind, *shape)
    assert _groups(rec) == want
    total = sum(b for kinds in want.values() for _, b in kinds.values())
    assert rec["collectives"]["total_bytes"] == total
    assert rec["roofline"]["collective_s"] == total / LINK_BW
    # the k / v reshape over an uneven head split is the one fallback
    assert rec["replicated_ops"] == {"reshape": 2 * cfg.n_layers}


# ------------------------------------------------------ the seven families

class _NoLargeCpuTensor(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor) and type(t) is torch.Tensor \
                    and t.device.type == "cpu":
                self.largest = max(self.largest,
                                   t.numel() * t.element_size())
        return out


def _replicated_ops(family, kind, cfg) -> dict:
    """The ops a reduced (2, 4) cell runs on replicated inputs (the
    record's ``replicated_ops``), each where DTensor has no sharding for
    its inputs' placements; a new one is a new gap or a fault."""
    L = cfg.n_layers
    if family in ("dense", "vlm"):
        # k and v unflattened into Hk = 2 heads over the model axis's 4,
        # each layer (a decode's split softmax runs on local tensors)
        return {"reshape": 2 * L}
    if family == "moe":
        n_moe = L - cfg.first_dense
        if kind == "decode":
            # one group of the data-split tokens: the router's product and
            # the combine's flatten of the expert buffer, each MoE layer
            return {"matmul": n_moe, "reshape": n_moe}
        # the routes' counts (two scatter-adds) and the load-balance
        # term's mean over the data-split tokens, each MoE layer
        return {"mean": n_moe, "scatter_add_": 2 * n_moe}
    if family in ("rwkv", "hybrid"):
        # the norm over a model-split width (RWKV's ln_x, Mamba2's gated
        # out_norm): a mean over the split dim, each layer
        return {"mean": L}
    return {}   # mla, encdec


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_partitions_on_the_2x4_plan(family, kind):
    arch = FAMILIES[family]
    _, one = _cell(arch, kind, (2, 4))
    with _NoLargeCpuTensor() as guard:
        out, rec = _cell(arch, kind, (2, 4), partitioned=True)
    assert guard.largest <= 2 ** 20, guard.largest
    assert rec["ok"] and rec["n_devices"] == 8 and rec["mesh"] == "2x4"
    # the arguments a device holds and reads, and its outputs, are the
    # global trace's by the specs
    assert rec["memory"] == one["memory"]
    # each device calls K5 / K6 once where the global step does, on its
    # shard: a part of the FLOPs, a part of the peak; but the
    # encoder-decoder's cross decode, which over the sequence-split cross
    # cache is a split softmax in plain torch on each device (K5 takes no
    # partial's row statistics)
    calls = dict(one["kernel_calls"])
    if family == "encdec" and kind == "decode":
        calls["flash_attention"] = 0
    assert rec["kernel_calls"] == calls
    assert 0 < rec["flops_per_device"] < one["flops"]
    assert 0 < rec["peak_bytes_per_device"] < one["peak_bytes"]
    assert rec["flops"] == rec["flops_per_device"] * 8
    coll = rec["collectives"]
    assert coll["total_bytes"] > 0 and set(coll["counts"]) <= {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all"}
    assert rec["roofline"]["collective_s"] == coll["total_bytes"] / LINK_BW
    assert rec["roofline"]["dominant"] in rec["roofline"]
    # collective_s may dominate, a decode's too (its split softmax over
    # the sequence-split cache moves no score); no decode note
    assert "decode" not in rec["notes"]
    assert rec["replicated_ops"] == _replicated_ops(
        family, kind, ARCHS[arch].reduced())
    assert set(rec["collectives_by_group"]) <= {"data", "model"}
    assert len(rec["hlo_ops"]) == 15 and rec["top_collectives"]
    assert set(rec["notes"]) >= {"rank", "collectives", "peak_bytes"}
    leaves = [t for t in torch.utils._pytree.tree_leaves(out)
              if isinstance(t, torch.Tensor)]
    assert all(t.device.type == "meta" or
               getattr(t, "_local_tensor", t).device.type == "meta"
               for t in leaves)


def test_only_dtensor_s_own_failures_are_replicated():
    """ReplicateUnsharded reruns an op replicated only where DTensor's own
    code fails to shard it: a shape fault fails the replicated run too
    and raises, an error raised outside DTensor's code raises at once (a
    rerun on replicated inputs would hide one that depends on the layout),
    and neither counts as a fallback; an uneven unflatten is one."""
    plan = make_production_mesh(shape=(2, 4))
    calls = []

    def model_fault(x):   # fails on the split input only
        calls.append(x.placements)
        if len(calls) == 1:
            raise IndexError("a fault of the model's")
        return x

    with plan.fake_group() as grid:
        mesh = grid.device_mesh

        def dt(shape, spec):
            return PT.meta_dtensors(torch.empty(shape, device="meta"), spec,
                                    mesh, plan)
        a, b = dt((8, 16), P("data", None)), dt((12, 4), P(None, "model"))
        mode = PT.ReplicateUnsharded()
        with mode, pytest.raises(RuntimeError):
            torch.matmul(a, b)
        with pytest.raises(IndexError, match="model's"):
            mode.__torch_function__(model_fault, (type(a),), (a,))
        assert len(calls) == 1 and not mode.fallbacks
        with mode:
            out = dt((4, 8, 32), P("data", None, "model")).reshape(4, 8, 2,
                                                                   16)
        assert tuple(out.shape) == (4, 8, 2, 16)
        assert mode.fallbacks == {"reshape": 1}


# ---------------------------------------------------------------- options

def test_micro_batches_keep_the_flops_and_lower_the_peak():
    cfg = dataclasses.replace(ARCHS["llama3.2-1b"].reduced(), remat=True)
    _, one = _cell("llama3.2-1b", "train", (2, 4), cfg, partitioned=True)
    _, two = _cell("llama3.2-1b", "train", (2, 4), cfg, partitioned=True,
                   micro_batches=2)
    assert two["flops_per_device"] == one["flops_per_device"]
    assert two["peak_bytes_per_device"] < one["peak_bytes_per_device"]
    assert two["kernel_calls"]["flash_attention"] == \
        2 * one["kernel_calls"]["flash_attention"]


def test_accumulated_step_equals_the_one_batch_step():
    """The micro-batched train step on CPU tensors: two halves of a batch
    of equal token counts give the one-batch step's loss and Adam moments
    (float32; the accumulator takes the params' dtype)."""
    from repro_torch.core.nets import tree_leaves
    from repro_torch.launch.train import lm_train_step
    from repro_torch.models import build_model, make_batch
    from repro_torch.optim.adam import init_adam

    cfg = dataclasses.replace(ARCHS["llama3.2-1b"].reduced(),
                              dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init(0)
    batch = make_batch(cfg, ShapeConfig("t", 16, 4, "train"), "train",
                       seed=1, device="cpu")
    _, one, loss, _ = lm_train_step(model, params, init_adam(params), batch,
                                    0, 1e-4, 1)
    _, two, loss2 = dryrun._accumulated_step(model, params,
                                             init_adam(params), batch, 2)
    assert abs(float(loss2) - float(loss)) <= 1e-6 * abs(float(loss))
    for a, b in zip(tree_leaves(one), tree_leaves(two)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-9)
    with pytest.raises(ValueError, match="micro-batches"):
        dryrun._accumulated_step(model, params, init_adam(params), batch, 3)


def test_op_histogram_counts_the_products_of_a_dense_prefill():
    """q, k, v, o and the SwiGLU's three a layer, and the tied head: every
    product one ``aten.mm`` (K5 on meta tensors runs none)."""
    cfg = ARCHS["llama3.2-1b"].reduced()
    _, rec = _cell("llama3.2-1b", "prefill", (1, 1), cfg, partitioned=True)
    ops = dict(rec["hlo_ops"])
    assert ops["aten.mm"] + ops.get("aten.bmm", 0) == 7 * cfg.n_layers + 1
    assert rec["hlo_ops"] == sorted(rec["hlo_ops"],
                                    key=lambda kv: (-kv[1], kv[0]))


def test_cli_writes_the_partitioned_record(tmp_path):
    """``--partitioned`` at full size on the (16, 16) plan: rank 0 of 256
    fake ranks, on the CPU."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--shape", "prefill_32k", "--partitioned",
         "--bf16-params", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    tag = "llama3.2-1b__prefill_32k__16x16__bf16_params__partitioned"
    assert f"[dryrun] {tag}: OK" in res.stdout
    with open(tmp_path / f"{tag}.json") as f:
        rec = json.load(f)
    assert rec["ok"] and rec["n_devices"] == 256
    assert rec["kernel_calls"] == {"flash_attention": 16, "wkv6": 0}
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["peak_bytes_per_device"] < rec["flops"]
