"""Dry run: trace every (arch x shape) cell's step on the meta device.

Counterpart of the reference package's ``launch/dryrun.py``, which lowers
and compiles every cell on the production mesh without allocating.  Here
the port's own step runs at the config's published width and depth on
``meta`` tensors (shapes and dtypes, no storage): ``launch.train``'s
``lm_train_step`` for a train cell (loss, gradient, the clip, the
schedule and the out-of-place Adam: the step the card runs), ``prefill``
and ``decode_step`` for the others.  The flash-attention (K5) and WKV6
(K6) wrappers launch nothing on meta tensors: they make the kernel's
output and count the call (``meta_calls``) and its work (``work``).  For
each cell the record holds

* ``memory`` — ``argument_size_in_bytes`` and ``output_size_in_bytes``
  per device, from the sharding specs (``models/sharding.py``) laid over
  the mesh plan (``launch/mesh.py``): a dim split over n devices takes
  ceil(dim / n), as XLA pads.  As XLA's figures: an argument that no op
  or kernel of the step reads is not counted (jit drops it: the VLM's ``vis_proj``
  and the encoder-decoder's encoder in a decode step, RWKV's decode
  position), and the outputs count the table of the step's output tuple,
  8 bytes an output array where there is more than one.  The train
  cell's outputs are the reference step's (params, Adam state, loss); the
  grad norm that the port's step also returns is not counted;
* ``peak_bytes`` — the peak of live bytes (storages) of the global step
  traced on one device, inputs included;
* ``flops`` — the aten ops' FLOPs under
  ``torch.utils.flop_counter.FlopCounterMode`` (the matrix products)
  plus K5/K6 by their work formulas; ``bytes`` — the input plus output
  bytes of every aten op that is not a view or a bare allocation, plus
  K5/K6 by their formulas: the traffic of an eager, unfused program;
* ``flops_per_device`` / ``bytes_per_device`` (the even split),
  ``kernel_calls`` (K5/K6 by name), the roofline's ``compute_s`` and
  ``memory_s`` over the H100 datasheet peaks, and the reference's
  ``model_flops``, ``model_flops_ratio``, ``param_count`` and
  ``active_param_count``;
* ``notes`` — what the record does not model: the global step on one
  device has no collective term and no per-device activation estimate.

``lower_cell(..., partitioned=True)`` (``--partitioned``) runs the step as
rank 0 of a ``fake`` process group of the plan's size instead
(``MeshPlan.fake_group``), on DTensors laid out by the specs with meta
local shards (``models/partition.py``), under the collective recorder
(``utils/collectives.py``) and :class:`_Trace` on the rank's local ops:
the counterpart of the reference reading its SPMD-partitioned HLO.  The
record then also holds ``collectives`` (``collective_bytes`` of the
rank's record), ``collectives_by_group``, ``top_collectives``,
``roofline.collective_s`` (the total over ``LINK_BW``; it takes part in
``dominant``; a decode's attention over its sequence-split cache is a
split softmax, ``partition.split_kv_attention``, so its collectives do
not grow with the cache), ``peak_bytes_per_device`` (the rank's live local
storages, arguments included; ``peak_bytes`` is the same), the rank's
own ``flops_per_device`` / ``bytes_per_device`` (n_devices times them
in ``flops`` / ``bytes``), ``kernel_calls`` a device, ``hlo_ops`` (the
rank's aten op histogram, ``op_histogram(top=15)``), ``replicated_ops``
and notes on what differs from XLA.  An expert-parallel cell
(``moe_shard_map``) runs the ranks' own program on its local shards
under the fake grid's ``EPRank``; it needs rules that replicate every
param but the experts.  ``micro_batches``, ``bf16_params`` and
``extra_rules`` are the reference's options (``--micro-batches``,
``--bf16-params``).

The reference's unrolled reduced-depth FLOP fit (``_measure_layers``,
``--no-unroll``) is not needed: a meta trace runs every layer.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--skip-existing] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --partitioned [--micro-batches N] [--bf16-params]

It runs on the CPU (``meta`` is no device) and needs no card; the records
go to ``dryrun_out/`` at the repository's root unless ``--out`` says.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import traceback
import weakref
from collections import Counter

import torch
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import (ARCHS, SHAPES, active_param_count,
                                 get_config, param_count)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.nets import map_tree, tree_leaves, tree_unflatten
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import wkv6 as WK
from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16,
                                     MeshPlan, make_production_mesh)
from repro_torch.launch.train import lm_train_step
from repro_torch.models import batch_struct, build_model
from repro_torch.models import expert_parallel as EP
from repro_torch.models import partition as PT
from repro_torch.models.sharding import P, rules_for, use_rules
from repro_torch.models.sharding import spec as lspec
from repro_torch.optim import adam as adam_lib
from repro_torch.utils import collectives as COL
from repro_torch.utils.collectives import CollectiveRecorder

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_out")
META = torch.device("meta")

_BATCH_LOGICAL = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "loss_mask": ("batch", "seq"),
    "patch_embeds": ("batch", None, None),
    "frames": ("batch", None, None),
}

# ops that only allocate: they move no bytes
_ALLOC = frozenset({
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
})

NOTES = {
    "peak_bytes": "the global step traced on one device; the port has no "
                  "partitioner, so there is no per-device activation "
                  "estimate",
    "per_device": "flops_per_device and bytes_per_device are the even split "
                  "of flops and bytes over n_devices",
    "collectives": "no collective term: the step is traced on one device, "
                   "not partitioned; lower_cell(partitioned=True) counts "
                   "one rank's collectives",
}

PARTITIONED_NOTES = {
    "rank": "the step run as rank 0 of a fake process group of n_devices "
            "ranks over DTensors whose local shards are meta tensors: "
            "every per-device figure is rank 0's (a dim split unevenly "
            "gives rank 0 the larger shard, ceil(dim / n), as XLA pads)",
    "peak_bytes": "peak_bytes and peak_bytes_per_device: the rank's live "
                  "local storages, its arguments included",
    "per_device": "flops_per_device and bytes_per_device are measured on "
                  "the rank (its local ops and its K5/K6 calls); flops "
                  "and bytes are n_devices times them",
    "collectives": "what DTensor issues for the rank: one collective per "
                   "redistribution, in program order; XLA combines "
                   "collectives and GSPMD picks its own plan (it pads "
                   "uneven splits, keeps some products sharded where "
                   "DTensor gathers), so counts differ from the reference "
                   "and bytes agree in size, not exactly",
    "replicated_ops": "ops DTensor has no sharding for on their inputs' "
                      "placements, run on their inputs replicated "
                      "(models/partition.py::ReplicateUnsharded)",
    "expert_parallel": "a moe_shard_map cell runs the expert-parallel "
                       "ranks' own program on its local shards, its "
                       "collectives those of models/expert_parallel.py "
                       "over the grid's data and model groups",
}


def batch_specs(batch: dict, rules) -> dict:
    return {k: lspec(*_BATCH_LOGICAL[k], rules=rules) for k in batch}


def param_structs(model):
    """The model's param tree as meta tensors (no draw, no storage)."""
    return model.on_meta().init()


def opt_structs(p_struct):
    """Adam's state for ``p_struct``: m and v as meta tensors of its
    shapes, an int32 step count."""
    return adam_lib.init_adam(p_struct)


def opt_specs(p_specs):
    return {"m": p_specs, "v": p_specs, "count": P()}


def _pairs(tree, specs):
    """(leaf, spec) pairs of a tree and its specs tree."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    else:
        yield tree, specs


def _key(t) -> int:
    return t.untyped_storage()._cdata


def _device_bytes(mesh: MeshPlan, tree, specs, read=None) -> int:
    """Per-device bytes of the tree's leaves (of those whose storage is in
    ``read`` where given)."""
    n = 0
    for t, s in _pairs(tree, specs):
        if read is not None and _key(t) not in read:
            continue
        numel = 1
        for d in mesh.shard_shape(t.shape, s):
            numel *= d
        n += numel * t.element_size()
    return n


def _tensors(tree) -> list:
    return [t for t in _pt_leaves(tree) if isinstance(t, torch.Tensor)]


class _Trace(TorchDispatchMode):
    """The live bytes and the traffic of the aten ops run under it, and
    the storages that ops other than views and bare allocations read
    (``read``).

    A storage counts from the first op that returns it (or from the start,
    for ``roots``) until it is freed, whatever views of it exist: a weak
    reference to its Python object fires when the storage dies (torch
    keeps that object for as long as the storage lives)."""

    def __init__(self, roots, per_rank=False):
        super().__init__()
        self.live, self._refs, self.read = {}, {}, set()
        self.cur = self.peak = self.traffic = 0
        # one rank of a partitioned step: DTensor's own ops are left to it
        # (their local ops come back here), its sharding propagation's
        # fake ones are not counted; FLOPs and the op histogram are kept
        self.per_rank = per_rank
        self.flops = 0
        self.ops: Counter = Counter()
        for t in roots:
            self._track(t)

    def _track(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self._refs[key] = weakref.ref(st, functools.partial(self._free, key))
        self.cur += n
        self.peak = max(self.peak, self.cur)

    def _free(self, key, _ref) -> None:
        self.cur -= self.live.pop(key)
        del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.per_rank and COL.subclassed(types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self.per_rank:
            if any(type(t).__name__ == "FakeTensor" for t in ins + outs):
                return out
            self.ops[str(func.overloadpacket)] += 1
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
        # a view reads nothing (its consumer does), an allocation neither
        if not func.is_view and func not in _ALLOC:
            self.read.update(_key(t) for t in ins)
            self.traffic += sum(t.numel() * t.element_size()
                                for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


def _traced(fn, roots):
    """``fn()`` under the FLOP counter and :class:`_Trace`, the kernels'
    meta counts reset just before: (out, matrix FLOPs, traffic, peak,
    storages read, kernel calls, kernel work)."""
    FA.reset_meta_counts()
    WK.reset_meta_counts()
    fc = FlopCounterMode(display=False)
    with fc, _Trace(_tensors(roots)) as tr:
        out = fn()
    calls = {**FA.meta_calls, **WK.meta_calls}
    work = {k: FA.meta_work[k] + WK.meta_work[k] for k in ("flops", "bytes")}
    read = tr.read | FA.meta_reads | WK.meta_reads
    return out, fc.get_total_flops(), tr.traffic, tr.peak, read, calls, work


def cell_arguments(model, shape: ShapeConfig, rules) -> list:
    """[(tree, specs)] of the step's arguments as meta tensors: params,
    Adam state and batch (train), params and batch (prefill), params,
    cache and batch (decode; the position is a Python int)."""
    p_struct = param_structs(model)
    p_specs = model.param_specs(rules)
    b_struct = batch_struct(model.cfg, shape)
    b = (b_struct, batch_specs(b_struct, rules))
    if shape.kind == "train":
        return [(p_struct, p_specs),
                (opt_structs(p_struct), opt_specs(p_specs)), b]
    if shape.kind == "prefill":
        return [(p_struct, p_specs), b]
    return [(p_struct, p_specs),
            (model.cache_struct(shape.global_batch, shape.seq_len),
             model.cache_specs(rules)), b]


def _accumulated_step(model, params, opt, batch, micro_batches: int):
    """``launch.train.lm_train_step`` (step 0 of 1) with its gradient
    accumulated over ``micro_batches`` equal parts of the batch's rows,
    as the reference dry run's ``train_step`` accumulates: each part's
    loss and gradient in turn, summed in a zero tree like the params (the
    float32 masters), then the loss and gradients divided by the count
    (the mean of the parts' means)."""
    leaves = tree_leaves(params)
    rows = batch["tokens"].shape[0]
    if rows % micro_batches:
        raise ValueError(f"{rows} rows in {micro_batches} micro-batches")
    n = rows // micro_batches
    grads = [torch.zeros_like(t) for t in leaves]
    loss = 0.0
    for i in range(micro_batches):
        part = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        for t in leaves:
            t.requires_grad_(True)
        try:
            part_loss = model.loss(params, part)
            part_grads = torch.autograd.grad(part_loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [a + g for a, g in zip(grads, part_grads)]
        loss = loss + part_loss.detach()
        del part_grads
    grads = [g / micro_batches for g in grads]
    loss, grads = EP.mean_over_data(loss / micro_batches, grads)
    grads = tree_unflatten(params, grads)
    grads, _ = adam_lib.clip_by_global_norm(grads, 1.0,
                                            norm=EP.global_norm(grads))
    lr = adam_lib.warmup_cosine(torch.tensor(0, device=loss.device), 1e-4,
                                warmup=20, total=1)
    with torch.profiler.record_function("adam_update"):
        params, opt = adam_lib.adam_update(grads, opt, params, lr)
    return params, opt, loss.detach()


def _bf16(tree):
    """A param tree's float32 leaves as bf16 meta tensors."""
    return map_tree(lambda t: torch.empty(t.shape, dtype=torch.bfloat16,
                                          device=META)
                    if t.dtype == torch.float32 else t, tree)


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               cfg_override: ModelConfig | None = None,
               mesh: MeshPlan | None = None,
               shape_override: ShapeConfig | None = None,
               partitioned: bool = False, micro_batches: int = 1,
               bf16_params: bool = False, extra_rules: dict | None = None):
    """Trace one cell's step on the meta device.  Returns (outputs, record):
    the step's outputs as meta tensors ((params, Adam state, loss) for
    train, the logits for prefill, (logits, cache) for decode), or None
    for a skipped cell.  ``mesh`` replaces the production mesh (any shape
    of ``launch.mesh.make_production_mesh``), ``shape_override`` the
    cell's batch and sequence.

    As the reference's: ``micro_batches`` splits a train cell's batch and
    accumulates the gradients (:func:`_accumulated_step`),
    ``bf16_params`` casts the float32 params of a prefill or decode cell
    to bf16, ``extra_rules`` updates the sharding rules.  With
    ``partitioned`` the step runs as rank 0 of the mesh's fake process
    group (:func:`_partitioned`); its outputs are then DTensors (or, in an
    expert-parallel cell, the rank's local tensors)."""
    cfg = cfg_override or get_config(arch)
    shape = shape_override or SHAPES[shape_name]
    if not cfg.supports(shape):
        return None, {"arch": arch, "shape": shape_name, "skipped": True,
                      "reason": "quadratic attention at 524288 (see "
                                "DESIGN.md)"}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rules = rules_for(multi_pod=multi_pod,
                      long_context=(shape.name == "long_500k"),
                      decode=(shape.kind == "decode"))
    if extra_rules:
        rules.update(extra_rules)
    model = build_model(cfg, META)
    rec = {"arch": arch, "shape": shape.name, "kind": shape.kind,
           "mesh": mesh.name, "n_devices": mesh.n_devices}

    args = cell_arguments(model, shape, rules)
    if bf16_params and shape.kind != "train":
        args[0] = (_bf16(args[0][0]), args[0][1])
    logits_spec = lspec("batch", None, "vocab", rules=rules)
    if shape.kind == "train":
        def step(params, opt, batch):
            if micro_batches > 1:
                return _accumulated_step(model, params, opt, batch,
                                         micro_batches)
            params, opt, loss, _ = lm_train_step(model, params, opt, batch,
                                                 0, 1e-4, 1)
            return params, opt, loss

        out_specs = (args[0][1], args[1][1], P())
    elif shape.kind == "prefill":
        def step(params, batch):
            return model.prefill(params, batch)

        out_specs = logits_spec
    else:  # decode
        def step(params, cache, batch):
            return model.decode_step(params, cache, batch,
                                     shape.seq_len - 1)

        out_specs = (logits_spec, args[1][1])

    if partitioned:
        out = _partitioned(rec, model, mesh, rules, args, step, out_specs)
    else:
        trees = [t for t, _ in args]
        out, mm_flops, traffic, peak, read, calls, work = _traced(
            lambda: step(*trees),
            [t for tree in trees for t in tree_leaves(tree)])
        out_pairs = list(zip(out, out_specs)) if isinstance(out, tuple) \
            else [(out, out_specs)]
        rec["memory"] = {
            "argument_size_in_bytes": sum(_device_bytes(mesh, t, s, read)
                                          for t, s in args),
            "output_size_in_bytes": sum(_device_bytes(mesh, t, s)
                                        for t, s in out_pairs),
        }
        rec["peak_bytes"] = peak
        rec["flops"] = float(mm_flops + work["flops"])
        rec["bytes"] = float(traffic + work["bytes"])
        rec["flops_per_device"] = rec["flops"] / mesh.n_devices
        rec["bytes_per_device"] = rec["bytes"] / mesh.n_devices
        rec["kernel_calls"] = calls
    # decode's position: a traced int32 scalar in the reference's step,
    # dropped where the step never reads it (the port's is a Python int);
    # the table of a tuple of outputs, 8 bytes an array
    rec["memory"]["argument_size_in_bytes"] += \
        4 if shape.kind == "decode" and model.decode_reads_pos else 0
    out_pairs = list(zip(out, out_specs)) if isinstance(out, tuple) \
        else [(out, out_specs)]
    n_out = sum(len(list(_pairs(t, s))) for t, s in out_pairs)
    rec["memory"]["output_size_in_bytes"] += 8 * n_out if n_out > 1 else 0
    _finalize_roofline(rec, arch, shape)
    return out, rec


def _local_bytes(tree, read=None) -> int:
    """Bytes of a tree's local shards (of those whose storage is in
    ``read`` where given)."""
    n = 0
    for t in _tensors(tree):
        t = PT.local(t)
        if read is None or _key(t) in read:
            n += t.numel() * t.element_size()
    return n


def _to_specs(out, out_specs):
    """The step's DTensor outputs laid out as the reference's
    ``out_shardings`` ask (a last redistribution inside the step)."""
    if isinstance(out, tuple):
        return tuple(_to_specs(o, s) for o, s in zip(out, out_specs))
    if isinstance(out, dict):
        return {k: _to_specs(out[k], out_specs[k]) for k in out}
    if not PT.is_dtensor(out):
        return out
    want = PT.placements(out_specs, out.device_mesh)
    if list(out.placements) == want:
        return out
    return out.redistribute(out.device_mesh, want)


def _expert_parallel_rules(model, rules) -> None:
    """Raise unless the rules shard nothing but the experts (over
    ``model``) and the batch (over ``data``): the layout the
    expert-parallel ranks hold, whose step is written for local tensors."""
    bad = []
    for path, spec_ in _spec_paths(model.param_specs(rules)):
        if any(e is not None for e in spec_) and "experts" not in path:
            bad.append("/".join(path))
    if bad:
        raise ValueError(
            "an expert-parallel cell (moe_shard_map=True) runs its ranks' "
            "program, which holds every param but the experts replicated; "
            f"these are sharded: {bad[:4]} (extra_rules can replicate them)")


def _spec_paths(specs, path=()):
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _spec_paths(v, path + (k,))
    else:
        yield path, specs


def _partitioned(rec, model, mesh, rules, args, step, out_specs):
    """The step as rank 0 of ``mesh``'s fake process group: its arguments
    DTensors over meta local shards (``models/partition.py``), its
    collectives recorded (``utils/collectives.py``), its live local
    storages, FLOPs, traffic and ops traced.  An expert-parallel cell
    (``moe_shard_map``) runs the ranks' own program on the local shards,
    its collectives issued by ``expert_parallel.EPRank`` over the grid's
    data and model groups.  Fills ``rec``; returns the outputs."""
    ep_cell = model.cfg.moe_shard_map
    if ep_cell:
        _expert_parallel_rules(model, rules)
    with mesh.fake_group() as grid, use_rules(rules):
        trees = [PT.meta_dtensors(t, s, grid.device_mesh, mesh)
                 for t, s in args]
        ctx = contextlib.ExitStack()
        if ep_cell:
            trees = [map_tree(PT.local, t) for t in trees]
            ctx.enter_context(EP.use_ep(grid.expert_parallel()))
        roots = [PT.local(t) for tree in trees for t in tree_leaves(tree)
                 if t is not None]
        FA.reset_meta_counts()
        WK.reset_meta_counts()
        fallback = PT.ReplicateUnsharded()
        with ctx, implicit_replication(), CollectiveRecorder() as coll, \
                _Trace(roots, per_rank=True) as tr:
            with fallback:
                out = _to_specs(step(*trees), out_specs)
        record = coll.record
    calls = {**FA.meta_calls, **WK.meta_calls}
    work = {k: FA.meta_work[k] + WK.meta_work[k] for k in ("flops", "bytes")}
    read = tr.read | FA.meta_reads | WK.meta_reads
    n = mesh.n_devices
    rec["memory"] = {
        "argument_size_in_bytes": sum(_local_bytes(t, read) for t in trees),
        "output_size_in_bytes": _local_bytes(out),
    }
    rec["peak_bytes"] = rec["peak_bytes_per_device"] = tr.peak
    rec["flops_per_device"] = float(tr.flops + work["flops"])
    rec["bytes_per_device"] = float(tr.traffic + work["bytes"])
    rec["flops"] = rec["flops_per_device"] * n
    rec["bytes"] = rec["bytes_per_device"] * n
    rec["kernel_calls"] = calls
    rec["collectives"] = COL.collective_bytes(record)
    rec["collectives_by_group"] = {
        g: {k: {"count": v["count"], "bytes": v["bytes"]}
            for k, v in kinds.items()}
        for g, kinds in COL.by_group(record).items()}
    rec["top_collectives"] = COL.top_collectives(record)
    rec["hlo_ops"] = COL.op_histogram(tr.ops, top=15)
    rec["replicated_ops"] = dict(sorted(fallback.fallbacks.items()))
    rec["notes"] = PARTITIONED_NOTES
    return out


def _finalize_roofline(rec: dict, arch: str, shape: ShapeConfig) -> None:
    rec["roofline"] = {
        "compute_s": rec["flops_per_device"] / PEAK_FLOPS_BF16,
        "memory_s": rec["bytes_per_device"] / HBM_BW,
    }
    if "collectives" in rec:
        rec["roofline"]["collective_s"] = \
            rec["collectives"]["total_bytes"] / LINK_BW
    terms = dict(rec["roofline"])
    rec["roofline"]["dominant"] = max(terms, key=terms.get)
    # as the reference: the published config's counts, whatever
    # cfg_override the cell ran with
    cfg_n = active_param_count(get_config(arch))
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = (6 if shape.kind == "train" else 2) * cfg_n * tokens
    rec["model_flops"] = float(mf)
    rec["model_flops_ratio"] = float(mf / max(rec["flops"], 1.0))
    rec["param_count"] = param_count(get_config(arch))
    rec["active_param_count"] = cfg_n
    rec.setdefault("notes", NOTES)
    rec["ok"] = True


def run_cell(arch, shape_name, multi_pod, out_dir, skip_existing=False,
             **options):
    """One cell's record, written to ``out_dir``; ``options`` are
    :func:`lower_cell`'s (``partitioned``, ``micro_batches``,
    ``bf16_params``), named in the file's tag where set."""
    os.makedirs(out_dir, exist_ok=True)
    mesh = make_production_mesh(multi_pod=multi_pod)
    tag = f"{arch}__{shape_name}__{mesh.name}" + "".join(
        f"__{k}" if v is True else f"__{k}{v}"
        for k, v in sorted(options.items())
        if v is True or (not isinstance(v, bool) and v != 1))
    path = os.path.join(out_dir, tag + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        if old.get("ok") or old.get("skipped"):
            print(f"[dryrun] {tag}: cached")
            return old
    try:
        out, rec = lower_cell(arch, shape_name, multi_pod, **options)
        del out
        if rec.get("skipped"):
            print(f"[dryrun] {tag}: SKIP ({rec['reason']})")
        elif "collectives" in rec:
            print(f"[dryrun] {tag}: OK dom={rec['roofline']['dominant']} "
                  f"peak={rec['peak_bytes_per_device'] / 1e9:.3f} GB a "
                  f"device (rank 0 of {rec['n_devices']}) "
                  f"flops/dev={rec['flops_per_device']:.4e} "
                  f"bytes/dev={rec['bytes_per_device']:.4e} "
                  f"coll/dev={rec['collectives']['total_bytes']:.4e} "
                  f"calls={rec['kernel_calls']}")
            print(f"  collectives: {rec['collectives']['counts']}")
            print(f"  memory per device: {rec['memory']}")
        else:
            print(f"[dryrun] {tag}: OK dom={rec['roofline']['dominant']} "
                  f"peak={rec['peak_bytes'] / 1e9:.3f} GB (global step, "
                  f"one device) flops={rec['flops']:.4e} "
                  f"bytes={rec['bytes']:.4e} calls={rec['kernel_calls']}")
            print(f"  memory per device: {rec['memory']}")
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh.name,
               "ok": False, "error": repr(e),
               "traceback": traceback.format_exc()}
        print(f"[dryrun] {tag}: FAIL {e!r}")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Trace each (arch x shape) cell's step on the meta "
                    "device: per-device argument and output bytes from the "
                    "sharding specs, the step's peak live bytes, FLOPs and "
                    "bytes (with --partitioned: one rank's, and its "
                    "collectives).  Runs on the CPU; needs no card.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--partitioned", action="store_true",
                    help="run each step as rank 0 of a fake process group "
                         "of the mesh's size over DTensors: collectives, "
                         "per-device peak, FLOPs and op histogram")
    ap.add_argument("--micro-batches", type=int, default=1,
                    help="train cells: accumulate over this many parts")
    ap.add_argument("--bf16-params", action="store_true",
                    help="prefill / decode cells: bf16 params")
    args = ap.parse_args(argv)
    options = {"partitioned": args.partitioned,
               "micro_batches": args.micro_batches,
               "bf16_params": args.bf16_params}

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    n_fail = 0
    for mp in meshes:
        for a in archs:
            for s in shapes:
                rec = run_cell(a, s, mp, args.out, args.skip_existing,
                               **options)
                if not (rec.get("ok") or rec.get("skipped")):
                    n_fail += 1
    print(f"[dryrun] done, failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
