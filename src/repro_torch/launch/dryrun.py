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
* ``notes`` — what the record does not model: torch emits no partitioned
  program, so there is no collective term and no per-device activation
  estimate.

The reference's unrolled reduced-depth FLOP fit (``_measure_layers``,
``--no-unroll``) is not needed: a meta trace runs every layer.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--skip-existing] [--out DIR]

It runs on the CPU (``meta`` is no device) and needs no card; the records
go to ``dryrun_out/`` at the repository's root unless ``--out`` says.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCHS, SHAPES, active_param_count,
                                 get_config, param_count)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.nets import tree_leaves
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import wkv6 as WK
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, MeshPlan,
                                     make_production_mesh)
from repro_torch.launch.train import lm_train_step
from repro_torch.models import batch_struct, build_model
from repro_torch.models.sharding import P, rules_for
from repro_torch.models.sharding import spec as lspec
from repro_torch.optim import adam as adam_lib

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
                   "not partitioned; the partitioned dry run (ROADMAP "
                   "Queue 1 item 2) would count its collectives with "
                   "utils.collectives",
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

    def __init__(self, roots):
        super().__init__()
        self.live, self._refs, self.read = {}, {}, set()
        self.cur = self.peak = self.traffic = 0
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
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
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


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               cfg_override: ModelConfig | None = None,
               mesh: MeshPlan | None = None,
               shape_override: ShapeConfig | None = None):
    """Trace one cell's step on the meta device.  Returns (outputs, record):
    the step's outputs as meta tensors ((params, Adam state, loss) for
    train, the logits for prefill, (logits, cache) for decode), or None
    for a skipped cell.  ``mesh`` replaces the production mesh (any shape
    of ``launch.mesh.make_production_mesh``), ``shape_override`` the
    cell's batch and sequence."""
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
    model = build_model(cfg, META)
    rec = {"arch": arch, "shape": shape.name, "kind": shape.kind,
           "mesh": mesh.name, "n_devices": mesh.n_devices}

    args = cell_arguments(model, shape, rules)
    trees = [t for t, _ in args]
    logits_spec = lspec("batch", None, "vocab", rules=rules)
    if shape.kind == "train":
        def step():
            params, opt, loss, _ = lm_train_step(model, *trees, 0, 1e-4, 1)
            return params, opt, loss

        out_specs = (args[0][1], args[1][1], P())
    elif shape.kind == "prefill":
        def step():
            return model.prefill(*trees)

        out_specs = logits_spec
    else:  # decode
        def step():
            return model.decode_step(*trees, shape.seq_len - 1)

        out_specs = (logits_spec, args[1][1])

    out, mm_flops, traffic, peak, read, calls, work = _traced(
        step, [t for tree in trees for t in tree_leaves(tree)])

    out_pairs = list(zip(out, out_specs)) if isinstance(out, tuple) \
        else [(out, out_specs)]
    n_out = sum(len(list(_pairs(t, s))) for t, s in out_pairs)
    rec["memory"] = {
        "argument_size_in_bytes": sum(_device_bytes(mesh, t, s, read)
                                      for t, s in args)
        # decode's position: a traced int32 scalar in the reference's step,
        # dropped where the step never reads it (the port's is a Python int)
        + (4 if shape.kind == "decode" and model.decode_reads_pos else 0),
        "output_size_in_bytes": sum(_device_bytes(mesh, t, s)
                                    for t, s in out_pairs)
        + (8 * n_out if n_out > 1 else 0),
    }
    rec["peak_bytes"] = peak
    rec["flops"] = float(mm_flops + work["flops"])
    rec["bytes"] = float(traffic + work["bytes"])
    rec["flops_per_device"] = rec["flops"] / mesh.n_devices
    rec["bytes_per_device"] = rec["bytes"] / mesh.n_devices
    rec["kernel_calls"] = calls
    _finalize_roofline(rec, arch, shape)
    return out, rec


def _finalize_roofline(rec: dict, arch: str, shape: ShapeConfig) -> None:
    rec["roofline"] = {
        "compute_s": rec["flops_per_device"] / PEAK_FLOPS_BF16,
        "memory_s": rec["bytes_per_device"] / HBM_BW,
    }
    rec["roofline"]["dominant"] = max(rec["roofline"],
                                      key=rec["roofline"].get)
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
    rec["notes"] = NOTES
    rec["ok"] = True


def run_cell(arch, shape_name, multi_pod, out_dir, skip_existing=False):
    os.makedirs(out_dir, exist_ok=True)
    mesh = make_production_mesh(multi_pod=multi_pod)
    tag = f"{arch}__{shape_name}__{mesh.name}"
    path = os.path.join(out_dir, tag + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        if old.get("ok") or old.get("skipped"):
            print(f"[dryrun] {tag}: cached")
            return old
    try:
        out, rec = lower_cell(arch, shape_name, multi_pod)
        del out
        if rec.get("skipped"):
            print(f"[dryrun] {tag}: SKIP ({rec['reason']})")
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
                    "bytes.  Runs on the CPU; needs no card.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    n_fail = 0
    for mp in meshes:
        for a in archs:
            for s in shapes:
                rec = run_cell(a, s, mp, args.out, args.skip_existing)
                if not (rec.get("ok") or rec.get("skipped")):
                    n_fail += 1
    print(f"[dryrun] done, failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
