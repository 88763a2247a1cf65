"""The readers of the program's spans inside the LM layer loop
(``moe_ms.train``, ``weight_cast_ms.train``, ``mla_expand_ms.prefill``,
``layer_idle_ms.prefill``) on hand-made profiler events: each gives the
hand-computed value, reads nothing where its spans are absent (never 0),
and is picked in exactly the cells its manifest entry lists; then a traced
run of a small cell on the CPU reports each of them."""
from __future__ import annotations

import json
import os
import shutil
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import run
from portbench.tests.small import small_cell, small_model
from portbench.trace import Trace

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
NEW = ("moe_ms.train", "weight_cast_ms.train", "mla_expand_ms.prefill",
       "layer_idle_ms.prefill")
MAIN, ENGINE = 1, 2     # the calling thread, the autograd engine's


def _ev(name, dev, start, end, corr=0, link=0, thread=MAIN):
    return SimpleNamespace(
        name=lambda: name, device_type=lambda: dev, start_ns=lambda: start,
        end_ns=lambda: end, correlation_id=lambda: corr,
        linked_correlation_id=lambda: link, start_thread_id=lambda: thread,
        is_async=lambda: False, shapes=lambda: [], dtypes=lambda: [])


def _op(name, start, corr, kernel, thread=MAIN):
    """A host op at ``start`` and the kernel it launched."""
    return [_ev(name, CPU, start, start + 10, corr=corr, thread=thread),
            _ev("k_" + name.split("::")[-1], CUDA, *kernel, link=corr)]


def _ctx(name, entry, events, items=2):
    mod = run.load_module("metrics", name)
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return mod, SimpleNamespace(entry=entry, items=items,
                                trace=Trace(prof, spans=mod.SPANS))


# the forward on the calling thread; the backward on the engine's, where
# the layer's remat recompute runs inside the MoE layer's bracket
TRAIN = [
    _ev("lm_layer", CPU, 0, 1000),
    _ev("moe_ffn", CPU, 100, 500),
    *_op("aten::mm", 110, 1, (150, 250)),            # MoE forward: 100
    _ev("weight_cast", CPU, 300, 400),
    *_op("aten::_to_copy", 310, 2, (320, 360)),      # a cast in it: 40
    *_op("aten::mul", 600, 3, (700, 750)),           # the layer, not MoE
    _ev("moe_ffn.bwd", CPU, 2000, 5000, thread=ENGINE),
    *_op("aten::mm", 2100, 4, (2200, 2400), ENGINE),      # backward: 200
    _ev("lm_layer", CPU, 2500, 3500, thread=ENGINE),
    _ev("moe_ffn", CPU, 2600, 3000, thread=ENGINE),
    *_op("aten::bmm", 2700, 5, (2800, 2850), ENGINE),     # recompute: 50
    _ev("weight_cast", CPU, 2715, 2790, thread=ENGINE),
    *_op("aten::_to_copy", 2720, 6, (2860, 2880), ENGINE),  # cast: 20
    *_op("aten::cat", 3100, 7, (3200, 3260), ENGINE),  # recompute, not MoE
    *_op("aten::add", 4000, 8, (4100, 4130), ENGINE),     # backward: 30
    *_op("aten::add", 6000, 9, (6100, 6200), ENGINE),     # after it
]


def test_moe_ms_reads_forward_recompute_and_backward_less_the_layer():
    mod, ctx = _ctx("moe_ms.train", "lm_train", TRAIN)
    # (100 + 40 + 200 + 50 + 20 + 30) ns over 2 steps, in ms
    assert mod.read(ctx) == pytest.approx(440 / 2 * 1e-6)


def test_weight_cast_ms_reads_the_casts_of_forward_and_recompute():
    mod, ctx = _ctx("weight_cast_ms.train", "lm_train", TRAIN)
    assert mod.read(ctx) == pytest.approx((40 + 20) / 2 * 1e-6)


PREFILL = [
    *_op("aten::embedding", 0, 1, (50, 100)),
    _ev("lm_layer", CPU, 100, 1000),
    _ev("mla_expand", CPU, 150, 400),
    *_op("aten::mm", 160, 2, (200, 300)),            # gap 100, expand 100
    *_op("aten::cat", 300, 3, (500, 580)),           # gap 200, expand 80
    *_op("aten::mm", 500, 4, (600, 700)),            # gap 20
    *_op("aten::mm", 520, 5, (650, 750)),            # overlaps: no gap
    _ev("lm_layer", CPU, 1000, 1800),
    *_op("aten::mm", 1010, 6, (1800, 1900)),         # gap 1050
    *_op("aten::mm", 2000, 7, (2400, 2500)),         # the head: gap 500
    *_op("aten::embedding", 3000, 8, (3100, 3200)),  # next request: 600
]


def test_mla_expand_ms_reads_the_expansion():
    mod, ctx = _ctx("mla_expand_ms.prefill", "lm_prefill", PREFILL)
    assert mod.read(ctx) == pytest.approx((100 + 80) / 2 * 1e-6)


def test_layer_idle_ms_counts_gaps_launched_inside_a_layer_only():
    mod, ctx = _ctx("layer_idle_ms.prefill", "lm_prefill", PREFILL)
    assert mod.read(ctx) == pytest.approx((100 + 200 + 20 + 1050) / 2
                                          * 1e-6)


@pytest.mark.parametrize("name, entry, events", [
    ("moe_ms.train", "lm_train", TRAIN),
    ("weight_cast_ms.train", "lm_train", TRAIN),
    ("mla_expand_ms.prefill", "lm_prefill", PREFILL),
    ("layer_idle_ms.prefill", "lm_prefill", PREFILL),
])
def test_a_reader_reads_nothing_where_its_spans_are_absent(name, entry,
                                                           events):
    """A program without the spans (an older one) leaves the metric out of
    the result line: None, never 0; so does a cell of the other entry.  A MoE reading without its backward range
    would be a part of it: any of the three spans missing reads nothing."""
    mod, ctx = _ctx(name, entry, events)
    for span in mod.SPANS:
        _, without = _ctx(name, entry,
                          [e for e in events if e.name() != span])
        assert mod.read(without) is None
    other = "lm_prefill" if entry == "lm_train" else "lm_train"
    assert mod.read(SimpleNamespace(entry=other, items=2,
                                    trace=ctx.trace)) is None


def test_the_readers_are_picked_in_exactly_their_listed_cells():
    with open(os.path.join(os.path.dirname(run.HERE),
                           "BENCHMARK.json")) as f:
        man = json.load(f)
    entries = {m["name"]: m for m in man["per_layer"]}
    for w in man["workloads"]:
        picked = run.readers(run.load_json("workloads", w["name"]))
        for name in NEW:
            assert (name in picked) == (w["name"] in
                                        entries[name]["workloads"])
            assert entries[name]["source"] == "program_span"
    spans = set()
    for name in NEW:
        spans |= run.load_module("metrics", name).SPANS
    assert spans == {"moe_ffn", "moe_ffn.bwd", "lm_layer", "weight_cast",
                     "mla_expand"}


@pytest.mark.parametrize("name, cut, want", [
    ("deepseek-moe-16b.train-4k", dict(seq=64),
     {"moe_ms.train", "weight_cast_ms.train"}),
    ("minicpm3-4b.prefill-b16x512",
     dict(batch=2, seq=32, check_horizon=3, check_requests=1, check_seqs=2,
          check_rows=4),
     {"mla_expand_ms.prefill", "layer_idle_ms.prefill"}),
])
def test_a_traced_cpu_run_reports_the_new_readings(name, cut, want,
                                                   tmp_path, monkeypatch):
    """The program opens the spans the readers read: a traced run of a
    small cell reports each (0 on the CPU, where no device event is
    traced: the spans were found, their device time is none).  The run
    writes its trace summary into a copy of the harness."""
    copy = tmp_path / "portbench"
    shutil.copytree(run.HERE, copy, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    monkeypatch.setattr(run, "HERE", str(copy))
    torch.manual_seed(0)
    cell = small_cell(name, **cut)
    res = run.run_cell(name, 2 ** 40 + 5, 0.05, True, torch.device("cpu"),
                       cell=cell, model=small_model(cell["config"]))
    assert want <= set(res["metrics"])
    assert all(res["metrics"][m]["value"] == 0.0 for m in want)
