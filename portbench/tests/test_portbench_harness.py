"""The harness finds configurations, cells and per-layer metrics by name
from their files, agrees with ``BENCHMARK.json``, and finds a new one of
each added as a file alone."""
from __future__ import annotations

import json
import os
import shutil

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import run
from portbench.trace import Trace

ROOT = os.path.dirname(run.HERE)


def _manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_of_the_manifest_has_its_files():
    man = _manifest()
    configs = {c["name"]: c for c in man["configs"]}
    for w in man["workloads"]:
        cell = run.load_json("workloads", w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"]
        assert cell["why"] == w["why"]
        assert run.load_module("entries", cell["entry"]).Runner
        conf = configs[w["config"]]
        assert conf["file"] == f"portbench/configs/{w['config']}.json"
        with open(os.path.join(ROOT, conf["file"])) as f:
            cfile = json.load(f)
        assert cfile["source"] == conf["source"]
        assert cfile["reduced"] == conf["reduced"]
        # a cell reports the manifest's end-to-end metrics that list it
        want = {e["name"] for e in man["end_to_end"]
                if w["name"] in e.get("workloads", [w["name"]])}
        assert set(cell["end_to_end"]) == want


def test_every_per_layer_metric_is_a_reader_of_its_own():
    man = _manifest()
    names = [m["name"] for m in man["per_layer"]]
    assert sorted(names) == run.metric_names()
    for m in man["per_layer"]:
        mod = run.load_module("metrics", m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.BETTER, mod.SOURCE) == \
            (m["unit"], m["layer"], m["moves"], m["better"], m["source"])
        assert callable(mod.read)


def test_a_new_config_cell_and_metric_are_found_by_name(tmp_path,
                                                        monkeypatch):
    copy = tmp_path / "portbench"
    shutil.copytree(run.HERE, copy, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache", "traces"))
    conf = json.loads((copy / "configs" / "minicpm3-4b.json").read_text())
    conf["model"]["n_layers"] = 31
    (copy / "configs" / "minicpm3-4b-half.json").write_text(
        json.dumps(conf))
    cell = json.loads((copy / "workloads" /
                       "minicpm3-4b.prefill-32k.json").read_text())
    cell.update(config="minicpm3-4b-half", traffic="prefill-4k")
    cell["params"]["seq"] = 4096
    (copy / "workloads" / "minicpm3-4b-half.prefill-4k.json").write_text(
        json.dumps(cell))
    (copy / "metrics" / "items_per_s.any.py").write_text(
        'UNIT = "1/s"\nLAYER = "harness"\nMOVES = "setup_s"\n\n\n'
        "def read(ctx):\n    return ctx.items / ctx.window_s\n")
    monkeypatch.setattr(run, "HERE", str(copy))
    got = run.load_json("workloads", "minicpm3-4b-half.prefill-4k")
    assert run.load_json("configs", got["config"])["model"]["n_layers"] == 31
    assert "items_per_s.any" in run.metric_names()
    ctx = type("Ctx", (), {"items": 6, "window_s": 2.0})()
    assert run.load_module("metrics", "items_per_s.any").read(ctx) == 3.0


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _ev(name, dev, start, end, corr=0, link=0):
    return SimpleNamespace(
        name=lambda: name, device_type=lambda: dev, start_ns=lambda: start,
        end_ns=lambda: end, correlation_id=lambda: corr,
        linked_correlation_id=lambda: link, start_thread_id=lambda: 1,
        is_async=lambda: False, shapes=lambda: [], dtypes=lambda: [])


def test_a_new_metric_reads_a_scope_of_its_own(tmp_path, monkeypatch):
    """A reader added as a file alone names the host scope it reads; the
    harness collects that scope for it, and a scope it did not name is an
    error, never 0."""
    copy = tmp_path / "portbench"
    shutil.copytree(run.HERE, copy, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache", "traces"))
    (copy / "metrics" / "moe_ms.train.py").write_text(
        'UNIT = "ms"\nLAYER = "models/moe.py moe_ffn"\n'
        'MOVES = "train_step_ms"\nSPANS = frozenset({"moe_ffn"})\n\n\n'
        "def read(ctx):\n"
        '    return 1e3 * ctx.trace.launched_in_s("moe_ffn") / ctx.items\n')
    (copy / "metrics" / "undeclared_ms.train.py").write_text(
        'UNIT = "ms"\nLAYER = "models/moe.py moe_ffn"\n'
        'MOVES = "train_step_ms"\n\n\n'
        "def read(ctx):\n"
        '    return 1e3 * ctx.trace.launched_in_s("moe_dispatch")\n')
    monkeypatch.setattr(run, "HERE", str(copy))
    cell = run.load_json("workloads", "deepseek-moe-16b.train-4k")
    mods = run.readers(cell)
    assert {"moe_ms.train", "adam_ms.train"} <= set(mods)
    assert "weight_cast_ms.prefill" not in mods   # moves no metric here
    spans, shaped = run.span_names(mods.values())
    assert {"moe_ffn", "adam_update"} <= spans and not shaped
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_ev("moe_ffn", cpu, 0, 100), _ev("aten::mm", cpu, 10, 20,
                                                corr=2),
              _ev("k_mm", cuda, 30, 530, link=2),
              _ev("moe_dispatch", cpu, 200, 300),
              _ev("aten::mm", cpu, 210, 220, corr=3),
              _ev("k_mm", cuda, 600, 700, link=3)]
    ctx = SimpleNamespace(entry="lm_train", items=2,
                          trace=Trace(_prof(events), spans=spans))
    assert mods["moe_ms.train"].read(ctx) == pytest.approx(250e-6)
    with pytest.raises(KeyError):
        mods["undeclared_ms.train"].read(ctx)


@pytest.mark.parametrize("name", ["repro", "jax", "jaxlib", "flax"])
def test_forbidden_modules_are_found_by_whole_top_level_name(name):
    assert run.forbidden_modules(["repro_torch", "repro_torch.models",
                                  "portbench.run", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro_torch", name + ".sub"]) == [name]
    assert run.forbidden_modules([name]) == [name]
