"""The port's perf-trajectory store and regression gate
(``repro_torch.obs.trajectory``) against the reference's
(``repro.obs.trajectory``): the same records, history files and rows give
the same validation errors, the same parsed histories, the same regression
reports, the same raise or pass of the gate and, with a fixed clock and
sha, the same appended line."""
import json

import pytest

from repro.obs import trajectory as ref
from repro_torch.obs import trajectory as port

GOOD = {"t": 1.5, "sha": "abc1234", "bench": "step", "mode": "smoke",
        "rows": [{"name": "step_ms", "value": 3.0, "unit": "ms"}]}

RECORDS = {
    "valid": GOOD,
    "extra_fields": dict(GOOD, host="x", rows=[dict(GOOD["rows"][0], n=2)]),
    "not_a_dict": [GOOD],
    "missing_sha": {k: v for k, v in GOOD.items() if k != "sha"},
    "bool_time": dict(GOOD, t=True),
    "bad_mode": dict(GOOD, mode="nightly"),
    "row_not_a_dict": dict(GOOD, rows=[("step_ms", 3.0, "ms")]),
    "row_missing_unit": dict(GOOD, rows=[{"name": "a", "value": 1.0}]),
    "row_string_value": dict(GOOD, rows=[{"name": "a", "value": "1",
                                          "unit": "ms"}]),
}


def _outcome(fn, *args, **kw):
    """("ok", result) or (the error's class name, its message)."""
    try:
        return "ok", fn(*args, **kw)
    except Exception as e:   # noqa: BLE001 (compared below)
        return type(e).__name__, str(e)


@pytest.mark.parametrize("case", list(RECORDS))
def test_validate_record_agrees(case):
    assert _outcome(port.validate_record, RECORDS[case], "rec") == \
        _outcome(ref.validate_record, RECORDS[case], "rec")


def _history(n, mode="smoke", scale=1.0, names=("a_ms", "b_ms", "c_rate")):
    units = {"a_ms": "ms", "b_ms": "ms", "c_rate": "it/s", "d_count": "x_n"}
    return [{"t": float(i), "sha": f"s{i}", "bench": "b", "mode": mode,
             "rows": [{"name": nm, "value": (10.0 + i % 3) * scale,
                       "unit": units[nm]} for nm in names]}
            for i in range(n)]


HISTORY_FILES = {
    "valid": "\n".join(json.dumps(r) for r in _history(4)) + "\n\n",
    "malformed_json": json.dumps(GOOD) + "\n{not json\n",
    "invalid_record": json.dumps(GOOD) + "\n" + json.dumps(
        dict(GOOD, mode="x")) + "\n",
}


@pytest.mark.parametrize("case", list(HISTORY_FILES) + ["missing"])
def test_read_history_agrees(tmp_path, case):
    path = tmp_path / "history.jsonl"
    if case != "missing":
        path.write_text(HISTORY_FILES[case])
    got = _outcome(port.read_history, str(path))
    assert got == _outcome(ref.read_history, str(path))
    assert got[0] == ("ok" if case in ("valid", "missing")
                      else "ObsSchemaError")


def _rows(scale=1.0, a=None, rate=None):
    return [("a_ms", (a if a is not None else 11.0) * scale, "ms"),
            {"name": "b_ms", "value": 11.0 * scale, "unit": "ms"},
            ("c_rate", (rate if rate is not None else 11.0) / scale, "it/s"),
            ("label", "fast", "")]


SCENARIOS = {
    "cold_history": (_history(2), _rows(), {}),
    "steady": (_history(6), _rows(), {}),
    "common_drift": (_history(6), _rows(scale=1.3), {}),
    "one_time_regressed": (_history(6), _rows(a=40.0), {}),
    "rate_regressed": (_history(6), _rows(rate=3.0), {}),
    "other_mode_only": (_history(6, mode="full"), _rows(a=40.0), {}),
    "window_of_two": (_history(9), _rows(a=40.0), {"window": 2,
                                                   "min_runs": 2}),
    "tight_threshold": (_history(6), _rows(a=14.0), {"threshold": 1.2}),
    "ungated_unit": (_history(6, names=("d_count",)),
                     [("d_count", 99.0, "x_n")], {}),
}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_detect_regressions_agrees(case):
    history, rows, kw = SCENARIOS[case]
    got = port.detect_regressions(history, rows, "smoke", **kw)
    assert got == ref.detect_regressions(history, rows, "smoke", **kw)
    tripped = case in ("one_time_regressed", "rate_regressed",
                       "window_of_two", "tight_threshold")
    assert bool(got["regressions"]) == tripped, got


@pytest.mark.parametrize("case", ["steady", "one_time_regressed",
                                  "cold_history"])
def test_gate_agrees(tmp_path, case):
    """The gate raises (the history file untouched) or records, alike."""
    history, rows, kw = SCENARIOS[case]
    text = "\n".join(json.dumps(r) for r in history) + "\n"
    out = {}
    for name, mod in (("port", port), ("ref", ref)):
        path = tmp_path / f"{name}.jsonl"
        path.write_text(text)
        res = _outcome(mod.gate, str(path), "b", rows, "smoke", sha="f00",
                       clock=lambda: 7.0, **kw)
        out[name] = (res, path.read_text())
    assert out["port"] == out["ref"]
    raised = out["port"][0][0] == "PerfRegressionError"
    assert raised == (case == "one_time_regressed")
    assert (out["port"][1] == text) == raised


def test_append_record_writes_the_same_line(tmp_path):
    rows = [("a_ms", 1.25, "ms"), {"name": "r", "value": 3, "unit": "it/s"},
            ("skip", "text", ""), ("flag", True, "")]
    lines = {}
    for name, mod in (("port", port), ("ref", ref)):
        path = tmp_path / name / "h.jsonl"
        rec = mod.append_record(str(path), "bench", rows, "full",
                                sha="0123abc", clock=lambda: 42.0, run=3)
        mod.append_record(str(path), "bench", rows[:1], "smoke",
                          sha="0123abc", clock=lambda: 43.0)
        lines[name] = (rec, path.read_text())
    assert lines["port"] == lines["ref"]
    assert [r["name"] for r in lines["port"][0]["rows"]] == ["a_ms", "r"]
    assert len(lines["port"][1].splitlines()) == 2
    with pytest.raises(port.ObsSchemaError):
        port.append_record(str(tmp_path / "x.jsonl"), "b", rows, "weekly",
                           sha="s", clock=lambda: 1.0)


def test_helpers_and_tables_agree():
    for xs in ([3.0], [1.0, 4.0], [5.0, 1.0, 3.0], [2.0, 2.0, 9.0, 1.0]):
        assert port._median(xs) == ref._median(xs)
    rows = [("a", 1, "ms"), {"name": "b", "value": 2.5}, ("c", None, "s")]
    assert port._as_rows(rows) == ref._as_rows(rows)
    for name in ("RECORD_FIELDS", "ROW_FIELDS", "LOWER_BETTER",
                 "HIGHER_BETTER", "DEFAULT_THRESHOLD", "DEFAULT_MIN_RUNS",
                 "DEFAULT_WINDOW"):
        assert getattr(port, name) == getattr(ref, name), name
    assert isinstance(port.git_sha(), str) and port.git_sha()
    assert issubclass(port.PerfRegressionError, AssertionError)
