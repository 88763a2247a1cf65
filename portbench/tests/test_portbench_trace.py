"""The trace reader on a hand-made list of profiler events."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench.trace import Trace


def _ev(name, dev, start, end, corr=0, link=0, thread=1, shapes=(),
        dtypes=()):
    return SimpleNamespace(
        name=lambda: name, device_type=lambda: dev, start_ns=lambda: start,
        end_ns=lambda: end, correlation_id=lambda: corr,
        linked_correlation_id=lambda: link, start_thread_id=lambda: thread,
        is_async=lambda: False, shapes=lambda: list(shapes),
        dtypes=lambda: list(dtypes))


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
EVENTS = [
    # the Adam scope holds one op that launches two kernels
    _ev("adam_update", CPU, 0, 100, corr=1),
    _ev("aten::add_", CPU, 10, 20, corr=2),
    _ev("k_add", CUDA, 30, 50, link=2),
    _ev("k_add", CUDA, 40, 70, link=2),
    # a weight cast: aten::to holds aten::_to_copy (a float matrix) holds
    # aten::copy_, whose kernel links the innermost op
    _ev("aten::to", CPU, 200, 260, corr=3),
    _ev("aten::_to_copy", CPU, 205, 255, corr=4, shapes=[[64, 32]],
        dtypes=["float"]),
    _ev("aten::copy_", CPU, 210, 250, corr=5),
    _ev("k_copy", CUDA, 300, 310, link=5),
    # an activation cast (three dimensions) whose kernel links aten::to
    _ev("aten::to", CPU, 400, 460, corr=6),
    _ev("aten::_to_copy", CPU, 405, 455, corr=7, shapes=[[2, 8, 32]],
        dtypes=["c10::BFloat16"]),
    _ev("k_copy", CUDA, 500, 540, link=6),
    # the profiler's pad kernels are never counted
    _ev("spin_kernel", CUDA, 600, 700, link=0),
]


@pytest.fixture
def trace():
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: EVENTS)))
    return Trace(prof, spans={"adam_update"}, shaped={"aten::_to_copy"})


def test_busy_is_the_union_of_device_events(trace):
    # [30, 70] + [300, 310] + [500, 540]
    assert trace.busy_s() == pytest.approx(90e-9)


def test_kernels_by_name(trace):
    assert trace.kernel_s(r"\bk_copy\b") == (pytest.approx(50e-9), 2)
    assert trace.kernel_s("spin") == (0.0, 0)


def test_device_time_inside_a_scope_and_a_picked_op(trace):
    assert trace.launched_in_s("adam_update") == pytest.approx(50e-9)

    def weight(sd):
        shapes, dtypes = sd
        return len(shapes[0]) == 2 and dtypes[0] == "float"
    assert trace.launched_in_s("aten::_to_copy", weight) == \
        pytest.approx(10e-9)
    assert trace.launched_in_s("aten::_to_copy") == pytest.approx(50e-9)


def test_breakdown_names_ops_and_the_gaps_before_them(trace):
    b = trace.breakdown()
    assert b["device_ops"][0] == ["k_add", pytest.approx(50e-9)]
    gaps = dict(b["idle_gaps"])
    assert gaps == {"aten::copy_": pytest.approx(230e-9),
                    "aten::to": pytest.approx(190e-9)}


def test_a_span_that_was_not_collected_is_an_error(trace):
    with pytest.raises(KeyError):
        trace.launched_in_s("moe_ffn")
    # collected without its shapes: a test of them is an error too
    plain = Trace(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: EVENTS))),
        spans={"aten::_to_copy"})
    assert plain.launched_in_s("aten::_to_copy") == pytest.approx(50e-9)
    with pytest.raises(KeyError):
        plain.launched_in_s("aten::_to_copy", lambda sd: True)
