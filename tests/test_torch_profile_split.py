"""``chip_smoke.py``'s profile reader (``_split``) against torch's own
(``_split_reference``: ``key_averages()`` and the ``FunctionEvent`` tree).

``_split`` reads the profiler's kineto events directly, where torch
builds a Python object a CPU event (about 17 s a traced LM step of ~21k
device events on the card).  Here both read the same synthetic events:
nested CPU ops on two threads, ``record_function`` scopes with their
device-side annotations, ops of one name nested one in another (torch
merges those), runtime calls on another thread linked to their op,
kernels linked to ops, an async event, a partial overlap, zero-length
kernels and the profiler's spin pad.  Torch parses them with its own
``_parse_kineto_results``; the device times by name and each scope's
device time must agree.
"""
import os
import sys
import types

import numpy as np
import pytest
from torch.autograd import DeviceType
from torch.autograd.profiler import profile as autograd_profile
from torch.autograd.profiler_util import EventList

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

NAMES = ("aten::mm", "aten::copy_", "aten::add", "aten::copy_",
         "aten::to")
SCOPES = chip_smoke.LM_SCOPES


class _Event:
    """A kineto event: the accessors torch's parser and ``_split`` call;
    every other one gives a neutral value."""

    _NEUTRAL = {"stack": [], "shapes": [], "concrete_inputs": [],
                "kwinputs": {}, "dtypes": [], "structured_input_shapes": [],
                "structured_input_strides": [], "overload_name": "",
                "metadata_json": "", "extra_meta": None,
                "activity_type": "", "cuda_elapsed_us": -1,
                "privateuse1_elapsed_us": -1, "is_hidden_event": False,
                "is_python_function": False, "is_async": False}

    def __init__(self, name, device, start, end, thread, corr, link,
                 annotation=False, end_thread=None):
        self._v = {"name": name, "device_type": device, "start_ns": start,
                   "end_ns": end, "start_thread_id": thread,
                   "end_thread_id": thread if end_thread is None
                   else end_thread, "fwd_thread_id": thread,
                   "correlation_id": corr, "linked_correlation_id": link,
                   "is_user_annotation": annotation}

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        value = self._v.get(attr, self._NEUTRAL.get(attr, 0))
        return lambda: value


def _events(seed) -> list:
    rng = np.random.default_rng(seed)
    events, corr = [], [0]
    clock = [10_000]

    def new_corr():
        corr[0] += 1
        return corr[0]

    def kernel(name, link, dur=None):
        start = clock[0] + int(rng.integers(0, 50))
        if dur is None:   # some kernels take no time
            dur = int(rng.choice([0, rng.integers(1, 900)]))
        events.append(_Event(name, DeviceType.CUDA, start, start + dur, 7,
                             new_corr(), link))

    def op(name, start, end, thread, depth):
        c = new_corr()
        events.append(_Event(name, DeviceType.CPU, start, end, thread, c, 0))
        for _ in range(int(rng.integers(0, 3))):   # the op's launches
            t = int(rng.integers(start, max(start + 1, end)))
            events.append(_Event("cudaLaunchKernel", DeviceType.CPU, t,
                                 min(end, t + 2), 99, new_corr(), c))
            kernel(f"void k{int(rng.integers(0, 6))}_kernel<float>", c)
        if depth < 4 and end - start > 40:
            t = start + 1
            while t < end - 10 and rng.random() < 0.8:
                span = int(rng.integers(5, max(6, (end - t) // 2)))
                if rng.random() < 0.3:   # one child of the parent's name
                    child = name
                else:
                    child = str(rng.choice(NAMES))
                op(child, t, min(end - 1, t + span), thread, depth + 1)
                t += span + int(rng.integers(1, 5))
        clock[0] = max(clock[0], end)

    for thread in (1, 2):
        t = 0
        for _ in range(6):
            span = int(rng.integers(200, 2000))
            if rng.random() < 0.5:
                name = str(rng.choice(SCOPES))
                c = new_corr()
                events.append(_Event(name, DeviceType.CPU, t, t + span,
                                     thread, c, 0, annotation=True))
                events.append(_Event(name, DeviceType.CUDA, clock[0],
                                     clock[0] + span, 7, new_corr(), 0,
                                     annotation=True))
                op(str(rng.choice(NAMES)), t + 1, t + span - 1, thread, 1)
            else:
                op(str(rng.choice(NAMES)), t, t + span, thread, 0)
            t += span + 3
    # an async op, an op that overlaps a scope's end, the spin pad
    events.append(_Event("aten::mm", DeviceType.CPU, 5, 50, 1, new_corr(),
                         0, end_thread=2))
    events.append(_Event("aten::add", DeviceType.CPU, 150, 2_500, 2,
                         new_corr(), 0))
    kernel("aten::add_kernel_overlap", corr[0])
    for _ in range(3):
        kernel(f"void {chip_smoke.PAD_KERNEL}(long)", 0, 30)
    order = rng.permutation(len(events))
    return [events[i] for i in order]


def _profiles(events):
    result = types.SimpleNamespace(events=lambda: events,
                                   trace_start_ns=lambda: 0)
    parsed = autograd_profile._parse_kineto_results(
        types.SimpleNamespace(use_device="cuda"), result)
    tree = EventList(parsed, use_device="cuda")
    tree._build_tree()
    ours = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=result))
    torch_s = types.SimpleNamespace(key_averages=tree.key_averages,
                                    events=lambda: tree)
    return ours, torch_s


@pytest.mark.parametrize("seed", range(6))
def test_split_equals_torch_s_event_tree(seed):
    ours, torch_s = _profiles(_events(seed))
    keys, scope_ms = chip_smoke._split(ours, SCOPES)
    ref_keys, ref_scope_ms = chip_smoke._split_reference(torch_s, SCOPES)
    assert keys.keys() == ref_keys.keys()
    for k in keys:
        assert keys[k][1] == ref_keys[k][1], k
        assert keys[k][0] == pytest.approx(ref_keys[k][0], rel=1e-9), k
    assert scope_ms == pytest.approx(ref_scope_ms, rel=1e-9, abs=1e-12)
    assert any(v > 0 for v in ref_scope_ms.values())
    assert any(chip_smoke.PAD_KERNEL in k for k in keys)
