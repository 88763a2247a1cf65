"""Reading a ``torch.profiler`` trace of the measured window.

:class:`Trace` takes the profiler's own kineto events (without building
torch's event tree, which costs tens of seconds a window): the device
events (kernels, copies, sets), the host ops that launched each (a device
event's linked correlation id is its op's), and the host spans around
them.  From those it gives what the per-layer readers ask for: the
device's busy seconds (the union of its events), a kernel's device
seconds by name, the device seconds of the kernels launched inside a
``record_function`` scope or inside a host op that a test picks, and the
breakdown: the device operations that took most time and the longest idle
gaps by what the host launched next.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

# a profiler session drops the first device records it would collect: the
# traced window opens with PAD spin kernels, which every sum leaves out
PAD_KERNEL = "spin_kernel"
PAD = 256


class Trace:
    """``spans``: the names of the host spans (``record_function`` scopes
    or ops) the readers ask for; ``shaped``: those of them whose input
    shapes and dtypes they read (the profiler recorded shapes)."""

    def __init__(self, prof, spans=(), shaped=()):
        from torch.autograd import DeviceType

        self.shaped = frozenset(shaped)
        self.span_names = frozenset(spans) | self.shaped

        self.device = []      # (start_ns, end_ns, name, op correlation id)
        self.ops = {}         # correlation id -> (thread, start, end, name)
        spans = defaultdict(list)   # (thread, name) -> [(start, end, i)]
        self.shapes = {}      # i -> (input shapes, input dtypes)
        events = prof.profiler.kineto_results.events()
        cpu = []
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", lambda: False)() or \
                        PAD_KERNEL in name:
                    continue
                self.device.append((e.start_ns(), e.end_ns(), name,
                                    e.linked_correlation_id()))
            elif e.device_type() == DeviceType.CPU and not e.is_async():
                cpu.append((e, name))
        links = {d[3] for d in self.device}
        for e, name in cpu:
            th = e.start_thread_id()
            corr = e.correlation_id()
            if corr in links and e.linked_correlation_id() == 0:
                self.ops[corr] = (th, e.start_ns(), e.end_ns(), name)
            if name in self.span_names:
                i = len(self.shapes)
                spans[(th, name)].append((e.start_ns(), e.end_ns(), i))
                self.shapes[i] = ((e.shapes(), e.dtypes())
                                  if name in self.shaped else None)
        self.spans = {}
        for key, rows in spans.items():
            rows.sort()
            self.spans[key] = ([r[0] for r in rows], rows)
        self.device.sort()

    # ---------------------------------------------------------------- sums
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        total, end = 0, None
        for s, e, _, _ in self.device:
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def kernel_s(self, pattern: str) -> tuple[float, int]:
        """Device seconds and count of the events whose name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [(e - s) for s, e, n, _ in self.device if rx.search(n)]
        return sum(hits) / 1e9, len(hits)

    def _inside(self, op, name, test=None) -> bool:
        """Whether ``op`` (thread, start, end, name) lies in a host span
        called ``name`` on its thread, or holds one (a device event links
        the op that launched it, which may enclose the span asked for)."""
        found = self.spans.get((op[0], name))
        if not found:
            return False
        starts, rows = found
        # spans of one name on one thread do not overlap (a span nested in
        # one of its own name, once, is looked at too)
        j = bisect.bisect_right(starts, op[1]) - 1
        for s, e, i in rows[max(j - 1, 0):j + 1][::-1]:
            if e >= op[1] and (test is None or test(self.shapes[i])):
                return True
        j = bisect.bisect_left(starts, op[1])
        while j < len(rows) and rows[j][0] <= op[2]:
            if test is None or test(self.shapes[rows[j][2]]):
                return True
            j += 1
        return False

    def launched_in_s(self, name: str, test=None) -> float:
        """Device seconds of the events launched by an op that runs inside
        a host span called ``name`` (a ``record_function`` scope or an op),
        on the op's thread; ``test`` picks spans by their (shapes,
        dtypes).  A span that was not collected (a reader lists the spans
        it reads in its ``SPANS``, and in ``SHAPED`` those it tests) is an
        error, never 0."""
        if name not in (self.shaped if test else self.span_names):
            raise KeyError(f"the trace collected no host span {name!r}"
                           + (" with its shapes" if test else ""))
        total = 0
        for s, e, _, corr in self.device:
            op = self.ops.get(corr)
            if op is not None and self._inside(op, name, test):
                total += e - s
        return total / 1e9

    # ----------------------------------------------------------- breakdown
    def breakdown(self, top: int = 10) -> dict:
        """``device_ops``: the device operations that took most time, by
        name; ``idle_gaps``: the idle gaps between device events, summed
        by the host op that launched the event ending each, the longest
        sums first.  Seconds, as measured."""
        by_name = defaultdict(int)
        for s, e, n, _ in self.device:
            by_name[n[:120]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = defaultdict(int)
        end = None
        for s, e, _, corr in self.device:
            if end is not None and s > end:
                op = self.ops.get(corr)
                gaps[op[3][:120] if op else "unknown"] += s - end
            end = e if end is None else max(end, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v / 1e9] for n, v in ops],
                "idle_gaps": [[n, v / 1e9] for n, v in idle]}
