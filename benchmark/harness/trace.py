"""Reading a `torch.profiler` trace of whole iterations.

Device operations (kernels, copies, sets) come from the trace's device
timeline.  Each is tied to the host call that launched it by the trace's
correlation id, and through that call's time to the innermost benchmark
span (`bench.<layer>`, a `record_function` of the harness's own) that was
open on the host when it was launched.  Kernels launched from the port's
own libraries through ctypes are tied the same way: their runtime launch
call is traced like any other.

`window` is the traced stretch on the trace's clock: from the start of the
first `bench.iter` span after the dropped ones to the end of the closing
`bench.sync` span, which waits for the device.  Operation names are
shortened to the kernel's own name (and the functor of an elementwise
kernel).
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field

SPAN_PREFIX = "bench."


def _ns(e) -> tuple[int, int]:
    start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
    dur = (e.duration_ns() if hasattr(e, "duration_ns")
           else e.duration_us() * 1000)
    return int(start), int(start + dur)


def _on_device(e) -> bool:
    return "CUDA" in str(e.device_type())


@dataclass
class Trace:
    window_s: float
    busy_s: float
    # span name -> [count, device seconds of the ops launched under it,
    # device ops launched under it]
    spans: dict = field(default_factory=dict)
    ops: dict = field(default_factory=dict)      # op name -> device seconds
    gaps: dict = field(default_factory=dict)     # open span -> idle seconds

    def device_s(self, span: str) -> float | None:
        s = self.spans.get(span)
        return s[1] if s and s[0] else None

    def count(self, span: str) -> int:
        return self.spans.get(span, [0])[0]

    def op_count(self, span: str) -> int:
        return self.spans.get(span, [0, 0.0, 0])[2]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Spans:
    """Innermost-span lookup over nested host spans, with each span's
    enclosing spans."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent = []
        stack: list = []
        for i, (a, b, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < a:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def at(self, t: int) -> int | None:
        """Index of the innermost span open at t, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            a, b, _ = self.spans[i]
            if a <= t <= b:
                return i
            i = self.parent[i] if self.parent[i] is not None else i - 1
        return None

    def chain(self, i: int | None):
        while i is not None:
            yield self.spans[i][2]
            i = self.parent[i]

    def name(self, t: int) -> str:
        i = self.at(t)
        return self.spans[i][2] if i is not None else "(no span)"


def short_name(name: str) -> str:
    """`void at::native::elementwise_kernel<128, 2, ...MulFunctor...>(...)`
    -> `elementwise_kernel:MulFunctor`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("std::enable_if<"):       # a templated return type
        depth = 0
        for i, ch in enumerate(name):
            depth += (ch == "<") - (ch == ">")
            if ch == ">" and depth == 0:
                name = name[i + 1:].split(" ", 1)[-1]
                break
    base = name[5:] if name.startswith("void ") else name
    cut = min([i for i in (base.find("<"), base.find("(")) if i > 0]
              or [len(base)])
    functors = re.findall(r"\w+Functor\w*|normal_kernel|uniform_kernel",
                          base[cut:])
    parts = base[:cut].strip().split("::")
    base = "::".join(parts[-2:]) if parts[-1] == "kernel" else parts[-1]
    return f"{base}:{functors[-1]}" if functors else base


def read(events, skip_iters: int = 0) -> Trace:
    """The trace of `events` (the profiler's kineto events), from the
    `skip_iters`+1-th `bench.iter` span on."""
    host_spans, launches, device_ops = [], {}, []
    for e in events:
        name = e.name()
        if _on_device(e):
            if not name.startswith(SPAN_PREFIX):
                device_ops.append((*_ns(e), name, e.correlation_id()))
        elif name.startswith(SPAN_PREFIX):
            host_spans.append((*_ns(e), name))
        elif e.correlation_id():
            launches[e.correlation_id()] = _ns(e)[0]
    iters = sorted(s for s in host_spans if s[2] == "bench.iter")[skip_iters:]
    syncs = [s for s in host_spans if s[2] == "bench.sync"]
    if not iters or not syncs:
        raise ValueError("the trace holds no bench.iter or bench.sync span")
    t0 = iters[0][0]
    t1 = max(s[1] for s in syncs)
    spans = _Spans(host_spans)
    per_span: dict = defaultdict(lambda: [0, 0.0, 0])
    for a, b, name in host_spans:
        if a >= t0 and b <= t1:
            per_span[name][0] += 1
    ops: dict = defaultdict(float)
    intervals = []
    for a, b, name, corr in device_ops:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        intervals.append((a, b))
        ops[short_name(name)] += (b - a) / 1e9
        at = launches.get(corr)
        owner = spans.at(at) if at is not None else None
        if owner is None:
            per_span["(no span)"][1] += (b - a) / 1e9
        # a span's device time counts what was launched under it or under
        # any span inside it
        for span in spans.chain(owner):
            per_span[span][1] += (b - a) / 1e9
            per_span[span][2] += 1
    busy = _merge(intervals)
    busy_ns = sum(b - a for a, b in busy)
    gaps: dict = defaultdict(float)
    edge = t0
    for a, b in busy + [[t1, t1]]:
        if a > edge:
            gaps[spans.name(edge)] += (a - edge) / 1e9
        edge = max(edge, b)
    return Trace(window_s=(t1 - t0) / 1e9, busy_s=busy_ns / 1e9,
                 spans=dict(per_span), ops=dict(ops), gaps=dict(gaps))


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
