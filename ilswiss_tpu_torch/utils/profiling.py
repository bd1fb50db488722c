"""Phase timing + device tracing (counterpart:
ilswiss_tpu/utils/profiling.py).

Rebuild of the reference's gtimer usage (rlkit/core/base_algorithm.py:
gt.reset/set_def_unique :156-157, gt.stamp('sample'/'train'/'eval')
:284-290, read back into Train/Sample/Eval/Total time logging
:329-343).  Phases are context managers that both accumulate wall time
(host view) and open a `torch.profiler.record_function` range, so the
same names show up on the timeline of a trace.

`trace(log_dir)` records one block with `torch.profiler.profile` (the
CPU, and the card when there is one) and writes it into `log_dir` as a
Chrome trace (`*.pt.trace.json`, readable in Perfetto or TensorBoard's
profiler plugin); runners do this when the variant sets `profile_dir`.

`span(name)` marks one layer boundary of the device loop (the names of
`SPANS`).  While a profiler records, it is a range on the profiler's
clock, to which the trace ties every device operation launched inside
it (the ctypes launches of the kernels too); while none records, it is a
shared no-op context, so the hot path pays one check of the profiler's
state and never enters a profiler range, which costs microseconds a call
even with no profiler.  The range is a plain host range
(`_RecordFunctionFast`, an op of the trace's CPU timeline), not a
user-scope `record_function`: the profiler mirrors a user-scope range on
the device's timeline as an annotation over the kernels launched inside
it, which a reader of the device's busy time would count as work.  The
ranges stay in the profiler's memory until it stops: `trace` writes
them, as does any caller that runs its own `torch.profiler.profile`.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict

import torch


class PhaseTimer:
    """gtimer-style named-phase accumulator."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._times: Dict[str, float] = defaultdict(float)
        self._start = time.time()

    @contextmanager
    def phase(self, name: str):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._times[name] += time.perf_counter() - t0

    def stamp(self) -> Dict[str, float]:
        """Per-phase seconds since the last reset (+ 'total'), then
        reset — one call per epoch mirrors the reference's epoch-time
        table (base_algorithm.py:329-343)."""
        out = {f"Time/{k}": v for k, v in self._times.items()}
        out["Time/total"] = time.time() - self._start
        self.reset()
        return out


# module-global default, like the reference's module-global gtimer
TIMER = PhaseTimer()
phase = TIMER.phase
stamp = TIMER.stamp


# every name `span` is given, by layer: the device loop, acting, the env
# and its engines, the replay ring, the learner
SPANS = (
    "loop.iter", "loop.collect",
    "acting.act",
    "env.step", "env.physics", "env.reset", "env.observe",
    "physics_planar.step",
    "physics_general.linearize", "physics_general.smooth",
    "physics_general.rows", "physics_general.solve",
    "physics_general.integrate",
    "replay.add", "replay.gather",
    "learner.chain", "learner.draws", "learner.launch", "learner.steps",
)

_OFF = nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A host range named `name` (one of `SPANS`) while a profiler
    records, else a shared no-op context."""
    if _profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


@contextmanager
def trace(log_dir: str | None):
    """Trace the enclosed block into `log_dir` when it is set; no-op
    otherwise."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
