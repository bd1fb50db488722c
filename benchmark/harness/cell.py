"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the metrics.

The configuration's `algorithm` names the file under `algos/` that
builds the system under test, sets it up from the seed (the kernels'
build comes first, on a checkout's first run) and compares what it
produced with the reference.  The window then runs the system's
iterations through the program's own call for the run's seconds, and
closes on a device synchronize.

With `trace`, spans (`record_function` and the host clock) are put around
the calls into each layer that the algorithm's file names and around each
iteration, and `torch.profiler` records a stretch of whole iterations
inside the window.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import torch

from benchmark.harness import algos
from benchmark.harness.spec import Cell

TRACE_START = 0.5       # share of the window before the profiler starts
TRACE_WARM_ITERS = 2    # profiled iterations dropped from the trace
TRACE_STRETCH_S = 1.0   # host seconds of whole iterations traced, at least
TRACE_MIN_ITERS = 3


class Marks:
    """Points on the device's clock (CUDA events), or on the host's for a
    CPU rehearsal."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


class Spans:
    """Spans around the program's calls into each layer: a `record_function`
    for the trace and, while `keep`, the host clock."""

    def __init__(self):
        self.host: dict = {}
        self.keep = True

    def span(self, name: str, fn):
        def spanned(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            if self.keep:
                self.host.setdefault(name, []).append(
                    time.perf_counter() - t0)
            return out
        return spanned


def _profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def run_window(system, runner, seconds: float, marks: Marks,
               trace: bool):
    """The measured window; returns (runner, window, spans, profiler or
    None).

    A traced window has three parts.  Until `TRACE_START` of it, the spans
    run without the profiler: their host times, and the rate of this part
    (closed by a synchronize), are read there, since the profiler's
    device tracing, once started, slows every later launch of the
    process.  Then the profiler runs `TRACE_WARM_ITERS` iterations, whose
    trace is dropped (its start takes seconds), and a stretch of whole
    iterations closed by a synchronize in a `bench.sync` span; the rest of
    the window runs untraced."""
    spans = None
    train_iter = system.step
    if trace:
        spans = Spans()
        for owner, method, name in system.spans:
            setattr(owner, method, spans.span(name, getattr(owner, method)))
        train_iter = spans.span("bench.iter", system.step)
    ends, metrics = [], []
    profiler, traced, prof_iters, prof_t0 = None, None, 0, 0.0
    clean = None       # (iterations, seconds) before the profiler
    start = marks.mark()
    t0 = time.perf_counter()
    try:
        while True:
            if trace and clean is None and \
                    time.perf_counter() - t0 >= TRACE_START * seconds:
                marks.sync()
                clean = (len(ends), time.perf_counter() - t0)
                spans.keep = False
                profiler = _profiler()
                profiler.__enter__()
                prof_iters = 0
            runner, m = train_iter(runner)
            ends.append(marks.mark())
            metrics.append(m)
            if profiler is not None:
                prof_iters += 1
                if prof_iters == TRACE_WARM_ITERS:
                    prof_t0 = time.perf_counter()
                if prof_iters >= TRACE_WARM_ITERS + TRACE_MIN_ITERS and \
                        time.perf_counter() - prof_t0 >= TRACE_STRETCH_S:
                    with torch.profiler.record_function("bench.sync"):
                        marks.sync()
                    profiler.__exit__(None, None, None)
                    traced, profiler = profiler, None
            # a traced run closes its stretch before the window closes
            if time.perf_counter() - t0 >= seconds and profiler is None \
                    and (clean is not None or not trace):
                break
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
    marks.sync()
    elapsed = time.perf_counter() - t0
    for owner, method, _ in system.spans:
        owner.__dict__.pop(method, None)
    intervals = [marks.ms(a, b) for a, b in zip([start] + ends[:-1], ends)]
    failed = sum(1 for m in metrics
                 if not all(math.isfinite(float(v)) for v in m.values()))
    window = SimpleNamespace(
        iterations=len(ends),
        env_steps=len(ends) * system.env_steps_per_iter,
        seconds=elapsed, intervals_ms=intervals, failed=failed,
        clean_iterations=clean[0] if clean else len(ends),
        clean_seconds=clean[1] if clean else elapsed)
    return runner, window, spans, traced


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        process_start: float, read_metric) -> dict:
    """One run; returns the result's fields.  `read_metric(name)` gives a
    metric's reader."""
    device = torch.device(device)
    marks = Marks(device)
    if device.type == "cuda":
        from ilswiss_tpu_torch.kernels import build
        build.build_all()
    algo = algos.load(cell.config["algorithm"])
    system = algo.build(cell.config, cell.traffic, device)
    runner, cap = algo.set_up(system, cell.config, cell.traffic, seed,
                              device)
    marks.sync()
    setup_s = time.time() - process_start

    runner, window, spans, traced = run_window(system, runner, seconds, marks,
                                               trace)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    shapes, planar = system.shapes, system.planar
    system = runner = None
    if device.type == "cuda":
        torch.cuda.empty_cache()

    correct, checks = algo.compare(cap, cell.config, cell.limits, device)
    trace_summary = None
    if traced is not None:
        from benchmark.harness import trace as trace_mod
        trace_summary = trace_mod.read(
            traced.profiler.kineto_results.events(), TRACE_WARM_ITERS)
    info = SimpleNamespace(
        cell=cell, config=cell.config, traffic=cell.traffic, shapes=shapes,
        planar=planar, setup_s=setup_s, window=window,
        host=spans.host if spans else {}, trace=trace_summary)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = read_metric(m["name"])(info)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return {"correct": correct, "attempted": window.iterations,
            "failed": window.failed, "metrics": metrics,
            "memory_peak_bytes": memory_peak, "trace": trace_summary,
            "checks": checks, "samples": len(window.intervals_ms)}
