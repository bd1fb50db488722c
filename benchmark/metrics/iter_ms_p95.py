"""The 95th percentile, over all of the window's iterations, of the
interval between consecutive iteration ends (CUDA events recorded on the
stream, read after the window).  The metric's `workloads` in
BENCHMARK.json names the cells whose window holds at least 200 of them,
so that at least 10 lie beyond it; a run of such a cell with fewer is an
error, not a missing number."""

from benchmark.harness.stats import percentile

MIN_SAMPLES = 200


def read(run):
    samples = run.window.intervals_ms
    if len(samples) < MIN_SAMPLES:
        raise ValueError(f"iter_ms_p95 needs {MIN_SAMPLES} iterations; the "
                         f"window held {len(samples)}")
    return percentile(samples, 95.0)
