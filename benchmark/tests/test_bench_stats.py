"""The rate and the tail are taken over every sample of the window."""

import importlib.util
from types import SimpleNamespace

import pytest

from benchmark.harness.spec import ROOT
from benchmark.harness.stats import percentile, rate


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_p95_sees_a_stall_that_chunk_medians_hide():
    # 400 iterations of 30 ms with 30 stalls of 200 ms, spread so that no
    # chunk of 20 holds more than two: every chunk's median stays 30 ms
    samples = [30.0] * 400
    for i in range(30):
        samples[i * 13 + 5] = 200.0
    chunks = [sorted(samples[i:i + 20])[10] for i in range(0, 400, 20)]
    assert max(chunks) == 30.0
    run = SimpleNamespace(window=SimpleNamespace(intervals_ms=samples))
    assert _reader("iter_ms_p95")(run) == 200.0
    assert percentile(samples, 95.0) == 200.0


def test_p95_needs_200_samples():
    # a cell that lists the metric and holds fewer is an error, not a
    # silently missing number
    run = SimpleNamespace(window=SimpleNamespace(intervals_ms=[1.0] * 199))
    with pytest.raises(ValueError, match="200"):
        _reader("iter_ms_p95")(run)
    run.window.intervals_ms.append(1.0)
    assert _reader("iter_ms_p95")(run) == 1.0


def test_rate_over_all_the_window():
    # a stall counts: the rate is the work over all of the time
    run = SimpleNamespace(window=SimpleNamespace(env_steps=128 * 100,
                                                 seconds=4.0))
    assert _reader("env_steps_per_s")(run) == rate(12800, 4.0) == 3200.0


def test_nearest_rank():
    assert percentile(list(range(1, 101)), 95.0) == 95
    assert percentile([5.0], 95.0) == 5.0
