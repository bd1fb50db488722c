"""Model FLOPs over time and the bf16 peak, in the traced run's window
before the profiler starts (closed by a synchronize): each iteration's K
gradient steps' products (`k2_work`) and its acting forward; physics is
not counted."""

from benchmark.work.acting import policy_forward_work
from benchmark.work.learner import k2_work
from benchmark.work.peaks import PEAK_BF16_FLOPS


def read(run):
    if run.trace is None:
        return None
    s, w = run.shapes, run.window
    flops = (k2_work(s.batch, s.obs, s.act, s.hidden, s.layers, s.K)[1]
             + policy_forward_work(s.envs, s.obs, s.act, s.hidden,
                                   s.layers)[1])
    return 100.0 * flops * w.clean_iterations / (
        w.clean_seconds * PEAK_BF16_FLOPS)
