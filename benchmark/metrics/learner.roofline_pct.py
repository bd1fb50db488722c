"""The K-step chain's least time (`k2_bound_ms`, bf16 products) over the
device time of everything launched under the learn span: the draws, the
[K, B] gather and the chain."""

from benchmark.work.learner import k2_bound_ms


def read(run):
    tr, s = run.trace, run.shapes
    device_s = tr.device_s("bench.learn") if tr else None
    if not device_s:
        return None
    least = k2_bound_ms(s.batch, s.obs, s.act, s.hidden, s.layers, s.K)
    return 100.0 * least * tr.count("bench.learn") / (device_s * 1e3)
