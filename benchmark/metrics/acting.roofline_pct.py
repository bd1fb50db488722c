"""The acting call's least time (the policy forward and its sample, from
shapes) over the device time of everything launched under the act span."""

from benchmark.work.acting import acting_bound_ms


def read(run):
    tr, s = run.trace, run.shapes
    device_s = tr.device_s("bench.act") if tr else None
    if not device_s:
        return None
    least = acting_bound_ms(s.envs, s.obs, s.act, s.hidden, s.layers)
    return 100.0 * least * tr.count("bench.act") / (device_s * 1e3)
