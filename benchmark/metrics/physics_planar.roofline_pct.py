"""Kernel K1's least time for one planar control step (from the model's
shapes) over the device time of everything launched under the env step's
span.  Nothing for a model that is not planar."""

from benchmark.reference.locomotion import SOLVER_ITERS
from benchmark.work.physics_planar import k1_step_bound_ms


def read(run):
    tr = run.trace
    if run.planar is None or tr is None or not tr.device_s("bench.env"):
        return None
    least = k1_step_bound_ms(run.planar, run.shapes.envs, SOLVER_ITERS)
    return 100.0 * least * tr.count("bench.env") / (
        tr.device_s("bench.env") * 1e3)
