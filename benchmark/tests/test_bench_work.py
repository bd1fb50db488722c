"""The copied work counts against the figures that PERF.md uses."""

import math

from benchmark.reference import envs
from benchmark.reference.locomotion import SOLVER_ITERS
from benchmark.work.acting import acting_bound_ms, policy_forward_work
from benchmark.work.learner import k2_bound_ms, k2_work
from benchmark.work.peaks import PEAK_BF16_FLOPS, PEAK_BYTES, bound_ms
from benchmark.work.physics_planar import k1_step_bound_ms


def test_k2_products_per_gradient_step():
    # hopper: obs 11, act 3; ant: obs 105, act 8; 256 x 2, batch 512
    for (obs, act, K), gflop in (((11, 3, 128), 1.123),
                                 ((105, 8, 512), 1.417)):
        _, prod, _ = k2_work(512, obs, act, 256, 2, K)
        assert math.isclose(prod / K / 1e9, gflop, abs_tol=5e-4)


def test_k2_bounds_by_operations():
    assert math.isclose(k2_bound_ms(512, 11, 3, 256, 2, 128), 0.1533,
                        abs_tol=5e-5)
    assert math.isclose(k2_bound_ms(512, 105, 8, 256, 2, 512), 0.7776,
                        abs_tol=5e-5)
    nbytes, prod, _ = k2_work(512, 11, 3, 256, 2, 128)
    assert prod / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES


def test_k1_step_bound_at_128_envs():
    # PERF.md's kernel table: 0.000657 ms per hopper control step
    pm = envs.load("hopper", "cpu").planar
    assert math.isclose(k1_step_bound_ms(pm, 128, SOLVER_ITERS), 0.000657,
                        rel_tol=2e-3)


def test_acting_work_from_shapes():
    nbytes, flops = policy_forward_work(128, 11, 3, 256, 2)
    assert flops == 2 * 128 * (11 * 256 + 256 * 256 + 2 * 3 * 256) \
        + 10 * 128 * 3
    assert acting_bound_ms(128, 11, 3, 256, 2) == bound_ms(nbytes, flops)
