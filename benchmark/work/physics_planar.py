"""Work of one planar control step (kernel K1's), counted from the model's
shapes (copied from `chip_smoke.py`).  `pm` is the reference's
`PlanarModel` (benchmark/reference/planar.py)."""

from benchmark.work.peaks import PEAK_F32_FLOPS, bound_ms


def k1_work(pm, B: int, iters: int, damped: bool) -> tuple[float, float]:
    """(bytes, flops) of one evaluation of B envs, counted from the
    kernel's loops: each input read and each output written once; flops
    of the mass matrix, Cholesky, W solves, row set-up, the PGS sweeps
    and the constraint force."""
    nv, nrow, nu = pm.nv, pm.nrow, len(pm.act_dof)
    nbytes = 4 * B * ((2 * nv + nu + nrow) + (2 * nv + nrow)
                      + (nv if damped else 0))
    ncols = 2 * pm.ncon + len(pm.limit_dofs) + 1 + (1 if damped else 0)
    per_env = (
        6 * sum(len(d) ** 2 for d in pm.dofs_of) / 2     # mass matrix
        + nv ** 3 / 3 * (2 if damped else 1)             # Cholesky
        + ncols * 2 * nv * nv                            # triangular solves
        + nrow * (4 * nv + 20)                           # row set-up
        + nrow * 2 * nv                                  # warm-start u
        + iters * nrow * (4 * nv + 6)                    # PGS sweeps
        + nrow * 2 * nv)                                 # qfrc_con
    return nbytes, per_env * B


def k1_step_work(pm, B: int, iters: int) -> tuple[float, float]:
    """(bytes, flops) of one control step of B envs: q, qd, ctrl and the
    warm-start forces read once, q, qd, qfrc_con, f, q_ev and qd_ev
    written once; the flops of its evaluations (4 per RK4 substep, 1
    damped one per Euler substep) and of the integrator's combinations."""
    nv, nrow, nu = pm.nv, pm.nrow, len(pm.act_dof)
    euler = pm.integrator == "euler"
    evals = pm.frame_skip * (1 if euler else 4)
    flops = evals * k1_work(pm, B, iters, euler)[1] \
        + pm.frame_skip * B * nv * (4 if euler else 30)
    return 4 * B * ((2 * nv + nu + nrow) + (5 * nv + nrow)), flops


def k1_step_bound_ms(pm, B: int, iters: int) -> float:
    return bound_ms(*k1_step_work(pm, B, iters), PEAK_F32_FLOPS)
