"""Scripted expert policies for analytic envs (counterpart:
ilswiss_tpu/envs/experts.py; `pendulum_expert`, `mountain_expert`,
`SCRIPTED_EXPERTS`).

Each maps a batch of observations [..., obs] to normalized actions
[..., 1] in [-1, 1] with the JAX package's formulas, thresholds included:
the `sign(thdot + 1e-6)` of the pendulum's energy pump and its `near_top`
test decide where a scripted action flips.  `run_gen_expert` rolls them
to make demos, and DAgger queries them to relabel its rollouts.
"""

from __future__ import annotations

import torch


def pendulum_expert(obs: torch.Tensor) -> torch.Tensor:
    """Energy-shaping swing-up plus a PD hold near the top for Pendulum.

    obs [..., 3] = (cos th, sin th, thdot); returns [..., 1] (the env
    scales it to +-2 torque)."""
    cos_th, sin_th, thdot = obs[..., 0], obs[..., 1], obs[..., 2]
    angle = torch.atan2(sin_th, cos_th)  # 0 at the top

    # per-unit (m l^2) energy with g = 10, l = 1
    energy = 0.5 * thdot ** 2 + 10.0 * cos_th
    e_target = 10.0

    # energy pumping: push along thdot while under-energized
    pump = torch.clamp(
        2.0 * (e_target - energy) * torch.sign(thdot + 1e-6), -1.0, 1.0)
    # PD hold near the top
    pd = torch.clamp(-8.0 * angle - 2.0 * thdot, -2.0, 2.0) / 2.0

    near_top = torch.logical_and(torch.abs(angle) < 0.35,
                                 torch.abs(thdot) < 8.0)
    return torch.where(near_top, pd, pump)[..., None]


def mountain_expert(obs: torch.Tensor) -> torch.Tensor:
    """Bang-bang energy pumping for MountainCarContinuous: push along the
    sign of the velocity.  obs [..., 2] = (position, velocity)."""
    return torch.sign(obs[..., 1] + 1e-8)[..., None]


# env name -> scripted controller fn(obs) -> normalized action, for the
# gen_expert specs' `use_scripted_policy`
SCRIPTED_EXPERTS = {
    "pendulum": pendulum_expert,
    "mountain": mountain_expert,
}
