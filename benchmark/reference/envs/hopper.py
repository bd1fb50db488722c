"""The reference's Hopper, gymnasium v5's rules over the plain planar
physics (`benchmark/reference/planar.py`)."""

from __future__ import annotations

import torch

from benchmark.reference.locomotion import SOLVER_ITERS, LocomotionEnv
from benchmark.reference.planar import PlanarModel, planar_control_step


class Env(LocomotionEnv):
    model_name = "hopper"

    def __init__(self, device, dtype=torch.float32):
        super().__init__(device, dtype)
        self.planar = PlanarModel(self.model)

    def reset_obs(self, dq, dqd):
        """The observation of a reset from the noise (dq, dqd)."""
        q, qd = self.qpos0 + self._t(dq), self._t(dqd)
        return torch.cat([q[:, 1:], torch.clamp(qd, -10.0, 10.0)], -1)

    def step(self, q, qd, warm, normalized_action) -> dict:
        q, qd, warm = self._t(q), self._t(qd), self._t(warm)
        ctrl = self.ctrl(normalized_action)
        q1, qd1, _, _, _ = planar_control_step(
            self.planar, q, qd, ctrl, warm, SOLVER_ITERS)
        obs = torch.cat([q1[:, 1:], torch.clamp(qd1, -10.0, 10.0)], -1)
        state = torch.cat([q1[:, 2:], qd1], -1)
        z, angle = q1[:, 1], q1[:, 2]
        healthy = (self.finite(q1, qd1) & (state.abs() < 100.0).all(-1)
                   & (z > 0.7) & (angle.abs() < 0.2))
        margin = torch.minimum(
            torch.minimum(100.0 - state.abs().amax(-1), (z - 0.7).abs()),
            (0.2 - angle.abs()).abs())
        reward = (self.x_velocity(q, q1) + 1.0
                  - 1e-3 * (ctrl ** 2).sum(-1))
        return {"next_obs": obs, "reward": reward,
                "terminal": ~healthy, "margin": margin}
