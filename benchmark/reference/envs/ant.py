"""The reference's Ant, gymnasium v5's rules over the plain rigid-body
physics (`benchmark/reference/rigid_body.py`)."""

from __future__ import annotations

import torch

from benchmark.reference.locomotion import SOLVER_ITERS, LocomotionEnv
from benchmark.reference.rigid_body import cfrc_ext, physics_step


class Env(LocomotionEnv):
    model_name = "ant"

    def reset_obs(self, dq, dqd):
        """The observation of a reset from the noise (dq, dqd)."""
        q, qd = self.qpos0 + self._t(dq), self._t(dqd)
        zero_cfrc = q.new_zeros((q.shape[0], (self.model.nbody - 1) * 6))
        return torch.cat([q[:, 2:], qd, zero_cfrc], -1)

    def step(self, q, qd, warm, normalized_action) -> dict:
        q, qd, warm = self._t(q), self._t(qd), self._t(warm)
        ctrl = self.ctrl(normalized_action)
        q1, qd1, _, f, (q_ev, _) = physics_step(
            self.model, q, qd, ctrl, iters=SOLVER_ITERS, f0=warm)
        cfrc = torch.clamp(cfrc_ext(self.model, q_ev, f), -1.0, 1.0)
        obs = torch.cat([q1[:, 2:], qd1, cfrc[:, 1:].flatten(1)], -1)
        z = q1[:, 2]
        healthy = self.finite(q1, qd1) & (z >= 0.2) & (z <= 1.0)
        margin = torch.minimum((z - 0.2).abs(), (1.0 - z).abs())
        reward = (self.x_velocity(q, q1) + healthy.to(self.dtype)
                  - 0.5 * (ctrl ** 2).sum(-1)
                  - 5e-4 * (cfrc ** 2).sum((1, 2)))
        return {"next_obs": obs, "reward": reward,
                "terminal": ~healthy, "margin": margin}
