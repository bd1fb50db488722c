"""What the reference's locomotion envs share: the model table
(`models/<name>.json`), the policy-space action scaled to the control
range, and the forward speed.  Each env's reset, control step,
observation, reward and termination are in a file of its own under
`envs/`.  It imports nothing of the port.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from benchmark.reference.rigid_body import RigidModel

MODELS = Path(__file__).resolve().parent / "models"
SOLVER_ITERS = 15


class LocomotionEnv:
    """An env over the model table `models/<model>.json`, on `device` in
    `dtype`.  `planar` is the planar model where the physics is planar
    (kernel K1's work counts read it), else None.

    `step(q, qd, warm, normalized_action)` returns `next_obs`, `reward`,
    `terminal` and `margin`: how far each env's state lies from the
    nearest threshold of its termination rule.  Two computations that
    agree to rounding can disagree on a termination only where that
    margin is of the size of the rounding."""

    model_name: str = ""
    planar = None

    def __init__(self, device, dtype=torch.float32):
        self.model = RigidModel(json.loads(
            (MODELS / f"{self.model_name}.json").read_text()))
        self.dtype, self.device = dtype, torch.device(device)
        kw = dict(dtype=dtype, device=self.device)
        self.qpos0 = torch.as_tensor(self.model.qpos0, **kw)
        self.low = torch.as_tensor(self.model.ctrl_range[:, 0], **kw)
        self.high = torch.as_tensor(self.model.ctrl_range[:, 1], **kw)
        self.dt = self.model.timestep * self.model.frame_skip

    def _t(self, x):
        return x.to(device=self.device, dtype=self.dtype)

    def ctrl(self, normalized_action):
        """Policy-space actions in [-1, 1] as controls."""
        a = self._t(normalized_action)
        return torch.clamp(self.low + (a + 1.0) * 0.5 * (self.high - self.low),
                           self.low, self.high)

    def x_velocity(self, q, q1):
        return (q1[:, 0] - q[:, 0]) / self.dt

    @staticmethod
    def finite(q1, qd1):
        return torch.isfinite(q1).all(-1) & torch.isfinite(qd1).all(-1)
