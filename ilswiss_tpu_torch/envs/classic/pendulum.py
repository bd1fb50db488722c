"""Pendulum swing-up, analytic dynamics (counterpart:
ilswiss_tpu/envs/classic/pendulum.py).

gym `Pendulum-v1` semantics, as in the JAX package: the reference registers
it as 'pendulum' (rlkit/envs/envs_dict.py) and trains SAC on it
(exp_specs/sac/sac_pendulum.yaml).  The internal state is one [B, 2]
tensor (theta, theta dot); the episode never terminates and is cut at 200
steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ilswiss_tpu_torch.envs.base import Environment


def _angle_normalize(x):
    return ((x + math.pi) % (2.0 * math.pi)) - math.pi


class Pendulum(Environment):
    observation_size = 3
    action_size = 1
    discrete = False
    max_episode_steps = 200
    action_low = np.array([-2.0], np.float32)
    action_high = np.array([2.0], np.float32)

    dt = 0.05
    g = 10.0
    m = 1.0
    l = 1.0
    max_speed = 8.0
    max_torque = 2.0

    def _obs(self, state):
        th, thdot = state[:, 0], state[:, 1]
        return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=-1)

    def sample_reset_noise(self, n: int, generator: torch.Generator):
        """(theta [n] uniform in [-pi, pi), theta dot [n] uniform in
        [-1, 1)), the draws of the JAX `_reset`."""
        kw = dict(dtype=torch.float32, device=self.device)
        th = torch.empty(n, **kw).uniform_(-math.pi, math.pi,
                                           generator=generator)
        thdot = torch.empty(n, **kw).uniform_(-1.0, 1.0, generator=generator)
        return th, thdot

    def _reset(self, noise):
        state = torch.stack(noise, dim=-1)
        return (state,), self._obs(state)

    def _step(self, internal, action):
        (state,) = internal
        th, thdot = state[:, 0], state[:, 1]
        u = torch.clamp(action[:, 0], -self.max_torque, self.max_torque)
        cost = (_angle_normalize(th) ** 2 + 0.1 * thdot ** 2
                + 0.001 * u ** 2)
        newthdot = thdot + (
            3.0 * self.g / (2.0 * self.l) * torch.sin(th)
            + 3.0 / (self.m * self.l ** 2) * u
        ) * self.dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt
        state = torch.stack([newth, newthdot], dim=-1)
        terminal = torch.zeros_like(newth, dtype=torch.bool)
        return (state,), self._obs(state), -cost, terminal
