"""Continuous mountain car, analytic dynamics (counterpart:
ilswiss_tpu/envs/classic/mountain_car.py; gym `MountainCarContinuous-v0`
semantics).  The internal state is one [B, 2] tensor (position,
velocity), and the observation is a copy of it."""

from __future__ import annotations

import numpy as np
import torch

from ilswiss_tpu_torch.envs.base import Environment


class MountainCarContinuous(Environment):
    observation_size = 2
    action_size = 1
    discrete = False
    max_episode_steps = 999
    action_low = np.array([-1.0], np.float32)
    action_high = np.array([1.0], np.float32)

    min_position = -1.2
    max_position = 0.6
    max_speed = 0.07
    goal_position = 0.45
    power = 0.0015

    def sample_reset_noise(self, n: int, generator: torch.Generator):
        """(position [n] uniform in [-0.6, -0.4),), the draw of the JAX
        `_reset`."""
        pos = torch.empty(n, dtype=torch.float32, device=self.device)
        return (pos.uniform_(-0.6, -0.4, generator=generator),)

    def _reset(self, noise):
        (pos,) = noise
        state = torch.stack([pos, torch.zeros_like(pos)], dim=-1)
        return (state,), state.clone()

    def _step(self, internal, action):
        (state,) = internal
        position, velocity = state[:, 0], state[:, 1]
        force = torch.clamp(action[:, 0], -1.0, 1.0)
        velocity = (velocity + force * self.power
                    - 0.0025 * torch.cos(3.0 * position))
        velocity = torch.clamp(velocity, -self.max_speed, self.max_speed)
        position = position + velocity
        position = torch.clamp(position, self.min_position, self.max_position)
        velocity = torch.where(
            (position <= self.min_position) & (velocity < 0.0),
            torch.zeros_like(velocity), velocity)
        terminal = position >= self.goal_position
        reward = (torch.where(terminal, 100.0, 0.0) - 0.1 * force ** 2)
        state = torch.stack([position, velocity], dim=-1)
        return (state,), state.clone(), reward, terminal
