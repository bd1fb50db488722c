"""Goal-conditioned environments with dict observations (counterpart:
ilswiss_tpu/envs/goal.py; `GoalReach2D`).

Observations are dicts {observation, achieved_goal, desired_goal} of
batched tensors, and the sparse threshold reward is `compute_reward`, the
hook through which hindsight relabeling (data/her.py) recomputes rewards.
`GoalReach2D` is the analytic point-mass reach task of the JAX package;
its reset draws are the two uniforms of the JAX `_reset`, taken as
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ilswiss_tpu_torch.envs.base import Environment


def _distance(achieved_goal: torch.Tensor, desired_goal: torch.Tensor
              ) -> torch.Tensor:
    diff = achieved_goal - desired_goal
    return torch.sqrt(torch.sum(diff * diff, dim=-1))


class GoalReach2D(Environment):
    """A velocity-controlled point mass must reach a random 2D goal.

    obs = {observation: [x, y, vx, vy], achieved_goal: [x, y],
           desired_goal: [gx, gy]}; reward 0 within `distance_threshold`
    of the goal, else -1 (sparse, Fetch-style); the episode terminates on
    success.  The internal state is (pos_vel [B, 4], goal [B, 2])."""

    observation_size = 4   # the non-goal part
    goal_size = 2
    action_size = 2
    discrete = False
    max_episode_steps = 50
    action_low = np.array([-1.0, -1.0], np.float32)
    action_high = np.array([1.0, 1.0], np.float32)

    dt = 0.1
    distance_threshold = 0.05
    bound = 1.0
    sparse = True

    # --- goal API ------------------------------------------------------
    def compute_reward(self, achieved_goal: torch.Tensor,
                       desired_goal: torch.Tensor) -> torch.Tensor:
        d = _distance(achieved_goal, desired_goal)
        if self.sparse:
            return -(d >= self.distance_threshold).to(torch.float32)
        return -d

    def compute_distance(self, achieved_goal, desired_goal):
        return _distance(achieved_goal, desired_goal)

    # --- env hooks -----------------------------------------------------
    @staticmethod
    def _obs(pos_vel, goal):
        return {"observation": pos_vel, "achieved_goal": pos_vel[:, :2],
                "desired_goal": goal}

    def sample_reset_noise(self, n: int, generator: torch.Generator):
        """(start position [n, 2], goal [n, 2]), each uniform in
        [-bound, bound), the draws of the JAX `_reset`."""
        kw = dict(dtype=torch.float32, device=self.device)
        pos = torch.empty((n, 2), **kw).uniform_(-self.bound, self.bound,
                                                 generator=generator)
        goal = torch.empty((n, 2), **kw).uniform_(-self.bound, self.bound,
                                                  generator=generator)
        return pos, goal

    def _reset(self, noise):
        pos, goal = noise
        pos_vel = torch.cat([pos, torch.zeros_like(pos)], dim=-1)
        return (pos_vel, goal), self._obs(pos_vel, goal)

    def _step(self, internal, action):
        pos_vel, goal = internal
        vel = torch.clamp(action, -1.0, 1.0)
        pos = torch.clamp(pos_vel[:, :2] + vel * self.dt,
                          -self.bound, self.bound)
        new_pv = torch.cat([pos, vel], dim=-1)
        reward = self.compute_reward(pos, goal)
        if self.sparse:
            terminal = reward >= -0.5
        else:
            terminal = self.compute_distance(pos, goal) \
                < self.distance_threshold
        return (new_pv, goal), self._obs(new_pv, goal), reward, terminal
