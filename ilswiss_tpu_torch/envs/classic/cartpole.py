"""CartPole balance, analytic dynamics (counterpart:
ilswiss_tpu/envs/classic/cartpole.py).

gym `CartPole-v1` semantics, as in the JAX package: two discrete actions
(push left, push right), reward 1 a step, termination when the cart
leaves +-2.4 or the pole leans past 12 degrees, a 500-step limit.  The
discrete env of the DQN and discrete-SAC specs
(exp_specs/dqn/dqn_cartpole.yaml, exp_specs/sac/sac_cartpole_d.yaml).
The internal state is one [B, 4] tensor (x, x dot, theta, theta dot);
resets draw it from U(+-0.05).  Actions are integer indices [B]; any
integer dtype does, and a float action is truncated as the JAX `astype`
truncates it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ilswiss_tpu_torch.envs.base import Environment


class CartPole(Environment):
    observation_size = 4
    action_size = 2  # number of discrete actions
    discrete = True
    max_episode_steps = 500
    action_low = np.array([0], np.int32)
    action_high = np.array([1], np.int32)

    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    total_mass = masscart + masspole
    length = 0.5  # half pole length
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02
    theta_threshold = 12.0 * 2.0 * math.pi / 360.0
    x_threshold = 2.4

    def sample_reset_noise(self, n: int, generator: torch.Generator):
        """(state [n, 4] uniform in [-0.05, 0.05)), the draw of the JAX
        `_reset`."""
        return (torch.empty((n, 4), dtype=torch.float32, device=self.device)
                .uniform_(-0.05, 0.05, generator=generator),)

    def _reset(self, noise):
        (state,) = noise
        # obs is a distinct tensor from the internal state
        return (state,), state.clone()

    def _step(self, internal, action):
        (state,) = internal
        x, x_dot, theta, theta_dot = state.unbind(-1)
        push = action.reshape(-1).to(torch.int32) == 1
        force = torch.where(push, self.force_mag, -self.force_mag).to(
            state.dtype)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)

        temp = (force + self.polemass_length * theta_dot ** 2 * sintheta
                ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length
            * (4.0 / 3.0 - self.masspole * costheta ** 2 / self.total_mass))
        xacc = (temp - self.polemass_length * thetaacc * costheta
                / self.total_mass)

        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc

        state = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        terminal = torch.logical_or(torch.abs(x) > self.x_threshold,
                                    torch.abs(theta) > self.theta_threshold)
        reward = torch.ones_like(x)
        return (state,), state.clone(), reward, terminal
