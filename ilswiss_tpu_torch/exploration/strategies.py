"""Exploration strategies as plain functions (counterpart:
ilswiss_tpu/exploration/strategies.py).

The reference wraps a policy in a strategy object
(rlkit/exploration_strategies/base.py:41-60); here, as in the JAX
package, a strategy is a function applied to the policy's action.  The
one stateful strategy (Ornstein-Uhlenbeck) carries its state explicitly.
Every draw comes in as a tensor, in place of the JAX key:

  - `ou_noise`: `eps` N(0, 1) shaped like the state;
  - `gaussian_noise`: `eps` N(0, 1) shaped like the action;
  - `epsilon_greedy`: `flip` uniforms in [0, 1) and `random_action`
    integers in [0, num_actions), both shaped like the greedy action (the
    JAX function's `k_flip` and `k_rand` draws);
  - `gaussian_and_epsilon`: `flip` ONE uniform in [0, 1) for the whole
    batch, `random_action` uniforms in [low, high) and `eps` N(0, 1),
    both shaped like the action (`k_flip`, `k_rand`, `k_noise`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass
class OUState:
    noise: torch.Tensor  # [..., action_dim]


def ou_init(shape, device=None, dtype=torch.float32) -> OUState:
    return OUState(noise=torch.zeros(shape, dtype=dtype, device=device))


def ou_noise(state: OUState, eps: torch.Tensor, theta: float = 0.15,
             sigma: float = 0.3, mu: float = 0.0, dt: float = 1.0
             ) -> tuple[torch.Tensor, OUState]:
    """Ornstein-Uhlenbeck process (reference OUStrategy): dx = theta *
    (mu - x) dt + sigma * sqrt(dt) * eps.  Returns (x + dx, its state)."""
    x = state.noise
    new = x + (theta * (mu - x) * dt + sigma * math.sqrt(dt) * eps)
    return new, OUState(noise=new)


def _frac(t: torch.Tensor, decay_period: int) -> torch.Tensor:
    return torch.clamp(t.to(torch.float32) / decay_period, 0.0, 1.0)


def gaussian_noise(action: torch.Tensor, eps: torch.Tensor,
                   sigma: float = 0.1, min_sigma: float | None = None,
                   decay_period: int | None = None,
                   t: torch.Tensor | None = None,
                   clip: tuple = (-1.0, 1.0)) -> torch.Tensor:
    """Additive Gaussian exploration with an optional linear decay of
    sigma to `min_sigma` over `decay_period` steps of `t` (reference
    GaussianStrategy)."""
    if min_sigma is not None and decay_period is not None and t is not None:
        sigma = sigma + _frac(t, decay_period) * (min_sigma - sigma)
    return torch.clamp(action + sigma * eps, clip[0], clip[1])


def epsilon_greedy(greedy_action: torch.Tensor, flip: torch.Tensor,
                   random_action: torch.Tensor, epsilon) -> torch.Tensor:
    """The random action where flip < epsilon, else the greedy one
    (reference EpsilonGreedy)."""
    return torch.where(flip < epsilon, random_action, greedy_action)


def gaussian_and_epsilon(action: torch.Tensor, flip: torch.Tensor,
                         random_action: torch.Tensor, eps: torch.Tensor,
                         epsilon: float = 0.3, sigma: float = 0.2,
                         min_sigma: float | None = None,
                         decay_period: int = 1_000_000,
                         t: torch.Tensor | None = None,
                         low: float = -1.0, high: float = 1.0
                         ) -> torch.Tensor:
    """The HER-TD3 / GCSL explorer (reference MlpGaussianAndEpsilonPolicy):
    with probability epsilon (one draw, `flip`, for the whole batch, as the
    reference's one `random.random()` per call) every env takes its uniform
    action; otherwise the action plus Gaussian noise whose sigma decays
    linearly from `sigma` to `min_sigma` over `decay_period` steps of `t`,
    clipped to [low, high]."""
    if min_sigma is None:
        min_sigma = sigma
    if t is not None and min_sigma != sigma:
        sigma = sigma - (sigma - min_sigma) * _frac(t, decay_period)
    noisy = torch.clamp(action + sigma * eps, low, high)
    return torch.where(flip < epsilon, random_action, noisy)
