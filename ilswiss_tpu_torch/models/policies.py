"""Policy heads (counterpart: ilswiss_tpu/models/policies.py;
`TanhGaussianPolicy`, `GaussianPolicy`, `GaussianNoisePolicy`,
`CategoricalPolicy`, `noisy_action`, `categorical_act`).

  - `TanhGaussianPolicy`, the SAC actor: a ReLU trunk `hidden_i`, a mean
    head `mean` and a state-dependent log-std head `log_std` clamped to
    [-20, 2]; the heads draw weight and bias from U(+-1e-3).  This module
    is the training forward (autograd); acting can take the fused kernel
    instead (ops/fused_mlp.py).
  - `GaussianPolicy`, the PPO actor: an unbounded diagonal Gaussian with
    the same trunk and mean head, and a log-std parameter `log_std` [A]
    (zeros) broadcast to the mean's shape, or a head `log_std` where
    `state_dependent_std`; clamped to [-20, 2].
  - `GaussianNoisePolicy`, the TD3 / DDPG actor: one MLP `mlp` with a
    tanh output, its output layer drawn from U(+-1e-3).  Exploration noise
    is added by the caller (`noisy_action`).
  - `CategoricalPolicy`, the discrete SAC actor: one MLP `mlp` giving
    logits.

The noise of `noisy_action` and `categorical_act` comes in as tensors.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ilswiss_tpu_torch.models import distributions as D
from ilswiss_tpu_torch.models.networks import (
    MLP, fanin_uniform_, small_uniform_,
)


class TanhGaussianPolicy(nn.Module):
    """Returns (mean, clamped log_std) for a batch of observations."""

    def __init__(self, obs_size: int, action_dim: int,
                 hidden_sizes: Sequence[int], generator: torch.Generator,
                 init_w: float = 1e-3):
        super().__init__()
        self.num_hidden = len(hidden_sizes)
        width = obs_size
        for i, h in enumerate(hidden_sizes):
            layer = nn.Linear(width, h)
            fanin_uniform_(layer, generator)
            self.add_module(f"hidden_{i}", layer)
            width = h
        self.mean = nn.Linear(width, action_dim)
        small_uniform_(self.mean, init_w, generator)
        self.log_std = nn.Linear(width, action_dim)
        small_uniform_(self.log_std, init_w, generator)

    def hidden_layers(self) -> list[nn.Linear]:
        return [getattr(self, f"hidden_{i}") for i in range(self.num_hidden)]

    def forward(self, obs: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        x = obs
        for layer in self.hidden_layers():
            x = torch.relu(layer(x))
        return self.mean(x), D.clamp_log_std(self.log_std(x))


class GaussianPolicy(nn.Module):
    """Returns (mean, clamped log_std) [B, A] for a batch of
    observations."""

    def __init__(self, obs_size: int, action_dim: int,
                 hidden_sizes: Sequence[int], generator: torch.Generator,
                 state_dependent_std: bool = False, init_w: float = 1e-3):
        super().__init__()
        self.num_hidden = len(hidden_sizes)
        width = obs_size
        for i, h in enumerate(hidden_sizes):
            layer = nn.Linear(width, h)
            fanin_uniform_(layer, generator)
            self.add_module(f"hidden_{i}", layer)
            width = h
        self.mean = nn.Linear(width, action_dim)
        small_uniform_(self.mean, init_w, generator)
        if state_dependent_std:
            self.log_std = nn.Linear(width, action_dim)
            small_uniform_(self.log_std, init_w, generator)
        else:
            self.log_std = nn.Parameter(torch.zeros(action_dim))

    def forward(self, obs: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        x = obs
        for i in range(self.num_hidden):
            x = torch.relu(getattr(self, f"hidden_{i}")(x))
        mean = self.mean(x)
        if isinstance(self.log_std, nn.Linear):
            log_std = self.log_std(x)
        else:
            log_std = self.log_std.expand(mean.shape)
        return mean, D.clamp_log_std(log_std)


class GaussianNoisePolicy(nn.Module):
    """Deterministic actor in [-1, 1]: tanh(MLP(obs))."""

    def __init__(self, obs_size: int, action_dim: int,
                 hidden_sizes: Sequence[int], generator: torch.Generator,
                 init_w: float = 1e-3):
        super().__init__()
        self.mlp = MLP(obs_size, hidden_sizes, action_dim, generator,
                       init_w=init_w, output_activation=torch.tanh)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.mlp(obs)


class CategoricalPolicy(nn.Module):
    """Logits [B, num_actions] of a discrete actor."""

    def __init__(self, obs_size: int, num_actions: int,
                 hidden_sizes: Sequence[int], generator: torch.Generator):
        super().__init__()
        self.mlp = MLP(obs_size, hidden_sizes, num_actions, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.mlp(obs)


def noisy_action(action: torch.Tensor, eps: torch.Tensor, sigma: float,
                 clip: float | None = None) -> torch.Tensor:
    """clip(action + noise, -1, 1) with noise = sigma * eps, first clipped
    to +-clip when `clip` is given (TD3's exploration and its target
    smoothing); `eps` holds N(0, 1) draws shaped like `action`."""
    noise = sigma * eps
    if clip is not None:
        noise = torch.clamp(noise, -clip, clip)
    return torch.clamp(action + noise, -1.0, 1.0)


def categorical_act(policy: CategoricalPolicy, obs: torch.Tensor,
                    gumbel: torch.Tensor | None = None,
                    deterministic: bool = False) -> torch.Tensor:
    """argmax of the logits, or a sample from the Gumbel draws `gumbel`."""
    logits = policy(obs)
    if deterministic:
        return torch.argmax(logits, dim=-1)
    return D.categorical_sample(logits, gumbel)
