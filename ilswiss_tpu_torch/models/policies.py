"""SAC actor (counterpart: ilswiss_tpu/models/policies.py, TanhGaussianPolicy).

A ReLU trunk `hidden_i`, a mean head `mean` and a state-dependent log-std
head `log_std` clamped to [-20, 2].  The heads draw weight and bias from
U(+-1e-3).  This module is the training forward (autograd); acting can
take the fused kernel instead (ops/fused_mlp.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ilswiss_tpu_torch.models import distributions as D
from ilswiss_tpu_torch.models.networks import fanin_uniform_, small_uniform_


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
