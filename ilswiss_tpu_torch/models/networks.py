"""Core network modules (counterpart: ilswiss_tpu/models/networks.py).

The inits match the JAX package: hidden layers draw their weights from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with bias 0.1, and the output layer
draws weight and bias from U(-init_w, init_w).  Every draw comes from the
`torch.Generator` the caller passes.  Layers keep the flax names
(`hidden_i`, `output`) so the weight bridge (utils/convert.py) maps them
one to one; `nn.Linear.weight` is `[out, in]` where a flax kernel is
`[in, out]`.  `output_activation` (for example `torch.tanh`, the TD3 and
DDPG actor's) is applied after the output layer, as the JAX `MLP`'s.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn


@torch.no_grad()
def fanin_uniform_(layer: nn.Linear, generator: torch.Generator) -> None:
    """Weight ~ U(+-1/sqrt(fan_in)), bias = 0.1 (hidden layers)."""
    bound = 1.0 / float(layer.in_features) ** 0.5
    layer.weight.uniform_(-bound, bound, generator=generator)
    layer.bias.fill_(0.1)


@torch.no_grad()
def small_uniform_(layer: nn.Linear, scale: float,
                   generator: torch.Generator) -> None:
    """Weight and bias ~ U(+-scale) (output heads)."""
    layer.weight.uniform_(-scale, scale, generator=generator)
    layer.bias.uniform_(-scale, scale, generator=generator)


class MLP(nn.Module):
    """ReLU MLP with the reference init; layers `hidden_i` and `output`."""

    def __init__(self, input_size: int, hidden_sizes: Sequence[int],
                 output_size: int, generator: torch.Generator,
                 init_w: float = 3e-3,
                 output_activation: Callable | None = None):
        super().__init__()
        self.num_hidden = len(hidden_sizes)
        self.output_activation = output_activation
        width = input_size
        for i, h in enumerate(hidden_sizes):
            layer = nn.Linear(width, h)
            fanin_uniform_(layer, generator)
            self.add_module(f"hidden_{i}", layer)
            width = h
        self.output = nn.Linear(width, output_size)
        small_uniform_(self.output, init_w, generator)

    def hidden_layers(self) -> list[nn.Linear]:
        return [getattr(self, f"hidden_{i}") for i in range(self.num_hidden)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.hidden_layers():
            x = torch.relu(layer(x))
        x = self.output(x)
        if self.output_activation is not None:
            x = self.output_activation(x)
        return x


class FlattenMLP(nn.Module):
    """MLP over concatenated inputs, the Q(s, a) critic; the MLP is `mlp`."""

    def __init__(self, input_size: int, hidden_sizes: Sequence[int],
                 output_size: int, generator: torch.Generator):
        super().__init__()
        self.mlp = MLP(input_size, hidden_sizes, output_size, generator)

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        return self.mlp(torch.cat(inputs, dim=-1))
