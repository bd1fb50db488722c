"""Probabilistic ensemble dynamics model (counterpart:
ilswiss_tpu/models/bnn.py; `InputNormalizer`, `fit_input_normalizer`,
`EnsembleDense`, `BNN`).

`EnsembleDense` holds a kernel [E, in, out] and a bias [E, 1, out] in
flax's layout (no transpose), so the whole ensemble is one batched product
per layer: a shared [B, in] input goes to every net, an [E, B, in] input
one slice per net.  The head predicts the mean and log-variance of
(reward, delta obs) with learned soft bounds:

    logvar = max_lv - softplus(max_lv - raw)
    logvar = min_lv + softplus(logvar - min_lv)

with `max_log_var` starting at 0.5 and `min_log_var` at -10, each
[1, target].  The inits are the JAX package's: hidden layers fan-in
uniform with bias 0.1, `last_fc` uniform in +-3e-3 for kernel and bias,
every draw from the `torch.Generator` the caller passes.  Input moments
are fitted at each model-training round and carried beside the
parameters, not inside them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclass
class InputNormalizer:
    mean: torch.Tensor  # [1, in]
    std: torch.Tensor   # [1, in]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.std


def fit_input_normalizer(inputs: torch.Tensor) -> InputNormalizer:
    """Column moments of `inputs` [N, in]: the population std (ddof 0, as
    `jnp.std`), 1 where it is below 1e-12."""
    mean = inputs.mean(dim=0, keepdim=True)
    std = inputs.std(dim=0, correction=0, keepdim=True)
    return InputNormalizer(mean=mean,
                           std=torch.where(std < 1e-12, 1.0, std))


class EnsembleDense(nn.Module):
    """[E, in, out] linear over [E, B, in] or a shared [B, in] input."""

    def __init__(self, in_features: int, features: int, ensemble_size: int,
                 generator: torch.Generator, fanin: bool = True,
                 init_w: float = 3e-3, bias_init_value: float = 0.1):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(ensemble_size, in_features, features))
        self.bias = nn.Parameter(torch.empty(ensemble_size, 1, features))
        with torch.no_grad():
            if fanin:
                bound = 1.0 / float(in_features) ** 0.5
                self.kernel.uniform_(-bound, bound, generator=generator)
                self.bias.fill_(bias_init_value)
            else:
                self.kernel.uniform_(-init_w, init_w, generator=generator)
                self.bias.uniform_(-init_w, init_w, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x.expand((self.kernel.shape[0],) + x.shape)
        return torch.baddbmm(self.bias, x, self.kernel)


class BNN(nn.Module):
    """Input [E?, B, obs + act] -> (mean, logvar), each [E, B, 1 + obs]
    (reward first, then the change of the observation).  Layers `fc0` ...
    `fc{n-1}` with SiLU, then `last_fc` to 2 (1 + obs)."""

    def __init__(self, input_size: int, hidden_sizes: Sequence[int],
                 target_size: int, num_nets: int,
                 generator: torch.Generator):
        super().__init__()
        self.num_hidden = len(hidden_sizes)
        self.target_size = target_size
        width = input_size
        for i, size in enumerate(hidden_sizes):
            self.add_module(f"fc{i}", EnsembleDense(width, size, num_nets,
                                                    generator))
            width = size
        self.last_fc = EnsembleDense(width, 2 * target_size, num_nets,
                                     generator, fanin=False)
        self.max_log_var = nn.Parameter(torch.full((1, target_size), 0.5))
        self.min_log_var = nn.Parameter(torch.full((1, target_size), -10.0))

    def layers(self) -> list[EnsembleDense]:
        """The hidden layers in order, then `last_fc`."""
        return [getattr(self, f"fc{i}") for i in range(self.num_hidden)] \
            + [self.last_fc]

    def forward(self, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        *hidden, last = self.layers()
        for layer in hidden:
            x = F.silu(layer(x))
        pre = last(x)
        mean = pre[..., :self.target_size]
        logvar = self.max_log_var - F.softplus(
            self.max_log_var - pre[..., self.target_size:])
        logvar = self.min_log_var + F.softplus(logvar - self.min_log_var)
        return mean, logvar
