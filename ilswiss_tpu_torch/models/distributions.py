"""Policy distributions as plain functions (counterpart:
ilswiss_tpu/models/distributions.py).

Same formulas as the JAX module: the tanh-Normal log-prob uses the
`log(1 - a^2 + 1e-6)` Jacobian correction, log-probs are summed over the
last axis with a kept dimension, and log-std is clamped to [-20, 2].
Sampling takes its standard-normal noise as a tensor argument, so a test
can hand the port and the JAX package the same draws.
"""

from __future__ import annotations

import math

import torch

TANH_EPS = 1e-6
LOG_SIG_MIN = -20.0
LOG_SIG_MAX = 2.0
_LOG_2PI = math.log(2.0 * math.pi)


def clamp_log_std(log_std: torch.Tensor) -> torch.Tensor:
    return torch.clamp(log_std, LOG_SIG_MIN, LOG_SIG_MAX)


def normal_sample(mean: torch.Tensor, log_std: torch.Tensor,
                  eps: torch.Tensor) -> torch.Tensor:
    return mean + torch.exp(log_std) * eps


def normal_log_prob(mean: torch.Tensor, log_std: torch.Tensor,
                    value: torch.Tensor) -> torch.Tensor:
    """Diagonal-Gaussian log density, summed over the action axis (keepdim)."""
    var = torch.exp(2.0 * log_std)
    log_det = 2.0 * log_std
    lp = -0.5 * ((value - mean) ** 2 / var + log_det + _LOG_2PI)
    return torch.sum(lp, dim=-1, keepdim=True)


def tanh_normal_sample(mean: torch.Tensor, log_std: torch.Tensor,
                       eps: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reparameterized sample from N(0, 1) noise `eps`; returns
    (action, pre_tanh_value)."""
    z = normal_sample(mean, log_std, eps)
    return torch.tanh(z), z


def tanh_normal_log_prob(mean: torch.Tensor, log_std: torch.Tensor,
                         action: torch.Tensor,
                         pre_tanh: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """log pi(a) with the tanh Jacobian correction; `pre_tanh` is
    recovered through atanh when it is not given."""
    if pre_tanh is None:
        pre_tanh = 0.5 * (torch.log(1.0 + action + TANH_EPS)
                          - torch.log(1.0 - action + TANH_EPS))
    base = normal_log_prob(mean, log_std, pre_tanh)
    correction = torch.sum(torch.log(1.0 - action ** 2 + TANH_EPS),
                           dim=-1, keepdim=True)
    return base - correction
