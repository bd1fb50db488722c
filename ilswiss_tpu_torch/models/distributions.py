"""Policy distributions as plain functions (counterpart:
ilswiss_tpu/models/distributions.py).

Same formulas as the JAX module: the tanh-Normal log-prob uses the
`log(1 - a^2 + 1e-6)` Jacobian correction, log-probs are summed over the
last axis with a kept dimension, and log-std is clamped to [-20, 2].
Sampling takes its noise as a tensor argument (standard normals, or the
standard Gumbel draws of a categorical sample), so a test can hand the
port and the JAX package the same draws.
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


def expert_action_log_prob(mean: torch.Tensor, log_std: torch.Tensor,
                           action: torch.Tensor) -> torch.Tensor:
    """`tanh_normal_log_prob` of a given action (BC's and GCSL's MLE
    losses), with the sums formed as (1 + 1e-6) -+ a and (1 + 1e-6) - a^2,
    as XLA compiles the JAX `1.0 - a + TANH_EPS` inside a jitted step: it
    folds the two constants into float32 1.00000095.  Expert actions sit
    exactly at +-1 (the scripted controllers saturate), where that reads
    log(9.54e-7) and not log(1e-6), and those rows dominate the loss."""
    one_eps = 1.0 + TANH_EPS      # float32 1.00000095 against a tensor
    pre_tanh = 0.5 * (torch.log(one_eps + action)
                      - torch.log(one_eps - action))
    correction = torch.sum(torch.log(one_eps - action ** 2), dim=-1,
                           keepdim=True)
    return normal_log_prob(mean, log_std, pre_tanh) - correction


# --- Categorical (the reference's DiscretePolicy softmax head) ------------
def categorical_sample(logits: torch.Tensor, gumbel: torch.Tensor
                       ) -> torch.Tensor:
    """The Gumbel-max sample argmax(logits + g) for standard Gumbel draws
    `gumbel` [..., A], as `jax.random.categorical` computes it from its
    key; ties break to the first index on both sides."""
    return torch.argmax(logits + gumbel, dim=-1)


def categorical_log_prob(logits: torch.Tensor, action: torch.Tensor
                         ) -> torch.Tensor:
    """log pi(action) [..., 1] for integer actions [...]."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.take_along_dim(logp, action[..., None].to(torch.int64),
                                dim=-1)


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1, keepdim=True)
