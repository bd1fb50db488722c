"""On-policy rollout utilities (counterpart: ilswiss_tpu/data/rollout.py;
`gae`, `normalize_advantages`).

A rollout is a fixed `[T, B]` stack of the T acting steps of B envs.  The
JAX package runs GAE as a reversed `lax.scan` over T; here it is a
reversed Python loop over T of the same recurrence.
"""

from __future__ import annotations

import torch


def gae(rewards: torch.Tensor, values: torch.Tensor,
        last_values: torch.Tensor, terminals: torch.Tensor,
        dones: torch.Tensor, discount: float, lam: float
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over a [T, B] rollout:

        delta_t = r_t + gamma * V(s_{t+1}) * (1 - terminal_t) - V(s_t)
        A_t     = delta_t + gamma * lam * (1 - done_t) * A_{t+1}

    `terminals` masks the bootstrap (true terminations only), `dones`
    (terminal or truncation) stops the advantage at an episode boundary;
    V(s_T) is `last_values` [B].  Returns (advantages, returns = A + V),
    each [T, B]."""
    next_values = torch.cat([values[1:], last_values[None]], dim=0)
    nonterminal = 1.0 - terminals.to(torch.float32)
    nonboundary = 1.0 - dones.to(torch.float32)
    deltas = rewards + discount * next_values * nonterminal - values
    adv = torch.zeros_like(last_values)
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        adv = deltas[t] + discount * lam * nonboundary[t] * adv
        out.append(adv)
    advantages = torch.stack(out[::-1])
    return advantages, advantages + values


def normalize_advantages(adv: torch.Tensor, eps: float = 1e-8
                         ) -> torch.Tensor:
    """(adv - mean) / (std + eps) over the whole rollout, the population
    std (`jnp.std`, ddof 0)."""
    return (adv - torch.mean(adv)) / (torch.std(adv, correction=0) + eps)
