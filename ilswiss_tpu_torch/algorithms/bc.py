"""Behaviour cloning as one gradient step (counterpart:
ilswiss_tpu/algorithms/bc.py; `BCConfig`, `BCState`, `BC`).

A tanh-Gaussian policy fit to expert (obs, action) pairs with
  - MLE: loss = -mean log pi(a_expert | s), the log-prob through the
    atanh of the tanh-Normal, with the constants of its log terms folded
    as the jitted JAX step computes them (`expert_action_log_prob`), or
  - MSE: loss = mean_i sum_a (a_sampled - a_expert)^2, the SAMPLED
    reparameterized action against the expert's, as the reference
    regresses it.
Adam is optax.adam(lr, b1=momentum, b2=0.999).

Draws: `act_noise` gives noise.act (N(0, 1) [n, A]); `train_noise` gives
noise.sample (N(0, 1) [B, A], the MSE sample) in MSE mode and nothing in
MLE mode, where the JAX step's key goes unused.  As the port's SAC,
`train_step` updates the state's tensors IN PLACE and returns the same
state object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ilswiss_tpu_torch.algorithms.sac import Adam
from ilswiss_tpu_torch.models import distributions as D
from ilswiss_tpu_torch.models.policies import TanhGaussianPolicy
from ilswiss_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class BCConfig:
    mode: str = "MLE"  # 'MLE' | 'MSE'
    lr: float = 1e-3
    momentum: float = 0.9


@dataclass
class BCState:
    policy: TanhGaussianPolicy
    policy_opt: Adam


class BC:
    """Trainer: config, sizes and device; the learned state is a BCState."""

    def __init__(self, obs_size: int, action_size: int,
                 config: BCConfig = BCConfig(),
                 net_size: int = 256, num_hidden_layers: int = 2,
                 device=None, group=None):
        if config.mode not in ("MLE", "MSE"):
            raise ValueError(f"BC mode {config.mode!r}: 'MLE' or 'MSE'")
        self.config = config
        self.obs_size = obs_size
        self.action_size = action_size
        self.hidden = (net_size,) * num_hidden_layers
        self.device = resolve_device(device)
        # the ranks whose gradients every step averages (JAX:
        # `axis_name`, parallel/mesh.py)
        self.group = group

    def init(self, seed: int) -> BCState:
        """Fresh state; the init draws come from a CPU generator seeded
        with `seed`."""
        gen = torch.Generator().manual_seed(seed)
        policy = TanhGaussianPolicy(self.obs_size, self.action_size,
                                    self.hidden, gen).to(self.device)
        return BCState(policy=policy,
                       policy_opt=Adam(policy.parameters(), self.config.lr,
                                       self.config.momentum))

    def act_noise(self, noise, n: int) -> tuple[torch.Tensor]:
        return (noise.act((n, self.action_size)),)

    def train_noise(self, noise, batch_size: int) -> tuple:
        if self.config.mode == "MSE":
            return (noise.sample((batch_size, self.action_size)),)
        return ()

    @torch.no_grad()
    def act(self, state: BCState, obs: torch.Tensor,
            eps: torch.Tensor | None = None,
            deterministic: bool = False) -> torch.Tensor:
        """Policy actions in [-1, 1]; `eps` [B, A] is the N(0, 1) noise of
        a stochastic action."""
        mean, log_std = state.policy(obs)
        if deterministic:
            return torch.tanh(mean)
        return D.tanh_normal_sample(mean, log_std, eps)[0]

    def train_step(self, state: BCState, batch: Dict[str, torch.Tensor],
                   eps: torch.Tensor | None = None
                   ) -> tuple[BCState, Dict[str, torch.Tensor]]:
        """One gradient step on batch["obs"] / batch["action"], in place;
        `eps` [B, A] is the MSE mode's N(0, 1) sample noise.  Returns
        (state, {"bc_loss": 0-d tensor})."""
        mean, log_std = state.policy(batch["obs"])
        acts = batch["action"]
        if self.config.mode == "MLE":
            loss = -torch.mean(D.expert_action_log_prob(mean, log_std, acts))
        else:
            action = D.tanh_normal_sample(mean, log_std, eps)[0]
            loss = torch.mean(torch.sum((action - acts) ** 2, dim=-1))
        state.policy_opt.step(state.policy_opt.grad(loss, self.group))
        return state, {"bc_loss": loss.detach()}
