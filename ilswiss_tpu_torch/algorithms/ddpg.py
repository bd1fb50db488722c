"""DDPG (counterpart: ilswiss_tpu/algorithms/ddpg.py; `DDPGConfig`,
`DDPGState`, `DDPG`).

Same update as the JAX `DDPG.train_step` (reference ddpg.py:102-175):
  - q_target = reward_scale * r + (1 - terminal) * gamma *
    Qbar(s', policy_bar(s')), clipped to [min_q_value, max_q_value];
    critic loss plain MSE;
  - policy loss: -mean(Q(s, policy(s))) against the critic BEFORE this
    step's update (both gradients are taken before either Adam steps);
  - targets: Polyak tau every step, or (use_soft_update off) a hard copy
    when the step count n, counted after the step's increment, is a
    multiple of target_update_period.

Adam is optax.adam(lr).  Exploration in `act`: a = clip(policy(s) + sigma
* eps, -1, 1), eps from noise.act (N(0, 1) [n, A]).  A gradient step
draws nothing (`train_noise` gives no tensor).  `train_step` updates the
state IN PLACE and returns the same state object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ilswiss_tpu_torch.algorithms.sac import Adam
from ilswiss_tpu_torch.models.networks import FlattenMLP
from ilswiss_tpu_torch.models.policies import (
    GaussianNoisePolicy, noisy_action,
)
from ilswiss_tpu_torch.utils.device import resolve_device
from ilswiss_tpu_torch.utils.pytree import (
    copy_params, hard_update, soft_update,
)


@dataclass(frozen=True)
class DDPGConfig:
    discount: float = 0.99
    reward_scale: float = 1.0
    policy_lr: float = 1e-4
    qf_lr: float = 1e-3
    soft_target_tau: float = 1e-2
    use_soft_update: bool = True
    target_update_period: int = 1000
    min_q_value: float = -float("inf")
    max_q_value: float = float("inf")
    exploration_noise: float = 0.1


@dataclass
class DDPGState:
    policy: GaussianNoisePolicy
    qf: FlattenMLP
    target_policy: GaussianNoisePolicy
    target_qf: FlattenMLP
    policy_opt: Adam
    qf_opt: Adam
    n_train_steps: int


class DDPG:
    """Trainer: config, sizes and device; the learned state is a
    DDPGState."""

    def __init__(self, obs_size: int, action_size: int,
                 config: DDPGConfig = DDPGConfig(),
                 net_size: int = 256, num_hidden_layers: int = 2,
                 device=None, group=None):
        self.config = config
        self.obs_size = obs_size
        self.action_size = action_size
        self.hidden = (net_size,) * num_hidden_layers
        self.device = resolve_device(device)
        # the ranks whose gradients every step averages (JAX:
        # `axis_name`, parallel/mesh.py)
        self.group = group

    def init(self, seed: int) -> DDPGState:
        """Fresh state; the init draws come from a CPU generator seeded
        with `seed` (policy, then critic)."""
        cfg = self.config
        gen = torch.Generator().manual_seed(seed)
        policy = GaussianNoisePolicy(self.obs_size, self.action_size,
                                     self.hidden, gen).to(self.device)
        qf = FlattenMLP(self.obs_size + self.action_size, self.hidden, 1,
                        gen).to(self.device)
        return DDPGState(
            policy=policy, qf=qf,
            target_policy=copy_params(policy), target_qf=copy_params(qf),
            policy_opt=Adam(policy.parameters(), cfg.policy_lr, 0.9),
            qf_opt=Adam(qf.parameters(), cfg.qf_lr, 0.9),
            n_train_steps=0,
        )

    def act_noise(self, noise, n: int) -> tuple:
        return (noise.act((n, self.action_size)),)

    def train_noise(self, noise, batch_size: int) -> tuple:
        return ()

    @torch.no_grad()
    def act(self, state: DDPGState, obs: torch.Tensor,
            eps: torch.Tensor | None = None,
            deterministic: bool = False) -> torch.Tensor:
        action = state.policy(obs)
        if deterministic:
            return action
        return noisy_action(action, eps, self.config.exploration_noise)

    def train_step(self, state: DDPGState, batch: Dict[str, torch.Tensor]
                   ) -> tuple[DDPGState, Dict[str, torch.Tensor]]:
        """One gradient step, in place; returns (state, metrics)."""
        cfg = self.config
        obs, actions = batch["obs"], batch["action"]
        rewards = cfg.reward_scale * batch["reward"][:, None]
        terminals = batch["terminal"][:, None]
        next_obs = batch["next_obs"]

        with torch.no_grad():
            target_q = state.target_qf(next_obs,
                                       state.target_policy(next_obs))
            q_target = torch.clamp(
                rewards + (1.0 - terminals) * cfg.discount * target_q,
                cfg.min_q_value, cfg.max_q_value)
        qf_loss = torch.mean((state.qf(obs, actions) - q_target) ** 2)
        gq = state.qf_opt.grad(qf_loss, self.group)
        # against the critic before this step's update
        policy_loss = -torch.mean(state.qf(obs, state.policy(obs)))
        gp = state.policy_opt.grad(policy_loss, self.group)
        state.qf_opt.step(gq)
        state.policy_opt.step(gp)

        state.n_train_steps += 1
        if cfg.use_soft_update:
            soft_update(state.target_policy, state.policy,
                        cfg.soft_target_tau)
            soft_update(state.target_qf, state.qf, cfg.soft_target_tau)
        elif state.n_train_steps % cfg.target_update_period == 0:
            hard_update(state.target_policy, state.policy)
            hard_update(state.target_qf, state.qf)

        metrics = {
            "qf_loss": qf_loss,
            "policy_loss": policy_loss,
            "q_target_mean": torch.mean(q_target),
        }
        return state, {k: v.detach() for k, v in metrics.items()}
