"""SAC over discrete actions (counterpart:
ilswiss_tpu/algorithms/discrete_sac.py; `DiscreteSACConfig`,
`DiscreteSACState`, `DiscreteSAC`).

Critics map obs to a Q value per action, and expectations over the
categorical policy replace samples.  Same update as the JAX
`DiscreteSAC.train_step` (reference discrete_sac.py:62-150):
  - soft value V(s') = sum_a pi(a|s') min(Q1bar, Q2bar)(s', a)
    + alpha * H(pi(.|s'));
  - q_target = reward_scale * r + (1 - terminal) * gamma * V(s'), loss
    0.5 * MSE on the Q of the stored action, for each critic;
  - policy loss: -mean(alpha * H(pi) + sum_a pi(a) min(Q1, Q2)(s, a)),
    the critics' values taken before this step's update and detached;
  - Polyak tau on both critics every step; every Adam at b1 = beta_1.

Acting: argmax of the logits, or a Gumbel-max sample from noise.gumbel
([n, A], `act_noise`).  A gradient step draws nothing.  Actions are
integer indices; the ring stores them as int32 and they are cast to int64
to gather.  `train_step` updates the state IN PLACE and returns the same
state object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ilswiss_tpu_torch.algorithms.sac import Adam
from ilswiss_tpu_torch.models.networks import MLP
from ilswiss_tpu_torch.models.policies import (
    CategoricalPolicy, categorical_act,
)
from ilswiss_tpu_torch.utils.device import resolve_device
from ilswiss_tpu_torch.utils.pytree import copy_params, soft_update


@dataclass(frozen=True)
class DiscreteSACConfig:
    discount: float = 0.99
    reward_scale: float = 1.0
    alpha: float = 1.0
    soft_target_tau: float = 1e-2
    policy_lr: float = 1e-3
    qf_lr: float = 1e-3
    beta_1: float = 0.9


@dataclass
class DiscreteSACState:
    policy: CategoricalPolicy
    qf1: MLP
    qf2: MLP
    target_qf1: MLP
    target_qf2: MLP
    policy_opt: Adam
    qf1_opt: Adam
    qf2_opt: Adam


def _taken(q_all: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Q [B, 1] of each row's action."""
    return torch.take_along_dim(q_all, actions.to(torch.int64)[:, None],
                                dim=-1)


class DiscreteSAC:
    """Trainer: config, sizes and device; the learned state is a
    DiscreteSACState."""

    def __init__(self, obs_size: int, num_actions: int,
                 config: DiscreteSACConfig = DiscreteSACConfig(),
                 net_size: int = 256, num_hidden_layers: int = 2,
                 device=None, group=None):
        self.config = config
        self.obs_size = obs_size
        self.num_actions = num_actions
        self.hidden = (net_size,) * num_hidden_layers
        self.device = resolve_device(device)
        # the ranks whose gradients every step averages (JAX:
        # `axis_name`, parallel/mesh.py)
        self.group = group

    def init(self, seed: int) -> DiscreteSACState:
        """Fresh state; the init draws come from a CPU generator seeded
        with `seed` (policy, then the two critics)."""
        cfg = self.config
        gen = torch.Generator().manual_seed(seed)
        policy = CategoricalPolicy(self.obs_size, self.num_actions,
                                   self.hidden, gen).to(self.device)
        qf1, qf2 = (MLP(self.obs_size, self.hidden, self.num_actions,
                        gen).to(self.device) for _ in range(2))
        adam = lambda module, lr: Adam(module.parameters(),  # noqa: E731
                                       lr, cfg.beta_1)
        return DiscreteSACState(
            policy=policy, qf1=qf1, qf2=qf2,
            target_qf1=copy_params(qf1), target_qf2=copy_params(qf2),
            policy_opt=adam(policy, cfg.policy_lr),
            qf1_opt=adam(qf1, cfg.qf_lr), qf2_opt=adam(qf2, cfg.qf_lr),
        )

    def act_noise(self, noise, n: int) -> tuple:
        return (noise.gumbel((n, self.num_actions)),)

    def train_noise(self, noise, batch_size: int) -> tuple:
        return ()

    @torch.no_grad()
    def act(self, state: DiscreteSACState, obs: torch.Tensor,
            gumbel: torch.Tensor | None = None,
            deterministic: bool = False) -> torch.Tensor:
        return categorical_act(state.policy, obs, gumbel, deterministic)

    def train_step(self, state: DiscreteSACState,
                   batch: Dict[str, torch.Tensor]
                   ) -> tuple[DiscreteSACState, Dict[str, torch.Tensor]]:
        """One gradient step, in place; returns (state, metrics)."""
        cfg = self.config
        obs, actions = batch["obs"], batch["action"]
        rewards = cfg.reward_scale * batch["reward"][:, None]
        terminals = batch["terminal"][:, None]
        next_obs = batch["next_obs"]

        # --- soft value of the next state (discrete_sac.py:85-95) -----
        with torch.no_grad():
            next_logp = torch.log_softmax(state.policy(next_obs), dim=-1)
            next_p = torch.exp(next_logp)
            min_t_q = torch.minimum(state.target_qf1(next_obs),
                                    state.target_qf2(next_obs))
            next_entropy = -torch.sum(next_p * next_logp, dim=-1,
                                      keepdim=True)
            target_v = (torch.sum(next_p * min_t_q, dim=-1, keepdim=True)
                        + cfg.alpha * next_entropy)
            q_target = rewards + (1.0 - terminals) * cfg.discount * target_v
            # the policy's critic values, before the critics move
            current_q = torch.minimum(state.qf1(obs), state.qf2(obs))

        qf1_loss = 0.5 * torch.mean(
            (_taken(state.qf1(obs), actions) - q_target) ** 2)
        qf2_loss = 0.5 * torch.mean(
            (_taken(state.qf2(obs), actions) - q_target) ** 2)
        state.qf1_opt.step(state.qf1_opt.grad(qf1_loss, self.group))
        state.qf2_opt.step(state.qf2_opt.grad(qf2_loss, self.group))

        # --- policy (discrete_sac.py:113-135) --------------------------
        logp = torch.log_softmax(state.policy(obs), dim=-1)
        p = torch.exp(logp)
        entropy = -torch.sum(p * logp, dim=-1)
        value = torch.sum(p * current_q, dim=-1)
        policy_loss = -torch.mean(cfg.alpha * entropy + value)
        state.policy_opt.step(state.policy_opt.grad(policy_loss,
                                                    self.group))

        soft_update(state.target_qf1, state.qf1, cfg.soft_target_tau)
        soft_update(state.target_qf2, state.qf2, cfg.soft_target_tau)
        metrics = {
            "qf1_loss": qf1_loss,
            "qf2_loss": qf2_loss,
            "policy_loss": policy_loss,
        }
        return state, {k: v.detach() for k, v in metrics.items()}
