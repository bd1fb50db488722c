"""SAC with a state-value network and a fixed alpha (counterpart:
ilswiss_tpu/algorithms/sac_v.py; `SACVConfig`, `SACVState`, `SACV`).

Same update as the JAX `SACV.train_step` (the reference's original SAC,
sac.py:23-273):
  - one policy sample at s: a_new = tanh(mean + std * eps), log pi;
  - Q target: reward_scale * r + (1 - terminal) * gamma * Vbar(s'), loss
    0.5 * MSE for each critic;
  - V target: min(Q1, Q2)(s, a_new) - alpha * log pi, loss 0.5 * MSE;
  - policy loss: mean(alpha * log pi - min(Q1, Q2)(s, a_new))
    + mean_reg * mean(mu^2) + std_reg * mean(log_std^2);
  - all four gradients are taken against the critics and V before this
    step's updates, then every Adam (b1 = beta_1) steps;
  - Polyak tau on V only.

The JAX step draws its sample twice from one key (sac_v.py:122 and :160),
so both are the same draw: here one N(0, 1) tensor `eps` [B, A] from
noise.sample (`train_noise`) serves both, and the min over the critics at
a_new is computed once, detached for the V target.  Acting draws
noise.act (N(0, 1) [n, A]).  `train_step` updates the state IN PLACE and
returns the same state object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ilswiss_tpu_torch.algorithms.sac import Adam
from ilswiss_tpu_torch.models import distributions as D
from ilswiss_tpu_torch.models.networks import MLP, FlattenMLP
from ilswiss_tpu_torch.models.policies import TanhGaussianPolicy
from ilswiss_tpu_torch.utils.device import resolve_device
from ilswiss_tpu_torch.utils.pytree import copy_params, soft_update


@dataclass(frozen=True)
class SACVConfig:
    discount: float = 0.99
    reward_scale: float = 1.0
    alpha: float = 1.0
    soft_target_tau: float = 5e-3
    policy_lr: float = 3e-4
    qf_lr: float = 3e-4
    vf_lr: float = 1e-3
    beta_1: float = 0.9
    policy_mean_reg_weight: float = 1e-3
    policy_std_reg_weight: float = 1e-3


@dataclass
class SACVState:
    policy: TanhGaussianPolicy
    qf1: FlattenMLP
    qf2: FlattenMLP
    vf: MLP
    target_vf: MLP
    policy_opt: Adam
    qf1_opt: Adam
    qf2_opt: Adam
    vf_opt: Adam


class SACV:
    """Trainer: config, sizes and device; the learned state is a
    SACVState."""

    def __init__(self, obs_size: int, action_size: int,
                 config: SACVConfig = SACVConfig(),
                 net_size: int = 256, num_hidden_layers: int = 2,
                 device=None):
        self.config = config
        self.obs_size = obs_size
        self.action_size = action_size
        self.hidden = (net_size,) * num_hidden_layers
        self.device = resolve_device(device)

    def init(self, seed: int) -> SACVState:
        """Fresh state; the init draws come from a CPU generator seeded
        with `seed` (policy, the two critics, V)."""
        cfg = self.config
        gen = torch.Generator().manual_seed(seed)
        policy = TanhGaussianPolicy(self.obs_size, self.action_size,
                                    self.hidden, gen).to(self.device)
        qf1, qf2 = (FlattenMLP(self.obs_size + self.action_size,
                               self.hidden, 1, gen).to(self.device)
                    for _ in range(2))
        vf = MLP(self.obs_size, self.hidden, 1, gen).to(self.device)
        adam = lambda module, lr: Adam(module.parameters(),  # noqa: E731
                                       lr, cfg.beta_1)
        return SACVState(
            policy=policy, qf1=qf1, qf2=qf2, vf=vf,
            target_vf=copy_params(vf),
            policy_opt=adam(policy, cfg.policy_lr),
            qf1_opt=adam(qf1, cfg.qf_lr), qf2_opt=adam(qf2, cfg.qf_lr),
            vf_opt=adam(vf, cfg.vf_lr),
        )

    def act_noise(self, noise, n: int) -> tuple:
        return (noise.act((n, self.action_size)),)

    def train_noise(self, noise, batch_size: int) -> tuple:
        return (noise.sample((batch_size, self.action_size)),)

    @torch.no_grad()
    def act(self, state: SACVState, obs: torch.Tensor,
            eps: torch.Tensor | None = None,
            deterministic: bool = False) -> torch.Tensor:
        mean, log_std = state.policy(obs)
        if deterministic:
            return torch.tanh(mean)
        return D.tanh_normal_sample(mean, log_std, eps)[0]

    def train_step(self, state: SACVState, batch: Dict[str, torch.Tensor],
                   eps: torch.Tensor
                   ) -> tuple[SACVState, Dict[str, torch.Tensor]]:
        """One gradient step, in place; `eps` [B, A] is the N(0, 1) noise
        of the policy sample.  Returns (state, metrics)."""
        cfg = self.config
        obs, actions = batch["obs"], batch["action"]
        rewards = cfg.reward_scale * batch["reward"][:, None]
        terminals = batch["terminal"][:, None]
        next_obs = batch["next_obs"]

        # the policy sample at obs (reference sac.py:122-127)
        mean, log_std = state.policy(obs)
        new_actions, pre = D.tanh_normal_sample(mean, log_std, eps)
        log_pi = D.tanh_normal_log_prob(mean, log_std, new_actions, pre)

        # --- Q losses against the target V (sac.py:91-103) ------------
        with torch.no_grad():
            q_target = rewards + (1.0 - terminals) * cfg.discount * \
                state.target_vf(next_obs)
        qf1_loss = 0.5 * torch.mean((state.qf1(obs, actions) - q_target) ** 2)
        qf2_loss = 0.5 * torch.mean((state.qf2(obs, actions) - q_target) ** 2)
        g1 = state.qf1_opt.grad(qf1_loss)
        g2 = state.qf2_opt.grad(qf2_loss)

        # --- V loss and policy loss against the pre-update Qs ----------
        q_new = torch.minimum(state.qf1(obs, new_actions),
                              state.qf2(obs, new_actions))
        v_target = (q_new - cfg.alpha * log_pi).detach()
        vf_loss = 0.5 * torch.mean((state.vf(obs) - v_target) ** 2)
        gv = state.vf_opt.grad(vf_loss)
        policy_loss = torch.mean(cfg.alpha * log_pi - q_new) + (
            cfg.policy_mean_reg_weight * torch.mean(mean ** 2)
            + cfg.policy_std_reg_weight * torch.mean(log_std ** 2))
        gp = state.policy_opt.grad(policy_loss)

        state.qf1_opt.step(g1)
        state.qf2_opt.step(g2)
        state.vf_opt.step(gv)
        state.policy_opt.step(gp)
        soft_update(state.target_vf, state.vf, cfg.soft_target_tau)

        metrics = {
            "qf1_loss": qf1_loss,
            "qf2_loss": qf2_loss,
            "vf_loss": vf_loss,
            "policy_loss": policy_loss,
            "log_pi_mean": torch.mean(log_pi),
        }
        return state, {k: v.detach() for k, v in metrics.items()}
