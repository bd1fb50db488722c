"""Twin Delayed DDPG (counterpart: ilswiss_tpu/algorithms/td3.py;
`TD3Config`, `TD3State`, `TD3`).

Same update as the JAX `TD3.train_step` (reference td3.py:72-124):
  - target actions: a' = clip(target_policy(s') + clip(sigma_t * eps,
    +-noise_clip), -1, 1);
  - q_target = reward_scale * r + (1 - terminal) * gamma *
    min(Q1bar, Q2bar)(s', a'), clipped to [q_target_min, q_target_max];
  - critic loss: plain MSE for each critic (not SAC's 0.5 x);
  - policy loss: -mean(Q1(s, policy(s))) against the UPDATED first
    critic, computed and reported at every step;
  - the policy, its Adam and all three targets (Polyak tau) move only at
    steps with n_train_steps % policy_and_target_update_period == 0,
    counted before the step's increment.

`n_train_steps` is part of the state, so a checkpoint carries it.  Adam is
optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8): each optimizer's count moves
only when it steps, as optax's does.

Exploration (the reference's exploration policy, not the trainer) is in
`act`: a = clip(policy(s) + sigma * eps, -1, 1); with
`exploration_epsilon` > 0 the Gaussian-and-epsilon explorer of HER-TD3
instead (exploration/strategies.py).  Draws: `act_noise` gives
noise.act (N(0, 1) [n, A]), or with epsilon noise.flip (one uniform),
noise.random_action ([n, A]) and noise.act; `train_noise` gives
noise.smoothing (N(0, 1) [B, A], the JAX step's `key`).

As the port's SAC, `train_step` updates the state's tensors IN PLACE and
returns the same state object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ilswiss_tpu_torch.algorithms.sac import Adam
from ilswiss_tpu_torch.exploration.strategies import gaussian_and_epsilon
from ilswiss_tpu_torch.models.networks import FlattenMLP
from ilswiss_tpu_torch.models.policies import (
    GaussianNoisePolicy, noisy_action,
)
from ilswiss_tpu_torch.utils.device import resolve_device
from ilswiss_tpu_torch.utils.pytree import copy_params, soft_update


@dataclass(frozen=True)
class TD3Config:
    discount: float = 0.99
    reward_scale: float = 1.0
    soft_target_tau: float = 5e-3
    policy_lr: float = 1e-3
    qf_lr: float = 1e-3
    target_policy_noise: float = 0.2
    target_policy_noise_clip: float = 0.5
    policy_and_target_update_period: int = 2
    exploration_noise: float = 0.1
    # > 0: the HER-TD3 explorer, whole-batch uniform actions with this
    # probability, Gaussian noise of sigma exploration_noise otherwise
    exploration_epsilon: float = 0.0
    q_target_min: float = -float("inf")
    q_target_max: float = float("inf")


@dataclass
class TD3State:
    policy: GaussianNoisePolicy
    qf1: FlattenMLP
    qf2: FlattenMLP
    target_policy: GaussianNoisePolicy
    target_qf1: FlattenMLP
    target_qf2: FlattenMLP
    policy_opt: Adam
    qf1_opt: Adam
    qf2_opt: Adam
    n_train_steps: int


class TD3:
    """Trainer: config, sizes and device; the learned state is a TD3State."""

    def __init__(self, obs_size: int, action_size: int,
                 config: TD3Config = TD3Config(),
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

    def init(self, seed: int) -> TD3State:
        """Fresh state; the init draws come from a CPU generator seeded
        with `seed` (policy, then the two critics)."""
        cfg = self.config
        gen = torch.Generator().manual_seed(seed)
        policy = GaussianNoisePolicy(self.obs_size, self.action_size,
                                     self.hidden, gen).to(self.device)
        qf1, qf2 = (FlattenMLP(self.obs_size + self.action_size,
                               self.hidden, 1, gen).to(self.device)
                    for _ in range(2))
        return TD3State(
            policy=policy, qf1=qf1, qf2=qf2,
            target_policy=copy_params(policy),
            target_qf1=copy_params(qf1), target_qf2=copy_params(qf2),
            policy_opt=Adam(policy.parameters(), cfg.policy_lr, 0.9),
            qf1_opt=Adam(qf1.parameters(), cfg.qf_lr, 0.9),
            qf2_opt=Adam(qf2.parameters(), cfg.qf_lr, 0.9),
            n_train_steps=0,
        )

    def act_noise(self, noise, n: int) -> tuple:
        shape = (n, self.action_size)
        if self.config.exploration_epsilon > 0.0:
            return (noise.flip(()), noise.random_action(shape),
                    noise.act(shape))
        return (noise.act(shape),)

    def train_noise(self, noise, batch_size: int) -> tuple:
        return (noise.smoothing((batch_size, self.action_size)),)

    @torch.no_grad()
    def act(self, state: TD3State, obs: torch.Tensor, *draws: torch.Tensor,
            deterministic: bool = False) -> torch.Tensor:
        """Policy actions in [-1, 1], with `act_noise`'s draws unless
        deterministic."""
        cfg = self.config
        action = state.policy(obs)
        if deterministic:
            return action
        if cfg.exploration_epsilon > 0.0:
            flip, rand, eps = draws
            return gaussian_and_epsilon(action, flip, rand, eps,
                                        epsilon=cfg.exploration_epsilon,
                                        sigma=cfg.exploration_noise)
        (eps,) = draws
        return noisy_action(action, eps, cfg.exploration_noise)

    def train_step(self, state: TD3State, batch: Dict[str, torch.Tensor],
                   eps_target: torch.Tensor
                   ) -> tuple[TD3State, Dict[str, torch.Tensor]]:
        """One gradient step, in place; `eps_target` [B, A] is the N(0, 1)
        noise of the target-policy smoothing.  Returns (state, metrics),
        0-d tensors on the device."""
        cfg = self.config
        obs, actions = batch["obs"], batch["action"]
        rewards = cfg.reward_scale * batch["reward"][:, None]
        terminals = batch["terminal"][:, None]
        next_obs = batch["next_obs"]

        # --- critics (reference td3.py:81-110) ------------------------
        with torch.no_grad():
            target_actions = noisy_action(
                state.target_policy(next_obs), eps_target,
                cfg.target_policy_noise, cfg.target_policy_noise_clip)
            min_t_q = torch.minimum(
                state.target_qf1(next_obs, target_actions),
                state.target_qf2(next_obs, target_actions))
            q_target = torch.clamp(
                rewards + (1.0 - terminals) * cfg.discount * min_t_q,
                cfg.q_target_min, cfg.q_target_max)
        qf1_loss = torch.mean((state.qf1(obs, actions) - q_target) ** 2)
        qf2_loss = torch.mean((state.qf2(obs, actions) - q_target) ** 2)
        state.qf1_opt.step(state.qf1_opt.grad(qf1_loss, self.group))
        state.qf2_opt.step(state.qf2_opt.grad(qf2_loss, self.group))

        # --- delayed policy and target update (td3.py:113-124) --------
        # reported at every step; its gradient is taken where it is used
        policy_loss = -torch.mean(state.qf1(obs, state.policy(obs)))
        if state.n_train_steps % cfg.policy_and_target_update_period == 0:
            state.policy_opt.step(state.policy_opt.grad(policy_loss,
                                                        self.group))
            tau = cfg.soft_target_tau
            soft_update(state.target_policy, state.policy, tau)
            soft_update(state.target_qf1, state.qf1, tau)
            soft_update(state.target_qf2, state.qf2, tau)
        state.n_train_steps += 1

        metrics = {
            "qf1_loss": qf1_loss,
            "qf2_loss": qf2_loss,
            "policy_loss": policy_loss,
            "q_target_mean": torch.mean(q_target),
        }
        return state, {k: v.detach() for k, v in metrics.items()}
