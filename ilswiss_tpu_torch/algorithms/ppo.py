"""PPO with the clipped surrogate (counterpart: ilswiss_tpu/algorithms/ppo.py;
`PPOConfig`, `PPOState`, `PPO`).

The reference trainer (rlkit/torch/algorithms/ppo/ppo.py) as the JAX
package rebuilt it, on a fixed [T, B] rollout:
  - before the passes, from the networks as they are: the values V(s_t)
    and V(s_T) (`last_obs`); with `zero_bootstrap_at_done` the terminals
    are the dones and V(s_T) is 0; GAE with `gae_tau`, then one global
    advantage normalization; the old log-probs under the rollout policy
    (ppo.py:111) on the rollout's observations;
  - the rollout flattened to N = T * B rows; `update_epoch` passes, each
    over one permutation of N cut to n_mb = max(1, N // mini_batch_size)
    minibatches (the ragged tail is dropped);
  - per minibatch, the value step first: MSE against the returns (or, with
    `use_value_clip`, the larger of it and the clipped prediction's) plus
    value_l2_reg * sum(w^2) over every leaf of the value net, biases
    included, Adam at `value_lr`; then the policy step: the clipped
    surrogate -mean(min(r A, clip(r, 1 - eps, 1 + eps) A)), the gradient
    clipped to a global norm of `policy_grad_clip` over every policy leaf
    (optax.clip_by_global_norm: g / norm * max where norm >= max), Adam at
    `policy_lr`.  The two Adams keep their own counts.
  - metrics: `vf_loss` (with the L2 term) and `pg_loss` averaged over every
    minibatch step of every pass, `adv_mean_abs` (of the normalized
    advantages) and `value_mean`.

Draws.  `act` takes the N(0, 1) noise of its sample (`act_noise`: one
`noise.act` [n, A]); `train_step` takes the passes' permutations
(`train_noise`: `noise.permutation(N)` once per pass, stacked [E, N]),
where the JAX step takes `permutation(k, N)` for each of
`split(key, update_epoch)`.

As the port's SAC, `train_step` updates the networks and the Adam moments
IN PLACE and returns the same state object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import torch

from ilswiss_tpu_torch.algorithms.sac import Adam
from ilswiss_tpu_torch.data.rollout import gae, normalize_advantages
from ilswiss_tpu_torch.models import distributions as D
from ilswiss_tpu_torch.models.networks import MLP
from ilswiss_tpu_torch.models.policies import GaussianPolicy
from ilswiss_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class PPOConfig:
    discount: float = 0.99
    reward_scale: float = 1.0
    gae_tau: float = 0.9
    clip_eps: float = 0.2
    policy_lr: float = 3e-4
    value_lr: float = 3e-4
    value_l2_reg: float = 1e-3
    use_value_clip: bool = False
    update_epoch: int = 10
    mini_batch_size: int = 64
    policy_grad_clip: float = 20.0
    zero_bootstrap_at_done: bool = False
    state_dependent_std: bool = False


@dataclass
class PPOState:
    policy: GaussianPolicy
    vf: MLP
    policy_opt: Adam
    vf_opt: Adam


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> list[torch.Tensor]:
    """optax.clip_by_global_norm: every leaf as it is where the global
    norm is under `max_norm`, else (g / norm) * max_norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


class PPO:
    """Trainer: config, sizes and device; the learned state is a PPOState."""

    def __init__(self, obs_size: int, action_size: int,
                 config: PPOConfig = PPOConfig(),
                 net_size: int = 256, num_hidden_layers: int = 2,
                 device=None):
        self.config = config
        self.obs_size = obs_size
        self.action_size = action_size
        self.hidden = (net_size,) * num_hidden_layers
        self.device = resolve_device(device)

    def init(self, seed: int) -> PPOState:
        """Fresh state; the init draws come from a CPU generator seeded
        with `seed` (the policy's, then the value net's), then the tensors
        move to the trainer's device."""
        cfg = self.config
        gen = torch.Generator().manual_seed(seed)
        policy = GaussianPolicy(
            self.obs_size, self.action_size, self.hidden, gen,
            state_dependent_std=cfg.state_dependent_std).to(self.device)
        vf = MLP(self.obs_size, self.hidden, 1, gen).to(self.device)
        return PPOState(
            policy=policy, vf=vf,
            policy_opt=Adam(policy.parameters(), cfg.policy_lr, 0.9),
            vf_opt=Adam(vf.parameters(), cfg.value_lr, 0.9))

    def act_noise(self, noise, n: int) -> tuple[torch.Tensor]:
        """The draws of one stochastic `act` for n envs: (noise.act, N(0, 1)
        [n, A])."""
        return (noise.act((n, self.action_size)),)

    def train_noise(self, noise, n: int) -> tuple[torch.Tensor]:
        """The draws of one `train_step` on n = T * B rollout rows: one
        `noise.permutation(n)` per pass, stacked [update_epoch, n]."""
        return (torch.stack([noise.permutation(n)
                             for _ in range(self.config.update_epoch)]),)

    @torch.no_grad()
    def act(self, state: PPOState, obs: torch.Tensor,
            eps: torch.Tensor | None = None,
            deterministic: bool = False) -> torch.Tensor:
        """mean + exp(log_std) * eps (no squashing), or the mean."""
        mean, log_std = state.policy(obs)
        if deterministic:
            return mean
        return D.normal_sample(mean, log_std, eps)

    def train_step(self, state: PPOState, rollout: Dict[str, torch.Tensor],
                   perms: torch.Tensor
                   ) -> tuple[PPOState, Dict[str, torch.Tensor]]:
        """`rollout`: obs, action, reward, terminal, done [T, B, ...] and
        last_obs [B, ...]; `perms` [update_epoch, T * B] the passes'
        permutations.  In place; returns (state, metrics), 0-d tensors."""
        cfg = self.config
        T, B = rollout["reward"].shape
        obs, actions = rollout["obs"], rollout["action"]
        with torch.no_grad():
            values = state.vf(obs)[..., 0]                        # [T, B]
            last_values = state.vf(rollout["last_obs"])[..., 0]    # [B]
            if cfg.zero_bootstrap_at_done:
                terminals = rollout["done"].to(torch.float32)
                last_values = torch.zeros_like(last_values)
            else:
                terminals = rollout["terminal"].to(torch.float32)
            advantages, returns = gae(
                cfg.reward_scale * rollout["reward"], values, last_values,
                terminals, rollout["done"], cfg.discount, cfg.gae_tau)
            advantages = normalize_advantages(advantages)
            old_mean, old_log_std = state.policy(obs)
            fixed_logp = D.normal_log_prob(old_mean, old_log_std,
                                           actions)[..., 0]
        N = T * B
        flat = {"obs": obs.reshape(N, -1), "action": actions.reshape(N, -1),
                "return": returns.reshape(N), "adv": advantages.reshape(N),
                "fixed_logp": fixed_logp.reshape(N),
                "fixed_v": values.reshape(N)}
        mb = cfg.mini_batch_size
        n_mb = max(1, N // mb)
        vf_losses, pg_losses = [], []
        for perm in perms:
            # one gather a pass: [n_mb, mb, ...]
            rows = perm[:n_mb * mb].reshape(n_mb, mb)
            passes = {k: v[rows] for k, v in flat.items()}
            for i in range(n_mb):
                vf_loss, pg_loss = self.minibatch_step(
                    state, {k: v[i] for k, v in passes.items()})
                vf_losses.append(vf_loss)
                pg_losses.append(pg_loss)
        return state, {
            "vf_loss": torch.stack(vf_losses).mean(),
            "pg_loss": torch.stack(pg_losses).mean(),
            "adv_mean_abs": torch.mean(torch.abs(advantages)),
            "value_mean": torch.mean(values),
        }

    def minibatch_step(self, state: PPOState,
                       batch: Dict[str, torch.Tensor]
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """One minibatch of a pass, in place: the value step, then the
        policy step.  `batch`: obs, action, return, adv, fixed_logp,
        fixed_v.  Returns the two losses, detached."""
        vf_loss = self._vf_loss(state, batch)
        state.vf_opt.step(state.vf_opt.grad(vf_loss))
        pg_loss = self._pg_loss(state, batch)
        state.policy_opt.step(clip_by_global_norm(
            state.policy_opt.grad(pg_loss), self.config.policy_grad_clip))
        return vf_loss.detach(), pg_loss.detach()

    def _vf_loss(self, state: PPOState, batch: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
        cfg = self.config
        v_pred = state.vf(batch["obs"])[..., 0]
        if cfg.use_value_clip:
            v_clip = batch["fixed_v"] + torch.clamp(
                v_pred - batch["fixed_v"], -cfg.clip_eps, cfg.clip_eps)
            loss = torch.mean(torch.maximum(
                (v_pred - batch["return"]) ** 2,
                (v_clip - batch["return"]) ** 2))
        else:
            loss = torch.mean((v_pred - batch["return"]) ** 2)
        l2 = sum(torch.sum(p ** 2) for p in state.vf_opt.params)
        return loss + cfg.value_l2_reg * l2

    def _pg_loss(self, state: PPOState, batch: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
        eps = self.config.clip_eps
        mean, log_std = state.policy(batch["obs"])
        logp = D.normal_log_prob(mean, log_std, batch["action"])[..., 0]
        ratio = torch.exp(logp - batch["fixed_logp"])
        surr1 = ratio * batch["adv"]
        surr2 = torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * batch["adv"]
        return -torch.mean(torch.minimum(surr1, surr2))
