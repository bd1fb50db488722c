"""Soft Actor-Critic with automatic entropy tuning (counterpart:
ilswiss_tpu/algorithms/sac.py).

Same update as the JAX `SAC.train_step`:
  - Q target: r * reward_scale + (1 - terminal) * gamma *
              (min(Q1bar, Q2bar)(s', a') - alpha * log pi(a'|s')),
    optionally clipped to [q_target_min, q_target_max];
  - Q loss: 0.5 * MSE for each critic, summed;
  - policy loss: mean(alpha * log pi - min(Q1, Q2)(s, a_new))
                 + mean_reg * mean(mu^2) + std_reg * mean(log_std^2);
  - alpha loss: -mean(log_alpha * (log pi + target_entropy)) with the
    target detached; target entropy -|A|/2 by default;
  - order: critics first, the policy against the UPDATED critics, then
    alpha; both losses use the previous step's alpha; log alpha is clamped
    to [log min_alpha, log max_alpha]; Polyak tau on both critics.

The twin critics are one stacked pair (`TwinQ`, kernels [2, in, out]),
evaluated as one batched product per layer.  Adam is optax.adam's formula
with b2 = 0.999 and eps = 1e-8.  `train_step` takes its backward from
autograd, as the JAX `train_step` takes its from XLA autodiff.
`train_chain` (with `use_fused_chain`) runs K steps through
ops/fused_sac.py, whose backward is derived by hand: kernel K2 for CUDA
tensors, tensor operations for CPU tensors, no autograd in either.

With a `group` (parallel/mesh.py), `train_step` averages each of its
three gradient groups (the critics', the policy's, log alpha's) across
the group's ranks before its Adam step, where the JAX step calls
`pmean` over its `axis_name`; `Adam.grad` takes the same group for the
trainers built on it.  Without one nothing is reduced.

Unlike the JAX function, `train_step` updates the state's tensors IN
PLACE (parameters, targets, moments, log alpha) and returns the same
state object: that saves a copy of every parameter and moment per step.
Its Gaussian noise comes in as tensors (`eps_next`, `eps_new`), the draws
JAX makes from `split(key)`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence

import torch
from torch import nn

from ilswiss_tpu_torch.models import distributions as D
from ilswiss_tpu_torch.models.networks import FlattenMLP
from ilswiss_tpu_torch.models.policies import TanhGaussianPolicy
from ilswiss_tpu_torch.data.replay import ReplayState, replay_sample
from ilswiss_tpu_torch.ops.fused_mlp import fused_gaussian_policy_forward
from ilswiss_tpu_torch.ops.fused_sac import fused_sac_chain
from ilswiss_tpu_torch.parallel.distributed import all_reduce_mean
from ilswiss_tpu_torch.utils.device import resolve_device
from ilswiss_tpu_torch.utils.profiling import span
from ilswiss_tpu_torch.utils.pytree import (
    copy_into, copy_params, soft_update,
)


@dataclass(frozen=True)
class SACConfig:
    discount: float = 0.99
    reward_scale: float = 1.0
    soft_target_tau: float = 5e-3
    policy_lr: float = 3e-4
    qf_lr: float = 3e-4
    alpha_lr: float = 3e-4
    beta_1: float = 0.9
    policy_mean_reg_weight: float = 1e-3
    policy_std_reg_weight: float = 1e-3
    target_entropy: float | None = None  # default -action_dim / 2
    init_alpha: float = 1.0
    train_alpha: bool = True
    # stability clamp of alpha (see the JAX SACConfig)
    min_alpha: float = 1e-6
    max_alpha: float = 10.0
    q_target_min: float | None = None
    q_target_max: float | None = None


class TwinQ(nn.Module):
    """The two critics stacked on a leading axis of 2: for each layer a
    kernel [2, in, out] (flax layout) and a bias [2, out], named
    `hidden_i_kernel` / `hidden_i_bias` and `output_kernel` /
    `output_bias`.  Each critic is drawn as a FlattenMLP."""

    def __init__(self, input_size: int, hidden_sizes: Sequence[int],
                 generator: torch.Generator):
        super().__init__()
        critics = [FlattenMLP(input_size, hidden_sizes, 1, generator)
                   for _ in range(2)]
        self.names = [f"hidden_{i}" for i in range(len(hidden_sizes))]
        self.names.append("output")
        for name in self.names:
            lin = [getattr(c.mlp, name) for c in critics]
            self.register_parameter(f"{name}_kernel", nn.Parameter(
                torch.stack([l.weight.detach().t() for l in lin])))
            self.register_parameter(f"{name}_bias", nn.Parameter(
                torch.stack([l.bias.detach() for l in lin])))

    def layers(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        return [(getattr(self, f"{n}_kernel"), getattr(self, f"{n}_bias"))
                for n in self.names]

    def forward(self, obs: torch.Tensor, actions: torch.Tensor
                ) -> torch.Tensor:
        """[2, B, 1] Q values: one batched product per layer."""
        x = torch.cat([obs, actions], dim=-1)
        x = x.expand((2,) + x.shape)
        *hidden, (wo, bo) = self.layers()
        for w, b in hidden:
            x = torch.relu(torch.baddbmm(b[:, None, :], x, w))
        return torch.baddbmm(bo[:, None, :], x, wo)


class Adam:
    """optax.adam(lr, b1, b2, eps): mu = b1 mu + (1 - b1) g,
    nu = b2 nu + (1 - b2) g^2, p -= lr * mu_hat / (sqrt(nu_hat) + eps)
    with bias correction by the shared step `count`.  Updates the
    parameters and moments in place."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 b1: float, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def state_dict(self) -> Dict:
        """The moments and the count (the parameters belong to their
        module's state dict)."""
        return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        """Copies the moments in place and sets the count."""
        for name in ("mu", "nu"):
            mine, theirs = getattr(self, name), state[name]
            if len(theirs) != len(mine):
                raise ValueError(f"Adam.{name}: {len(mine)} moments, the "
                                 f"state holds {len(theirs)}")
            for i, (m, t) in enumerate(zip(mine, theirs)):
                copy_into(m, t, f"Adam.{name}[{i}]")
        self.count = int(state["count"])

    def grad(self, loss: torch.Tensor, group=None
             ) -> tuple[torch.Tensor, ...]:
        """d loss / d (this optimizer's parameters), by autograd, averaged
        across the ranks of `group` (parallel/mesh.py) when one is given."""
        return all_reduce_mean(torch.autograd.grad(loss, self.params), group)

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        self.apply(grads, self.count)

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor], t: int) -> None:
        """The update at step `t` (bias correction 1 - b^t); leaves
        `count` alone."""
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            p.sub_(self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)))


@dataclass
class SACState:
    policy: TanhGaussianPolicy
    qf: TwinQ
    target_qf: TwinQ
    log_alpha: torch.Tensor      # 0-d leaf, requires grad
    policy_opt: Adam
    qf_opt: Adam
    alpha_opt: Adam


class SAC:
    """Trainer: config, sizes and device; the learned state is a SACState."""

    def __init__(self, obs_size: int, action_size: int,
                 config: SACConfig = SACConfig(),
                 net_size: int = 256, num_hidden_layers: int = 2,
                 use_fused_act: bool = False, use_fused_chain: bool = False,
                 device=None, group=None):
        self.config = config
        self.obs_size = obs_size
        self.action_size = action_size
        self.hidden = (net_size,) * num_hidden_layers
        # acting through kernel K3 (ops/fused_mlp.py); the training
        # forward stays the nn.Module path
        self.use_fused_act = use_fused_act
        # the loop's K gradient steps per iteration as one call of
        # `train_chain` (kernel K2, ops/fused_sac.py) instead of K
        # `train_step` calls
        self.use_fused_chain = use_fused_chain
        self.device = resolve_device(device)
        # the ranks to average gradients across (JAX: `axis_name`); the
        # loop takes the eager steps under a group, as K2 applies local
        # gradients only
        self.group = group
        self.target_entropy = (config.target_entropy
                               if config.target_entropy is not None
                               else -action_size / 2.0)

    def init(self, seed: int) -> SACState:
        """Fresh state; every init draw comes from a CPU generator seeded
        with `seed`, then the tensors move to the trainer's device."""
        cfg = self.config
        gen = torch.Generator().manual_seed(seed)
        policy = TanhGaussianPolicy(self.obs_size, self.action_size,
                                    self.hidden, gen).to(self.device)
        qf = TwinQ(self.obs_size + self.action_size, self.hidden,
                   gen).to(self.device)
        log_alpha = torch.tensor(math.log(cfg.init_alpha),
                                 device=self.device, requires_grad=True)
        return SACState(
            policy=policy,
            qf=qf,
            target_qf=copy_params(qf),
            log_alpha=log_alpha,
            policy_opt=Adam(policy.parameters(), cfg.policy_lr, cfg.beta_1),
            qf_opt=Adam(qf.parameters(), cfg.qf_lr, cfg.beta_1),
            alpha_opt=Adam([log_alpha], cfg.alpha_lr, cfg.beta_1),
        )

    def act_noise(self, noise, n: int) -> tuple[torch.Tensor]:
        """The draws of one stochastic `act` for n envs: (noise.act, N(0, 1)
        [n, A])."""
        return (noise.act((n, self.action_size)),)

    def train_noise(self, noise, batch_size: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The draws of one `train_step`: noise.train, (eps_next, eps_new)
        N(0, 1) [batch_size, A] each."""
        return noise.train((batch_size, self.action_size))

    def acting_state(self, state: SACState) -> SACState:
        """The acting slice of `state` (JAX sac.py:198-202), what the host
        loops copy to the CPU for acting: the policy; the critics, their
        targets, log alpha and the optimizers are None."""
        return SACState(policy=state.policy, qf=None, target_qf=None,
                        log_alpha=None, policy_opt=None, qf_opt=None,
                        alpha_opt=None)

    @torch.no_grad()
    def act(self, state: SACState, obs: torch.Tensor,
            eps: torch.Tensor | None = None,
            deterministic: bool = False) -> torch.Tensor:
        """Policy actions in [-1, 1]; `eps` [B, A] is the N(0, 1) noise of
        a stochastic action."""
        if self.use_fused_act:
            mean, log_std = fused_gaussian_policy_forward(state.policy, obs)
        else:
            mean, log_std = state.policy(obs)
        if deterministic:
            return torch.tanh(mean)
        return D.tanh_normal_sample(mean, log_std, eps)[0]

    def train_chain(self, state: SACState, replay: ReplayState, noise,
                    batch_size: int, num_steps: int
                    ) -> tuple[SACState, Dict[str, torch.Tensor]]:
        """`num_steps` gradient steps in one call of `fused_sac_chain`, in
        place; returns (state, metrics) with each metric a [num_steps]
        tensor.  The draws are taken from `noise` in the order the loop's
        `train_step` path takes them (for each step `replay`, then
        `train`), so both paths see the same batches and noise."""
        shape = (batch_size, self.action_size)
        with span("learner.chain"):
            with span("learner.draws"):
                u, eps_next, eps_new = [], [], []
                for _ in range(num_steps):
                    u.append(noise.replay(batch_size))
                    e_next, e_new = noise.train(shape)
                    eps_next.append(e_next)
                    eps_new.append(e_new)
                u, eps_next, eps_new = (torch.stack(u), torch.stack(eps_next),
                                        torch.stack(eps_new))
            batches = replay_sample(replay, u)
            return fused_sac_chain(self, state, batches, eps_next, eps_new)

    def train_step(self, state: SACState, batch: Dict[str, torch.Tensor],
                   eps_next: torch.Tensor, eps_new: torch.Tensor
                   ) -> tuple[SACState, Dict[str, torch.Tensor]]:
        """One gradient step, in place; returns (state, metrics).  The
        metrics are 0-d tensors on the device."""
        cfg = self.config
        obs = batch["obs"]
        actions = batch["action"]
        rewards = cfg.reward_scale * batch["reward"][:, None]
        terminals = batch["terminal"][:, None]
        next_obs = batch["next_obs"]
        alpha = torch.exp(state.log_alpha.detach())   # previous-step alpha

        # --- critic update ---------------------------------------------
        with torch.no_grad():
            next_mean, next_log_std = state.policy(next_obs)
            next_actions, next_pre = D.tanh_normal_sample(
                next_mean, next_log_std, eps_next)
            next_log_pi = D.tanh_normal_log_prob(
                next_mean, next_log_std, next_actions, next_pre)
            min_t_q = torch.amin(
                state.target_qf(next_obs, next_actions), dim=0)
            q_target = rewards + (1.0 - terminals) * cfg.discount * (
                min_t_q - alpha * next_log_pi)
            if cfg.q_target_min is not None or cfg.q_target_max is not None:
                q_target = torch.clamp(q_target, cfg.q_target_min,
                                       cfg.q_target_max)
        q_pred = state.qf(obs, actions)                      # [2, B, 1]
        qf_losses = 0.5 * torch.mean((q_pred - q_target[None]) ** 2,
                                     dim=(1, 2))
        qf_params = list(state.qf.parameters())
        gq = all_reduce_mean(torch.autograd.grad(torch.sum(qf_losses),
                                                 qf_params), self.group)
        state.qf_opt.step(gq)

        # --- policy update against the updated critics -----------------
        mean, log_std = state.policy(obs)
        new_actions, pre = D.tanh_normal_sample(mean, log_std, eps_new)
        log_pi = D.tanh_normal_log_prob(mean, log_std, new_actions, pre)
        q_new = torch.amin(state.qf(obs, new_actions), dim=0)
        loss = torch.mean(alpha * log_pi - q_new)
        reg = (cfg.policy_mean_reg_weight * torch.mean(mean ** 2)
               + cfg.policy_std_reg_weight * torch.mean(log_std ** 2))
        policy_loss = loss + reg
        gp = all_reduce_mean(torch.autograd.grad(
            policy_loss, list(state.policy.parameters())), self.group)
        state.policy_opt.step(gp)

        # --- alpha update ----------------------------------------------
        target = (log_pi + self.target_entropy).detach()
        alpha_loss = -torch.mean(state.log_alpha * target)
        if cfg.train_alpha:
            (ga,) = all_reduce_mean(torch.autograd.grad(
                alpha_loss, [state.log_alpha]), self.group)
            state.alpha_opt.step([ga])
            with torch.no_grad():
                state.log_alpha.clamp_(math.log(cfg.min_alpha),
                                       math.log(cfg.max_alpha))

        # --- target Polyak ---------------------------------------------
        soft_update(state.target_qf, state.qf, cfg.soft_target_tau)

        metrics = {
            "qf1_loss": qf_losses[0],
            "qf2_loss": qf_losses[1],
            "policy_loss": policy_loss,
            "alpha_loss": alpha_loss,
            "alpha": alpha,
            "q1_pred_mean": torch.mean(q_pred[0]),
            "q2_pred_mean": torch.mean(q_pred[1]),
            "log_pi_mean": torch.mean(log_pi),
        }
        return state, {k: v.detach() for k, v in metrics.items()}
