"""DQN / Double DQN (counterpart: ilswiss_tpu/algorithms/dqn.py;
`DQNConfig`, `DQNState`, `DQN`).

Same update as the JAX `DQN.train_step`: a Q network over discrete
actions; the target's value of the online network's argmax (Double DQN)
or of its own max; q_target = reward_scale * r + (1 - terminal) * gamma *
that value; plain MSE on the Q of the stored action; Adam (optax.adam); a
hard target copy when (n_train_steps + 1) % target_update_period == 0.

Epsilon decays linearly from epsilon_start to epsilon_end over
epsilon_decay_steps counts of `n_act_steps`.  Unlike the JAX package,
which adds one to that count per gradient step (dqn.py:143-145; its
comment names a loop hook, `note_env_steps`, that does not exist), the
port counts the env steps of training iterations: the loop calls
`note_env_steps(state, num_envs)` at the end of each.  At K = num_envs
gradient steps an iteration both counts are equal at every `act`; at
exp_specs/dqn/dqn_cartpole.yaml's K = num_envs / 2, epsilon reaches its
end value at 50,000 env steps, where the JAX count stops at 40,000 steps
of 50,000 and leaves epsilon at 0.24 (ROADMAP.md section 3).  The
metric `epsilon` is the value the iteration's acting used.

Acting: the greedy argmax (ties to the first index), or epsilon-greedy
from noise.flip (uniforms [n]) and noise.random_index (integers [n]),
the JAX act's `k_eps` and `k_rand` draws (`act_noise`).  A gradient step
draws nothing.  `train_step` updates the state IN PLACE and returns the
same state object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ilswiss_tpu_torch.algorithms.sac import Adam
from ilswiss_tpu_torch.exploration.strategies import epsilon_greedy
from ilswiss_tpu_torch.models.networks import MLP
from ilswiss_tpu_torch.utils.device import resolve_device
from ilswiss_tpu_torch.utils.pytree import copy_params, hard_update


@dataclass(frozen=True)
class DQNConfig:
    discount: float = 0.99
    reward_scale: float = 1.0
    qf_lr: float = 1e-3
    target_update_period: int = 500
    double_dqn: bool = True
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 50_000


@dataclass
class DQNState:
    qf: MLP
    target_qf: MLP
    qf_opt: Adam
    n_train_steps: int
    n_act_steps: int        # env steps of training iterations


class DQN:
    """Trainer: config, sizes and device; the learned state is a
    DQNState."""

    def __init__(self, obs_size: int, num_actions: int,
                 config: DQNConfig = DQNConfig(),
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

    def init(self, seed: int) -> DQNState:
        """Fresh state; the init draws come from a CPU generator seeded
        with `seed`."""
        gen = torch.Generator().manual_seed(seed)
        qf = MLP(self.obs_size, self.hidden, self.num_actions,
                 gen).to(self.device)
        return DQNState(qf=qf, target_qf=copy_params(qf),
                        qf_opt=Adam(qf.parameters(), self.config.qf_lr, 0.9),
                        n_train_steps=0, n_act_steps=0)

    def epsilon(self, state: DQNState) -> float:
        """start + clip(n_act_steps / decay_steps, 0, 1) * (end - start),
        in float32 as the JAX function computes it."""
        cfg = self.config
        f32 = np.float32
        frac = np.clip(f32(state.n_act_steps) / f32(cfg.epsilon_decay_steps),
                       f32(0.0), f32(1.0))
        return float(f32(cfg.epsilon_start)
                     + frac * (f32(cfg.epsilon_end) - f32(cfg.epsilon_start)))

    def note_env_steps(self, state: DQNState, n: int) -> None:
        """Count `n` env steps of a training iteration toward epsilon's
        decay (in place)."""
        state.n_act_steps += n

    def act_noise(self, noise, n: int) -> tuple:
        return (noise.flip((n,)), noise.random_index((n,), self.num_actions))

    def train_noise(self, noise, batch_size: int) -> tuple:
        return ()

    @torch.no_grad()
    def act(self, state: DQNState, obs: torch.Tensor,
            flip: torch.Tensor | None = None,
            random_action: torch.Tensor | None = None,
            deterministic: bool = False) -> torch.Tensor:
        greedy = torch.argmax(state.qf(obs), dim=-1)
        if deterministic:
            return greedy
        return epsilon_greedy(greedy, flip, random_action,
                              self.epsilon(state))

    def train_step(self, state: DQNState, batch: Dict[str, torch.Tensor]
                   ) -> tuple[DQNState, Dict[str, torch.Tensor]]:
        """One gradient step, in place; returns (state, metrics)."""
        cfg = self.config
        obs = batch["obs"]
        actions = batch["action"].to(torch.int64)[:, None]
        rewards = cfg.reward_scale * batch["reward"][:, None]
        terminals = batch["terminal"][:, None]
        next_obs = batch["next_obs"]

        with torch.no_grad():
            target_q_all = state.target_qf(next_obs)
            if cfg.double_dqn:
                best = torch.argmax(state.qf(next_obs), dim=-1)
                next_q = torch.take_along_dim(target_q_all, best[:, None],
                                              dim=-1)
            else:
                next_q = torch.amax(target_q_all, dim=-1, keepdim=True)
            q_target = rewards + (1.0 - terminals) * cfg.discount * next_q
        q_pred = torch.take_along_dim(state.qf(obs), actions, dim=-1)
        qf_loss = torch.mean((q_pred - q_target) ** 2)
        state.qf_opt.step(state.qf_opt.grad(qf_loss, self.group))
        epsilon = self.epsilon(state)
        state.n_train_steps += 1
        if state.n_train_steps % cfg.target_update_period == 0:
            hard_update(state.target_qf, state.qf)

        metrics = {
            "qf_loss": qf_loss.detach(),
            "q_pred_mean": torch.mean(q_pred).detach(),
            "epsilon": torch.full((), epsilon, device=q_pred.device),
        }
        return state, metrics
