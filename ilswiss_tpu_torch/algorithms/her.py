"""HER: hindsight experience replay over an inner off-policy trainer
(counterpart: ilswiss_tpu/algorithms/her.py:30-189; `goal_concat`, `HER`,
`HERLoopConfig`, `HERRunnerState`, `HERLoop`).

`HER` gives the inner trainer (SAC, or TD3 with the reference's target
clip q_target_min = -1 / (1 - gamma), q_target_max = 0 and the
Gaussian-and-epsilon explorer) goal-concatenated views: the policy and
critics see concat(observation, desired_goal), the relabeled goal on both
ends of a transition.  `HERLoop` is the off-policy loop over the episodic
hindsight ring (data/her.py): a warmup of min_episodes_before_training *
max_episode_steps iterations of uniform random actions, then iterations
of act -> step -> store -> K gradient steps on relabeled batches.  The
JAX package scans them in jitted programs; here they are eager calls.

Draws per iteration: the acting draws (the inner trainer's `act_noise`;
warmup: `warmup_action`, or `warmup_index` for a discrete env in GCSL's
loop), `reset`, then per gradient step `hindsight` (the batch) and the
inner step's `train_noise`.  `HostHERLoop` (JAX her.py:190-) runs host
goal envs, ROADMAP.md section 1 item 2.8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from ilswiss_tpu_torch.data.her import (
    HindsightReplayBuffer, HindsightReplayState,
)
from ilswiss_tpu_torch.envs.base import EnvState
from ilswiss_tpu_torch.envs.vector import VectorEnv
from ilswiss_tpu_torch.runtime.loop import Noise


def goal_concat(obs_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([obs_dict["observation"], obs_dict["desired_goal"]],
                     dim=-1)


class HER:
    """Adapter: the inner trainer sees concat(observation, desired_goal)."""

    def __init__(self, policy_trainer):
        self.inner = policy_trainer

    def init(self, seed: int):
        return self.inner.init(seed)

    def act_noise(self, noise, n: int) -> tuple:
        return self.inner.act_noise(noise, n)

    def train_noise(self, noise, batch_size: int) -> tuple:
        return self.inner.train_noise(noise, batch_size)

    def act(self, state, obs_dict, *draws, deterministic: bool = False):
        return self.inner.act(state, goal_concat(obs_dict), *draws,
                              deterministic=deterministic)

    def train_step(self, state, her_batch: Dict[str, torch.Tensor], *draws):
        batch = {
            "obs": torch.cat([her_batch["observation"],
                              her_batch["desired_goal"]], dim=-1),
            "action": her_batch["action"],
            "reward": her_batch["reward"],
            "terminal": her_batch["terminal"],
            # the relabeled goal applies to both ends of the transition
            # (relabel_replay_buffer.py:104-117)
            "next_obs": torch.cat([her_batch["next_observation"],
                                   her_batch["desired_goal"]], dim=-1),
        }
        return self.inner.train_step(state, batch, *draws)


@dataclass(frozen=True)
class HERLoopConfig:
    batch_size: int = 256
    num_episode_slots: int = 1024
    grad_steps_per_iter: int | None = None   # default: num_envs
    min_episodes_before_training: int = 2    # per env


@dataclass
class HERRunnerState:
    noise: Any
    env_state: EnvState
    replay: HindsightReplayState
    algo_state: Any
    total_env_steps: int


class HERLoop:
    """The loop for an algorithm with `init(seed)`, `act(state, obs_dict,
    *draws)` with `act_noise(noise, n)`, and `train_step(state, batch,
    *draws)` with `train_noise(noise, batch_size)`: `HER`, and GCSL
    through its subclass `GCSLLoop`."""

    return_horizon = False

    def __init__(self, vec_env: VectorEnv, her, config: HERLoopConfig =
                 HERLoopConfig(), relabel_type: str | None = "future",
                 her_ratio: float = 0.8):
        self.vec_env = vec_env
        self.algo = her
        self.config = config
        self.device = vec_env.env.device
        self.buffer = HindsightReplayBuffer(
            vec_env.env, vec_env.num_envs, config.num_episode_slots,
            vec_env.env.max_episode_steps, relabel_type=relabel_type,
            her_ratio=her_ratio)
        self.grad_steps_per_iter = (
            config.grad_steps_per_iter
            if config.grad_steps_per_iter is not None
            else vec_env.num_envs)

    def init(self, seed: int, noise=None) -> HERRunnerState:
        """Fresh runner: algorithm state from `seed`, the env reset and
        every later draw from `noise` (default `Noise(seed + 1, device)`)."""
        noise = Noise(seed + 1, self.device) if noise is None else noise
        return HERRunnerState(
            noise=noise,
            env_state=self.vec_env.reset(
                noise.reset(self.vec_env.env, self.vec_env.num_envs)),
            replay=self.buffer.init(),
            algo_state=self.algo.init(seed),
            total_env_steps=0,
        )

    def _random_action(self, noise) -> torch.Tensor:
        env = self.vec_env.env
        return noise.warmup_action((self.vec_env.num_envs, env.action_size))

    def _collect(self, runner: HERRunnerState, random_actions: bool
                 ) -> HERRunnerState:
        noise, n, env = runner.noise, self.vec_env.num_envs, self.vec_env.env
        if random_actions:
            action = self._random_action(noise)
        else:
            action = self.algo.act(runner.algo_state, runner.env_state.obs,
                                   *self.algo.act_noise(noise, n))
        runner.env_state, tr = self.vec_env.step(
            runner.env_state, action, noise.reset(env, n))
        self.buffer.add(runner.replay, tr)
        runner.total_env_steps += n
        return runner

    def _train_iter(self, runner: HERRunnerState
                    ) -> tuple[HERRunnerState, Dict[str, torch.Tensor]]:
        runner = self._collect(runner, random_actions=False)
        bs, n = self.config.batch_size, self.vec_env.num_envs
        sums: Dict[str, torch.Tensor] = {}
        state = runner.algo_state
        for _ in range(self.grad_steps_per_iter):
            batch = self.buffer.sample(
                runner.replay, runner.noise.hindsight(bs, n), bs,
                return_horizon=self.return_horizon)
            state, metrics = self.algo.train_step(
                state, batch, *self.algo.train_noise(runner.noise, bs))
            for k, v in metrics.items():
                sums[k] = v if k not in sums else sums[k] + v
        runner.algo_state = state
        return runner, {k: v / self.grad_steps_per_iter
                        for k, v in sums.items()}

    # ------------------------------------------------------------------
    def warmup(self, runner: HERRunnerState) -> HERRunnerState:
        """min_episodes_before_training * max_episode_steps iterations of
        random actions, so that every env has completed episodes."""
        iters = (self.config.min_episodes_before_training
                 * self.vec_env.env.max_episode_steps)
        for _ in range(iters):
            runner = self._collect(runner, random_actions=True)
        return runner

    def train_epoch(self, runner: HERRunnerState, steps_per_epoch: int
                    ) -> tuple[HERRunnerState, Dict[str, float]]:
        """max(1, steps_per_epoch // num_envs) training iterations; returns
        the per-epoch means of the metrics as floats."""
        iters = max(1, steps_per_epoch // self.vec_env.num_envs)
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(iters):
            runner, metrics = self._train_iter(runner)
            for k, v in metrics.items():
                sums[k] = v if k not in sums else sums[k] + v
        return runner, {k: float(v / iters) for k, v in sums.items()}
