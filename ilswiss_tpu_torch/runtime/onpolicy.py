"""On-policy loop: rollout, then one update on it (counterpart:
ilswiss_tpu/runtime/onpolicy.py; `OnPolicyConfig`, `OnPolicyRunnerState`,
`OnPolicyLoop`).

    iteration = T x (act -> vec-env step) -> observation moments ->
                algo.train_step(rollout)

The JAX package scans the T acting steps and the update inside one jitted
program; here they are eager PyTorch calls.  The rollout is a fixed
`[T, B, ...]` stack, made anew every iteration (the reference's
`sample_all_trajs` -> train -> `clear_buffer`).

With `normalize_obs` the runner holds running observation moments
(utils/running_stats.py), and the order inside an iteration is the JAX
package's: the T acting steps normalize the observations with the OLD
moments; the moments then merge all T * B rollout observations; the
rollout's `obs` and `last_obs` are normalized with the NEW moments before
`train_step` (so the update's old log-probs are those of observations
the acting policy saw normalized otherwise).

Draws.  Every draw comes from the runner's `noise` (runtime/loop.py::
Noise), in this order: per acting step, the algorithm's `act_noise(noise,
B)` and then `reset` (the reset draws of the envs whose episode ends);
then the update's `train_noise(noise, T * B)` (PPO: one `permutation` per
pass).  The JAX iteration splits its key into (rng, k_roll, k_train), acts
with `split(k_roll, T)` and draws its resets from the env state's keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from ilswiss_tpu_torch.envs.base import EnvState
from ilswiss_tpu_torch.envs.vector import VectorEnv
from ilswiss_tpu_torch.runtime.loop import Noise
from ilswiss_tpu_torch.utils.running_stats import (
    RunningMeanStd, normalize, running_mean_std_init,
    running_mean_std_update,
)


@dataclass(frozen=True)
class OnPolicyConfig:
    rollout_length: int = 128      # T env steps per update (per env)
    # running observation normalization (the reference vec-env's obs_rms)
    normalize_obs: bool = False
    obs_clip: float = 10.0


@dataclass
class OnPolicyRunnerState:
    noise: Any
    env_state: EnvState            # batched [num_envs]
    algo_state: Any
    total_env_steps: int
    obs_rms: RunningMeanStd | None = None


class OnPolicyLoop:
    """For an algorithm with `init(seed)`, `act(state, obs, *draws)` with
    `act_noise(noise, n)`, and `train_step(state, rollout, *draws)` with
    `train_noise(noise, n)` (PPO)."""

    def __init__(self, vec_env: VectorEnv, algo,
                 config: OnPolicyConfig = OnPolicyConfig()):
        self.vec_env = vec_env
        self.algo = algo
        self.config = config
        self.device = vec_env.env.device

    def init(self, seed: int, noise=None) -> OnPolicyRunnerState:
        """Fresh runner: algorithm state from `seed`, env reset and every
        later draw from `noise` (default `Noise(seed + 1, device)`)."""
        noise = Noise(seed + 1, self.device) if noise is None else noise
        env, n = self.vec_env.env, self.vec_env.num_envs
        return OnPolicyRunnerState(
            noise=noise,
            env_state=self.vec_env.reset(noise.reset(env, n)),
            algo_state=self.algo.init(seed),
            total_env_steps=0,
            obs_rms=(running_mean_std_init((env.observation_size,),
                                           self.device)
                     if self.config.normalize_obs else None))

    def normalize(self, obs_rms: RunningMeanStd | None, obs: torch.Tensor
                  ) -> torch.Tensor:
        """`obs` as the algorithm sees it: normalized by `obs_rms` and
        clipped to +-obs_clip, or as it is without moments."""
        if obs_rms is None:
            return obs
        return normalize(obs_rms, obs, self.config.obs_clip)

    def rollout(self, runner: OnPolicyRunnerState
                ) -> tuple[EnvState, Dict[str, torch.Tensor],
                           RunningMeanStd | None]:
        """The T acting steps from the runner's state, and the moments
        merged with their observations: (the envs' state after them, the
        rollout as `train_step` takes it, the new moments).  The runner is
        left as it was, but for the draws taken from its noise."""
        algo, vec, noise = self.algo, self.vec_env, runner.noise
        env, n = vec.env, vec.num_envs
        env_state = runner.env_state
        steps = []
        for _ in range(self.config.rollout_length):
            action = algo.act(runner.algo_state,
                              self.normalize(runner.obs_rms, env_state.obs),
                              *algo.act_noise(noise, n))
            env_state, tr = vec.step(env_state, action, noise.reset(env, n))
            steps.append(tr)
        obs = torch.stack([tr.obs for tr in steps])            # [T, B, O]
        obs_rms = runner.obs_rms
        if obs_rms is not None:
            obs_rms = running_mean_std_update(
                obs_rms, obs.reshape(-1, obs.shape[-1]))
        rollout = {
            "obs": self.normalize(obs_rms, obs),
            "action": torch.stack([tr.action for tr in steps]),
            "reward": torch.stack([tr.reward for tr in steps]),
            "terminal": torch.stack([tr.terminal for tr in steps]),
            "done": torch.stack([tr.done for tr in steps]),
            "last_obs": self.normalize(obs_rms, env_state.obs),
        }
        return env_state, rollout, obs_rms

    def _iter(self, runner: OnPolicyRunnerState
              ) -> tuple[OnPolicyRunnerState, Dict[str, torch.Tensor]]:
        env_state, rollout, obs_rms = self.rollout(runner)
        n = rollout["reward"].numel()
        runner.algo_state, metrics = self.algo.train_step(
            runner.algo_state, rollout,
            *self.algo.train_noise(runner.noise, n))
        metrics["rollout_reward_mean"] = torch.mean(rollout["reward"])
        runner.env_state = env_state
        runner.obs_rms = obs_rms
        runner.total_env_steps += n
        return runner, metrics

    def warmup(self, runner: OnPolicyRunnerState) -> OnPolicyRunnerState:
        """On-policy training has no warmup: the runner as it is."""
        return runner

    def train_epoch(self, runner: OnPolicyRunnerState, steps_per_epoch: int
                    ) -> tuple[OnPolicyRunnerState, Dict[str, float]]:
        """max(1, steps_per_epoch // (T * num_envs)) iterations; returns
        the per-epoch means of the metrics as floats (kept on the device
        until the epoch ends)."""
        iters = max(1, steps_per_epoch // (self.config.rollout_length
                                           * self.vec_env.num_envs))
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(iters):
            runner, metrics = self._iter(runner)
            for k, v in metrics.items():
                sums[k] = v if k not in sums else sums[k] + v
        return runner, {k: float(v / iters) for k, v in sums.items()}
