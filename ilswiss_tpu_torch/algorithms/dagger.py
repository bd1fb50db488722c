"""DAgger: dataset aggregation (counterpart:
ilswiss_tpu/algorithms/dagger.py; `DAggerLoopConfig`, `DAggerRunnerState`,
`DAggerLoop`).

The learner's ring is seeded with the expert demos (the first `n` rows,
cursor at n), then every on-policy step of the learner is stored with its
action RELABELED by the queried expert on the pre-step observation, and
BC trains on the aggregate.  `pretrain` takes `num_initial_train_steps`
steps on the seeded ring before any rollout.

`expert_fn(obs) -> action` is the queried expert: a scripted controller
(envs/experts.py) or a frozen trained policy acting deterministically.

The JAX package scans an epoch in one jitted program; here it is a loop
of eager calls.  Draws per iteration: the learner's `act_noise`, the
step's reset, then per gradient step noise.replay and the BC step's
`train_noise`; `pretrain` draws per step noise.replay and `train_noise`.

The seeded cursor n need not be a multiple of the env count, so a write
may cross the ring's wrap: `replay_add` splits it there, where the JAX
write lands clamped at capacity - B (ROADMAP.md section 3).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from ilswiss_tpu_torch.algorithms.bc import BC
from ilswiss_tpu_torch.data.replay import (
    ReplayState, replay_add, replay_init, replay_sample,
)
from ilswiss_tpu_torch.envs.base import EnvState
from ilswiss_tpu_torch.envs.vector import VectorEnv
from ilswiss_tpu_torch.runtime.loop import Noise


@dataclass(frozen=True)
class DAggerLoopConfig:
    batch_size: int = 256
    aggregate_capacity: int = 200_000
    grad_steps_per_iter: int | None = None   # default: num_envs


@dataclass
class DAggerRunnerState:
    noise: Any
    env_state: EnvState
    aggregate: ReplayState
    algo_state: Any
    total_env_steps: int


class DAggerLoop:
    def __init__(self, vec_env: VectorEnv, bc: BC, expert_fn: Callable,
                 expert_replay: ReplayState,
                 config: DAggerLoopConfig = DAggerLoopConfig()):
        self.vec_env = vec_env
        self.algo = bc
        self.expert_fn = expert_fn
        self.expert_replay = expert_replay
        self.config = config
        self.device = vec_env.env.device
        self.grad_steps_per_iter = (config.grad_steps_per_iter
                                    or vec_env.num_envs)

    def init(self, seed: int, noise=None) -> DAggerRunnerState:
        """Fresh runner: BC state from `seed`, the ring seeded with the
        demos, the env reset and every later draw from `noise` (default
        `Noise(seed + 1, device)`)."""
        noise = Noise(seed + 1, self.device) if noise is None else noise
        env, B = self.vec_env.env, self.vec_env.num_envs
        agg = replay_init(self.config.aggregate_capacity,
                          env.observation_size, env.action_size,
                          write_batch=B, device=self.device)
        n = self.expert_replay.size
        cap = agg.data["reward"].shape[0]
        if n > cap:
            raise ValueError(f"{n} demo rows do not fit the aggregate ring "
                             f"of {cap} rows")
        for k, v in agg.data.items():
            v[:n] = self.expert_replay.data[k][:n]
        agg.ptr, agg.size = n % cap, n
        return DAggerRunnerState(
            noise=noise,
            env_state=self.vec_env.reset(noise.reset(env, B)),
            aggregate=agg,
            algo_state=self.algo.init(seed),
            total_env_steps=0,
        )

    def _grad_steps(self, runner: DAggerRunnerState, steps: int
                    ) -> Dict[str, torch.Tensor]:
        """`steps` BC steps on the aggregate, in place; the metrics'
        sums."""
        bs = self.config.batch_size
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(steps):
            batch = replay_sample(runner.aggregate, runner.noise.replay(bs))
            runner.algo_state, metrics = self.algo.train_step(
                runner.algo_state, batch,
                *self.algo.train_noise(runner.noise, bs))
            for k, v in metrics.items():
                sums[k] = v if k not in sums else sums[k] + v
        return sums

    def _iter(self, runner: DAggerRunnerState) -> Dict[str, torch.Tensor]:
        """One iteration in place: the learner acts, the expert relabels,
        the aggregate grows by num_envs rows, then `grad_steps_per_iter`
        BC steps; returns the metrics' means."""
        env, B = self.vec_env.env, self.vec_env.num_envs
        noise = runner.noise
        action = self.algo.act(runner.algo_state, runner.env_state.obs,
                               *self.algo.act_noise(noise, B))
        runner.env_state, tr = self.vec_env.step(
            runner.env_state, action, noise.reset(env, B))
        with torch.no_grad():
            relabeled = dataclasses.replace(tr, action=self.expert_fn(tr.obs))
        replay_add(runner.aggregate, relabeled)
        runner.total_env_steps += B
        sums = self._grad_steps(runner, self.grad_steps_per_iter)
        return {k: v / self.grad_steps_per_iter for k, v in sums.items()}

    def pretrain(self, runner: DAggerRunnerState,
                 initial_train_steps: int = 1000) -> DAggerRunnerState:
        """Expert-only training before any rollout, in place."""
        self._grad_steps(runner, initial_train_steps)
        return runner

    def train_epoch(self, runner: DAggerRunnerState, steps_per_epoch: int
                    ) -> tuple[DAggerRunnerState, Dict[str, float]]:
        """max(1, steps_per_epoch // num_envs) iterations; returns the
        per-epoch means of the metrics as floats."""
        iters = max(1, steps_per_epoch // self.vec_env.num_envs)
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(iters):
            for k, v in self._iter(runner).items():
                sums[k] = v if k not in sums else sums[k] + v
        return runner, {k: float(v / iters) for k, v in sums.items()}
