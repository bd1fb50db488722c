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
inner step's `train_noise`.

`HostHERLoop` (JAX her.py:190-389) runs a host goal env (the Fetch family
through envs/host_mujoco.py::HostGoalVectorEnv): dict-obs segments of
`segment_steps` env steps are collected on the host, acting with a CPU
copy of the algorithm's state, while the hindsight ring, the relabeled
sampling and `grad_steps_per_segment` inner steps run on the learner's
device.  Its draws are runtime/host_loop.py's: the collector's from
`collector_noise(seed, env steps)` (the warmup's uniform actions too,
where the JAX loop takes the unseeded `np.random`), the learner's from the
runner's `noise`, per gradient step `hindsight` then the inner step's.
Its evaluation reports SuccessRate from the env's is_success info
(reference eval_util.get_generic_path_information:33-59).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ilswiss_tpu_torch.data.her import (
    HindsightReplayBuffer, HindsightReplayState,
)
from ilswiss_tpu_torch.envs.base import EnvState
from ilswiss_tpu_torch.envs.vector import Transition, VectorEnv
from ilswiss_tpu_torch.runtime.host_loop import (
    collector_noise, evaluate_host, mean_metrics,
)
from ilswiss_tpu_torch.runtime.loop import Noise
from ilswiss_tpu_torch.utils.pytree import cpu_copy


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


# --------------------------------------------------------------------------
@dataclass
class HostHERRunnerState:
    noise: Any                # the learner's draws
    replay: HindsightReplayState
    algo_state: Any
    total_env_steps: int
    seed: int                 # seeds the collector's draws


class HostHERLoop:
    """HER on a host goal env (numpy dict observations, `step` returning
    (obs_prev, true_next, reward, terminal, done, obs_after, success)):
    per segment, `segment_steps` host steps, then the segment into the
    hindsight ring and `grad_steps_per_segment` relabeled inner steps."""

    def __init__(self, env, her: HER, config: HERLoopConfig = HERLoopConfig(),
                 relabel_type: str | None = "future", her_ratio: float = 0.8,
                 grad_steps_per_segment: int | None = None,
                 segment_steps: int = 1000):
        self.env = env
        self.algo = her
        self.config = config
        self.device = her.inner.device
        self.segment_steps = segment_steps
        self.grad_steps_per_segment = (
            grad_steps_per_segment if grad_steps_per_segment is not None
            else segment_steps)
        self.buffer = HindsightReplayBuffer(
            env, env.num_envs, config.num_episode_slots,
            env.max_episode_steps, relabel_type=relabel_type,
            her_ratio=her_ratio, device=self.device)
        self._obs = None

    def init(self, seed: int = 0, noise=None) -> HostHERRunnerState:
        self._obs = self.env.reset(seed=seed)
        return HostHERRunnerState(
            noise=Noise(seed + 1, self.device) if noise is None else noise,
            replay=self.buffer.init(),
            algo_state=self.algo.init(seed),
            total_env_steps=0,
            seed=seed)

    def _collect_segment(self, runner: HostHERRunnerState, num_steps: int,
                         random_actions: bool) -> Dict[str, Any]:
        """max(1, num_steps // B) host steps; the [T, B, ...] numpy
        segment, its observations dicts."""
        B, A = self.env.num_envs, self.env.action_size
        noise = collector_noise(runner.seed, runner.total_env_steps)
        state_cpu = None if random_actions else cpu_copy(runner.algo_state)
        rows = []
        with torch.no_grad():
            for _ in range(max(1, num_steps // B)):
                if random_actions:
                    action = noise.warmup_action((B, A)).numpy()
                else:
                    obs = {k: torch.as_tensor(v) for k, v in self._obs.items()}
                    action = self.algo.act(
                        state_cpu, obs, *self.algo.act_noise(noise, B)).numpy()
                obs_prev, true_next, reward, terminal, done, obs_after, _ = (
                    self.env.step(action))
                self._obs = obs_after
                rows.append((obs_prev, action, reward, true_next, terminal,
                             done))
        stack = lambda i: np.stack([r[i] for r in rows])  # noqa: E731
        stackd = lambda i: {k: np.stack([r[i][k] for r in rows])  # noqa: E731
                            for k in rows[0][i]}
        return {"obs": stackd(0), "action": stack(1), "reward": stack(2),
                "next_obs": stackd(3), "terminal": stack(4),
                "done": stack(5)}

    def _ingest(self, runner: HostHERRunnerState, segment) -> int:
        """The segment into the hindsight ring (one host-to-device copy per
        field); returns its env steps."""
        dev = self.device
        seg = {k: ({kk: torch.as_tensor(vv).to(dev) for kk, vv in v.items()}
                   if isinstance(v, dict) else torch.as_tensor(v).to(dev))
               for k, v in segment.items()}
        T = seg["reward"].shape[0]
        for t in range(T):
            self.buffer.add(runner.replay, Transition(
                obs={k: v[t] for k, v in seg["obs"].items()},
                action=seg["action"][t], reward=seg["reward"][t],
                next_obs={k: v[t] for k, v in seg["next_obs"].items()},
                terminal=seg["terminal"][t], done=seg["done"][t]))
        return int(seg["reward"].numel())

    def ingest_and_train(self, runner: HostHERRunnerState, segment
                         ) -> tuple[HostHERRunnerState,
                                    Dict[str, torch.Tensor]]:
        self._ingest(runner, segment)
        bs, n = self.config.batch_size, self.env.num_envs
        state, out = runner.algo_state, []
        for _ in range(self.grad_steps_per_segment):
            batch = self.buffer.sample(runner.replay,
                                       runner.noise.hindsight(bs, n), bs)
            state, m = self.algo.train_step(
                state, batch, *self.algo.train_noise(runner.noise, bs))
            out.append(m)
        runner.algo_state = state
        return runner, {k: torch.stack([m[k] for m in out]).mean()
                        for k in out[0]}

    def warmup(self, runner: HostHERRunnerState, min_steps: int | None = None
               ) -> HostHERRunnerState:
        """`min_steps` (default min_episodes_before_training episodes of
        every env) steps of uniform [-1, 1] actions into the ring."""
        min_steps = min_steps or (self.config.min_episodes_before_training
                                  * self.env.max_episode_steps
                                  * self.env.num_envs)
        seg = self._collect_segment(runner, min_steps, random_actions=True)
        runner.total_env_steps += self._ingest(runner, seg)
        return runner

    def train_epoch(self, runner: HostHERRunnerState, steps_per_epoch: int
                    ) -> tuple[HostHERRunnerState, Dict[str, float]]:
        """max(1, steps_per_epoch // segment_steps) segments; the metrics'
        means over them as floats."""
        metrics = []
        for _ in range(max(1, steps_per_epoch // self.segment_steps)):
            seg = self._collect_segment(runner, self.segment_steps,
                                        random_actions=False)
            runner, m = self.ingest_and_train(runner, seg)
            runner.total_env_steps += int(seg["reward"].size)
            metrics.append(m)
        return runner, mean_metrics(metrics)

    def evaluate(self, runner: HostHERRunnerState, num_episodes: int,
                 seed: int = 0) -> Dict[str, float]:
        """Deterministic-policy episodes with SuccessRate; the env is reset
        afterwards (seed + 20_000), as in the JAX package."""
        state_cpu = cpu_copy(runner.algo_state)

        @torch.no_grad()
        def act(obs):
            return self.algo.act(
                state_cpu, {k: torch.as_tensor(v) for k, v in obs.items()},
                deterministic=True).numpy()

        stats, _ = evaluate_host(self.env, act, num_episodes, seed,
                                 success=True)
        self._obs = self.env.reset(seed=seed + 20_000)
        return stats
