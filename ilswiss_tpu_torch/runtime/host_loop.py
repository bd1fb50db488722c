"""Actor-learner split for host-simulated envs (counterpart:
ilswiss_tpu/runtime/host_loop.py; `HostLoopConfig`, `HostRunnerState`,
`HostOffPolicyLoop`, `HostOnPolicyRunnerState`, `HostOnPolicyLoop`).

For envs that step on the host (MuJoCo's C engine, Box2D, Fetch:
envs/host_mujoco.py, envs/native_mujoco.py) the loop splits: acting runs
on the CPU against the host vector env, and learning runs on the
learner's device (`algo.device`).  Transitions cross to the device once
per collection segment (`steps_between_train_calls` env steps), one
`to(device)` per field, and the acting parameters cross back once per
segment.

The learner is `ingest_and_train`: the segment into the ring, then
`train_steps_per_call` eager `train_step`s on uniform batches, or one
`algo.train_call` when the algorithm owns its schedule (AdvIRL: one call
per segment, the reference's cadence).  With `overlap_collection` (the
default) segment t + 1 is collected on a background thread while the
learner trains on segment t, acting with the parameters from before that
train call (one segment of staleness); without it the loop alternates.
The metrics stay on the learner's device until the epoch ends, and cross
in one copy.

Acting snapshot.  The trainers update their parameters in place, so the
collector acts on `utils/pytree.py::cpu_copy` of the algorithm's acting
slice (`algo.acting_state`, else the whole state): a true copy on every
device (`.cpu()` of a CPU tensor is the tensor itself, which the learner
would update under the collector's feet).

Draws.  The learner draws from the runner's `noise` (runtime/loop.py::
Noise on the learner's device): per gradient step `replay` (the batch)
and the step's `train_noise`, or `train_call`'s own.  The collector
never does: each segment draws from a CPU generator of its own,
`collector_noise(runner.seed, env steps taken before it)` (the JAX
`fold_in(rng, total_env_steps)`), so the draws do not depend on thread
timing.  The warmup's uniform actions come from it too
(`Noise.warmup_action`), where the JAX package draws them from the
unseeded global `np.random`, so two JAX runs of one seed fill different
rings (ROADMAP.md section 3).  Under overlap the JAX collector folds in
the count of the steps ingested, so the first two segments of every
epoch repeat one key; here a segment is seeded with the steps the actor
has taken before it, which differ.

`total_env_steps` and `seed` are fields of the runner, so a snapshot
holds them and a full resume continues the count (the JAX field is
static and no snapshot holds it).  The host env's state is in no
snapshot: a resumed run starts from a fresh reset, as in the JAX package.

On-policy (`HostOnPolicyLoop`): a [T, B] rollout collected with the
acting snapshot, then on the learner the running observation moments
merge the rollout's T * B observations before `obs` and `last_obs` are
normalized with them, and `algo.train_step` takes the rollout, as the
device `OnPolicyLoop` does.  Acting normalizes with the moments from
before the rollout.

The loops time their phases through `utils/profiling.py::phase`
("sample", "train"; the JAX switch ILSWISS_HOST_LOOP_DEBUG has no
counterpart).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ilswiss_tpu_torch.data.replay import ReplayState, replay_add, replay_init
from ilswiss_tpu_torch.envs.vector import Transition
from ilswiss_tpu_torch.runtime.loop import Noise, sample_uniform
from ilswiss_tpu_torch.utils.profiling import phase
from ilswiss_tpu_torch.utils.pytree import cpu_copy
from ilswiss_tpu_torch.utils.running_stats import (
    RunningMeanStd, normalize, running_mean_std_init,
    running_mean_std_update,
)

SEGMENT_FIELDS = ("obs", "action", "reward", "next_obs", "terminal", "done")


@dataclass(frozen=True)
class HostLoopConfig:
    batch_size: int = 256
    replay_capacity: int = 1_000_000
    steps_between_train_calls: int = 1000
    train_steps_per_call: int = 1000
    min_steps_before_training: int = 1000
    # store terminal = 0 for every transition (the reference `no_terminal`)
    no_terminal: bool = False
    # collect segment t + 1 on a background thread while the learner
    # trains on segment t (one segment of policy staleness)
    overlap_collection: bool = True


@dataclass
class HostRunnerState:
    noise: Any                # the learner's draws
    replay: ReplayState
    algo_state: Any
    total_env_steps: int
    seed: int                 # seeds the collector's draws


def collector_noise(seed: int, env_steps: int) -> Noise:
    """The acting draws of a segment that starts after `env_steps` env
    steps of a run seeded `seed`: a CPU generator of its own."""
    return Noise(((seed & 0xFFFFFFFF) << 32) | (env_steps & 0xFFFFFFFF),
                 "cpu")


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a host env's observation dtype (numpy, as
    `DMCVectorEnv.obs_dtype`, or torch)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def mean_metrics(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The mean of each metric over a list of metric dicts of 0-d tensors
    on one device, fetched in one copy."""
    keys = list(metrics[0])
    means = torch.stack([torch.stack([m[k] for m in metrics]).mean()
                         for k in keys])
    return dict(zip(keys, means.tolist()))


def evaluate_host(env, act: Callable, num_episodes: int, seed: int,
                  success: bool = False):
    """Deterministic-policy episodes on a host env from a fresh reset
    (`seed + 10_000`) until `num_episodes` have ended: (the return stats,
    the last observation).  `act(obs)` -> numpy actions; a goal env
    (`success`) also reports SuccessRate from its is_success info."""
    B = env.num_envs
    returns, lengths, successes = [], [], []
    ep_ret, ep_len, ep_success = np.zeros(B), np.zeros(B), np.zeros(B)
    obs = env.reset(seed=seed + 10_000)
    while len(returns) < num_episodes:
        out = env.step(act(obs))
        reward, done, obs = out[2], out[4], out[5]
        ep_ret += reward
        ep_len += 1
        if success:
            ep_success = np.maximum(ep_success, out[6])
        for i in np.nonzero(done)[0]:
            returns.append(ep_ret[i])
            lengths.append(ep_len[i])
            successes.append(ep_success[i])
            ep_ret[i] = ep_len[i] = ep_success[i] = 0.0
    returns = np.asarray(returns[:num_episodes])
    stats = {"AverageReturn": float(returns.mean()),
             "MaxReturn": float(returns.max()),
             "MinReturn": float(returns.min()),
             "StdReturn": float(returns.std()),
             "AvgPathLength": float(np.mean(lengths[:num_episodes]))}
    if success:
        stats["SuccessRate"] = float(np.mean(successes[:num_episodes]))
    return stats, obs


class HostOffPolicyLoop:
    """The off-policy loop over a host vector env, for an algorithm with
    `init(seed)`, `act(state, obs, *draws)` with `act_noise(noise, n)`,
    `device`, and either `train_call(state, replay, noise)` or
    `train_step(state, batch, *draws)` with `train_noise(noise,
    batch_size)`; `acting_state(state)` narrows what the collector copies.
    `sample_fn(replay, noise, batch_size)` makes each step's batch, as in
    `OffPolicyLoop`."""

    def __init__(self, env, algo, config: HostLoopConfig = HostLoopConfig(),
                 sample_fn: Callable | None = None):
        self.env = env
        self.algo = algo
        self.config = config
        self.sample_fn = sample_fn or sample_uniform
        self.device = algo.device
        self._acting_view = getattr(algo, "acting_state", lambda s: s)
        self._obs = None

    def init(self, seed: int = 0, noise=None) -> HostRunnerState:
        """Fresh runner: the env reset with `seed`, the algorithm's state
        from `seed`, the learner's draws from `noise` (default
        `Noise(seed + 1, device)`)."""
        self._obs = self.env.reset(seed=seed)
        env = self.env
        return HostRunnerState(
            noise=Noise(seed + 1, self.device) if noise is None else noise,
            replay=replay_init(
                self.config.replay_capacity, env.observation_size,
                env.action_size, write_batch=env.num_envs,
                device=self.device,
                obs_dtype=torch_dtype(getattr(env, "obs_dtype",
                                              np.float32))),
            algo_state=self.algo.init(seed),
            total_env_steps=0,
            seed=seed)

    def acting_snapshot(self, algo_state) -> Any:
        """A CPU copy of the acting slice of `algo_state` that nothing
        else holds."""
        return cpu_copy(self._acting_view(algo_state))

    # ------------------------------------------------------------------
    def _collect_segment(self, num_steps: int, noise, state_cpu=None
                         ) -> Dict[str, np.ndarray]:
        """max(1, num_steps // B) host steps, acting with `state_cpu` (or
        uniform warmup actions where it is None), drawing from `noise`;
        returns the [T, B, ...] numpy segment."""
        B, A = self.env.num_envs, self.env.action_size
        rows = []
        with torch.no_grad():
            for _ in range(max(1, num_steps // B)):
                if state_cpu is None:
                    action = noise.warmup_action((B, A)).numpy()
                else:
                    action = self.algo.act(
                        state_cpu, torch.as_tensor(self._obs),
                        *self.algo.act_noise(noise, B)).numpy()
                obs_prev, true_next, reward, terminal, done, obs_after = (
                    self.env.step(action))
                self._obs = obs_after
                rows.append((obs_prev, action, reward, true_next, terminal,
                             done))
        seg = {k: np.stack([r[i] for r in rows])
               for i, k in enumerate(SEGMENT_FIELDS)}
        if self.config.no_terminal:
            seg["terminal"] = np.zeros_like(seg["terminal"])
        return seg

    def _ingest(self, runner, segment: Dict[str, np.ndarray]) -> None:
        """The segment into the runner's ring: one host-to-device copy per
        field, then one `replay_add` per time step."""
        seg = {k: torch.as_tensor(v).to(self.device)
               for k, v in segment.items()}
        for t in range(seg["reward"].shape[0]):
            replay_add(runner.replay, Transition(
                **{k: seg[k][t] for k in SEGMENT_FIELDS}))

    def ingest_and_train(self, runner, segment: Dict[str, np.ndarray]
                         ) -> tuple[Any, Dict[str, torch.Tensor]]:
        """The learner's call for one segment: ingest it, then train;
        returns (runner, the metrics' means, 0-d tensors on the device)."""
        self._ingest(runner, segment)
        algo, cfg, noise = self.algo, self.config, runner.noise
        if hasattr(algo, "train_call"):
            runner.algo_state, metrics = algo.train_call(
                runner.algo_state, runner.replay, noise)
            return runner, metrics
        state, steps = runner.algo_state, []
        for _ in range(cfg.train_steps_per_call):
            batch = self.sample_fn(runner.replay, noise, cfg.batch_size)
            state, m = algo.train_step(
                state, batch, *algo.train_noise(noise, cfg.batch_size))
            steps.append(m)
        runner.algo_state = state
        return runner, {k: torch.stack([m[k] for m in steps]).mean()
                        for k in steps[0]}

    @staticmethod
    def _steps(segment: Dict[str, np.ndarray]) -> int:
        return int(segment["reward"].size)

    # ------------------------------------------------------------------
    def warmup(self, runner: HostRunnerState) -> HostRunnerState:
        """max(1, min_steps_before_training // B) steps of uniform [-1, 1]
        actions into the ring."""
        seg = self._collect_segment(
            self.config.min_steps_before_training,
            collector_noise(runner.seed, runner.total_env_steps))
        self._ingest(runner, seg)
        runner.total_env_steps += self._steps(seg)
        return runner

    def _collect_from(self, runner, env_steps: int):
        return (self.config.steps_between_train_calls,
                collector_noise(runner.seed, env_steps),
                self.acting_snapshot(runner.algo_state))

    def train_epoch(self, runner: HostRunnerState, steps_per_epoch: int
                    ) -> tuple[HostRunnerState, Dict[str, float]]:
        """max(1, steps_per_epoch // steps_between_train_calls) segments,
        each collected and then trained on; returns the metrics' means
        over the segments as floats."""
        n_calls = max(1, steps_per_epoch
                      // self.config.steps_between_train_calls)
        metrics = []
        if not self.config.overlap_collection:
            for _ in range(n_calls):
                with phase("sample"):
                    seg = self._collect_segment(*self._collect_from(
                        runner, runner.total_env_steps))
                with phase("train"):
                    runner, m = self.ingest_and_train(runner, seg)
                runner.total_env_steps += self._steps(seg)
                metrics.append(m)
            return runner, mean_metrics(metrics)
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self._collect_segment, *self._collect_from(
                runner, runner.total_env_steps))
            for i in range(n_calls):
                with phase("sample"):
                    seg = fut.result()
                steps = self._steps(seg)
                if i + 1 < n_calls:
                    # the next segment acts with the parameters from before
                    # this train call, while the learner trains
                    fut = pool.submit(self._collect_segment,
                                      *self._collect_from(
                                          runner,
                                          runner.total_env_steps + steps))
                with phase("train"):
                    runner, m = self.ingest_and_train(runner, seg)
                runner.total_env_steps += steps
                metrics.append(m)
        return runner, mean_metrics(metrics)

    # ------------------------------------------------------------------
    def evaluate(self, runner, num_episodes: int, seed: int = 0,
                 eval_env=None) -> Dict[str, float]:
        """Deterministic-policy episodes on the host env (the training env
        unless `eval_env` is given; its obs stream then continues from
        where the evaluation left it, as in the JAX package)."""
        env = eval_env or self.env
        state_cpu = self.acting_snapshot(runner.algo_state)

        @torch.no_grad()
        def act(obs):
            return self.algo.act(state_cpu, torch.as_tensor(obs),
                                 deterministic=True).numpy()

        stats, obs = evaluate_host(env, act, num_episodes, seed)
        if eval_env is None:
            self._obs = obs
        return stats


# --------------------------------------------------------------------------
@dataclass
class HostOnPolicyRunnerState:
    noise: Any                # the learner's draws
    algo_state: Any
    total_env_steps: int
    seed: int                 # seeds the collector's draws
    obs_rms: RunningMeanStd | None = None


class HostOnPolicyLoop:
    """PPO-style training on host envs: collect a [T, B] rollout on the
    host, hand it to `algo.train_step(state, rollout, *draws)` (with
    `train_noise(noise, T * B)`) on the learner's device, the device
    `OnPolicyLoop`'s contract.  `normalize_obs` keeps running observation
    moments (the reference vec env's obs_rms, rlkit/envs/vecenvs.py:
    102-107, 299-327)."""

    def __init__(self, env, algo, rollout_length: int = 128,
                 normalize_obs: bool = False, obs_clip: float = 10.0):
        self.env = env
        self.algo = algo
        self.rollout_length = rollout_length
        self.normalize_obs = normalize_obs
        self.obs_clip = obs_clip
        self.device = algo.device
        self._acting_view = getattr(algo, "acting_state", lambda s: s)
        self._obs = None

    def init(self, seed: int = 0, noise=None) -> HostOnPolicyRunnerState:
        self._obs = self.env.reset(seed=seed)
        return HostOnPolicyRunnerState(
            noise=Noise(seed + 1, self.device) if noise is None else noise,
            algo_state=self.algo.init(seed),
            total_env_steps=0,
            seed=seed,
            obs_rms=(running_mean_std_init((self.env.observation_size,),
                                           self.device)
                     if self.normalize_obs else None))

    def warmup(self, runner: HostOnPolicyRunnerState
               ) -> HostOnPolicyRunnerState:
        """On-policy training has no warmup: the runner as it is."""
        return runner

    def _norm(self, obs_rms, obs: torch.Tensor) -> torch.Tensor:
        return obs if obs_rms is None else normalize(obs_rms, obs,
                                                     self.obs_clip)

    def _collect_rollout(self, runner: HostOnPolicyRunnerState
                         ) -> Dict[str, np.ndarray]:
        B = self.env.num_envs
        state_cpu = cpu_copy(self._acting_view(runner.algo_state))
        rms_cpu = cpu_copy(runner.obs_rms)
        noise = collector_noise(runner.seed, runner.total_env_steps)
        rows = []
        with torch.no_grad():
            for _ in range(self.rollout_length):
                pol_obs = self._norm(rms_cpu, torch.as_tensor(self._obs))
                action = self.algo.act(state_cpu, pol_obs,
                                       *self.algo.act_noise(noise, B)).numpy()
                obs_prev, _, reward, terminal, done, obs_after = (
                    self.env.step(action))
                self._obs = obs_after
                rows.append((obs_prev, action, reward, terminal, done))
        out = {k: np.stack([r[i] for r in rows]) for i, k in enumerate(
            ("obs", "action", "reward", "terminal", "done"))}
        out["last_obs"] = self._obs
        return out

    def train_on_rollout(self, runner: HostOnPolicyRunnerState,
                         rollout: Dict[str, np.ndarray]
                         ) -> tuple[HostOnPolicyRunnerState,
                                    Dict[str, torch.Tensor]]:
        """The learner's call: the rollout to the device (one copy per
        field), the moments merged with its observations and the rollout
        normalized with the new moments, then one `train_step`."""
        r = {k: torch.as_tensor(v).to(self.device) for k, v in rollout.items()}
        if runner.obs_rms is not None:
            runner.obs_rms = running_mean_std_update(
                runner.obs_rms, r["obs"].reshape(-1, r["obs"].shape[-1]))
            r["obs"] = self._norm(runner.obs_rms, r["obs"])
            r["last_obs"] = self._norm(runner.obs_rms, r["last_obs"])
        runner.algo_state, metrics = self.algo.train_step(
            runner.algo_state, r,
            *self.algo.train_noise(runner.noise, r["reward"].numel()))
        metrics["rollout_reward_mean"] = torch.mean(r["reward"])
        return runner, metrics

    def train_epoch(self, runner: HostOnPolicyRunnerState,
                    steps_per_epoch: int
                    ) -> tuple[HostOnPolicyRunnerState, Dict[str, float]]:
        """max(1, steps_per_epoch // (T * B)) rollouts and updates;
        returns the metrics' means as floats."""
        B = self.env.num_envs
        metrics = []
        for _ in range(max(1, steps_per_epoch // (self.rollout_length * B))):
            with phase("sample"):
                rollout = self._collect_rollout(runner)
            with phase("train"):
                runner, m = self.train_on_rollout(runner, rollout)
            runner.total_env_steps += self.rollout_length * B
            metrics.append(m)
        return runner, mean_metrics(metrics)

    def evaluate(self, runner: HostOnPolicyRunnerState, num_episodes: int,
                 seed: int = 0, eval_env=None) -> Dict[str, float]:
        """Deterministic-policy episodes, observations normalized with the
        runner's moments; the training env is reset afterwards (seed +
        20_000) unless `eval_env` is given, as in the JAX package."""
        env = eval_env or self.env
        state_cpu = cpu_copy(self._acting_view(runner.algo_state))
        rms_cpu = cpu_copy(runner.obs_rms)

        @torch.no_grad()
        def act(obs):
            return self.algo.act(
                state_cpu, self._norm(rms_cpu, torch.as_tensor(obs)),
                deterministic=True).numpy()

        stats, _ = evaluate_host(env, act, num_episodes, seed)
        if eval_env is None:
            self._obs = env.reset(seed=seed + 20_000)
        return stats
