"""MBPO: model-based policy optimisation (counterpart:
ilswiss_tpu/algorithms/mbpo.py; `MBPOConfig`, `MBPORunnerState`, `MBPO`,
its device class).

An ensemble dynamics model (algorithms/bnn_trainer.py) is refit on the
whole real ring every `model_train_freq` env steps; branched rollouts from
real states fill a model ring; the inner SAC trains on mixed batches of
int(batch * real_ratio) real rows, then the rest from the model ring.
The epoch, as the JAX package's `train_epoch`:

    seg_iters = max(1, model_train_freq // num_envs) iterations a segment,
    max(1, steps_per_epoch // (seg_iters * num_envs)) segments, each:
      1. (real_ratio < 1) fit the ensemble on the real ring's valid rows;
      2. roll the model out `rollout_length(epoch)` steps from
         `rollout_batch_size` states of the real ring (`_rollout_model`);
      3. seg_iters iterations of: one act, one env step and one
         `replay_add`, then `grad_steps_per_iter` eager `SAC.train_step`s
         on mixed batches (`_mixed_batch`).

A model step acts on every branch, predicts with all E nets, takes for
each branch the row of one elite net picked at random, adds that net's
Gaussian noise (unless `deterministic_rollouts`), computes the analytic
terminal (envs/terminals.py), writes the branches that were alive before
the step with `replay_add_masked` and drops those that ended.  The model
ring is preallocated at the schedule's largest size, retrain_epochs *
max_length * rollout_batch_size * max_path_length / model_train_freq
(6,000,000 rows for mbpo_hopper.yaml); the real ring writes num_envs
rows, the model ring rollout_batch_size.

The JAX package takes its draws from key splits; here every draw comes
from the runner's `noise` (runtime/loop.py::Noise), in this order.
Per segment:
  - the ensemble fit: `permutation(N)`, `bootstrap(E, N_train)`, then
    one `shuffle(E, N_train)` per ensemble epoch;
  - the rollout: `replay(R)` (the start states), then per model step the
    acting draws `act((R, A))`, `elite(R, num_elites)` and, unless
    deterministic, `model((R, 1 + obs))`: the noise of the picked net's
    row only (the JAX package draws it for all E nets and gathers);
  - per iteration: the acting draws `act((num_envs, A))` and `reset`,
    then per gradient step `replay(n_real)`, `replay(n_model)` and SAC's
    `train` pair.
The warmup draws `warmup_action` and `reset` per iteration.

`HostMBPOLoop` (JAX mbpo.py:336-453) runs MBPO on a host env
(runtime/host_loop.py): per segment of `model_train_freq` env steps, the
ensemble fit and the model rollout as above, then the segment collected
on the host with a CPU copy of SAC's policy (the collector's draws its
own, `collector_noise`), ingested into the real ring, and
`model_train_freq * grad_steps_per_env_step` SAC steps on mixed batches
(per step `replay(n_real)`, `replay(n_model)`, then `train`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch

from ilswiss_tpu_torch.algorithms.bnn_trainer import (
    BNNState, BNNTrainer, BNNTrainerConfig,
)
from ilswiss_tpu_torch.data.replay import (
    ReplayState, replay_add_masked, replay_init, replay_sample,
)
from ilswiss_tpu_torch.envs.base import EnvState
from ilswiss_tpu_torch.envs.vector import VectorEnv
from ilswiss_tpu_torch.runtime.host_loop import (
    HostLoopConfig, HostOffPolicyLoop, collector_noise, mean_metrics,
)
from ilswiss_tpu_torch.runtime.loop import (
    Noise, OffPolicyConfig, OffPolicyLoop,
)

# the ensemble's init draws come from seed + BNN_SEED_OFFSET, apart from
# the inner trainer's, which come from seed
BNN_SEED_OFFSET = 1 << 29


@dataclass(frozen=True)
class MBPOConfig:
    model_train_freq: int = 250
    rollout_batch_size: int = 100_000
    real_ratio: float = 0.1
    rollout_schedule: tuple = (20, 100, 1, 1)  # (min_ep, max_ep, min_l, max_l)
    model_retrain_epochs: int = 1
    deterministic_rollouts: bool = False
    batch_size: int = 256
    grad_steps_per_iter: int | None = None
    replay_capacity: int = 1_000_000
    min_steps_before_training: int = 5000
    max_path_length: int = 1000


@dataclass
class MBPORunnerState:
    noise: Any
    env_state: EnvState | None   # batched [num_envs]; None on a host env
    replay: ReplayState          # real transitions
    model_replay: ReplayState    # model transitions
    algo_state: Any              # the inner SAC's
    bnn_state: BNNState
    total_env_steps: int


class MBPO:
    """The epoch loop around `policy_trainer` (SAC) and a `BNNTrainer`,
    on the device of `vec_env`."""

    def __init__(self, vec_env: VectorEnv | None, policy_trainer,
                 terminal_fn: Callable,
                 config: MBPOConfig = MBPOConfig(),
                 bnn_config: BNNTrainerConfig = BNNTrainerConfig(),
                 obs_size: int | None = None,
                 action_size: int | None = None,
                 num_envs: int | None = None):
        """`vec_env` is None for a host env (`HostMBPOLoop` collects); the
        sizes and the env count are then given, and the device is the
        trainer's."""
        self.vec_env = vec_env
        self.algo = policy_trainer
        self.terminal_fn = terminal_fn
        self.config = config
        if vec_env is not None:
            env = vec_env.env
            obs_size, action_size = env.observation_size, env.action_size
            num_envs = vec_env.num_envs
        self.discrete = vec_env is not None and vec_env.env.discrete
        self.device = policy_trainer.device
        self.obs_size = obs_size
        self.action_size = action_size
        self.num_envs = num_envs
        self.bnn = BNNTrainer(self.obs_size, self.action_size, bnn_config,
                              device=self.device)
        self.grad_steps_per_iter = (
            config.grad_steps_per_iter
            if config.grad_steps_per_iter is not None else self.num_envs)
        max_len = config.rollout_schedule[3]
        rollouts_per_epoch = (config.rollout_batch_size
                              * config.max_path_length
                              / config.model_train_freq)
        self.model_capacity = int(
            config.model_retrain_epochs * max_len * rollouts_per_epoch)
        # the real env's collection (act, step, replay_add) and warmup
        # are the off-policy loop's
        self.loop = None if vec_env is None else OffPolicyLoop(
            vec_env, policy_trainer, OffPolicyConfig(
                batch_size=config.batch_size,
                replay_capacity=config.replay_capacity,
                grad_steps_per_iter=self.grad_steps_per_iter,
                min_steps_before_training=config.min_steps_before_training))

    def init(self, seed: int, noise=None) -> MBPORunnerState:
        """Fresh runner: SAC's state from `seed`, the ensemble's from
        `seed + BNN_SEED_OFFSET`, the env reset and every later draw from
        `noise` (default `Noise(seed + 1, device)`).  Without a vec env
        the env state is None."""
        noise = Noise(seed + 1, self.device) if noise is None else noise
        n = self.num_envs
        ring = dict(obs_size=self.obs_size, action_size=self.action_size,
                    device=self.device, discrete=self.discrete)
        return MBPORunnerState(
            noise=noise,
            env_state=(None if self.vec_env is None else self.vec_env.reset(
                noise.reset(self.vec_env.env, n))),
            replay=replay_init(self.config.replay_capacity,
                               write_batch=n, **ring),
            model_replay=replay_init(
                self.model_capacity,
                write_batch=self.config.rollout_batch_size, **ring),
            algo_state=self.algo.init(seed),
            bnn_state=self.bnn.init(seed + BNN_SEED_OFFSET),
            total_env_steps=0)

    def rollout_length(self, epoch: int) -> int:
        """The schedule (min_ep, max_ep, min_l, max_l): min_l before
        min_ep, then linear to max_l at max_ep, truncated to an int."""
        min_ep, max_ep, min_l, max_l = self.config.rollout_schedule
        if epoch < min_ep:
            return int(min_l)
        dx = min((epoch - min_ep) / max(max_ep - min_ep, 1), 1.0)
        return int(dx * (max_l - min_l) + min_l)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _rollout_model(self, runner: MBPORunnerState, length: int
                       ) -> List[int]:
        """A branched model rollout of `length` steps into the model ring,
        in place; returns the rows written at each step (the branches
        alive before it)."""
        cfg, noise = self.config, runner.noise
        R = cfg.rollout_batch_size
        bnn_state = runner.bnn_state
        branch = torch.arange(R, device=self.device)
        obs = replay_sample(runner.replay, noise.replay(R))["obs"]
        alive = torch.ones(R, dtype=torch.bool, device=self.device)
        written = []
        for _ in range(length):
            act = self.algo.act(runner.algo_state, obs,
                                *self.algo.act_noise(noise, R))
            means, variances = self.bnn.predict_factored(bnn_state, obs, act)
            pick = bnn_state.elites[noise.elite(R, bnn_state.elites.shape[0])]
            row = means[pick, branch]
            if not cfg.deterministic_rollouts:
                row = row + torch.sqrt(variances[pick, branch]) \
                    * noise.model(row.shape)
            reward, next_obs = row[:, 0], row[:, 1:]
            terminal = self.terminal_fn(obs, act, next_obs)
            written.append(int(alive.sum()))
            replay_add_masked(runner.model_replay, {
                "obs": obs, "action": act, "reward": reward,
                "next_obs": next_obs, "terminal": terminal.float()}, alive)
            alive = alive & ~terminal
            obs = next_obs
        return written

    def _mixed_batch(self, runner: MBPORunnerState, noise
                     ) -> Dict[str, torch.Tensor]:
        """int(batch * real_ratio) rows of the real ring, then the rest of
        the batch from the model ring."""
        cfg = self.config
        n_real = int(cfg.batch_size * cfg.real_ratio)
        real = replay_sample(runner.replay, noise.replay(n_real))
        model = replay_sample(runner.model_replay,
                              noise.replay(cfg.batch_size - n_real))
        return {k: torch.cat([real[k], model[k]]) for k in real}

    def _train_iter(self, runner: MBPORunnerState
                    ) -> Tuple[MBPORunnerState, Dict[str, torch.Tensor]]:
        """One act, env step and `replay_add`, then `grad_steps_per_iter`
        SAC steps on mixed batches; returns the steps' mean metrics."""
        runner = self.loop._collect_iter(runner, random_actions=False)
        sums: Dict[str, torch.Tensor] = {}
        state = runner.algo_state
        for _ in range(self.grad_steps_per_iter):
            batch = self._mixed_batch(runner, runner.noise)
            state, metrics = self.algo.train_step(
                state, batch,
                *self.algo.train_noise(runner.noise, self.config.batch_size))
            for k, v in metrics.items():
                sums[k] = v if k not in sums else sums[k] + v
        runner.algo_state = state
        return runner, {k: v / self.grad_steps_per_iter
                        for k, v in sums.items()}

    # ------------------------------------------------------------------
    def warmup(self, runner: MBPORunnerState) -> MBPORunnerState:
        """max(1, min_steps_before_training // num_envs) iterations of
        uniform [-1, 1] actions."""
        return self.loop.warmup(runner)

    def train_epoch(self, runner: MBPORunnerState, epoch: int,
                    steps_per_epoch: int, log=None
                    ) -> Tuple[MBPORunnerState, Dict[str, float]]:
        """The segments of one epoch (module docstring); returns the SAC
        metrics' means over the segments, the last ensemble fit's stats
        and `mean_rollout_length`, as floats."""
        cfg = self.config
        seg_iters = max(1, cfg.model_train_freq // self.num_envs)
        num_segments = max(1, steps_per_epoch // (seg_iters * self.num_envs))
        seg_means: List[Dict[str, torch.Tensor]] = []
        bnn_stats: Dict[str, float] = {}
        for seg in range(num_segments):
            if cfg.real_ratio < 1.0:
                size = runner.replay.size
                data = {k: v[:size] for k, v in runner.replay.data.items()}
                runner.bnn_state, bnn_stats = self.bnn.train(
                    runner.bnn_state, data, runner.noise, log=log)
                length = self.rollout_length(epoch)
                written = self._rollout_model(runner, length)
                if log:
                    log(f"MBPO seg {seg}: rollout_len={length} "
                        f"model_pool={runner.model_replay.size} "
                        f"holdout={bnn_stats['bnn_holdout_mse']:.4f} "
                        f"written per step={written}")
            sums: Dict[str, torch.Tensor] = {}
            for _ in range(seg_iters):
                runner, metrics = self._train_iter(runner)
                for k, v in metrics.items():
                    sums[k] = v if k not in sums else sums[k] + v
            seg_means.append({k: v / seg_iters for k, v in sums.items()})
        agg = {k: float(torch.stack([m[k] for m in seg_means]).mean())
               for k in seg_means[0]}
        agg.update({k: float(v) for k, v in bnn_stats.items()})
        agg["mean_rollout_length"] = float(self.rollout_length(epoch))
        return runner, agg

    def act(self, algo_state, obs: torch.Tensor, *draws,
            deterministic: bool = False) -> torch.Tensor:
        """The inner trainer's `act`."""
        return self.algo.act(algo_state, obs, *draws,
                             deterministic=deterministic)


class HostMBPOLoop:
    """MBPO on a host env: the host off-policy loop's collection, ingest
    and evaluation around `mbpo`'s ensemble, model rollouts and mixed
    batches.  The runner is an `MBPORunnerState` without an env state;
    the run's seed, which seeds the collector's draws, is the loop's."""

    def __init__(self, env, mbpo: MBPO, grad_steps_per_env_step: float = 20.0,
                 no_terminal: bool = False):
        self.env = env
        self.mbpo = mbpo
        self.host = HostOffPolicyLoop(env, mbpo.algo, HostLoopConfig(
            min_steps_before_training=mbpo.config.min_steps_before_training,
            no_terminal=no_terminal))
        self.grad_steps_per_segment = max(1, int(
            mbpo.config.model_train_freq * grad_steps_per_env_step))
        self.seed = 0

    def init(self, seed: int = 0, noise=None) -> MBPORunnerState:
        self.seed = seed
        self.host._obs = self.env.reset(seed=seed)
        return self.mbpo.init(seed, noise)

    def warmup(self, runner: MBPORunnerState) -> MBPORunnerState:
        """max(1, min_steps_before_training // B) steps of uniform [-1, 1]
        actions into the real ring."""
        seg = self.host._collect_segment(
            self.mbpo.config.min_steps_before_training,
            collector_noise(self.seed, runner.total_env_steps))
        self.host._ingest(runner, seg)
        runner.total_env_steps += int(seg["reward"].size)
        return runner

    def ingest_and_train(self, runner: MBPORunnerState, segment
                         ) -> Tuple[MBPORunnerState, Dict[str, torch.Tensor]]:
        """The segment into the real ring, then the SAC steps on mixed
        batches; returns the steps' mean metrics (0-d, on the device)."""
        self.host._ingest(runner, segment)
        algo, bs, noise = self.mbpo.algo, self.mbpo.config.batch_size, \
            runner.noise
        state, steps = runner.algo_state, []
        for _ in range(self.grad_steps_per_segment):
            batch = self.mbpo._mixed_batch(runner, noise)
            state, m = algo.train_step(state, batch,
                                       *algo.train_noise(noise, bs))
            steps.append(m)
        runner.algo_state = state
        return runner, {k: torch.stack([m[k] for m in steps]).mean()
                        for k in steps[0]}

    def train_epoch(self, runner: MBPORunnerState, epoch: int,
                    steps_per_epoch: int, log=None
                    ) -> Tuple[MBPORunnerState, Dict[str, float]]:
        """max(1, steps_per_epoch // model_train_freq) segments; returns
        the SAC metrics' means, the last ensemble fit's stats and
        `mean_rollout_length`, as floats."""
        mbpo, cfg = self.mbpo, self.mbpo.config
        metrics: List[Dict[str, torch.Tensor]] = []
        bnn_stats: Dict[str, float] = {}
        for seg in range(max(1, steps_per_epoch // cfg.model_train_freq)):
            if cfg.real_ratio < 1.0:
                size = runner.replay.size
                data = {k: v[:size] for k, v in runner.replay.data.items()}
                runner.bnn_state, bnn_stats = mbpo.bnn.train(
                    runner.bnn_state, data, runner.noise, log=log)
                length = mbpo.rollout_length(epoch)
                mbpo._rollout_model(runner, length)
                if log:
                    log(f"MBPO seg {seg}: rollout_len={length} "
                        f"model_pool={runner.model_replay.size}")
            segment = self.host._collect_segment(
                cfg.model_train_freq,
                collector_noise(self.seed, runner.total_env_steps),
                self.host.acting_snapshot(runner.algo_state))
            runner, m = self.ingest_and_train(runner, segment)
            runner.total_env_steps += int(segment["reward"].size)
            metrics.append(m)
        agg = mean_metrics(metrics)
        agg.update({k: float(v) for k, v in bnn_stats.items()})
        agg["mean_rollout_length"] = float(mbpo.rollout_length(epoch))
        return runner, agg

    def evaluate(self, runner: MBPORunnerState, num_episodes: int,
                 seed: int = 0) -> Dict[str, float]:
        return self.host.evaluate(runner, num_episodes, seed=seed)
