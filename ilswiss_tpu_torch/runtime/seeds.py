"""N independent seeds of one off-policy trainer in one process
(counterpart: the seed axis of ilswiss_tpu/launchers/experiments.py::
run_sac_vmapped_seeds, which vmaps the JAX loop over its whole runner).

Each seed keeps what a one-seed `OffPolicyLoop` run keeps: its env state,
ring, trainer state and `Noise`.  Only the envs' step is shared: the
seeds' envs are stepped as ONE batch of N x num_envs envs, so a control
step of a planar model is one launch of kernel K1 at B = N x num_envs
(ops/planar_dynamics.py), not N.  The envs' rows are independent, and
each seed draws in the one-seed loop's order from its own noise (the
acting draws, then `reset`, then the learner's), so a seed follows its
one-seed run.  The learner's steps run seed by seed
(`OffPolicyLoop.learn`: the eager steps, or one `train_chain` per seed
where the trainer has `use_fused_chain`).  The evaluation steps the
seeds' evaluation envs as one batch too (`make_seeds_evaluator`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import torch

from ilswiss_tpu_torch.data.replay import replay_add
from ilswiss_tpu_torch.envs.base import EnvState
from ilswiss_tpu_torch.envs.vector import Transition, VectorEnv
from ilswiss_tpu_torch.runtime.evaluator import return_stats
from ilswiss_tpu_torch.runtime.loop import (
    OffPolicyConfig, OffPolicyLoop, RunnerState,
)


def _cat(parts):
    if isinstance(parts[0], dict):
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return torch.cat(parts)


def _rows(x, lo: int, hi: int):
    if isinstance(x, dict):
        return {k: v[lo:hi] for k, v in x.items()}
    return x[lo:hi]


def cat_env_states(states: Sequence[EnvState]) -> EnvState:
    """The env states of the seeds as one batch, seed after seed."""
    return EnvState(
        internal=tuple(torch.cat(parts) for parts in
                       zip(*(s.internal for s in states))),
        obs=_cat([s.obs for s in states]),
        t=torch.cat([s.t for s in states]))


def split_env_state(state: EnvState, n: int) -> List[EnvState]:
    """`cat_env_states`'s inverse for seeds of n envs each."""
    return [EnvState(internal=tuple(x[lo:lo + n] for x in state.internal),
                     obs=_rows(state.obs, lo, lo + n),
                     t=state.t[lo:lo + n])
            for lo in range(0, state.t.shape[0], n)]


def _cat_noise(draws):
    """Each seed's reset draws (a tuple of [n, ...] tensors) as one."""
    return tuple(torch.cat(parts) for parts in zip(*draws))


@dataclass
class SeedsRunnerState:
    """The seeds' runners, one `RunnerState` each, seed by seed."""

    runners: List[RunnerState]

    @property
    def algo_state(self) -> list:
        """The seeds' trainer states: what a params-only snapshot holds."""
        return [r.algo_state for r in self.runners]


class SeedsOffPolicyLoop:
    """`OffPolicyLoop`'s warmup and training epochs for N seeds, the envs
    of all seeds stepped as one batch."""

    def __init__(self, vec_env: VectorEnv, algo, config: OffPolicyConfig,
                 num_seeds: int, sample_fn: Callable | None = None):
        self.loop = OffPolicyLoop(vec_env, algo, config, sample_fn)
        self.algo = algo
        self.config = config
        self.num_seeds = num_seeds
        self.vec_env = vec_env
        self.all_envs = VectorEnv(vec_env.env, num_seeds * vec_env.num_envs)

    def init(self, seeds: Sequence[int], noises=None) -> SeedsRunnerState:
        """Each seed's fresh runner, as `OffPolicyLoop.init(seed)` makes
        it (its draws from `noises[i]` where given)."""
        if len(seeds) != self.num_seeds:
            raise ValueError(f"{len(seeds)} seeds for a loop of "
                             f"{self.num_seeds}")
        noises = noises or [None] * len(seeds)
        return SeedsRunnerState([self.loop.init(s, noise=n)
                                 for s, n in zip(seeds, noises)])

    def _collect_iter(self, runner: SeedsRunnerState, random_actions: bool
                      ) -> SeedsRunnerState:
        env, n, algo = self.vec_env.env, self.vec_env.num_envs, self.algo
        actions, resets = [], []
        for r in runner.runners:
            if random_actions and env.discrete:
                a = r.noise.warmup_index(n, env.action_size)
            elif random_actions:
                a = r.noise.warmup_action((n, env.action_size))
            else:
                a = algo.act(r.algo_state, r.env_state.obs,
                             *algo.act_noise(r.noise, n))
            actions.append(a)
            resets.append(r.noise.reset(env, n))
        state, tr = self.all_envs.step(
            cat_env_states([r.env_state for r in runner.runners]),
            torch.cat(actions), _cat_noise(resets))
        for i, (r, s) in enumerate(zip(runner.runners,
                                       split_env_state(state, n))):
            lo, hi = i * n, (i + 1) * n
            part = Transition(
                obs=_rows(tr.obs, lo, hi), action=tr.action[lo:hi],
                reward=tr.reward[lo:hi], next_obs=_rows(tr.next_obs, lo, hi),
                terminal=tr.terminal[lo:hi], done=tr.done[lo:hi])
            if self.config.no_terminal:
                part.terminal = torch.zeros_like(part.terminal)
            r.replay = replay_add(r.replay, part)
            r.env_state = s
            r.total_env_steps += n
        return runner

    def warmup(self, runner: SeedsRunnerState) -> SeedsRunnerState:
        """max(1, min_steps_before_training // num_envs) iterations of
        uniform random actions for every seed."""
        for _ in range(max(1, self.config.min_steps_before_training
                           // self.vec_env.num_envs)):
            runner = self._collect_iter(runner, random_actions=True)
        return runner

    def epoch_metrics(self, runner: SeedsRunnerState, steps_per_epoch: int
                      ) -> tuple[SeedsRunnerState,
                                 List[Dict[str, torch.Tensor]]]:
        """max(1, steps_per_epoch // num_envs) training iterations; returns
        each seed's per-epoch metric means, kept on the device."""
        iters = max(1, steps_per_epoch // self.vec_env.num_envs)
        sums: List[Dict[str, torch.Tensor]] = [{} for _ in runner.runners]
        for _ in range(iters):
            runner = self._collect_iter(runner, random_actions=False)
            for r, acc in zip(runner.runners, sums):
                _, metrics = self.loop.learn(r)
                for k, v in metrics.items():
                    acc[k] = v if k not in acc else acc[k] + v
        return runner, [{k: v / iters for k, v in acc.items()}
                        for acc in sums]

    def train_epoch(self, runner: SeedsRunnerState, steps_per_epoch: int
                    ) -> tuple[SeedsRunnerState, List[Dict[str, float]]]:
        """`epoch_metrics` with the means as floats."""
        runner, metrics = self.epoch_metrics(runner, steps_per_epoch)
        return runner, [{k: float(v) for k, v in m.items()}
                        for m in metrics]


def make_seeds_evaluator(vec_env: VectorEnv, act_fn: Callable,
                         max_path_length: int, num_seeds: int) -> Callable:
    """`runtime/evaluator.py::make_evaluator` for N seeds of `vec_env`'s
    envs each, stepped as one batch.  Returns evaluate(algo_states,
    noises) -> one stats dict a seed; seed i's reset draws come from
    noises[i] in the one-seed evaluator's order, so each dict is what
    `make_evaluator` gives that seed alone."""
    all_envs = VectorEnv(vec_env.env, num_seeds * vec_env.num_envs)

    @torch.no_grad()
    def evaluate(algo_states, noises) -> List[Dict[str, float]]:
        env, n = vec_env.env, vec_env.num_envs
        state = all_envs.reset(_cat_noise([z.reset(env, n) for z in noises]))
        kw = dict(dtype=torch.float32, device=state.t.device)
        returns = torch.zeros(num_seeds * n, **kw)
        lengths = torch.zeros(num_seeds * n, **kw)
        running = torch.ones(num_seeds * n, **kw)
        for _ in range(max_path_length):
            action = torch.cat([
                act_fn(s, _rows(state.obs, i * n, (i + 1) * n))
                for i, s in enumerate(algo_states)])
            state, tr = all_envs.step(
                state, action, _cat_noise([z.reset(env, n) for z in noises]))
            returns = returns + tr.reward * running
            lengths = lengths + running
            running = running * (1.0 - tr.done.to(torch.float32))
        return [return_stats(returns[i * n:(i + 1) * n],
                             lengths[i * n:(i + 1) * n])
                for i in range(num_seeds)]

    return evaluate
