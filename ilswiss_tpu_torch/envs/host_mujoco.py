"""Host-side vectorized gymnasium envs feeding the learner (counterpart:
ilswiss_tpu/envs/host_mujoco.py; `GYM_ENV_IDS`, `GymVectorEnv`,
`HostGoalVectorEnv`, `ScaledHostEnv`, `MinmaxHostEnv`,
`AbsorbingHostEnv`).

The simulators that cannot run as tensor programs (MuJoCo's C engine,
Box2D, the gymnasium-robotics Fetch family) step B env instances on host
threads (mj_step releases the GIL); acting runs on the host CPU and
learning on the learner's device (runtime/host_loop.py).  Everything here
is numpy: the envs know nothing of torch but `HostGoalVectorEnv.
compute_reward`, which the hindsight ring (data/her.py) calls on the
learner's tensors.  gymnasium and gymnasium_robotics are imported where
an env is built, never when this module is imported.

Env names follow the reference registry (rlkit/envs/envs_dict.py).
Autoreset is immediate (same step), as the on-device `VectorEnv`: `step`
returns the true terminal next obs in the transition while the carried
observation is the one after the reset.  The seeds of the resets that
one step needs are drawn from the env's generator in env order, after
the step: the JAX package draws them inside the worker threads, so where
several envs end in one step, which env gets which seed depends on the
order the threads reach the generator (ROADMAP.md section 3).  With one
worker thread the JAX env draws in env order, and the two agree bit for
bit.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np
import torch

GYM_ENV_IDS: Dict[str, str] = {
    # reference envs_dict.py names -> gymnasium ids
    "hopper": "Hopper-v5",
    "walker": "Walker2d-v5",
    "halfcheetah": "HalfCheetah-v5",
    "ant": "Ant-v5",
    "humanoid": "Humanoid-v5",
    "swimmer": "Swimmer-v5",
    "invertedpendulum": "InvertedPendulum-v5",
    "inverteddoublependulum": "InvertedDoublePendulum-v5",
    "lunarlandercont": "LunarLanderContinuous-v3",
    "bipedalwalker": "BipedalWalker-v3",
    "fetch-reach": "FetchReach-v4",
    "fetch-push": "FetchPush-v4",
    "fetch-pick-place": "FetchPickAndPlace-v4",
    "fetch-slide": "FetchSlide-v4",
}


def _make_envs(env_name: str, num_envs: int, max_episode_steps, env_kwargs):
    import gymnasium as gym

    kwargs = dict(env_kwargs or {})
    if max_episode_steps is not None:
        kwargs["max_episode_steps"] = max_episode_steps
    gym_id = GYM_ENV_IDS.get(env_name, env_name)
    return [gym.make(gym_id, **kwargs) for _ in range(num_envs)]


class _ThreadedEnvs:
    """What both vector envs share: the B gymnasium envs, their reset
    seeds from np.random.RandomState(seed), the thread pool and the
    [-1, 1] -> Box action scaling (reference NormalizedBoxEnv,
    rlkit/envs/wrappers.py:342-352)."""

    def _setup(self, envs, env_name: str, seed: int, max_episode_steps,
               default_horizon: int, num_threads: int) -> None:
        self.envs = envs
        self.num_envs = len(envs)
        self.name = env_name
        aspace = envs[0].action_space
        self.action_size = int(np.prod(aspace.shape))
        self.discrete = False
        self.action_low = np.asarray(aspace.low, np.float32)
        self.action_high = np.asarray(aspace.high, np.float32)
        self.max_episode_steps = (
            max_episode_steps
            or getattr(envs[0].spec, "max_episode_steps", None)
            or default_horizon)
        self._reseed(seed)
        self._pool = (ThreadPoolExecutor(
            max_workers=min(num_threads, self.num_envs))
            if self.num_envs > 1 else None)

    def _reseed(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)
        self._seeds = [int(self._rng.randint(2**31)) for _ in self.envs]

    def _scale(self, normalized: np.ndarray) -> np.ndarray:
        a = self.action_low + (normalized + 1.0) * 0.5 * (
            self.action_high - self.action_low)
        return np.clip(a, self.action_low, self.action_high)

    def _run(self, fn, *args):
        if self._pool is not None:
            return list(self._pool.map(fn, *args))
        return [fn(*a) for a in zip(*args)]

    def _step_all(self, actions):
        """Step every env: [(obs, reward, terminated, truncated, info)]."""
        return self._run(lambda env, a: env.step(a), self.envs, actions)

    def _reset_ended(self, done: np.ndarray) -> dict:
        """Reset the envs whose episode ended, each with the next seed of
        the env's generator in env order: {env index: reset obs}."""
        idx = [int(i) for i in np.nonzero(done)[0]]
        seeds = [int(self._rng.randint(2**31)) for _ in idx]
        obs = self._run(lambda i, s: self.envs[i].reset(seed=s)[0], idx,
                        seeds)
        return dict(zip(idx, obs))

    def close(self) -> None:
        for env in self.envs:
            env.close()
        if self._pool is not None:
            self._pool.shutdown()


class GymVectorEnv(_ThreadedEnvs):
    """B lockstep gymnasium envs with immediate autoreset (numpy API).
    Actions are normalized to [-1, 1] and rescaled to the env's Box."""

    def __init__(self, env_name: str, num_envs: int, seed: int = 0,
                 max_episode_steps: int | None = None,
                 env_kwargs: dict | None = None, num_threads: int = 8):
        envs = _make_envs(env_name, num_envs, max_episode_steps, env_kwargs)
        self.observation_size = int(np.prod(envs[0].observation_space.shape))
        self._setup(envs, env_name, seed, max_episode_steps, 1000,
                    num_threads)
        self._obs = np.zeros((num_envs, self.observation_size), np.float32)

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self._reseed(seed)
        for i, env in enumerate(self.envs):
            obs, _ = env.reset(seed=self._seeds[i])
            self._obs[i] = np.asarray(obs, np.float32).ravel()
        return self._obs.copy()

    def step(self, normalized_actions: np.ndarray) -> Tuple[np.ndarray, ...]:
        """(obs_prev, true_next_obs, reward, terminal, done,
        obs_after_reset), all [B, ...] numpy."""
        actions = self._scale(np.asarray(normalized_actions, np.float32))
        obs_prev = self._obs.copy()
        results = self._step_all(actions)
        true_next = np.stack([np.asarray(r[0], np.float32).ravel()
                              for r in results])
        reward = np.asarray([float(r[1]) for r in results], np.float32)
        terminal = np.asarray([bool(r[2]) for r in results], bool)
        done = terminal | np.asarray([bool(r[3]) for r in results], bool)
        self._obs = true_next.copy()
        for i, obs in self._reset_ended(done).items():
            self._obs[i] = np.asarray(obs, np.float32).ravel()
        return obs_prev, true_next, reward, terminal, done, self._obs.copy()


GOAL_KEYS = ("observation", "achieved_goal", "desired_goal")


class HostGoalVectorEnv(_ThreadedEnvs):
    """B lockstep dict-obs goal envs (gymnasium-robotics Fetch family)
    with immediate autoreset: the host backend for HER (reference
    her_*_exp_script.py).  Observations are dicts {observation,
    achieved_goal, desired_goal} of [B, ...] arrays; `compute_reward` is
    the env's sparse or dense goal reward on tensors, for the hindsight
    ring's relabeling (reference relabel_replay_buffer.py:137-142)."""

    def __init__(self, env_name: str, num_envs: int, seed: int = 0,
                 max_episode_steps: int | None = None,
                 env_kwargs: dict | None = None, num_threads: int = 8):
        try:  # registers the Fetch / Hand ids
            import gymnasium_robotics  # noqa: F401
        except ImportError:
            pass
        envs = _make_envs(env_name, num_envs, max_episode_steps, env_kwargs)
        space = envs[0].observation_space
        self.observation_size = int(np.prod(space["observation"].shape))
        self.goal_size = int(np.prod(space["desired_goal"].shape))
        self._setup(envs, env_name, seed, max_episode_steps, 50, num_threads)
        u = envs[0].unwrapped
        self.distance_threshold = float(
            getattr(u, "distance_threshold", 0.05))
        self.reward_type = str(getattr(u, "reward_type", "sparse"))
        sizes = {"observation": self.observation_size,
                 "achieved_goal": self.goal_size,
                 "desired_goal": self.goal_size}
        self._obs = {k: np.zeros((num_envs, sizes[k]), np.float32)
                     for k in GOAL_KEYS}

    @staticmethod
    def _flat(obs_dict):
        return {k: np.asarray(obs_dict[k], np.float32).ravel()
                for k in GOAL_KEYS}

    def compute_reward(self, achieved_goal: torch.Tensor,
                       desired_goal: torch.Tensor) -> torch.Tensor:
        """The Fetch goal reward (gymnasium_robotics fetch_env.
        compute_reward) on tensors of any device."""
        d = torch.linalg.vector_norm(achieved_goal - desired_goal, dim=-1)
        if self.reward_type == "sparse":
            return -(d > self.distance_threshold).to(torch.float32)
        return -d

    def reset(self, seed: int | None = None):
        if seed is not None:
            self._reseed(seed)
        for i, env in enumerate(self.envs):
            obs, _ = env.reset(seed=self._seeds[i])
            flat = self._flat(obs)
            for k in GOAL_KEYS:
                self._obs[k][i] = flat[k]
        return {k: v.copy() for k, v in self._obs.items()}

    def step(self, normalized_actions: np.ndarray):
        """(obs_prev, true_next_obs, reward, terminal, done,
        obs_after_reset, success); the obs entries are dicts of [B, ...]."""
        actions = self._scale(np.asarray(normalized_actions, np.float32))
        obs_prev = {k: v.copy() for k, v in self._obs.items()}
        results = self._step_all(actions)
        flat = [self._flat(r[0]) for r in results]
        true_next = {k: np.stack([f[k] for f in flat]) for k in GOAL_KEYS}
        reward = np.asarray([float(r[1]) for r in results], np.float32)
        terminal = np.asarray([bool(r[2]) for r in results], bool)
        done = terminal | np.asarray([bool(r[3]) for r in results], bool)
        success = np.asarray([float(r[4].get("is_success", 0.0))
                              for r in results], np.float32)
        self._obs = {k: v.copy() for k, v in true_next.items()}
        for i, obs in self._reset_ended(done).items():
            for k, v in self._flat(obs).items():
                self._obs[k][i] = v
        return (obs_prev, true_next, reward, terminal, done,
                {k: v.copy() for k, v in self._obs.items()}, success)


class _DelegatingHostEnv:
    """Shares the GymVectorEnv step contract; wraps any host vec env."""

    def __init__(self, inner):
        self.inner = inner
        self.num_envs = inner.num_envs
        self.name = inner.name
        self.observation_size = inner.observation_size
        self.action_size = inner.action_size
        self.discrete = getattr(inner, "discrete", False)
        self.max_episode_steps = inner.max_episode_steps

    def reset(self, seed: int | None = None) -> np.ndarray:
        return self.inner.reset(seed=seed)

    def step(self, normalized_actions: np.ndarray) -> Tuple[np.ndarray, ...]:
        return self.inner.step(normalized_actions)

    def close(self) -> None:
        self.inner.close()


class ScaledHostEnv(_DelegatingHostEnv):
    """Demo-stats obs standardization (reference ScaledEnv,
    rlkit/envs/wrappers.py:53, applied in adv_irl_exp_script.py:86-103)."""

    def __init__(self, inner, obs_mean, obs_std, eps: float = 1e-8):
        super().__init__(inner)
        self.obs_mean = np.asarray(obs_mean, np.float32)
        self.obs_denom = np.asarray(obs_std, np.float32) + eps

    def _scale(self, obs):
        return (obs - self.obs_mean) / self.obs_denom

    def reset(self, seed: int | None = None) -> np.ndarray:
        return self._scale(self.inner.reset(seed=seed))

    def step(self, normalized_actions):
        obs_prev, true_next, reward, terminal, done, obs_after = (
            self.inner.step(normalized_actions))
        return (self._scale(obs_prev), self._scale(true_next), reward,
                terminal, done, self._scale(obs_after))


class MinmaxHostEnv(ScaledHostEnv):
    """obs -> (obs - min) / (max - min)  (reference MinmaxEnv:143)."""

    def __init__(self, inner, obs_min, obs_max, eps: float = 1e-8):
        _DelegatingHostEnv.__init__(self, inner)
        self.obs_mean = np.asarray(obs_min, np.float32)
        self.obs_denom = (np.asarray(obs_max, np.float32)
                          - np.asarray(obs_min, np.float32) + eps)


class AbsorbingHostEnv(_DelegatingHostEnv):
    """DAC absorbing states on host envs, as envs/wrappers.py::
    AbsorbingEnv: the obs gain a trailing indicator; a true terminal
    routes into a zero-obs absorbing state with one self-loop step (zero
    reward) before the inner reset's obs is exposed.  The inner env still
    advances during the self-loop step (with inner autoreset, one
    throwaway step of the fresh episode): the recorded DAC transitions are
    exact, and the episode resumes one inner step in."""

    def __init__(self, inner):
        super().__init__(inner)
        self.observation_size = inner.observation_size + 1
        self.max_episode_steps = inner.max_episode_steps + 1
        self._in_absorbing = np.zeros((inner.num_envs,), bool)

    def _pad(self, obs, flag: float = 0.0):
        f = np.full((obs.shape[0], 1), flag, np.float32)
        return np.concatenate([obs, f], axis=-1)

    def _absorb(self, n: int):
        out = np.zeros((n, self.observation_size), np.float32)
        out[:, -1] = 1.0
        return out

    def reset(self, seed: int | None = None) -> np.ndarray:
        self._in_absorbing[:] = False
        return self._pad(self.inner.reset(seed=seed))

    def step(self, normalized_actions):
        B = self.num_envs
        was_absorbing = self._in_absorbing.copy()
        obs_prev_i, true_next_i, reward_i, terminal_i, done_i, obs_after_i = (
            self.inner.step(normalized_actions))
        obs_prev = np.where(was_absorbing[:, None], self._absorb(B),
                            self._pad(obs_prev_i))
        reward = np.where(was_absorbing, 0.0, reward_i)
        entered = np.logical_and(~was_absorbing, terminal_i)
        # the absorbing self-loop row ends the episode
        terminal = was_absorbing.copy()
        done = np.logical_or(was_absorbing,
                             np.logical_and(done_i, ~entered))
        true_next = np.where(
            np.logical_or(was_absorbing, entered)[:, None],
            self._absorb(B), self._pad(true_next_i))
        # rows entering absorbing expose the absorbing obs for one step;
        # afterwards the stream rejoins the inner env's live obs
        obs_after = self._pad(obs_after_i)
        obs_after[entered] = self._absorb(B)[entered]
        self._in_absorbing = entered
        return obs_prev, true_next, reward, terminal, done, obs_after
