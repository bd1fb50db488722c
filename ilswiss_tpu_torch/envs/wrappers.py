"""Env wrappers of the demo statistics and of absorbing states
(counterpart: ilswiss_tpu/envs/wrappers.py; `ScaledEnv`, `AbsorbingEnv`,
`MinmaxEnv`).

Each wraps a port `Environment` and keeps its batched API: `reset` takes
the reset noise (`sample_reset_noise` is the inner env's), `step` the
batched state and Box action, so `VectorEnv`'s branchless autoreset
selects a wrapped state as it selects the inner one.  The reference's
wrappers are rlkit/envs/wrappers.py:53 (ScaledEnv) and :143 (MinmaxEnv);
the absorbing states are DAC's (adv_irl.py:144-171).  `DiscretEnv`
(JAX wrappers.py:200-240) turns a Box env's actions into indices of an
action table.  `FrameStackEnv` (JAX wrappers.py:157-198) stacks the last
k observations along the trailing axis.
A wrapper of a goal env forwards its `goal_size` and `compute_reward`.
"""

from __future__ import annotations

import numpy as np
import torch

from ilswiss_tpu_torch.envs.base import Environment, EnvState, StepOutput


class _DelegatingEnv(Environment):
    """Sizes, bounds, horizon and device of the inner env."""

    def __init__(self, inner: Environment):
        self.inner = inner
        self.observation_size = inner.observation_size
        self.action_size = inner.action_size
        self.discrete = inner.discrete
        self.max_episode_steps = inner.max_episode_steps
        self.action_low = inner.action_low
        self.action_high = inner.action_high
        self.device = inner.device
        # the goal-env surface (HER, GCSL), where the inner env has one
        if hasattr(inner, "goal_size"):
            self.goal_size = inner.goal_size
        if hasattr(inner, "compute_reward"):
            self.compute_reward = inner.compute_reward

    def sample_reset_noise(self, n: int, generator: torch.Generator):
        return self.inner.sample_reset_noise(n, generator)

    def scale_action(self, normalized: torch.Tensor) -> torch.Tensor:
        return self.inner.scale_action(normalized)

    def _vector(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)


class _ObsMapEnv(_DelegatingEnv):
    """An elementwise map of every observation the inner env returns."""

    def _scale_obs(self, obs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _inner_action(self, action: torch.Tensor) -> torch.Tensor:
        return action

    def reset(self, noise) -> EnvState:
        s = self.inner.reset(noise)
        return EnvState(internal=s.internal, obs=self._scale_obs(s.obs),
                        t=s.t)

    def step(self, state: EnvState, action: torch.Tensor) -> StepOutput:
        out = self.inner.step(state, self._inner_action(action))
        obs = self._scale_obs(out.obs)
        return StepOutput(
            state=EnvState(internal=out.state.internal, obs=obs,
                           t=out.state.t),
            obs=obs, reward=out.reward, terminal=out.terminal,
            truncation=out.truncation)


class ScaledEnv(_ObsMapEnv):
    """obs -> (obs - mean) / (std + 1e-8); with action statistics, the
    agent's actions are unscaled, a * (std + 1e-8) + mean, before the true
    step (JAX `ScaledEnv`, wrappers.py:45-83)."""

    def __init__(self, inner: Environment, obs_mean=None, obs_std=None,
                 acts_mean=None, acts_std=None):
        super().__init__(inner)
        vec = lambda x: None if x is None else self._vector(x)  # noqa: E731
        self.obs_mean, self.obs_std = vec(obs_mean), vec(obs_std)
        self.acts_mean, self.acts_std = vec(acts_mean), vec(acts_std)

    def _scale_obs(self, obs):
        if self.obs_mean is None:
            return obs
        return (obs - self.obs_mean) / (self.obs_std + 1e-8)

    def _inner_action(self, action):
        if self.acts_mean is None:
            return action
        return action * (self.acts_std + 1e-8) + self.acts_mean


class MinmaxEnv(_ObsMapEnv):
    """obs -> (obs - min) / (max - min + 1e-8) (JAX `MinmaxEnv`,
    wrappers.py:243-266)."""

    def __init__(self, inner: Environment, obs_min, obs_max):
        super().__init__(inner)
        self.obs_min = self._vector(obs_min)
        self.obs_max = self._vector(obs_max)

    def _scale_obs(self, obs):
        return (obs - self.obs_min) / (self.obs_max - self.obs_min + 1e-8)


class AbsorbingEnv(_DelegatingEnv):
    """DAC absorbing states (JAX `AbsorbingEnv`, wrappers.py:85-155).

    Observations gain a trailing flag (0 normal, 1 absorbing).  When the
    inner env terminates, the episode does not end: the next observation is
    the absorbing state (zeros, flag 1), and the step after it is the
    absorbing self-loop, with reward 0 and terminal set, which ends the
    episode.  The inner env is stepped on that step too, and its result is
    dropped, as in the JAX package.  The state's `internal` is the inner
    env's tensors followed by the [B] bool "in the absorbing state"; the
    truncation horizon stays the inner env's, and `max_episode_steps` says
    one more, as the JAX attribute does."""

    def __init__(self, inner: Environment):
        super().__init__(inner)
        self.observation_size = inner.observation_size + 1
        self.max_episode_steps = inner.max_episode_steps + 1

    @staticmethod
    def _pad(obs: torch.Tensor, flag: float) -> torch.Tensor:
        return torch.cat([obs, torch.full_like(obs[:, :1], flag)], dim=-1)

    def reset(self, noise) -> EnvState:
        s = self.inner.reset(noise)
        absorbing = torch.zeros(s.obs.shape[0], dtype=torch.bool,
                                device=s.obs.device)
        return EnvState(internal=tuple(s.internal) + (absorbing,),
                        obs=self._pad(s.obs, 0.0), t=s.t)

    def step(self, state: EnvState, action: torch.Tensor) -> StepOutput:
        *inner_internal, in_absorbing = state.internal
        out = self.inner.step(
            EnvState(internal=tuple(inner_internal),
                     obs=state.obs[:, :-1], t=state.t), action)
        entered = out.terminal
        absorb_obs = self._pad(torch.zeros_like(out.obs), 1.0)
        col = lambda m: m[:, None]  # noqa: E731
        normal_obs = torch.where(col(entered), absorb_obs,
                                 self._pad(out.obs, 0.0))
        obs = torch.where(col(in_absorbing), absorb_obs, normal_obs)
        return StepOutput(
            state=EnvState(internal=tuple(out.state.internal) + (entered,),
                           obs=obs, t=out.state.t),
            obs=obs,
            reward=torch.where(in_absorbing, torch.zeros_like(out.reward),
                               out.reward),
            terminal=in_absorbing,
            truncation=torch.logical_and(out.truncation,
                                         torch.logical_not(entered)))


class DiscretEnv(_DelegatingEnv):
    """Continuous -> discrete actions (JAX `DiscretEnv`, wrappers.py:
    200-240; reference rlkit/envs/wrappers.py:411-446): an action is an
    index [B] into `base_actions`, a meshgrid of `granularity` levels per
    action dim between the Box bounds (numpy's `meshgrid` order), or the
    rows of an explicit `possible_actions` table.  `scale_action` passes
    the index through, and the inner env steps on the table's rows."""

    def __init__(self, inner: Environment, granularity: int = 10,
                 possible_actions=None):
        super().__init__(inner)
        if inner.discrete:
            raise ValueError("DiscretEnv: the inner env is already discrete")
        if possible_actions is not None:
            base = np.asarray(possible_actions, np.float32)
            if base.ndim == 1:
                base = base[:, None]
        else:
            axes = [np.linspace(lo, hi, granularity) for lo, hi in zip(
                np.atleast_1d(inner.action_low),
                np.atleast_1d(inner.action_high))]
            mesh = np.meshgrid(*axes)
            base = np.stack([a.ravel() for a in mesh], axis=-1)
        self.base_actions = self._vector(base)
        self.discrete = True
        self.action_size = int(base.shape[0])  # number of discrete actions
        self.action_low = None
        self.action_high = None

    def reset(self, noise) -> EnvState:
        return self.inner.reset(noise)

    def step(self, state: EnvState, action: torch.Tensor) -> StepOutput:
        cont = self.base_actions[action.to(torch.int64)]
        return self.inner.step(state, cont.reshape(
            (-1,) + np.shape(self.inner.action_low)))

    def scale_action(self, normalized: torch.Tensor) -> torch.Tensor:
        return normalized  # discrete indices pass through


class FrameStackEnv(_DelegatingEnv):
    """The last k observations stacked along the trailing axis (JAX
    `FrameStackEnv`, wrappers.py:157-198; reference rlkit/envs/wrappers.py:
    367): image obs [B, H, W, C] -> [B, H, W, C * k], vector obs [B, D] ->
    [B, D * k], oldest first.  At reset all k frames are the first
    observation.  The state's `internal` is the inner env's tensors
    followed by the k frames, so `VectorEnv`'s autoreset selects them
    as it selects the inner state."""

    def __init__(self, inner: Environment, k: int = 4):
        super().__init__(inner)
        self.k = k
        size = inner.observation_size
        if isinstance(size, tuple):
            self.observation_size = size[:-1] + (size[-1] * k,)
        else:
            self.observation_size = size * k

    def reset(self, noise) -> EnvState:
        s = self.inner.reset(noise)
        frames = (s.obs,) * self.k
        return EnvState(internal=tuple(s.internal) + frames,
                        obs=torch.cat(frames, dim=-1), t=s.t)

    def step(self, state: EnvState, action: torch.Tensor) -> StepOutput:
        inner_internal = state.internal[:-self.k]
        frames = state.internal[-self.k:]
        out = self.inner.step(
            EnvState(internal=inner_internal, obs=frames[-1], t=state.t),
            action)
        frames = frames[1:] + (out.obs,)
        obs = torch.cat(frames, dim=-1)
        return StepOutput(
            state=EnvState(internal=tuple(out.state.internal) + frames,
                           obs=obs, t=out.state.t),
            obs=obs, reward=out.reward, terminal=out.terminal,
            truncation=out.truncation)
