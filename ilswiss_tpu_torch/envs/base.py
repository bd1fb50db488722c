"""Batched environment API (counterpart: ilswiss_tpu/envs/base.py).

The JAX package writes a per-env `reset`/`step` and vmaps it; here the
batch dimension is written out, so `reset` and `step` take and return
batched tensors `[B, ...]`.  Episode truncation is part of the state (the
`t` counter), as in the JAX package.  Randomness comes in as tensors:
`reset` takes its noise draws, which `sample_reset_noise` makes from a
`torch.Generator` (or a test hands over the JAX package's draws).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from ilswiss_tpu_torch.utils.device import resolve_device


@dataclass
class EnvState:
    """Batched per-env dynamic state.

    internal: env-specific physics state, a tuple of [B, ...] tensors.
    obs: current observation [B, obs_size] (what the policy sees next),
      or a goal env's dict of such tensors (envs/goal.py).
    t: int32 [B] step count within the current episode."""

    internal: Tuple[torch.Tensor, ...]
    obs: Any
    t: torch.Tensor


@dataclass
class StepOutput:
    """One batched `env.step` before any autoreset.  `terminal` is a true
    termination (no bootstrap), `truncation` a time-limit cut."""

    state: EnvState
    obs: Any
    reward: torch.Tensor
    terminal: torch.Tensor
    truncation: torch.Tensor

    @property
    def done(self) -> torch.Tensor:
        return torch.logical_or(self.terminal, self.truncation)


class Environment:
    """Static env descriptor with batched reset/step.

    Subclasses set observation_size, action_size, action_low/high and
    max_episode_steps (0 = no limit), and implement
    `sample_reset_noise(n, generator)`, `_reset(noise) -> (internal, obs)`
    and `_step(internal, action) -> (internal, obs, reward, terminal)`."""

    observation_size: int
    action_size: int
    discrete: bool = False
    max_episode_steps: int = 1000
    action_low: np.ndarray
    action_high: np.ndarray

    def __init__(self, device=None, **overrides):
        # env_kwargs of a spec; unknown keys fail loudly
        for k, v in overrides.items():
            if not hasattr(type(self), k):
                raise TypeError(
                    f"{type(self).__name__} has no parameter '{k}'")
            setattr(self, k, v)
        self.device = resolve_device(device)

    # --- subclass hooks -------------------------------------------------
    def sample_reset_noise(self, n: int, generator: torch.Generator
                           ) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def _reset(self, noise: Tuple[torch.Tensor, ...]) -> Tuple[Any, Any]:
        raise NotImplementedError

    def _step(self, internal, action: torch.Tensor):
        raise NotImplementedError

    # --- public API -----------------------------------------------------
    def reset(self, noise: Tuple[torch.Tensor, ...]) -> EnvState:
        internal, obs = self._reset(noise)
        first = next(iter(obs.values())) if isinstance(obs, dict) else obs
        t = torch.zeros(first.shape[0], dtype=torch.int32,
                        device=first.device)
        return EnvState(internal=internal, obs=obs, t=t)

    def step(self, state: EnvState, action: torch.Tensor) -> StepOutput:
        internal, obs, reward, terminal = self._step(state.internal, action)
        t = state.t + 1
        if self.max_episode_steps > 0:
            truncation = torch.logical_and(t >= self.max_episode_steps,
                                           torch.logical_not(terminal))
        else:
            truncation = torch.zeros_like(terminal)
        return StepOutput(
            state=EnvState(internal=internal, obs=obs, t=t),
            obs=obs,
            reward=reward.to(torch.float32),
            terminal=terminal.to(torch.bool),
            truncation=truncation,
        )

    def scale_action(self, normalized: torch.Tensor) -> torch.Tensor:
        """Policy actions in [-1, 1] to the Box bounds: lerp, then clip."""
        if self.discrete:
            return normalized
        low, high = self._action_bounds(normalized.device)
        action = low + (normalized + 1.0) * 0.5 * (high - low)
        return torch.clamp(action, low, high)

    def _action_bounds(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The Box bounds as float32 tensors on `device`, copied from the
        host at the first call there: a copy from host memory to a CUDA
        device waits for the device."""
        bounds = getattr(self, "_bounds", None)
        if bounds is None or bounds[0].device != device:
            bounds = self._bounds = tuple(
                torch.as_tensor(b, dtype=torch.float32, device=device)
                for b in (self.action_low, self.action_high))
        return bounds
