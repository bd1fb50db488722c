"""Vectorized env with branchless autoreset (counterpart:
ilswiss_tpu/envs/vector.py).

`step` returns a `Transition` that carries the TRUE next observation,
while the returned state already holds the reset state of every env that
finished.  Every env's reset state is computed each step from the reset
noise passed in, and `torch.where` keeps it only where the episode ended.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from ilswiss_tpu_torch.envs.base import Environment, EnvState


@dataclass
class Transition:
    """One batched transition [B, ...] as stored into replay."""

    obs: Any                 # [B, obs_size], or a goal env's dict
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: Any
    terminal: torch.Tensor   # true termination -> no bootstrap
    done: torch.Tensor       # terminal | truncation -> episode boundary


def _select(done: torch.Tensor, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    return torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def _select_obs(done: torch.Tensor, a, b):
    """`_select` on an observation, or on each entry of a dict
    observation, as the JAX `jax.tree.map` does."""
    if isinstance(a, dict):
        return {k: _select(done, a[k], b[k]) for k in a}
    return _select(done, a, b)


class VectorEnv:
    """`num_envs` lockstep instances of `env` with automatic reset."""

    def __init__(self, env: Environment, num_envs: int):
        self.env = env
        self.num_envs = num_envs

    def reset(self, noise: Tuple[torch.Tensor, ...]) -> EnvState:
        return self.env.reset(noise)

    def step(self, state: EnvState, normalized_action: torch.Tensor,
             reset_noise: Tuple[torch.Tensor, ...]
             ) -> tuple[EnvState, Transition]:
        """Step all envs with policy-space actions in [-1, 1]; envs whose
        episode ended restart from `reset_noise`."""
        env_action = self.env.scale_action(normalized_action)
        out = self.env.step(state, env_action)
        done = out.done
        fresh = self.env.reset(reset_noise)
        new_state = EnvState(
            internal=tuple(_select(done, r, s) for r, s in
                           zip(fresh.internal, out.state.internal)),
            obs=_select_obs(done, fresh.obs, out.state.obs),
            t=_select(done, fresh.t, out.state.t),
        )
        transition = Transition(
            obs=state.obs,
            action=normalized_action,
            reward=out.reward,
            next_obs=out.obs,
            terminal=out.terminal,
            done=done,
        )
        return new_state, transition
