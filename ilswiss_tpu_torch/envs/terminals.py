"""Analytic terminal predicates for model rollouts (counterpart:
ilswiss_tpu/envs/terminals.py).

MBPO's branched rollouts need a done signal computed from (obs, act,
next_obs) without a simulator.  Each predicate maps `[B, ...]` tensors to
a `[B]` bool tensor.  As in the JAX package, hopper, ant and
invertedpendulum count a row with a NaN or inf as terminal; walker and
humanoid compare heights only, so such a row is terminal there only where
a comparison with NaN is false.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

TERMINAL_REGISTRY: Dict[str, Callable] = {}


def register_terminal(name: str):
    def deco(fn):
        TERMINAL_REGISTRY[name] = fn
        return fn
    return deco


def get_terminal_func(env_name: str) -> Callable:
    if env_name not in TERMINAL_REGISTRY:
        raise KeyError(f"no terminal fn for '{env_name}'; "
                       f"registered: {sorted(TERMINAL_REGISTRY)}")
    return TERMINAL_REGISTRY[env_name]


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x).all(dim=-1)


@register_terminal("pendulum")
@register_terminal("halfcheetah")
@register_terminal("swimmer")
def never_terminal(obs, act, next_obs):
    return torch.zeros(next_obs.shape[0], dtype=torch.bool,
                       device=next_obs.device)


@register_terminal("cartpole")
def cartpole_terminal(obs, act, next_obs):
    x, theta = next_obs[:, 0], next_obs[:, 2]
    return (x.abs() > 2.4) | (theta.abs() > 12.0 * 2.0 * math.pi / 360.0)


@register_terminal("mountain")
def mountain_terminal(obs, act, next_obs):
    return next_obs[:, 0] >= 0.45


@register_terminal("invertedpendulum")
def inverted_pendulum_terminal(obs, act, next_obs):
    return ~(_finite(next_obs) & (next_obs[:, 1].abs() <= 0.2))


@register_terminal("hopper")
def hopper_terminal(obs, act, next_obs):
    """Healthy iff finite, |state[1:]| < 100, height > 0.7 and
    |angle| < 0.2."""
    height, angle = next_obs[:, 0], next_obs[:, 1]
    bounded = (next_obs[:, 1:].abs() < 100.0).all(dim=-1)
    return ~(_finite(next_obs) & bounded & (height > 0.7)
             & (angle.abs() < 0.2))


@register_terminal("walker")
def walker_terminal(obs, act, next_obs):
    """Healthy iff 0.8 < height < 2.0 and -1 < angle < 1."""
    height, angle = next_obs[:, 0], next_obs[:, 1]
    return ~((height > 0.8) & (height < 2.0) & (angle > -1.0)
             & (angle < 1.0))


@register_terminal("ant")
def ant_terminal(obs, act, next_obs):
    """Healthy iff finite and 0.2 <= torso height <= 1.0."""
    height = next_obs[:, 0]
    return ~(_finite(next_obs) & (height >= 0.2) & (height <= 1.0))


@register_terminal("humanoid")
def humanoid_terminal(obs, act, next_obs):
    """Healthy iff 1.0 < torso height < 2.0."""
    height = next_obs[:, 0]
    return ~((height > 1.0) & (height < 2.0))


# the truncated-observation variants keep the torso height at obs[:, 0]
register_terminal("ant_trunc_obs")(ant_terminal)
register_terminal("humanoid_trunc_obs")(humanoid_terminal)
