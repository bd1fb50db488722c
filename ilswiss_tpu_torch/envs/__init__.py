"""Env registry and factory (counterpart: ilswiss_tpu/envs/__init__.py).

`make(name)` returns a static `Environment`, `make_vec(name, num_envs)`
the lockstep vectorized env.  Ported: the MuJoCo locomotion models,
pendulum, mountain, cartpole, the goal env reach2d and pendulum_pixels
(image observations, NHWC).
"""

from __future__ import annotations

from typing import Callable, Dict

from ilswiss_tpu_torch.envs.base import Environment, EnvState, StepOutput
from ilswiss_tpu_torch.envs.vector import Transition, VectorEnv
from ilswiss_tpu_torch.envs import locomotion
from ilswiss_tpu_torch.envs.classic import (
    CartPole, MountainCarContinuous, Pendulum, PendulumPixels,
)
from ilswiss_tpu_torch.envs.goal import GoalReach2D

ENV_REGISTRY: Dict[str, Callable[..., Environment]] = {}


def register(name: str, ctor: Callable[..., Environment]) -> None:
    ENV_REGISTRY[name] = ctor


# Names follow the reference registry keys (rlkit/envs/envs_dict.py).
register("pendulum", Pendulum)
register("mountain", MountainCarContinuous)
register("cartpole", CartPole)
register("reach2d", GoalReach2D)
register("pendulum_pixels", PendulumPixels)
locomotion.register_all(register)


def make(name: str, device=None, **kwargs) -> Environment:
    if name not in ENV_REGISTRY:
        raise KeyError(
            f"Unknown env '{name}'. Registered: {sorted(ENV_REGISTRY)}")
    return ENV_REGISTRY[name](device=device, **kwargs)


def make_vec(name: str, num_envs: int, device=None, **kwargs) -> VectorEnv:
    return VectorEnv(make(name, device=device, **kwargs), num_envs)


__all__ = ["Environment", "EnvState", "StepOutput", "Transition",
           "VectorEnv", "make", "make_vec", "register", "ENV_REGISTRY"]
