"""On-device MuJoCo locomotion environments (counterpart:
ilswiss_tpu/envs/locomotion.py; hopper so far).

Observation, reward, termination and reset noise follow gymnasium v5, as
in the JAX package:

  hopper:  obs [qpos[1:], clip(qvel, +-10)]; r = dx/dt + healthy
           - 1e-3 |a|^2; healthy: finite, |state[2:]| < 100, z > 0.7,
           |angle| < 0.2

Only hopper is registered so far; the other planar models (walker,
halfcheetah, invertedpendulum) already step through the same physics.

The internal state is (qpos, qvel, row forces): the constraint solver
warm-starts from the previous control step's forces, and they reset to
zero with the episode.  `solver_iters` PGS sweeps per evaluation (15).
Physics steps through ops/planar_dynamics.py, whose forward evaluations
are kernel K1 on the GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ilswiss_tpu_torch.envs._locomotion_params import PARAMS
from ilswiss_tpu_torch.envs.base import Environment
from ilswiss_tpu_torch.ops.planar_dynamics import (
    physics_step_auto as physics_step,
)
from ilswiss_tpu_torch.ops.rigid_body import RigidModel

_MODELS: dict[str, RigidModel] = {}


def _model(name: str) -> RigidModel:
    if name not in _MODELS:
        _MODELS[name] = RigidModel(PARAMS[name])
    return _MODELS[name]


class LocomotionEnv(Environment):
    """Base for the scalar-joint MuJoCo models."""

    name: str
    max_episode_steps = 1000
    solver_iters = 15
    reset_noise_scale = 5e-3

    def __init__(self, device=None, **overrides):
        super().__init__(device=device, **overrides)
        self.model = _model(self.name)
        self.action_low = np.asarray(self.model.ctrl_range[:, 0], np.float32)
        self.action_high = np.asarray(self.model.ctrl_range[:, 1], np.float32)
        self.action_size = self.model.nu
        self.dt = self.model.timestep * self.model.frame_skip
        self.qpos0 = torch.as_tensor(self.model.qpos0, dtype=torch.float32,
                                     device=self.device)

    # -- hooks per env -------------------------------------------------
    def _obs(self, q, qd, qfrc_con):
        raise NotImplementedError

    def _reward_terminal(self, q_before, q, qd, qfrc_con, action):
        raise NotImplementedError

    # -- Environment API ----------------------------------------------
    def sample_reset_noise(self, n: int, generator: torch.Generator):
        """(dq [n, nq], dqd [n, nv]): uniform(+-s) on qpos and on qvel,
        as gymnasium draws them for hopper."""
        m, s = self.model, self.reset_noise_scale
        kw = dict(dtype=torch.float32, device=self.device)
        dq = torch.empty((n, m.nq), **kw).uniform_(-s, s, generator=generator)
        dqd = torch.empty((n, m.nv), **kw).uniform_(-s, s, generator=generator)
        return dq, dqd

    def _reset(self, noise):
        dq, dqd = noise
        q = self.qpos0 + dq
        warm = q.new_zeros((q.shape[0], self.model.nrow))
        return (q, dqd, warm), self._obs(q, dqd, torch.zeros_like(dqd))

    def _step(self, internal, action):
        q0, qd0, warm = internal
        q, qd, qfrc_con, warm, _ = physics_step(
            self.model, q0, qd0, action, iters=self.solver_iters, f0=warm)
        q, qd, warm = q.contiguous(), qd.contiguous(), warm.contiguous()
        obs = self._obs(q, qd, qfrc_con)
        reward, terminal = self._reward_terminal(q0, q, qd, qfrc_con, action)
        return (q, qd, warm), obs, reward, terminal


def _all_finite(x: torch.Tensor) -> torch.Tensor:
    return torch.all(torch.isfinite(x), dim=-1)


class HopperDevice(LocomotionEnv):
    name = "hopper"
    observation_size = 11

    def _obs(self, q, qd, qfrc_con):
        return torch.cat([q[:, 1:], torch.clamp(qd, -10.0, 10.0)], dim=-1)

    def _reward_terminal(self, q_before, q, qd, qfrc_con, action):
        x_vel = (q[:, 0] - q_before[:, 0]) / self.dt
        state = torch.cat([q[:, 2:], qd], dim=-1)
        healthy = (_all_finite(q) & _all_finite(qd)
                   & torch.all(torch.abs(state) < 100.0, dim=-1)
                   & (q[:, 1] > 0.7) & (torch.abs(q[:, 2]) < 0.2))
        reward = x_vel + 1.0 - 1e-3 * torch.sum(action ** 2, dim=-1)
        return reward, torch.logical_not(healthy)


def register_all(register) -> None:
    register("hopper", HopperDevice)
