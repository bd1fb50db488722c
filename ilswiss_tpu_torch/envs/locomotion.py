"""On-device MuJoCo locomotion environments (counterpart:
ilswiss_tpu/envs/locomotion.py).

Observation, reward, termination and reset noise follow gymnasium v5, as
in the JAX package:

  hopper:  obs [qpos[1:], clip(qvel, +-10)]; r = dx/dt + healthy
           - 1e-3 |a|^2; healthy: finite, |state[2:]| < 100, z > 0.7,
           |angle| < 0.2
  walker:  same obs form; healthy: 0.8 < z < 2.0, |angle| < 1
  halfcheetah: obs [qpos[1:], qvel]; r = dx/dt - 0.1 |a|^2; no terminal
  invertedpendulum: obs [qpos, qvel]; r = 1 while |angle| <= 0.2
  inverteddoublependulum: obs [x, sin q12, cos q12, clip(qvel, +-10),
           clip(qfrc_constraint[0], +-10)]; r = 10 healthy
           - (0.01 x_tip^2 + (y_tip - 2)^2) - (1e-3 w1^2 + 5e-3 w2^2);
           terminal when y_tip <= 1
  swimmer: obs [qpos[2:], qvel]; r = dx/dt - 1e-4 |a|^2; no terminal
  ant:     obs [qpos[2:], qvel, clip(cfrc_ext[1:], +-1)]; r = dx/dt
           + healthy - 0.5 |a|^2 - 5e-4 sum clip(cfrc)^2; healthy: finite,
           0.2 <= z <= 1
  humanoid: obs [qpos[2:], qvel, cinert[1:], cvel[1:], qfrc_actuator[6:],
           cfrc_ext[1:]]; r = 1.25 d(com_x)/dt + 5 healthy - 0.1 |a|^2
           - min(5e-7 sum cfrc^2, 10); healthy: 1 < z < 2
  ant_trunc_obs, humanoid_trunc_obs: the same with obs [qpos[2:], qvel]

The internal state is (qpos, qvel, row forces): the constraint solver
warm-starts from the previous control step's forces, and they reset to
zero with the episode.  `solver_iters` PGS sweeps per evaluation (15).
Physics steps through `physics_step_auto`: the planar models (hopper,
walker, halfcheetah, invertedpendulum) through ops/planar_dynamics.py, whose forward evaluations
are kernel K1 on the GPU; the others through the general engine of
ops/rigid_body.py, whose Gauss-Seidel solves are kernel K4.
"""

from __future__ import annotations

import numpy as np
import torch

from ilswiss_tpu_torch.envs._locomotion_params import PARAMS
from ilswiss_tpu_torch.envs.base import Environment
from ilswiss_tpu_torch.ops.planar_dynamics import (
    physics_step_auto as physics_step,
)
from ilswiss_tpu_torch.ops.rigid_body import (
    RigidModel, actuation, cfrc_ext, com_quantities, site_positions,
)
from ilswiss_tpu_torch.utils.profiling import span

_MODELS: dict[str, RigidModel] = {}


def _model(name: str) -> RigidModel:
    if name not in _MODELS:
        _MODELS[name] = RigidModel(PARAMS[name])
    return _MODELS[name]


class LocomotionEnv(Environment):
    """Base for the MuJoCo models."""

    name: str
    model_name: str | None = None   # the PARAMS entry, where it is not `name`
    max_episode_steps = 1000
    solver_iters = 15
    reset_noise_scale = 5e-3
    gaussian_qvel_noise = False   # halfcheetah, the double pendulum and
                                  # ant draw qvel from N(0, s)

    def __init__(self, device=None, **overrides):
        super().__init__(device=device, **overrides)
        self.model = _model(self.model_name or self.name)
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
        """(dq [n, nq], dqd [n, nv]) as gymnasium draws them: uniform(+-s)
        on qpos (applied raw, quaternions included), and uniform(+-s) or
        s N(0, 1) on qvel."""
        m, s = self.model, self.reset_noise_scale
        kw = dict(dtype=torch.float32, device=self.device)
        dq = torch.empty((n, m.nq), **kw).uniform_(-s, s, generator=generator)
        if self.gaussian_qvel_noise:
            dqd = s * torch.randn((n, m.nv), generator=generator, **kw)
        else:
            dqd = torch.empty((n, m.nv), **kw).uniform_(-s, s,
                                                        generator=generator)
        return dq, dqd

    def _sample_state(self, noise):
        dq, dqd = noise
        q = self.qpos0 + dq
        return q, dqd, q.new_zeros((q.shape[0], self.model.nrow))

    def _reset(self, noise):
        q, qd, warm = self._sample_state(noise)
        return (q, qd, warm), self._obs(q, qd, torch.zeros_like(qd))

    def _step(self, internal, action):
        q0, qd0, warm = internal
        q, qd, qfrc_con, warm, _ = physics_step(
            self.model, q0, qd0, action, iters=self.solver_iters, f0=warm)
        with span("env.observe"):
            q, qd, warm = q.contiguous(), qd.contiguous(), warm.contiguous()
            obs = self._obs(q, qd, qfrc_con)
            reward, terminal = self._reward_terminal(q0, q, qd, qfrc_con,
                                                     action)
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


class WalkerDevice(LocomotionEnv):
    name = "walker"
    observation_size = 17

    def _obs(self, q, qd, qfrc_con):
        return torch.cat([q[:, 1:], torch.clamp(qd, -10.0, 10.0)], dim=-1)

    def _reward_terminal(self, q_before, q, qd, qfrc_con, action):
        x_vel = (q[:, 0] - q_before[:, 0]) / self.dt
        healthy = ((q[:, 1] > 0.8) & (q[:, 1] < 2.0)
                   & (q[:, 2] > -1.0) & (q[:, 2] < 1.0))
        reward = x_vel + 1.0 - 1e-3 * torch.sum(action ** 2, dim=-1)
        return reward, torch.logical_not(healthy)


class HalfCheetahDevice(LocomotionEnv):
    name = "halfcheetah"
    observation_size = 17
    reset_noise_scale = 0.1
    gaussian_qvel_noise = True

    def _obs(self, q, qd, qfrc_con):
        return torch.cat([q[:, 1:], qd], dim=-1)

    def _reward_terminal(self, q_before, q, qd, qfrc_con, action):
        x_vel = (q[:, 0] - q_before[:, 0]) / self.dt
        reward = x_vel - 0.1 * torch.sum(action ** 2, dim=-1)
        return reward, torch.zeros_like(reward, dtype=torch.bool)


class InvertedPendulumDevice(LocomotionEnv):
    name = "invertedpendulum"
    observation_size = 4
    reset_noise_scale = 0.01

    def _obs(self, q, qd, qfrc_con):
        return torch.cat([q, qd], dim=-1)

    def _reward_terminal(self, q_before, q, qd, qfrc_con, action):
        finite = _all_finite(q) & _all_finite(qd)
        terminal = torch.logical_not(finite) | (torch.abs(q[:, 1]) > 0.2)
        return torch.logical_not(terminal).to(torch.float32), terminal


class InvertedDoublePendulumDevice(LocomotionEnv):
    name = "inverteddoublependulum"
    observation_size = 9
    reset_noise_scale = 0.1
    gaussian_qvel_noise = True
    healthy_reward = 10.0

    def _obs(self, q, qd, qfrc_con):
        return torch.cat([
            q[:, :1], torch.sin(q[:, 1:]), torch.cos(q[:, 1:]),
            torch.clamp(qd, -10.0, 10.0),
            torch.clamp(qfrc_con, -10.0, 10.0)[:, :1],
        ], dim=-1)

    def _reward_terminal(self, q_before, q, qd, qfrc_con, action):
        tip = site_positions(self.model, q)[:, 0]
        x, y = tip[:, 0], tip[:, 2]
        terminal = y <= 1.0
        dist_penalty = 0.01 * x ** 2 + (y - 2.0) ** 2
        vel_penalty = 1e-3 * qd[:, 1] ** 2 + 5e-3 * qd[:, 2] ** 2
        alive = self.healthy_reward * torch.logical_not(terminal)
        return alive - dist_penalty - vel_penalty, terminal


class SwimmerDevice(LocomotionEnv):
    """Swimmer-v5 (planar slide-slide-hinge root; propulsion comes from the
    inertia-box fluid model).  Never terminates."""

    name = "swimmer"
    observation_size = 8
    reset_noise_scale = 0.1

    def _obs(self, q, qd, qfrc_con):
        return torch.cat([q[:, 2:], qd], dim=-1)

    def _reward_terminal(self, q_before, q, qd, qfrc_con, action):
        x_vel = (q[:, 0] - q_before[:, 0]) / self.dt
        reward = x_vel - 1e-4 * torch.sum(action ** 2, dim=-1)
        return reward, torch.zeros_like(reward, dtype=torch.bool)


class AntDevice(LocomotionEnv):
    """Ant-v5 (free quaternion root, RK4, 25 plane-contact candidates).

    cfrc_ext is recomposed at the last substep's final forward evaluation
    (RK4 stage 3), where gym's mj_rnePostConstraint reads mjData's contacts
    and forces; gym's reset skips that pass, so a reset observation's
    cfrc_ext entries are zero."""

    name = "ant"
    observation_size = 105
    reset_noise_scale = 0.1
    gaussian_qvel_noise = True

    def _obs(self, q, qd, cfrc):
        return torch.cat([
            q[:, 2:], qd, torch.clamp(cfrc[:, 1:].flatten(1), -1.0, 1.0),
        ], dim=-1)

    def _reset(self, noise):
        q, qd, warm = self._sample_state(noise)
        zero_cfrc = q.new_zeros((q.shape[0], self.model.nbody, 6))
        return (q, qd, warm), self._obs(q, qd, zero_cfrc)

    def _step(self, internal, action):
        q0, qd0, warm = internal
        q, qd, _, warm, (q_ev, _) = physics_step(
            self.model, q0, qd0, action, iters=self.solver_iters, f0=warm)
        with span("env.observe"):
            cfrc = cfrc_ext(self.model, q_ev, warm)
            obs = self._obs(q, qd, cfrc)
            x_vel = (q[:, 0] - q0[:, 0]) / self.dt
            healthy = (_all_finite(q) & _all_finite(qd)
                       & (q[:, 2] >= 0.2) & (q[:, 2] <= 1.0))
            clipped = torch.clamp(cfrc, -1.0, 1.0)
            contact_cost = 5e-4 * torch.sum(clipped ** 2, dim=(1, 2))
            reward = (x_vel + healthy.to(torch.float32)
                      - 0.5 * torch.sum(action ** 2, dim=-1) - contact_cost)
            terminal = torch.logical_not(healthy)
        return (q, qd, warm), obs, reward, terminal


class HumanoidDevice(LocomotionEnv):
    """Humanoid-v5 (free root + 17 hinges, RK4 at 3 ms), 348 observation
    entries.

    gym's observation-side derived quantities (cinert, cvel, cfrc_ext) come
    from mjData after the final forward evaluation, one integration behind
    qpos and qvel; the reward's mass-center displacement is measured at the
    integrated states, so its interval is exactly dt."""

    name = "humanoid"
    observation_size = 348
    reset_noise_scale = 0.01

    def _obs(self, q, qd, cinert, cvel, qfrc_act, cfrc):
        return torch.cat([
            q[:, 2:], qd, cinert[:, 1:].flatten(1), cvel[:, 1:].flatten(1),
            qfrc_act[:, 6:], cfrc[:, 1:].flatten(1),
        ], dim=-1)

    def _reset(self, noise):
        q, qd, warm = self._sample_state(noise)
        cinert, cvel, _ = com_quantities(self.model, q, qd)
        zeros6 = q.new_zeros((q.shape[0], self.model.nbody, 6))
        obs = self._obs(q, qd, cinert, cvel, torch.zeros_like(qd), zeros6)
        return (q, qd, warm), obs

    def _step(self, internal, action):
        q0, qd0, warm = internal
        q, qd, _, warm, (q_ev, qd_ev) = physics_step(
            self.model, q0, qd0, action, iters=self.solver_iters, f0=warm)
        with span("env.observe"):
            _, _, com_before = com_quantities(self.model, q0, qd0)
            cinert, cvel, _ = com_quantities(self.model, q_ev, qd_ev)
            _, _, com_after = com_quantities(self.model, q, qd)
            cfrc = cfrc_ext(self.model, q_ev, warm)
            obs = self._obs(q, qd, cinert, cvel,
                            actuation(self.model, action), cfrc)
            x_vel = (com_after[:, 0] - com_before[:, 0]) / self.dt
            healthy = (q[:, 2] > 1.0) & (q[:, 2] < 2.0)
            contact_cost = torch.clamp_max(
                5e-7 * torch.sum(cfrc ** 2, dim=(1, 2)), 10.0)
            reward = (1.25 * x_vel + 5.0 * healthy.to(torch.float32)
                      - 0.1 * torch.sum(action ** 2, dim=-1) - contact_cost)
            terminal = torch.logical_not(healthy)
        return (q, qd, warm), obs, reward, terminal


class AntTruncObsDevice(AntDevice):
    """MBPO's truncated-observation ant: obs = [qpos[2:], qvel] (27);
    reward and termination as ant."""

    name = "ant_trunc_obs"
    model_name = "ant"
    observation_size = 27

    def _obs(self, q, qd, cfrc):
        return torch.cat([q[:, 2:], qd], dim=-1)


class HumanoidTruncObsDevice(HumanoidDevice):
    """MBPO's truncated-observation humanoid: obs = [qpos[2:], qvel]
    (45); reward and termination as humanoid."""

    name = "humanoid_trunc_obs"
    model_name = "humanoid"
    observation_size = 45

    def _obs(self, q, qd, cinert, cvel, qfrc_act, cfrc):
        return torch.cat([q[:, 2:], qd], dim=-1)


def register_all(register) -> None:
    register("hopper", HopperDevice)
    register("walker", WalkerDevice)
    register("halfcheetah", HalfCheetahDevice)
    register("ant", AntDevice)
    register("ant_trunc_obs", AntTruncObsDevice)
    register("humanoid", HumanoidDevice)
    register("humanoid_trunc_obs", HumanoidTruncObsDevice)
    register("swimmer", SwimmerDevice)
    register("invertedpendulum", InvertedPendulumDevice)
    register("inverteddoublependulum", InvertedDoublePendulumDevice)
