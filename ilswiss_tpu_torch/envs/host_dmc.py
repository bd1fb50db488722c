"""DeepMind Control suite pixel envs on the host (counterpart:
ilswiss_tpu/envs/host_dmc.py; `DMCVectorEnv`).

The reference reaches DMC through the `dmc2gym` shim (finger-spin and
reacher-easy at 84 x 84, frame stack 3).  Here B lockstep
`dm_control.suite` instances step on host threads and emit channel-stacked
uint8 frames, which the host loop (runtime/host_loop.py) copies into a
uint8 ring on the learner's device for SAC-AE, RAD and CURL
(algorithms/sac_ae.py).  The step contract is the host vector envs' own
(envs/host_mujoco.py): numpy in, numpy out, nothing of torch.

DMC episodes end only by their time limit, so every transition has
terminal False (a pure truncation: the critic bootstraps through episode
ends, which dmc2gym's `done` at the limit obscures).  dm_control is
imported where an env is built, never when this module is imported.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np


class DMCVectorEnv:
    """B lockstep dm_control envs with immediate autoreset.

    Observations are uint8 [H, W, 3 * frame_stack] frames (the newest in
    the last channels) rendered by `physics.render`; actions in [-1, 1]
    are rescaled to the action spec.  `render_quality="fast"` switches off
    shadows and multisampling (a software GL renderer spends most of a
    step on them); "full" renders the reference's pixels."""

    obs_dtype = np.uint8

    def __init__(self, num_envs: int, seed: int = 0,
                 domain_name: str = "finger", task_name: str = "spin",
                 height: int = 84, width: int = 84, camera_id: int = 0,
                 frame_skip: int = 1, frame_stack: int = 3,
                 from_pixels: bool = True,
                 visualize_reward: bool = False,  # the reference's; unused
                 max_episode_steps: int | None = None,
                 num_threads: int = 8,
                 render_quality: str = "fast"):
        from dm_control import suite

        self.envs = [
            suite.load(domain_name, task_name,
                       task_kwargs={"random": seed + 7919 * i})
            for i in range(num_envs)
        ]
        if render_quality == "fast":
            # shadowless, single-sample frames: the cosmetics change, the
            # task does not
            for env in self.envs:
                env.physics.model.vis.quality.shadowsize = 0
                env.physics.model.vis.quality.offsamples = 0
        self.num_envs = num_envs
        self.name = f"dmc-{domain_name}-{task_name}"
        self.height, self.width = height, width
        self.camera_id = camera_id
        self.frame_skip = max(1, frame_skip)
        self.frame_stack = max(1, frame_stack)
        self.from_pixels = from_pixels

        spec = self.envs[0].action_spec()
        self.action_size = int(np.prod(spec.shape))
        self.action_low = np.asarray(spec.minimum, np.float32)
        self.action_high = np.asarray(spec.maximum, np.float32)
        self.discrete = False

        if from_pixels:
            self.observation_size = (height, width, 3 * self.frame_stack)
        else:
            ts = self.envs[0].reset()
            self.observation_size = int(self._flat_state(ts).shape[0])
            self.obs_dtype = np.float32

        # dm_control enforces its own time limit through timestep.last();
        # max_episode_steps only adds an earlier cutoff
        step_limit = getattr(self.envs[0], "_step_limit", float("inf"))
        self.max_episode_steps = max_episode_steps or int(
            1e9 if not np.isfinite(step_limit)
            else max(1, round(step_limit / self.frame_skip)))

        self._rng = np.random.RandomState(seed)
        # one thread per env: an EGL context is current on one thread
        # only, so env i's reset, step and render all run on executor i (a
        # shared pool would move contexts between threads: EGL_BAD_ACCESS)
        self._execs = [ThreadPoolExecutor(max_workers=1)
                       for _ in range(num_envs)]
        self._frames = [None] * num_envs   # each env's stacked frames
        self._steps = np.zeros(num_envs, np.int64)
        self._obs = None

    # ------------------------------------------------------------------
    def _render(self, i: int) -> np.ndarray:
        return self.envs[i].physics.render(
            height=self.height, width=self.width, camera_id=self.camera_id)

    @staticmethod
    def _flat_state(ts) -> np.ndarray:
        return np.concatenate(
            [np.asarray(v, np.float32).ravel()
             for v in ts.observation.values()])

    def _obs_of(self, i: int, ts, fresh: bool) -> np.ndarray:
        if not self.from_pixels:
            return self._flat_state(ts)
        frame = self._render(i)
        if fresh or self._frames[i] is None:
            self._frames[i] = [frame] * self.frame_stack
        else:
            self._frames[i] = self._frames[i][1:] + [frame]
        return np.concatenate(self._frames[i], axis=-1)

    def _reset_one(self, i: int) -> np.ndarray:
        ts = self.envs[i].reset()
        self._steps[i] = 0
        return self._obs_of(i, ts, fresh=True)

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            # a task's generator is fixed when the env is built; reseed it
            # so that `seed` decides the initial states (the evaluation
            # resets with seed + 10_000)
            self._rng = np.random.RandomState(seed)
            for i, env in enumerate(self.envs):
                task = getattr(env, "task", None) or getattr(
                    env, "_task", None)
                if task is not None and hasattr(task, "random"):
                    task.random.seed(seed + i)
        futs = [self._execs[i].submit(self._reset_one, i)
                for i in range(self.num_envs)]
        obs = np.stack([f.result() for f in futs])
        self._obs = obs
        return obs.copy()

    def _scale(self, normalized: np.ndarray) -> np.ndarray:
        a = self.action_low + (normalized + 1.0) * 0.5 * (
            self.action_high - self.action_low)
        return np.clip(a, self.action_low, self.action_high)

    def _step_one(self, i: int, action: np.ndarray):
        env = self.envs[i]
        reward = 0.0
        ts = None
        for _ in range(self.frame_skip):
            ts = env.step(action)
            reward += float(ts.reward or 0.0)
            if ts.last():
                break
        self._steps[i] += 1
        done = bool(ts.last()) or self._steps[i] >= self.max_episode_steps
        true_next = self._obs_of(i, ts, fresh=False)
        obs = self._reset_one(i) if done else true_next
        # only the time limit ends a DMC episode: a truncation, never a
        # terminal
        return true_next, reward, False, done, obs

    def step(self, normalized_actions: np.ndarray) -> Tuple[np.ndarray, ...]:
        """(obs_prev, true_next_obs, reward, terminal, done,
        obs_after_reset), each [B, ...] numpy."""
        actions = self._scale(np.asarray(normalized_actions, np.float32))
        obs_prev = self._obs.copy()
        futs = [self._execs[i].submit(self._step_one, i, actions[i])
                for i in range(self.num_envs)]
        results = [f.result() for f in futs]
        true_next = np.stack([r[0] for r in results])
        reward = np.asarray([r[1] for r in results], np.float32)
        terminal = np.asarray([r[2] for r in results], bool)
        done = np.asarray([r[3] for r in results], bool)
        self._obs = np.stack([r[4] for r in results])
        return obs_prev, true_next, reward, terminal, done, self._obs.copy()

    def close(self) -> None:
        for i, env in enumerate(self.envs):
            self._execs[i].submit(env.close).result()
        for ex in self._execs:
            ex.shutdown()
