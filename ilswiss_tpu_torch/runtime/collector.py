"""Demo collection: a scripted or trained policy rolled over the vec env
into a demo buffer (counterpart: ilswiss_tpu/runtime/collector.py;
`collect_transitions`).

The JAX package scans the rollout in one jitted program; here it is a
Python loop of eager steps whose transitions stay on the device until the
rollout ends.  The draws come from one `noise` object (runtime/loop.py's
`Noise`): the initial reset, then per step the policy's own draws
(`act_fn`'s) and the step's reset draws.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ilswiss_tpu_torch.data.demo import demos_to_replay_state
from ilswiss_tpu_torch.data.replay import ReplayState
from ilswiss_tpu_torch.envs.vector import VectorEnv


@torch.no_grad()
def collect_transitions(vec_env: VectorEnv, act_fn: Callable,
                        num_steps_per_env: int, noise) -> ReplayState:
    """`act_fn(obs, noise) -> normalized action` takes its draws from
    `noise`.  Returns a full demo ReplayState of num_steps_per_env *
    num_envs transitions, the rows of one step side by side (stride
    num_envs), with per-episode ids env * (max local episode + 2) + the
    env's episode count (JAX collector.py:46-52)."""
    env, B = vec_env.env, vec_env.num_envs
    env_state = vec_env.reset(noise.reset(env, B))
    trs = []
    for _ in range(num_steps_per_env):
        action = act_fn(env_state.obs, noise)
        env_state, tr = vec_env.step(env_state, action, noise.reset(env, B))
        trs.append(tr)

    def stacked(field):
        return torch.stack([getattr(t, field) for t in trs]).cpu().numpy()

    done = stacked("done")
    T = done.shape[0]
    local_ep = np.concatenate(
        [np.zeros((1, B), np.int32), np.cumsum(done[:-1], axis=0)], axis=0
    ).astype(np.int32)
    ep_id = (np.arange(B, dtype=np.int32)[None, :] * (local_ep.max() + 2)
             + local_ep)

    def flat(x):
        return x.reshape((T * B,) + x.shape[2:])

    return demos_to_replay_state(
        flat(stacked("obs")), flat(stacked("action")),
        flat(stacked("reward")), flat(stacked("next_obs")),
        flat(stacked("terminal")), ep_id.reshape(T * B),
        stride=B, device=env.device,
    )
