"""Hindsight experience replay: an episodic ring with relabeling
(counterpart: ilswiss_tpu/data/her.py; `HindsightReplayState`,
`HindsightReplayBuffer`).

The ring holds `[S, T, ...]` episode slots, partitioned per env: each env
ring-buffers its own K = S / B slots, so the lockstep writes never
collide.  `ep_len` is 0 for a slot whose episode is still running or was
recycled.  `add` runs after the vec env has already reset the finished
envs: an env whose episode ended finalizes its slot's length and claims
slot env * K + completed % K, which it invalidates.

Sampling (relabel_replay_buffer.py:66-145 of the reference), from the
draws of one `Noise.hindsight` call (an env index and three uniforms a
row): an env, one of its min(completed, K - 1) newest completed episodes,
a step uniform in it, and for `future` a step uniform in [t, length)
(`final`: the last step).  Each index is the float32 product of a uniform
and a count, truncated to int32, as the JAX package computes it.  The
first int(her_ratio * batch) rows take the relabeled goal, the reward is
recomputed for the whole batch through `env.compute_reward`, and
terminals stay as recorded; `return_horizon` adds GCSL's steps to the
relabeled goal.  A discrete env's actions are int32 indices [S, T].

Unlike the JAX functions, `add` writes into the state's tensors IN PLACE
and returns the same state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ilswiss_tpu_torch.envs.vector import Transition

RELABEL_TYPES = ("future", "final", None)


@dataclass
class HindsightReplayState:
    data: Dict[str, torch.Tensor]  # [S, T, ...]
    ep_len: torch.Tensor           # [S] int32, 0 = running or invalid
    cur_slot: torch.Tensor         # [B] int32 active slot per env
    cur_t: torch.Tensor            # [B] int32 step within the episode
    completed: torch.Tensor        # [B] int32 completed episodes per env


class HindsightReplayBuffer:
    def __init__(self, env, num_envs: int, num_episode_slots: int,
                 max_episode_steps: int, relabel_type: str | None = "future",
                 her_ratio: float = 0.8, device=None):
        """`env` gives the sizes, `discrete` and `compute_reward`; the ring
        lives on `device` (default the env's: a host goal env has none)."""
        if relabel_type not in RELABEL_TYPES:
            raise ValueError(f"relabel_type {relabel_type!r}: one of "
                             f"{RELABEL_TYPES}")
        if num_episode_slots % num_envs:
            raise ValueError(f"{num_episode_slots} episode slots do not "
                             f"divide among {num_envs} envs")
        self.env = env
        self.device = torch.device(env.device if device is None else device)
        self.num_envs = num_envs
        self.S = num_episode_slots
        self.T = max_episode_steps
        self.K = num_episode_slots // num_envs
        if self.K < 2:
            raise ValueError("need >= 2 episode slots per env")
        self.relabel_type = relabel_type
        self.her_ratio = her_ratio

    # ------------------------------------------------------------------
    def init(self) -> HindsightReplayState:
        S, T, env = self.S, self.T, self.env
        kw = dict(dtype=torch.float32, device=self.device)
        action = (torch.zeros((S, T), dtype=torch.int32, device=self.device)
                  if env.discrete else
                  torch.zeros((S, T, env.action_size), **kw))
        obs, goal = env.observation_size, env.goal_size
        data = {
            "observation": torch.zeros((S, T, obs), **kw),
            "achieved_goal": torch.zeros((S, T, goal), **kw),
            "desired_goal": torch.zeros((S, T, goal), **kw),
            "action": action,
            "reward": torch.zeros((S, T), **kw),
            "terminal": torch.zeros((S, T), **kw),
            "next_observation": torch.zeros((S, T, obs), **kw),
            "next_achieved_goal": torch.zeros((S, T, goal), **kw),
        }
        int32 = dict(dtype=torch.int32, device=self.device)
        B, K = self.num_envs, self.K
        return HindsightReplayState(
            data=data,
            ep_len=torch.zeros((S,), **int32),
            cur_slot=torch.arange(B, **int32) * K,
            cur_t=torch.zeros((B,), **int32),
            completed=torch.zeros((B,), **int32),
        )

    # ------------------------------------------------------------------
    def add(self, state: HindsightReplayState, tr: Transition
            ) -> HindsightReplayState:
        """Store one vectorized batch of dict-obs transitions, in place."""
        B, K = self.num_envs, self.K
        slots, ts = state.cur_slot, state.cur_t
        rows = {
            "observation": tr.obs["observation"],
            "achieved_goal": tr.obs["achieved_goal"],
            "desired_goal": tr.obs["desired_goal"],
            "action": tr.action,
            "reward": tr.reward,
            "terminal": tr.terminal,
            "next_observation": tr.next_obs["observation"],
            "next_achieved_goal": tr.next_obs["achieved_goal"],
        }
        where = (slots.to(torch.int64), ts.to(torch.int64))
        for k, v in rows.items():
            state.data[k][where] = v.to(state.data[k].dtype)

        done = tr.done
        # truncate silently at T (the caller sizes T = max_episode_steps)
        new_t = torch.clamp_max(torch.where(done, 0, ts + 1), self.T - 1)
        completed = state.completed + done.to(torch.int32)
        # the finished slots' episode lengths
        state.ep_len[where[0]] = torch.where(done, ts + 1,
                                             state.ep_len[where[0]])
        # claim the next slot of the env's partition, and invalidate it
        next_slot = (torch.arange(B, dtype=torch.int32, device=done.device)
                     * K + completed % K)
        new_slot = torch.where(done, next_slot, slots)
        claimed = torch.zeros((self.S,), dtype=torch.bool,
                              device=done.device)
        claimed[new_slot.to(torch.int64)] = done
        state.ep_len.masked_fill_(claimed, 0)
        state.cur_slot, state.cur_t = new_slot.to(torch.int32), new_t.to(
            torch.int32)
        state.completed = completed
        return state

    # ------------------------------------------------------------------
    def sample(self, state: HindsightReplayState, draws, batch_size: int,
               return_horizon: bool = False) -> Dict[str, torch.Tensor]:
        """A relabeled batch from `draws` = (env index [batch] in [0, B),
        then uniforms [batch] for the episode, the step and the future
        step: `Noise.hindsight`).  `return_horizon` adds "horizon", the
        steps from the row to its relabeled goal (GCSL)."""
        K = self.K
        env_draw, u_ep, u_t, u_fut = draws
        env_idx = env_draw.to(torch.int64)
        n_comp = torch.clamp(torch.clamp_max(state.completed[env_idx], K - 1),
                             min=1)      # the caller warms up first
        # the n_comp newest completed episodes of the env: local slots
        # (cur_local - 1 - j) mod K
        j = (u_ep * n_comp.to(torch.float32)).to(torch.int32)
        cur_local = state.cur_slot[env_idx] - env_idx * K
        slot = (env_idx * K + (cur_local - 1 - j) % K).to(torch.int64)

        length = torch.clamp(state.ep_len[slot], min=1)
        t = (u_t * length.to(torch.float32)).to(torch.int32)
        if self.relabel_type == "final":
            t_her = length - 1
        else:   # future: uniform in [t, length)
            span = (length - t).to(torch.float32)
            t_her = torch.minimum(t + (u_fut * span).to(torch.int32),
                                  length - 1)
        t64 = t.to(torch.int64)
        batch = {k: v[slot, t64] for k, v in state.data.items()}

        if self.relabel_type is not None and self.her_ratio > 0:
            relabel_num = int(self.her_ratio * batch_size)
            new_goal = state.data["next_achieved_goal"][
                slot, t_her.to(torch.int64)]
            mask = (torch.arange(batch_size, device=slot.device)
                    < relabel_num)[:, None]
            desired = torch.where(mask, new_goal, batch["desired_goal"])
            batch["desired_goal"] = desired
            # the reward recomputed for the whole batch (:137-142)
            batch["reward"] = self.env.compute_reward(
                batch["next_achieved_goal"], desired)
        if return_horizon:
            batch["horizon"] = (t_her - t).to(torch.int32)
        return batch
