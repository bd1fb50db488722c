"""Device-resident replay ring (counterpart: ilswiss_tpu/data/replay.py;
`round_capacity`, `replay_init`, `replay_add`, `replay_add_masked`,
`replay_sample`, `replay_sample_window`, `replay_sample_nstep`).

Fixed `[capacity, ...]` tensors, a write cursor and per-row episode ids
`env_idx * 2**20 + env_ep`.  The capacity is rounded up to a multiple of
the write batch so a write from a cursor at a multiple of it never splits
across the wrap (DAgger's ring, seeded with a demo count, may).  Unlike
the JAX functions, `replay_add` writes into the ring's tensors IN PLACE and
returns the same state, which saves a copy of the ring per write; the
cursor and size are host integers, since every write has the same size
(`replay_add_masked`'s reads its count from the device once).
A discrete env's ring keeps its actions as `[capacity]` int32 indices,
as the JAX ring does; they are cast to int64 only where they index.
Sampling takes its uniforms as a tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ilswiss_tpu_torch.envs.vector import Transition

_EP_STRIDE = 1 << 20  # episodes-per-env headroom for unique ids


@dataclass
class ReplayState:
    data: Dict[str, torch.Tensor]   # each [capacity, ...]
    ep_id: torch.Tensor             # [capacity] int32, -1 where unwritten
    ptr: int                        # next write position
    size: int                       # number of valid rows
    env_ep: torch.Tensor            # [write_batch] int32 episode counters


def round_capacity(capacity: int, write_batch: int) -> int:
    return ((capacity + write_batch - 1) // write_batch) * write_batch


def replay_init(capacity: int, obs_size, action_size: int,
                write_batch: int, device, discrete: bool = False,
                obs_dtype: torch.dtype = torch.float32) -> ReplayState:
    """The ring, its capacity rounded up to a multiple of `write_batch`;
    a `discrete` env's actions are int32 indices [capacity].  `obs_size`
    is an int (vector obs) or a shape tuple (image obs, [H, W, C]); obs
    and next_obs are kept at `obs_dtype` (JAX replay.py:47-67)."""
    capacity = round_capacity(capacity, write_batch)
    kw = dict(dtype=torch.float32, device=device)
    obs_shape = ((obs_size,) if isinstance(obs_size, int)
                 else tuple(obs_size))
    action = (torch.zeros((capacity,), dtype=torch.int32, device=device)
              if discrete else torch.zeros((capacity, action_size), **kw))
    data = {
        "obs": torch.zeros((capacity,) + obs_shape, dtype=obs_dtype,
                           device=device),
        "action": action,
        "reward": torch.zeros((capacity,), **kw),
        "next_obs": torch.zeros((capacity,) + obs_shape, dtype=obs_dtype,
                                device=device),
        "terminal": torch.zeros((capacity,), **kw),
    }
    return ReplayState(
        data=data,
        ep_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        ptr=0,
        size=0,
        env_ep=torch.zeros((write_batch,), dtype=torch.int32, device=device),
    )


def replay_add(state: ReplayState, tr: Transition) -> ReplayState:
    """Store one vectorized-env batch of B transitions at the cursor, in
    place.  Requires capacity % B == 0 (`replay_init` guarantees it).

    A cursor that is not a multiple of B (DAgger's ring, seeded with a
    demo count) splits the write at the wrap: the rows that do not fit
    before it go to the front.  The JAX `dynamic_update_slice` clamps its
    start instead, so there the write lands at capacity - B, over rows
    written just before (ROADMAP.md section 3); the port does not copy
    that.  A cursor at a multiple of B writes one slice, as before."""
    capacity = state.data["reward"].shape[0]
    batch = tr.reward.shape[0]
    if capacity % batch or batch != state.env_ep.shape[0]:
        raise ValueError(f"write batch {batch} does not fit the ring "
                         f"(capacity {capacity}, "
                         f"write batch {state.env_ep.shape[0]})")
    updates = {
        "obs": tr.obs,
        "action": tr.action,
        "reward": tr.reward,
        "next_obs": tr.next_obs,
        "terminal": tr.terminal.to(torch.float32),
    }
    env_idx = torch.arange(batch, dtype=torch.int32, device=tr.reward.device)
    updates["ep_id"] = env_idx * _EP_STRIDE + state.env_ep
    first = min(batch, capacity - state.ptr)
    for k, v in updates.items():
        dst = state.ep_id if k == "ep_id" else state.data[k]
        if first == batch:
            dst[state.ptr:state.ptr + batch] = v
        else:
            dst[state.ptr:] = v[:first]
            dst[:batch - first] = v[first:]
    state.env_ep += tr.done.to(torch.int32)
    state.ptr = (state.ptr + batch) % capacity
    state.size = min(state.size + batch, capacity)
    return state


def replay_add_masked(state: ReplayState, rows: Dict[str, torch.Tensor],
                      mask: torch.Tensor) -> ReplayState:
    """Append only the rows where `mask` [R] is True, in their order,
    contiguously at the cursor (wrapping modulo the capacity), in place:
    MBPO's model rollouts drop their ended branches.  `ptr` and `size`
    advance by the alive count, read from the device once; `ep_id` and
    `env_ep` stay as they are (model rows have no episodes).  Unlike
    `replay_add`, a write may have any count and may cross the wrap."""
    capacity = state.data["reward"].shape[0]
    if mask.shape[0] > capacity:
        raise ValueError(f"{mask.shape[0]} rows do not fit the ring "
                         f"(capacity {capacity})")
    alive = torch.nonzero(mask).squeeze(1)
    n = alive.shape[0]
    first = min(n, capacity - state.ptr)
    for k, v in rows.items():
        v = v[alive].to(state.data[k].dtype)
        state.data[k][state.ptr:state.ptr + first] = v[:first]
        state.data[k][:n - first] = v[first:]
    state.ptr = (state.ptr + n) % capacity
    state.size = min(state.size + n, capacity)
    return state


def replay_sample(state: ReplayState, u: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """Uniform gather over the valid rows: row min(int(u * size), size - 1)
    for each uniform in `u` [batch]."""
    idx = _rows(state, u)
    return {k: v[idx] for k, v in state.data.items()}


def _rows(state: ReplayState, u: torch.Tensor) -> torch.Tensor:
    return torch.clamp_max((u * float(state.size)).to(torch.int64),
                           state.size - 1)


def replay_sample_window(state: ReplayState, u: torch.Tensor, window: int
                         ) -> Dict[str, torch.Tensor]:
    """Same-env trajectory windows [Bw, window, ...] starting at the rows
    `u` [Bw] picks (as `replay_sample`), with `valid` [Bw, window]: the
    prefix of each window that stays inside the episode of its first step
    (the trajectory discriminator's batches).

    Consecutive steps of one env sit `stride` = len(env_ep) rows apart:
    the ring's write batch, or a demo buffer's own stride (data/demo.py).
    Offsets wrap modulo the capacity; a step is valid while every step
    up to it has the first step's episode id and lies below `size`."""
    capacity = state.data["reward"].shape[0]
    stride = state.env_ep.shape[0]
    idx = _rows(state, u)
    offs = (idx[:, None] + stride * torch.arange(
        window, dtype=torch.int64, device=idx.device)[None, :]) % capacity
    same_ep = state.ep_id[offs] == state.ep_id[idx][:, None]
    in_range = offs < state.size
    valid = torch.cumprod(torch.logical_and(same_ep, in_range).to(
        torch.int32), dim=1).to(torch.bool)
    out = {k: v[offs] for k, v in state.data.items()}
    out["valid"] = valid
    return out


def replay_sample_nstep(state: ReplayState, u: torch.Tensor, n_step: int,
                        discount: float) -> Dict[str, torch.Tensor]:
    """An n-step batch from the rows `u` picks (as `replay_sample`): for
    each, the discounted sum of up to `n_step` rewards of its env, the
    next_obs and terminal of the last step summed, and `n_step_used`.

    Consecutive steps of one env sit `write_batch` rows apart (the
    lockstep write).  A row's lookahead stops before a row of another
    episode id (an episode boundary, the write cursor, an unwritten row)
    and after a terminal, as the JAX function's scan does."""
    capacity = state.data["reward"].shape[0]
    stride = state.env_ep.shape[0]
    idx = _rows(state, u)
    base_ep = state.ep_id[idx]
    reward_acc = torch.zeros(idx.shape, dtype=torch.float32,
                             device=idx.device)
    valid = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    last_off = torch.zeros(idx.shape, dtype=torch.int32, device=idx.device)
    for k in range(n_step):
        off_idx = (idx + k * stride) % capacity
        valid_k = torch.logical_and(valid, state.ep_id[off_idx] == base_ep)
        reward_acc = reward_acc + torch.where(
            valid_k, (discount ** k) * state.data["reward"][off_idx], 0.0)
        last_off = torch.where(valid_k, k, last_off)
        # no extension past a terminal inside the window
        valid = torch.logical_and(
            valid_k, torch.logical_not(state.data["terminal"][off_idx] > 0.5))
    end_idx = (idx + last_off.to(torch.int64) * stride) % capacity
    return {
        "obs": state.data["obs"][idx],
        "action": state.data["action"][idx],
        "reward": reward_acc,
        "next_obs": state.data["next_obs"][end_idx],
        "terminal": state.data["terminal"][end_idx],
        "n_step_used": last_off + 1,
    }
