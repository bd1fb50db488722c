"""Device-resident replay ring (counterpart: ilswiss_tpu/data/replay.py;
`round_capacity`, `replay_init`, `replay_add`, `replay_sample`).

Fixed `[capacity, ...]` tensors, a write cursor and per-row episode ids
`env_idx * 2**20 + env_ep`.  The capacity is rounded up to a multiple of
the write batch so one write never splits across the wrap.  Unlike the
JAX functions, `replay_add` writes into the ring's tensors IN PLACE and
returns the same state, which saves a copy of the ring per write; the
cursor and size are host integers, since every write has the same size.
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


def replay_init(capacity: int, obs_size: int, action_size: int,
                write_batch: int, device) -> ReplayState:
    capacity = round_capacity(capacity, write_batch)
    kw = dict(dtype=torch.float32, device=device)
    data = {
        "obs": torch.zeros((capacity, obs_size), **kw),
        "action": torch.zeros((capacity, action_size), **kw),
        "reward": torch.zeros((capacity,), **kw),
        "next_obs": torch.zeros((capacity, obs_size), **kw),
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
    place.  Requires capacity % B == 0 (`replay_init` guarantees it)."""
    capacity = state.data["reward"].shape[0]
    batch = tr.reward.shape[0]
    if capacity % batch or batch != state.env_ep.shape[0]:
        raise ValueError(f"write batch {batch} does not fit the ring "
                         f"(capacity {capacity}, "
                         f"write batch {state.env_ep.shape[0]})")
    rows = slice(state.ptr, state.ptr + batch)
    updates = {
        "obs": tr.obs,
        "action": tr.action,
        "reward": tr.reward,
        "next_obs": tr.next_obs,
        "terminal": tr.terminal.to(torch.float32),
    }
    for k, v in updates.items():
        state.data[k][rows] = v
    env_idx = torch.arange(batch, dtype=torch.int32, device=tr.reward.device)
    state.ep_id[rows] = env_idx * _EP_STRIDE + state.env_ep
    state.env_ep += tr.done.to(torch.int32)
    state.ptr = (state.ptr + batch) % capacity
    state.size = min(state.size + batch, capacity)
    return state


def replay_sample(state: ReplayState, u: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """Uniform gather over the valid rows: row min(int(u * size), size - 1)
    for each uniform in `u` [batch]."""
    idx = torch.clamp_max((u * float(state.size)).to(torch.int64),
                          state.size - 1)
    return {k: v[idx] for k, v in state.data.items()}
