"""Expert demonstration buffers (counterpart: ilswiss_tpu/data/demo.py).

Demos are flat transition arrays in an `.npz`, loaded straight into a
FULL port `ReplayState` (size = capacity = N), so expert sampling is the
same uniform gather as replay sampling (`replay_sample`).  The numpy
work (statistics, subsetting, absorbing rows) is the JAX package's; the
buffer's tensors live on the device the caller names, the GPU by
default.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ilswiss_tpu_torch.data.replay import ReplayState
from ilswiss_tpu_torch.utils.device import resolve_device


def demos_to_replay_state(
    obs: np.ndarray, action: np.ndarray, reward: np.ndarray,
    next_obs: np.ndarray, terminal: np.ndarray,
    ep_id: np.ndarray | None = None,
    stride: int = 1, device=None,
) -> ReplayState:
    """A full expert ReplayState from flat transition arrays [N, ...]
    (JAX `demos_to_replay_state`, demo.py:23).

    `stride` is the row distance between consecutive steps of one
    trajectory (1 for trajectory-contiguous demos; B for the vectorized
    collector's interleaved rows).  As in the JAX package it is the length
    of `env_ep`, where trajectory-window sampling reads it back; the JAX
    buffer's `env_ep=None` for stride 1 is a zero vector of length 1."""
    device = resolve_device(device)
    n = obs.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    data = {
        "obs": torch.as_tensor(np.asarray(obs), **f32),
        "action": torch.as_tensor(np.asarray(action), **f32),
        "reward": torch.as_tensor(np.asarray(reward), **f32).reshape(n),
        "next_obs": torch.as_tensor(np.asarray(next_obs), **f32),
        "terminal": torch.as_tensor(np.asarray(terminal), **f32).reshape(n),
    }
    if ep_id is None:
        ep_id = np.zeros((n,), np.int32)
    return ReplayState(
        data=data,
        ep_id=torch.as_tensor(np.asarray(ep_id), dtype=torch.int32,
                              device=device),
        ptr=0,
        size=n,
        env_ep=torch.zeros((stride,), dtype=torch.int32, device=device),
    )


def _numpy(state: ReplayState) -> Dict[str, np.ndarray]:
    out = {k: v.cpu().numpy() for k, v in state.data.items()}
    out["ep_id"] = state.ep_id.cpu().numpy()
    return out


def save_demos_npz(path: str, state: ReplayState) -> None:
    """Persist a demo buffer; ep_ids are renumbered densely (0..E-1 in
    order of first appearance), as the JAX `save_demos_npz`."""
    arrays = _numpy(state)
    ep = arrays.pop("ep_id")
    _, first, inverse = np.unique(ep, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int32)
    rank[np.argsort(first)] = np.arange(len(first), dtype=np.int32)
    np.savez_compressed(path, ep_id=rank[inverse], **arrays)


def load_demos_npz(path: str, device=None) -> ReplayState:
    """JAX `load_demos_npz` (demo.py:86)."""
    z = np.load(path)
    return demos_to_replay_state(
        z["obs"], z["action"], z["reward"], z["next_obs"], z["terminal"],
        z["ep_id"] if "ep_id" in z else None, device=device,
    )


def _rebuild(state: ReplayState, obs, action, reward, next_obs, terminal,
             ep_id) -> ReplayState:
    return demos_to_replay_state(obs, action, reward, next_obs, terminal,
                                 ep_id, device=state.ep_id.device)


def wrap_absorbing_demos(state: ReplayState) -> ReplayState:
    """DAC absorbing indicators and transitions (JAX
    `wrap_absorbing_demos`, demo.py:94): obs gain a 0-flag dim; each
    terminal transition is redirected into the absorbing state and
    followed by one absorbing self-loop row with zero action and reward
    and terminal 1."""
    a = _numpy(state)
    obs, next_obs, action = a["obs"], a["next_obs"], a["action"]
    reward, terminal, ep_id = a["reward"], a["terminal"], a["ep_id"]
    n, d = obs.shape

    pad0 = lambda x: np.concatenate(  # noqa: E731
        [x, np.zeros((len(x), 1), x.dtype)], axis=-1)
    absorb = np.zeros((1, d + 1), np.float32)
    absorb[0, -1] = 1.0

    rows = {k: [] for k in ("obs", "action", "reward", "next_obs",
                            "terminal", "ep")}
    for i in range(n):
        rows["obs"].append(pad0(obs[i:i + 1]))
        rows["action"].append(action[i:i + 1])
        rows["reward"].append(reward[i:i + 1])
        rows["next_obs"].append(absorb if terminal[i] > 0.5
                                else pad0(next_obs[i:i + 1]))
        rows["terminal"].append(np.zeros(1))
        rows["ep"].append(ep_id[i:i + 1])
        if terminal[i] > 0.5:
            rows["obs"].append(absorb)
            rows["action"].append(np.zeros_like(action[i:i + 1]))
            rows["reward"].append(np.zeros(1))
            rows["next_obs"].append(absorb)
            rows["terminal"].append(np.ones(1))
            rows["ep"].append(ep_id[i:i + 1])
    cat = {k: np.concatenate(v) for k, v in rows.items()}
    return _rebuild(state, cat["obs"], cat["action"], cat["reward"],
                    cat["next_obs"], cat["terminal"], cat["ep"])


def demo_obs_stats(state: ReplayState) -> Dict[str, np.ndarray]:
    """Per-dim mean, std (population), min and max of the demo
    observations (JAX `demo_obs_stats`, demo.py:143), as numpy arrays."""
    obs = state.data["obs"].cpu().numpy()
    return {
        "obs_mean": obs.mean(axis=0),
        "obs_std": obs.std(axis=0),
        "obs_min": obs.min(axis=0),
        "obs_max": obs.max(axis=0),
    }


def _map_obs(state: ReplayState, fn) -> ReplayState:
    data = dict(state.data)
    data["obs"] = fn(state.data["obs"])
    data["next_obs"] = fn(state.data["next_obs"])
    return ReplayState(data=data, ep_id=state.ep_id, ptr=state.ptr,
                       size=state.size, env_ep=state.env_ep)


def scale_demos(state: ReplayState, mean: np.ndarray, std: np.ndarray,
                eps: float = 1e-8) -> ReplayState:
    """obs and next_obs -> (x - mean) / (std + eps) (JAX `scale_demos`,
    demo.py:156)."""
    dev = state.ep_id.device
    mean = torch.as_tensor(np.asarray(mean, np.float32), device=dev)
    std = torch.as_tensor(np.asarray(std, np.float32), device=dev)
    return _map_obs(state, lambda x: (x - mean) / (std + eps))


def minmax_demos(state: ReplayState, lo: np.ndarray, hi: np.ndarray,
                 eps: float = 1e-8) -> ReplayState:
    """obs and next_obs -> (x - lo) / (hi - lo + eps) (JAX
    `minmax_demos`, demo.py:166)."""
    dev = state.ep_id.device
    lo = torch.as_tensor(np.asarray(lo, np.float32), device=dev)
    hi = torch.as_tensor(np.asarray(hi, np.float32), device=dev)
    return _map_obs(state, lambda x: (x - lo) / (hi - lo + eps))


def subsample_trajs(state: ReplayState, num_trajs: int) -> ReplayState:
    """The first `num_trajs` episodes, by unique ep_id in order of first
    appearance, renumbered 0..num_trajs-1 (JAX `subsample_trajs`,
    demo.py:176: the reference's `traj_num`)."""
    a = _numpy(state)
    ep = a["ep_id"]
    _, first = np.unique(ep, return_index=True)
    keep = ep[np.sort(first)][:num_trajs]
    remap = {int(e): i for i, e in enumerate(keep)}
    idx = np.nonzero(np.isin(ep, keep))[0]
    new_ep = np.array([remap[int(e)] for e in ep[idx]], np.int32)
    return _rebuild(state, a["obs"][idx], a["action"][idx],
                    a["reward"][idx], a["next_obs"][idx],
                    a["terminal"][idx], new_ep)
