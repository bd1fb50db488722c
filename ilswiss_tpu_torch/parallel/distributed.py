"""Data parallelism over torch.distributed: the gradient all-reduce, the
off- and on-policy runners and the restore across topologies
(counterpart: ilswiss_tpu/parallel/distributed.py;
`DistributedOffPolicyRunner`, `restore_across_topology`,
`DistributedOnPolicyRunner`).

The JAX runners `shard_map` the sequential loop over the ``env`` mesh
axis and stack the per-shard state on a leading axis.  Here every rank
is a process (parallel/mesh.py) holding the sequential loop's own
runner state, so nothing is stacked:

  * a rank's env slice and its replay ring live on its own device, its
    noise is its own generator, and it counts its own env steps;
  * the algorithm's state is the same on every rank and stays so: each
    trainer given a group (`group=`) averages its gradients across it
    with `all_reduce_mean` where the JAX trainer calls `pmean`;
  * an epoch's metrics are averaged across ranks in one all-reduce.

`all_reduce_mean` flattens a list of tensors into one buffer, makes one
`all_reduce(SUM)` call, divides by the world size (`ReduceOp.AVG` is
nccl's only) and splits the buffer back: one collective per gradient
group, not one per tensor.  Without a group, or in a world of one, it
returns its tensors and issues no operation.  Its `calls` count the
collectives it issued.

Snapshots: `save_distributed` has every rank write its own runner with
`runtime/checkpoint.py` (`<path>/rank_<r>/`), then rank 0 writes
`<path>/topology.json` once all have: no ring travels through another
rank or over the wire, and the meta file marks a whole snapshot.
`restore_distributed` resumes one exactly on the same topology;
`restore_across_topology` migrates one onto another.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ilswiss_tpu_torch.data.replay import _EP_STRIDE, replay_init
from ilswiss_tpu_torch.parallel.mesh import RankGroup
from ilswiss_tpu_torch.runtime.checkpoint import (
    load_tree, restore_checkpoint, restore_into, save_checkpoint,
)
from ilswiss_tpu_torch.runtime.loop import Noise, RunnerState

TOPOLOGY_FILE = "topology.json"


def all_reduce_mean(tensors: Sequence[torch.Tensor],
                    group: RankGroup | None) -> tuple[torch.Tensor, ...]:
    """The mean of each tensor across the ranks of `group`, in one
    collective; the tensors themselves without a group or in a world of
    one."""
    tensors = tuple(tensors)
    if group is None or group.world_size == 1:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group.process_group)
    all_reduce_mean.calls += 1
    flat.div_(group.world_size)
    parts = torch.split(flat, [t.numel() for t in tensors])
    return tuple(p.view_as(t) for p, t in zip(parts, tensors))


all_reduce_mean.calls = 0


def _check_group(loop, group: RankGroup) -> None:
    """The algorithm (and an inner trainer) must average its gradients
    over `group`, and the loop must run on the rank's device."""
    algo = loop.algo
    for who in (algo, getattr(algo, "policy_trainer", None)):
        if who is not None and getattr(who, "group", None) is not group:
            raise ValueError(
                f"{type(who).__name__} must average its gradients over the "
                f"runner's group: pass group= when constructing it")
    if loop.device != group.device:
        raise ValueError(f"the loop runs on {loop.device}, the rank's "
                         f"device is {group.device}")


def _global_reset(loop, group: RankGroup, seed: int):
    """Rank's rows of one reset of world x B envs drawn from
    `Noise(seed + 1)`, and the rank's noise: rank 0 goes on drawing from
    that generator (a world of one is the sequential loop's `init`), the
    others from `Noise(seed + 1 + rank)`."""
    env, b = loop.vec_env.env, loop.vec_env.num_envs
    noise = Noise(seed + 1, loop.device)
    draws = noise.reset(env, group.world_size * b)
    rows = slice(group.rank * b, (group.rank + 1) * b)
    env_state = loop.vec_env.reset(tuple(d[rows] for d in draws))
    if group.rank:
        noise = Noise(seed + 1 + group.rank, loop.device)
    return env_state, noise


def _mean_metrics(metrics: Dict[str, torch.Tensor], group: RankGroup
                  ) -> Dict[str, float]:
    """Each metric averaged across the ranks, in one all-reduce."""
    keys = sorted(metrics)
    if not keys:
        return {}
    vec = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32)
                       .to(group.device) for k in keys])
    (vec,) = all_reduce_mean([vec], group)
    return dict(zip(keys, vec.tolist()))


class _RankRunner:
    """A loop (its vec env is this rank's slice) run as one rank of
    `group`; the loop's algorithm must carry the same group."""

    def __init__(self, loop, group: RankGroup):
        _check_group(loop, group)
        self.loop = loop
        self.group = group
        self.rank = group.rank
        self.world_size = group.world_size

    def build(self, steps_per_epoch: int):
        """(warmup, train_epoch): `steps_per_epoch` counts GLOBAL env
        steps, each rank takes its share; `train_epoch(runner)` returns
        (runner, the epoch's metrics averaged across ranks)."""
        loop = self.loop
        per_rank = steps_per_epoch // self.world_size

        def train_epoch(runner):
            runner, metrics = loop.epoch_metrics(runner, per_rank)
            return runner, _mean_metrics(metrics, self.group)

        return loop.warmup, train_epoch


class DistributedOffPolicyRunner(_RankRunner):
    """An `OffPolicyLoop` run as one rank of a group."""

    def init(self, seed: int) -> RunnerState:
        """This rank's runner: its rows of one global env reset, a ring of
        the loop's capacity, the algorithm's state from `seed` (the same on
        every rank, as every rank passes the same seed), no env steps."""
        loop = self.loop
        env = loop.vec_env.env
        env_state, noise = _global_reset(loop, self.group, seed)
        return RunnerState(
            noise=noise,
            env_state=env_state,
            replay=replay_init(loop.config.replay_capacity,
                               env.observation_size, env.action_size,
                               write_batch=loop.vec_env.num_envs,
                               device=loop.device, discrete=env.discrete),
            algo_state=loop.algo.init(seed),
            total_env_steps=0)


class DistributedOnPolicyRunner(_RankRunner):
    """An `OnPolicyLoop` (PPO) run as one rank of a group: each rank rolls
    out its own envs, PPO averages its gradients across the group, and the
    observation moments merge across it (utils/running_stats.py)."""

    def init(self, seed: int):
        """As the off-policy runner's, with fresh moments and no ring."""
        # imported here: runtime/onpolicy.py imports utils/running_stats.py,
        # which imports this module
        from ilswiss_tpu_torch.runtime.onpolicy import OnPolicyRunnerState
        from ilswiss_tpu_torch.utils.running_stats import (
            running_mean_std_init,
        )
        loop = self.loop
        env_state, noise = _global_reset(loop, self.group, seed)
        return OnPolicyRunnerState(
            noise=noise, env_state=env_state,
            algo_state=loop.algo.init(seed), total_env_steps=0,
            obs_rms=(running_mean_std_init(
                (loop.vec_env.env.observation_size,), loop.device)
                     if loop.config.normalize_obs else None))


# --- snapshots ---------------------------------------------------------------
def rank_dir(path: str, rank: int) -> str:
    """Where rank `rank` keeps its part of snapshot `path`."""
    return os.path.join(path, f"rank_{rank}")


def write_topology(path: str, world_size: int) -> None:
    """The meta file of a snapshot whose `world_size` rank parts are all
    written."""
    with open(os.path.join(path, TOPOLOGY_FILE), "w") as f:
        json.dump({"world_size": world_size}, f)


def read_topology(path: str) -> dict:
    with open(os.path.join(path, TOPOLOGY_FILE)) as f:
        return json.load(f)


def save_distributed(path: str, runner, group: RankGroup) -> None:
    """Every rank of `group` writes its runner; rank 0 then writes the
    meta file.  A collective: every rank must call it."""
    save_checkpoint(rank_dir(path, group.rank), runner)
    group.barrier()
    if group.rank == 0:
        write_topology(path, group.world_size)
    group.barrier()


def restore_distributed(path: str, template, group: RankGroup):
    """This rank's part of snapshot `path`, saved on the same topology,
    into `template` (in place; returned): the exact resume."""
    world = read_topology(path)["world_size"]
    if world != group.world_size:
        raise ValueError(f"the snapshot holds {world} ranks, the group has "
                         f"{group.world_size}: use restore_across_topology")
    return restore_checkpoint(rank_dir(path, group.rank), template)


def _numpy(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def restore_across_topology(path: str,
                            factory: DistributedOffPolicyRunner
                            ) -> RunnerState:
    """This rank's runner from a snapshot saved on ANOTHER number of ranks,
    by the JAX package's migration rules:

      * the replicated algorithm state and the global env batch move as
        they are (this rank takes its rows of the envs);
      * each old ring's valid rows are unrolled oldest first, joined in
        rank order into one stream and re-packed contiguously into the
        new rings (ptr and size recomputed): no row lost or repeated;
      * episode ids are made unique across old ranks (old rank r's ids
        offset by r x old envs x 2**20; int32 overflow raises ValueError)
        and the episode counters restart past the old maximum;
      * the env-step count's global sum is split evenly, the remainder on
        rank 0;
      * fresh generators, seeded per rank from a hash of the old rank 0's
        (generators do not merge across topologies).

    Requires the same global env count and global ring capacity (the
    loop's `replay_capacity` times the world size); raises ValueError
    otherwise.  A same-topology resume is `restore_distributed`."""
    n_old = read_topology(path)["world_size"]
    trees = [load_tree(rank_dir(path, i)) for i in range(n_old)]
    n_new, rank = factory.world_size, factory.rank
    loop = factory.loop
    cap_new = loop.config.replay_capacity
    g_rows = sum(int(t["replay"]["ep_id"].shape[0]) for t in trees)
    if g_rows != n_new * cap_new:
        raise ValueError(
            f"global replay capacity mismatch: checkpoint has {g_rows} "
            f"rows, target group wants {n_new} x {cap_new}")
    cap_old = g_rows // n_old
    b_old = int(trees[0]["replay"]["env_ep"].shape[0])
    b_new = loop.vec_env.num_envs
    if n_old * b_old != n_new * b_new:
        raise ValueError(
            f"global env count mismatch: checkpoint has {n_old} x {b_old} "
            f"envs, target group wants {n_new} x {b_new}")

    # ring-order (oldest-first) row indices of each old rank, into the
    # old rings joined in rank order
    order = []
    for i, t in enumerate(trees):
        s, p = int(t["replay"]["size"]), int(t["replay"]["ptr"])
        idx = (np.arange(s) if s < cap_old
               else np.concatenate([np.arange(p, cap_old), np.arange(p)]))
        order.append(i * cap_old + idx)
    order = np.concatenate(order)
    sizes = np.zeros((n_new,), np.int64)
    remaining = order.shape[0]
    for j in range(n_new):
        sizes[j] = min(cap_new, remaining)
        remaining -= sizes[j]
    start = int(sizes[:rank].sum())
    mine = order[start:start + int(sizes[rank])]

    def repack(arrays):
        joined = np.concatenate([_numpy(a) for a in arrays])
        out = np.zeros((cap_new,) + joined.shape[1:], joined.dtype)
        out[:mine.shape[0]] = joined[mine]
        return torch.from_numpy(out)

    data = {k: repack([t["replay"]["data"][k] for t in trees])
            for k in trees[0]["replay"]["data"]}
    raw_ep = np.concatenate([_numpy(t["replay"]["ep_id"]) for t in trees])
    remapped = raw_ep.astype(np.int64) + (
        np.arange(g_rows, dtype=np.int64) // cap_old) * (b_old * _EP_STRIDE)
    remapped[raw_ep < 0] = -1
    if remapped.max(initial=0) > np.iinfo(raw_ep.dtype).max:
        raise ValueError(
            f"migrated ep_ids exceed {raw_ep.dtype} "
            f"(max {remapped.max()}): too many global envs "
            f"({n_old} ranks x {b_old} envs) for the "
            f"{_EP_STRIDE:#x} stride — widen replay ep_id dtype")
    ep_id = np.full((cap_new,), -1, raw_ep.dtype)
    ep_id[:mine.shape[0]] = remapped[mine]
    env_ep = max(int(_numpy(t["replay"]["env_ep"]).max()) for t in trees)

    env_rows = slice(rank * b_new, (rank + 1) * b_new)
    env_tree = trees[0]["env_state"]

    def env_rows_of(get):
        return torch.cat([get(t["env_state"]) for t in trees])[env_rows]

    env_state = {
        "internal": [env_rows_of(lambda e, i=i: e["internal"][i])
                     for i in range(len(env_tree["internal"]))],
        "obs": env_rows_of(lambda e: e["obs"]),
        "t": env_rows_of(lambda e: e["t"])}

    total = sum(int(t["total_env_steps"]) for t in trees)
    steps = total // n_new + (total - n_new * (total // n_new)
                              if rank == 0 else 0)
    digest = hashlib.sha256(
        _numpy(trees[0]["noise"]["generator"]).tobytes()).digest()
    seed = int.from_bytes(digest[:8], "little") >> 2

    template = factory.init(0)
    restore_into(template.algo_state, trees[0]["algo_state"], "algo_state")
    restore_into(template.env_state, env_state, "env_state")
    restore_into(template.replay, {
        "data": data, "ep_id": torch.from_numpy(ep_id),
        "ptr": int(sizes[rank] % cap_new), "size": int(sizes[rank]),
        "env_ep": torch.full((b_new,), env_ep + 1, dtype=torch.int32)},
        "replay")
    template.noise = Noise(seed + rank, loop.device)
    template.total_env_steps = steps
    return template
