"""The rank bodies of tests/test_torch_distributed*.py.

Each runs in a process that `ilswiss_tpu_torch.parallel.mesh.spawn_ranks`
starts; it imports the port only (no JAX), joins a gloo group on the CPU
through a `FileStore` in the test's directory, reads the inputs the test
wrote there (`inputs.pt`: port states converted from the JAX ones,
batches and draws per rank), runs every case and writes what it got to
`out_<rank>.pt`.
"""

import os
import time

import numpy as np
import torch

from ilswiss_tpu_torch.parallel import distributed as dd
from ilswiss_tpu_torch.parallel import mesh
from ilswiss_tpu_torch.runtime.loop import Noise
from ilswiss_tpu_torch.utils import convert
from ilswiss_tpu_torch.utils.running_stats import running_mean_std_update


class Draws:
    """The `Noise` methods, each call answered with the next of the draws
    the test made from the JAX keys; a call out of that order fails."""

    def __init__(self, seq):
        self.seq = list(seq)

    def _pop(self, kind):
        assert self.seq, f"no draw left for {kind}"
        got, value = self.seq.pop(0)
        assert got == kind, f"drew {kind} where the JAX order has {got}"
        if isinstance(value, tuple):
            return tuple(torch.as_tensor(np.array(v)) for v in value)
        return torch.as_tensor(np.array(value))

    def reset(self, env, n):
        return self._pop("reset")

    def train(self, shape):
        return self._pop("eps_next"), self._pop("eps_new")

    def __getattr__(self, kind):
        if kind not in vars(Noise):
            raise AttributeError(kind)
        return lambda *args: self._pop(kind)


def _join(rank, world_size, tmp):
    torch.set_num_threads(1)
    store = torch.distributed.FileStore(os.path.join(tmp, "store"),
                                        world_size)
    group = mesh.init_group(rank, world_size, store=store, device="cpu",
                            timeout=90.0)
    return group, torch.load(os.path.join(tmp, "inputs.pt"),
                             weights_only=False)


def _leave(rank, tmp, out):
    torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    torch.distributed.destroy_process_group()


# --- the trainers, the moments ---------------------------------------------
def trainers(rank, world_size, tmp):
    """Per case: the trainer built with the group, then its steps on this
    rank's batches and draws; the state after the last step and every
    step's metrics.  The moments' case merges this rank's batch."""
    group, cases = _join(rank, world_size, tmp)
    out = {}
    for name, case in cases.items():
        if name == "moments":
            rms = running_mean_std_update(case["rms"], case["batches"][rank],
                                          group=group)
            out[name] = convert.running_mean_std_to_numpy(rms)
            continue
        cls, args, kwargs = case["ctor"]
        if "inner" in case:
            icls, iargs, ikw = case["inner"]
            args = (*args[:2], icls(*iargs, device="cpu", group=group,
                                    **ikw), *args[2:])
            algo = cls(*args, group=group, **kwargs)
        else:
            algo = cls(*args, device="cpu", group=group, **kwargs)
        state = case["state"]
        metrics = []
        before = dd.all_reduce_mean.calls
        for batch, draws in zip(case["batches"][rank], case["draws"][rank]):
            if case.get("disc_step"):
                state, m = algo._disc_update(state, batch, Draws(draws))
            else:
                state, m = algo.train_step(
                    state, batch, *[torch.as_tensor(np.array(d))
                                    for d in draws])
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = dict(state=case["to_numpy"](state), metrics=metrics,
                         calls=dd.all_reduce_mean.calls - before)
    _leave(rank, tmp, out)


# --- the runners, the snapshots --------------------------------------------
def _sac_loop(group, envs, capacity, warmup=8):
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.envs import make_vec
    from ilswiss_tpu_torch.runtime.loop import OffPolicyConfig, OffPolicyLoop
    sac = SAC(3, 1, SACConfig(reward_scale=2.0), net_size=16,
              num_hidden_layers=1, device="cpu", group=group)
    return OffPolicyLoop(make_vec("pendulum", envs, device="cpu"), sac,
                         OffPolicyConfig(batch_size=8,
                                         replay_capacity=capacity,
                                         min_steps_before_training=warmup,
                                         grad_steps_per_iter=2))


def _subgroup(group, members):
    """The group of ranks `members` of `group` (the default group), for
    its members; None for the others.  Every rank must call it."""
    pg = torch.distributed.new_group(members, backend=group.backend)
    if group.rank not in members:
        return None
    return mesh.RankGroup(rank=members.index(group.rank),
                          world_size=len(members), backend=group.backend,
                          device=group.device, process_group=pg)


def _runner_numpy(runner):
    return dict(env_state=convert.env_state_to_numpy(runner.env_state),
                replay=convert.replay_to_numpy(runner.replay),
                algo_state=convert.sac_state_to_numpy(runner.algo_state),
                total_env_steps=runner.total_env_steps)


def _flat_params(state):
    return torch.cat([p.detach().reshape(-1) for p in (
        *state.policy.parameters(), *state.qf.parameters())]).numpy()


def _ppo_loop(group, envs):
    from ilswiss_tpu_torch.algorithms.ppo import PPO, PPOConfig
    from ilswiss_tpu_torch.envs import make_vec
    from ilswiss_tpu_torch.runtime.onpolicy import (
        OnPolicyConfig, OnPolicyLoop,
    )
    ppo = PPO(3, 1, PPOConfig(update_epoch=2, mini_batch_size=32),
              net_size=32, num_hidden_layers=1, device="cpu", group=group)
    return OnPolicyLoop(make_vec("pendulum", envs, device="cpu"), ppo,
                        OnPolicyConfig(rollout_length=16,
                                       normalize_obs=True))


def _ppo_params(state):
    return torch.cat([p.detach().reshape(-1) for p in (
        *state.policy.parameters(), *state.vf.parameters())]).numpy()


def runners(rank, world_size, tmp):
    """The off-policy runner's epoch from this rank's converted JAX runner
    with its draws replayed; a same-topology save and restore; the
    migrations 8 -> 4 (this group) and 2 -> 3 (a group of ranks 0 to 2);
    the migration's errors; the on-policy runner on identical and on
    distinct data."""
    from ilswiss_tpu_torch.runtime.checkpoint import to_tree
    group, cases = _join(rank, world_size, tmp)
    out = {}

    # one epoch (one iteration per rank) from the JAX runner's state
    case = cases["epoch"]
    loop = _sac_loop(group, case["envs"], case["capacity"])
    factory = dd.DistributedOffPolicyRunner(loop, group)
    _, epoch = factory.build(case["steps"])
    runner, metrics = epoch(case["runners"][rank])
    assert not runner.noise.seq, "draws left over"
    out["epoch"] = dict(runner=_runner_numpy(runner), metrics=metrics)

    # a fresh runner's warmup and epoch, saved and restored in place
    runner = factory.init(0)
    warmup, epoch = factory.build(case["steps"])
    runner, _ = epoch(warmup(runner))
    path = os.path.join(tmp, "same")
    dd.save_distributed(path, runner, group)
    fresh = dd.restore_distributed(path, factory.init(5), group)
    want, got = to_tree(runner), to_tree(fresh)
    out["same_topology"] = dict(
        want=want, got=got, params=_flat_params(runner.algo_state),
        obs=runner.env_state.obs.numpy())

    # the migrations and their errors
    for name, members in (("to4", range(world_size)), ("to3", range(3))):
        case = cases[name]
        sub = group if len(members) == world_size else _subgroup(
            group, list(members))
        if sub is None:
            continue
        factory = dd.DistributedOffPolicyRunner(
            _sac_loop(sub, case["envs"], case["capacity"]), sub)
        out[name] = _runner_numpy(
            dd.restore_across_topology(case["path"], factory))
    errors = {}
    for name in ("capacity", "overflow"):
        case = cases[name]
        factory = dd.DistributedOffPolicyRunner(
            _sac_loop(group, case["envs"], case["capacity"]), group)
        try:
            dd.restore_across_topology(case["path"], factory)
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors

    # PPO: every rank from the one-rank runner's state, against that run;
    # then every rank from its own rows of a global reset
    case = cases["ppo"]
    plain_loop = _ppo_loop(None, case["envs"])
    plain, plain_m = plain_loop.train_epoch(plain_loop.init(3),
                                            case["envs"] * 16)
    loop = _ppo_loop(group, case["envs"])
    factory = dd.DistributedOnPolicyRunner(loop, group)
    _, epoch = factory.build(world_size * case["envs"] * 16)
    same, same_m = epoch(loop.init(3))
    distinct, distinct_m = epoch(factory.init(3))
    out["ppo"] = dict(
        plain=_ppo_params(plain.algo_state), plain_m=plain_m,
        same=_ppo_params(same.algo_state), same_m=same_m,
        distinct=_ppo_params(distinct.algo_state),
        count=float(distinct.obs_rms.count),
        steps=distinct.total_env_steps)
    _leave(rank, tmp, out)


def fail_or_sleep(rank, world_size):
    """Rank 1 raises at once; the others sleep far past any deadline."""
    if rank == 1:
        raise ValueError("rank 1 fails")
    time.sleep(600)
