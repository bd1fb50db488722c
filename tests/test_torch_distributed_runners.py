"""The port's distributed runners and its restore across topologies
(ilswiss_tpu_torch/parallel/distributed.py) against the JAX package's
(ilswiss_tpu/parallel/distributed.py) on the 8 virtual CPU devices.

One spawn of 4 gloo ranks on the CPU for the module, joined with a
deadline of its own (tests/torch_distributed_ranks.py::runners):

  * one `DistributedOffPolicyRunner` epoch (SAC on pendulum, 2 envs and a
    64-row ring a rank, 16-wide nets, one iteration of K = 2 steps a rank)
    from the JAX runner's state after its warmup on 4 devices, converted
    rank by rank (`convert.rank_runner_from_jax`), with every draw of each
    JAX shard replayed in the port's order; rtol 2e-4, atol 2e-5 (the loop
    twins' pins of tests/test_torch_offpolicy_trainers.py);
  * a fresh runner saved and restored on the same topology: bit for bit;
  * `restore_across_topology` 8 -> 4 and 2 -> 3 (a group of 3 of the 4
    ranks) against JAX's on the same saved state (the JAX snapshot, and
    the port's written from its converted ranks): rows, episode ids, ring
    cursors and sizes, episode counters, env steps, the env batch and the
    learner state exactly (the generators are fresh by design and not
    compared); the capacity-mismatch and the int32-overflow errors for the
    same inputs on both sides;
  * `DistributedOnPolicyRunner` (PPO on pendulum, obs_norm): every rank
    given the one-rank runner's envs and draws ends where the one-rank
    loop ends, at the pins of JAX's
    `test_distributed_ppo_matches_single_shard_on_identical_data` (rtol
    1e-5, atol 1e-6); on distinct data the replicas stay equal and leave
    the one-rank run.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilswiss_tpu.algorithms.sac import SAC as JSAC
from ilswiss_tpu.algorithms.sac import SACConfig as JSACConfig
from ilswiss_tpu.envs import make_vec as jmake_vec
from ilswiss_tpu.parallel.distributed import (
    DistributedOffPolicyRunner as JRunner,
)
from ilswiss_tpu.parallel.distributed import (
    restore_across_topology as jrestore,
)
from ilswiss_tpu.parallel.mesh import make_mesh
from ilswiss_tpu.runtime.checkpoint import save_checkpoint as jsave
from ilswiss_tpu.runtime.loop import OffPolicyConfig as JConfig
from ilswiss_tpu.runtime.loop import OffPolicyLoop as JLoop
from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.envs import make_vec
from ilswiss_tpu_torch.parallel import distributed as dd
from ilswiss_tpu_torch.parallel import mesh as pmesh
from ilswiss_tpu_torch.runtime.checkpoint import save_checkpoint
from ilswiss_tpu_torch.runtime.loop import (
    Noise, OffPolicyConfig, OffPolicyLoop,
)
from ilswiss_tpu_torch.testing import tree_diff
from ilswiss_tpu_torch.utils import convert

import torch_distributed_ranks as ranks

torch.set_num_threads(1)

PIN = dict(rtol=2e-4, atol=2e-5)
WORLD, JOIN_S = 4, 120.0
ENVS, CAP, K, BATCH, WARMUP = 2, 64, 2, 8, 8
# the migrations: (old ranks, envs, capacity, warmup steps) ->
# (new ranks, envs, capacity); the old rings wrap
TO4 = ((8, 2, 32, 40), (4, 4, 64))
TO3 = ((2, 6, 48, 60), (3, 4, 32))


def _jax_factory(n, envs, capacity, warmup=WARMUP):
    vec = jmake_vec("pendulum", num_envs=envs)
    sac = JSAC(3, 1, JSACConfig(reward_scale=2.0), net_size=16,
               num_hidden_layers=1, axis_name="env")
    loop = JLoop(vec, sac, JConfig(batch_size=BATCH,
                                   replay_capacity=capacity,
                                   min_steps_before_training=warmup,
                                   grad_steps_per_iter=K))
    factory = JRunner(loop, make_mesh(n))
    # jitted: the eager init dispatches op by op (JAX's restore calls it
    # too, for its template)
    factory.init = jax.jit(factory.init)
    return factory


def _port_loop(envs, capacity):
    sac = SAC(3, 1, SACConfig(reward_scale=2.0), net_size=16,
              num_hidden_layers=1, device="cpu")
    return OffPolicyLoop(make_vec("pendulum", envs, device="cpu"), sac,
                         OffPolicyConfig(batch_size=BATCH,
                                         replay_capacity=capacity,
                                         min_steps_before_training=WARMUP,
                                         grad_steps_per_iter=K))


def _shard_draws(snapshot, r):
    """Every draw of shard r's JAX training iteration (loop.py:98-187),
    from its keys, in the port's order: the acting noise, the envs'
    reset draws (vector.py, base.py, then pendulum's `_reset`), then per
    gradient step the batch's uniforms and SAC's two Gaussians."""
    rng, k_act = jax.random.split(snapshot.rng[r])
    seq = [("act", jax.random.normal(k_act, (ENVS, 1)))]
    thetas, dots = [], []
    for key in snapshot.env_state.rng[r * ENVS:(r + 1) * ENVS]:
        _, carry = jax.random.split(key)
        k_reset, _ = jax.random.split(jax.random.split(carry)[1])
        k1, k2 = jax.random.split(k_reset)
        thetas.append(jax.random.uniform(k1, (), minval=-jnp.pi,
                                         maxval=jnp.pi))
        dots.append(jax.random.uniform(k2, (), minval=-1.0, maxval=1.0))
    seq.append(("reset", (np.stack(thetas), np.stack(dots))))
    _, k_steps = jax.random.split(rng)
    for key in jax.random.split(k_steps, K):
        k_samp, k_train = jax.random.split(key)
        seq.append(("replay", jax.random.uniform(k_samp, (BATCH,))))
        k_next, k_new = jax.random.split(k_train)
        seq += [(name, jax.random.normal(k, (BATCH, 1)))
                for name, k in (("eps_next", k_next), ("eps_new", k_new))]
    return [(k, v if isinstance(v, tuple) else np.asarray(v))
            for k, v in seq]


def _migration(tmp, name, old, new):
    """The old runner warmed up and saved by both packages; JAX's restore
    onto the new topology, as numpy."""
    (n_old, envs_old, cap_old, warmup), (n_new, envs_new, cap_new) = old, new
    factory = _jax_factory(n_old, envs_old, cap_old, warmup)
    warm, _ = factory.build(n_old * envs_old)
    jrunner = warm(factory.init(jax.random.PRNGKey(0)))
    jpath = os.path.join(tmp, f"jax_{name}")
    jsave(jpath, jrunner)
    snapshot = jax.tree.map(np.asarray, jrunner)
    loop = _port_loop(envs_old, cap_old)
    path = os.path.join(tmp, name)
    for r in range(n_old):
        save_checkpoint(dd.rank_dir(path, r), convert.rank_runner_from_jax(
            loop, snapshot, r, n_old, Noise(r, "cpu")))
    dd.write_topology(path, n_old)
    want = jax.tree.map(np.asarray, jrestore(
        jpath, _jax_factory(n_new, envs_new, cap_new, warmup)))
    return jpath, path, snapshot, want


def _overflow_snapshot(tmp):
    """A state of 2 old ranks x 2048 envs whose old rank 1 holds an
    episode: remapped, its id passes int32, on both sides."""
    n, envs = 2, 2048
    rows = n * envs
    ep_id = np.full((rows,), -1, np.int32)
    ep_id[:4] = 0
    ep_id[envs:envs + 4] = 0
    ring = {"data": {"obs": np.zeros((rows, 3), np.float32),
                     "action": np.zeros((rows, 1), np.float32),
                     "reward": np.zeros((rows,), np.float32),
                     "next_obs": np.zeros((rows, 3), np.float32),
                     "terminal": np.zeros((rows,), np.float32)},
            "ep_id": ep_id, "ptr": np.array([4, 4], np.int32),
            "size": np.array([4, 4], np.int32),
            "env_ep": np.zeros((rows,), np.int32)}
    jpath = os.path.join(tmp, "jax_overflow")
    jsave(jpath, {"rng": np.zeros((n, 2), np.uint32), "replay": ring,
                  "total_env_steps": np.array([4, 4], np.int32)})
    path = os.path.join(tmp, "overflow")
    for r in range(n):
        part = slice(r * envs, (r + 1) * envs)
        save_checkpoint(dd.rank_dir(path, r), {
            "noise": Noise(r, "cpu"), "env_state": None, "algo_state": None,
            "replay": {"data": {k: torch.as_tensor(v[part])
                                for k, v in ring["data"].items()},
                       "ep_id": torch.as_tensor(ep_id[part]),
                       "ptr": 4, "size": 4,
                       "env_ep": torch.as_tensor(ring["env_ep"][part])},
            "total_env_steps": 4})
    dd.write_topology(path, n)
    return jpath, path


def _jax_error(path, factory):
    with pytest.raises(ValueError) as info:
        jrestore(path, factory)
    return str(info.value)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_runners"))
    inputs, refs = {}, {}

    # the epoch: JAX's runner on 4 devices after its warmup
    factory = _jax_factory(WORLD, ENVS, CAP)
    warm, epoch = factory.build(WORLD * ENVS)
    jrunner = warm(factory.init(jax.random.PRNGKey(0)))
    snapshot = jax.tree.map(np.asarray, jrunner)
    jnext, jm = epoch(jrunner)
    loop = _port_loop(ENVS, CAP)
    inputs["epoch"] = dict(envs=ENVS, capacity=CAP, steps=WORLD * ENVS,
                           runners=[convert.rank_runner_from_jax(
                               loop, snapshot, r, WORLD,
                               ranks.Draws(_shard_draws(snapshot, r)))
                               for r in range(WORLD)])
    refs["epoch"] = (jax.tree.map(np.asarray, jnext),
                     {k: float(v) for k, v in jm.items()})

    # the migrations and their errors
    jpaths = {}
    for name, (old, new) in (("to4", TO4), ("to3", TO3)):
        jpaths[name], path, snapshot, want = _migration(tmp, name, old, new)
        inputs[name] = dict(path=path, envs=new[1], capacity=new[2])
        refs[name] = (snapshot, want)
    refs["capacity"] = _jax_error(jpaths["to4"], _jax_factory(4, 4, 32))
    inputs["capacity"] = dict(path=inputs["to4"]["path"], envs=4,
                              capacity=32)
    jpath, path = _overflow_snapshot(tmp)
    refs["overflow"] = _jax_error(jpath, _jax_factory(4, 1024, 1024))
    inputs["overflow"] = dict(path=path, envs=1024, capacity=1024)
    inputs["ppo"] = dict(envs=4)

    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    pmesh.spawn_ranks(ranks.runners, WORLD, (tmp,), timeout=JOIN_S)
    outs = [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return refs, outs


def _close(got, want, pin, path=""):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], pin, f"{path}/{k}")
    elif isinstance(want, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, pin, f"{path}[{i}]")
    elif isinstance(want, int):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **pin)


def _shard(want, r, n, envs, capacity):
    """Shard r of a JAX distributed runner state (numpy), in the layout of
    `ranks._runner_numpy` without the learner."""
    e = slice(r * envs, (r + 1) * envs)
    c = slice(r * capacity, (r + 1) * capacity)
    rep = want.replay
    return dict(
        env_state={"internal": (want.env_state.internal[e],),
                   "obs": want.env_state.obs[e], "t": want.env_state.t[e]},
        replay={"data": {k: v[c] for k, v in rep.data.items()},
                "ep_id": rep.ep_id[c], "ptr": int(rep.ptr[r]),
                "size": int(rep.size[r]), "env_ep": rep.env_ep[e]},
        total_env_steps=int(want.total_env_steps[r]))


def test_offpolicy_epoch_matches_jax_shard_map(runs):
    """Each rank's env slice, ring and env steps against its JAX shard,
    the replicated learner against the JAX one on every rank, and the
    epoch's metrics averaged across ranks as the JAX runner's pmean."""
    refs, outs = runs
    jnext, jm = refs["epoch"]
    want_algo = convert.sac_state_to_numpy(convert.sac_state_from_jax(
        _port_loop(ENVS, CAP).algo, jnext.algo_state))
    for r, out in enumerate(outs):
        got = out["epoch"]["runner"]
        _close(got, _shard(jnext, r, WORLD, ENVS, CAP), PIN, f"rank {r}")
        _close(got["algo_state"], want_algo, PIN, f"rank {r} learner")
        np.testing.assert_array_equal(got["replay"]["ep_id"],
                                      jnext.replay.ep_id[r * CAP:
                                                         (r + 1) * CAP])
        assert set(out["epoch"]["metrics"]) == set(jm)
        _close(out["epoch"]["metrics"], jm, PIN, "metrics")
        assert out["epoch"]["metrics"] == outs[0]["epoch"]["metrics"]


def test_replicas_equal_and_same_topology_restore_is_exact(runs):
    """A fresh runner's warmup and epoch on 4 ranks: the envs differ
    across ranks, the learner is equal on all; `save_distributed` then
    `restore_distributed` gives back every rank's runner bit for bit, its
    generator's state among it."""
    _, outs = runs
    same = [out["same_topology"] for out in outs]
    assert len({s["obs"].tobytes() for s in same}) == WORLD
    for s in same:
        np.testing.assert_array_equal(s["params"], same[0]["params"])
        assert not tree_diff(s["got"], s["want"])


@pytest.mark.parametrize("name", ["to4", "to3"])
def test_restore_across_topology_matches_jax(runs, name):
    refs, outs = runs
    snapshot, want = refs[name]
    (n_old, *_), (n_new, envs, cap) = TO4 if name == "to4" else TO3
    assert int(snapshot.replay.size.min()) == snapshot.replay.data[
        "reward"].shape[0] // n_old      # every old ring full, and wrapped
    assert int(snapshot.replay.ptr.max()) > 0
    want_algo = convert.sac_state_to_numpy(convert.sac_state_from_jax(
        _port_loop(envs, cap).algo, want.algo_state))
    exact = dict(rtol=0, atol=0)
    for r in range(n_new):
        got = outs[r][name]
        _close(got, _shard(want, r, n_new, envs, cap), exact, f"rank {r}")
        _close(got["algo_state"], want_algo, exact, f"rank {r} learner")
    assert sum(outs[r][name]["total_env_steps"] for r in range(n_new)) \
        == int(snapshot.total_env_steps.sum())
    assert name == "to4" or name not in outs[3]


@pytest.mark.parametrize("name", ["capacity", "overflow"])
def test_restore_across_topology_raises_as_jax(runs, name):
    """The same ValueError for the same snapshot and target: its reason
    and every number in its message (JAX names shards and a mesh where
    the port names ranks and a group)."""
    refs, outs = runs
    head = refs[name].split(":")[0]
    assert head.startswith(("global replay capacity mismatch",
                            "migrated ep_ids exceed int32"))
    for out in outs:
        got = out["errors"][name]
        assert got.split(":")[0] == head
        assert re.findall(r"\d+", got) == re.findall(r"\d+", refs[name])


def test_onpolicy_runner_on_identical_data_matches_one_rank(runs):
    """PPO with obs_norm: every rank given the one-rank runner's envs and
    draws ends where the one-rank loop ends (the moments merged across
    ranks, the gradients averaged); on distinct data the replicas stay
    equal, leave the one-rank run, and the moments count every rank's
    rollout."""
    _, outs = runs
    for out in outs:
        p = out["ppo"]
        np.testing.assert_allclose(p["same"], p["plain"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(p["same_m"]["pg_loss"],
                                   p["plain_m"]["pg_loss"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(p["distinct"],
                                      outs[0]["ppo"]["distinct"])
        assert np.abs(p["distinct"] - p["plain"]).max() > 1e-3
        assert p["count"] == pytest.approx(1e-4 + WORLD * 16 * 4)
        assert p["steps"] == 16 * 4
