"""Data parallelism in the port (ilswiss_tpu_torch/parallel/,
the trainers' `group`, utils/running_stats.py) against the JAX package
under `shard_map` over 4 of the 8 virtual CPU devices
(ilswiss_tpu/parallel/, the trainers' `axis_name`).

The same per-rank batches and draws, made from a numpy seed and the JAX
keys, go through each JAX trainer's step under `shard_map` with its
`axis_name` (its gradients `pmean`ed across the shards) and through the
port's trainer on 4 ranks: processes over gloo on the CPU, one spawn for
the module (`spawn_ranks`, joined with a deadline of its own so a hang
fails here), each rank running every case (tests/torch_distributed_ranks.py).
SAC, TD3, DDPG, SAC-V, discrete SAC, DQN, PPO, BC and AdvIRL's
discriminator step each take two steps from the JAX init state (PPO two
updates of 2 passes of 4 minibatches), all of a trainer's steps one
jitted `shard_map`; `running_mean_std_update` merges one batch per rank.

Pins are those of each trainer's single-device twin: states and metrics
rtol 2e-4, atol 2e-5 (tests/test_torch_sac.py, test_torch_offpolicy_
trainers.py, test_torch_ppo.py, test_torch_il_offline.py, test_torch_adv_
irl.py); the moments rtol 1e-5, atol 1e-6 (test_torch_ppo.py).  The ranks'
states are equal to each other bit for bit.  DQN's `n_act_steps` and
`epsilon` are left out, as its single-device twin leaves them
(ROADMAP.md section 3).
"""

import dataclasses
import os
import socket
import time
from datetime import timedelta
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ilswiss_tpu.algorithms.adv_irl import AdvIRL as JAdvIRL
from ilswiss_tpu.algorithms.adv_irl import AdvIRLConfig as JAdvIRLConfig
from ilswiss_tpu.algorithms.bc import BC as JBC
from ilswiss_tpu.algorithms.bc import BCConfig as JBCConfig
from ilswiss_tpu.algorithms.ddpg import DDPG as JDDPG
from ilswiss_tpu.algorithms.ddpg import DDPGConfig as JDDPGConfig
from ilswiss_tpu.algorithms.discrete_sac import DiscreteSAC as JDiscreteSAC
from ilswiss_tpu.algorithms.discrete_sac import (
    DiscreteSACConfig as JDiscreteSACConfig,
)
from ilswiss_tpu.algorithms.dqn import DQN as JDQN
from ilswiss_tpu.algorithms.dqn import DQNConfig as JDQNConfig
from ilswiss_tpu.algorithms.ppo import PPO as JPPO
from ilswiss_tpu.algorithms.ppo import PPOConfig as JPPOConfig
from ilswiss_tpu.algorithms.sac import SAC as JSAC
from ilswiss_tpu.algorithms.sac import SACConfig as JSACConfig
from ilswiss_tpu.algorithms.sac_v import SACV as JSACV
from ilswiss_tpu.algorithms.sac_v import SACVConfig as JSACVConfig
from ilswiss_tpu.algorithms.td3 import TD3 as JTD3
from ilswiss_tpu.algorithms.td3 import TD3Config as JTD3Config
from ilswiss_tpu.data.demo import load_demos_npz as jload_demos
from ilswiss_tpu.data.replay import replay_init as jreplay_init
from ilswiss_tpu.envs import experts as jexperts
from ilswiss_tpu.parallel.mesh import make_mesh
from ilswiss_tpu.utils import running_stats as jrs
from ilswiss_tpu_torch.algorithms.adv_irl import AdvIRL, AdvIRLConfig
from ilswiss_tpu_torch.algorithms.bc import BC, BCConfig
from ilswiss_tpu_torch.algorithms.ddpg import DDPG, DDPGConfig
from ilswiss_tpu_torch.algorithms.discrete_sac import (
    DiscreteSAC, DiscreteSACConfig,
)
from ilswiss_tpu_torch.algorithms.dqn import DQN, DQNConfig
from ilswiss_tpu_torch.algorithms.ppo import PPO, PPOConfig
from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.algorithms.sac_v import SACV, SACVConfig
from ilswiss_tpu_torch.algorithms.td3 import TD3, TD3Config
from ilswiss_tpu_torch.data.demo import load_demos_npz
from ilswiss_tpu_torch.envs import make_vec
from ilswiss_tpu_torch.ops import fused_sac
from ilswiss_tpu_torch.parallel import distributed as dd
from ilswiss_tpu_torch.parallel import mesh as pmesh
from ilswiss_tpu_torch.runtime.loop import OffPolicyConfig, OffPolicyLoop
from ilswiss_tpu_torch.runtime.onpolicy import OnPolicyConfig, OnPolicyLoop
from ilswiss_tpu_torch.utils import convert

import torch_distributed_ranks as ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PIN = dict(rtol=2e-4, atol=2e-5)
FWD = dict(rtol=1e-5, atol=1e-6)
WORLD, STEPS, JOIN_S = 4, 2, 120.0
AXIS = "env"

# name: (JAX class, JAX config, port class, port config, config kwargs,
# obs, action, width, batch, converter from JAX, to numpy)
SAC_CFG = dict(reward_scale=2.0, beta_1=0.5, q_target_max=0.5)
OFF = (convert.offpolicy_state_from_jax, convert.offpolicy_state_to_numpy)
TRAINERS = {
    "sac": (JSAC, JSACConfig, SAC, SACConfig, SAC_CFG, 11, 3, 32, 16,
            convert.sac_state_from_jax, convert.sac_state_to_numpy),
    "td3": (JTD3, JTD3Config, TD3, TD3Config,
            dict(reward_scale=2.0, discount=0.9, q_target_max=1.0,
                 policy_and_target_update_period=2), 5, 2, 32, 16, *OFF),
    "ddpg": (JDDPG, JDDPGConfig, DDPG, DDPGConfig,
             dict(reward_scale=2.0, max_q_value=1.0, policy_lr=1e-3),
             5, 2, 32, 16, *OFF),
    "sac_v": (JSACV, JSACVConfig, SACV, SACVConfig,
              dict(reward_scale=2.0, alpha=0.2, beta_1=0.5), 5, 2, 32, 16,
              *OFF),
    "discrete_sac": (JDiscreteSAC, JDiscreteSACConfig, DiscreteSAC,
                     DiscreteSACConfig,
                     dict(alpha=0.3, beta_1=0.5, discount=0.95), 4, 3, 32,
                     16, *OFF),
    "dqn": (JDQN, JDQNConfig, DQN, DQNConfig,
            dict(reward_scale=2.0, target_update_period=2,
                 epsilon_decay_steps=60), 4, 3, 32, 16, *OFF),
    "bc": (JBC, JBCConfig, BC, BCConfig, dict(mode="MLE", lr=1e-3,
                                              momentum=0.5), 3, 1, 32, 16,
           convert.bc_state_from_jax, convert.bc_state_to_numpy),
}
DISCRETE = ("discrete_sac", "dqn")
# PPO (tests/test_torch_ppo.py's sizes and configuration)
PPO_CFG = dict(discount=0.97, reward_scale=2.0, gae_tau=0.9, clip_eps=0.2,
               policy_lr=1e-3, value_lr=2e-3, value_l2_reg=1e-2,
               update_epoch=2, mini_batch_size=8, policy_grad_clip=0.5)
PPO_T, PPO_B, PPO_OBS, PPO_ACT, PPO_NET = 8, 4, 3, 2, 16
# AdvIRL (tests/test_torch_adv_irl.py's)
GAIL_CFG = dict(mode="gail", disc_optim_batch_size=32,
                policy_optim_batch_size=32, disc_lr=1e-3, disc_momentum=0.5,
                grad_pen_weight=4.0, disc_hid_dim=16, disc_hid_act="tanh",
                disc_use_bn=False)
GAIL_RING = 64
CASES = list(TRAINERS) + ["ppo", "adv_irl_disc"]


def _batch(rng, obs, act, b, discrete):
    return {
        "obs": rng.randn(b, obs).astype(np.float32),
        "action": (rng.randint(0, act, b).astype(np.int32) if discrete
                   else np.tanh(rng.randn(b, act)).astype(np.float32)),
        "reward": rng.randn(b).astype(np.float32),
        "next_obs": rng.randn(b, obs).astype(np.float32),
        "terminal": (rng.rand(b) < 0.2).astype(np.float32),
    }


def _bc_batch(rng, b):
    """Pendulum observations with the scripted expert's actions, most of
    them at +-1 (tests/test_torch_il_offline.py's)."""
    th = rng.uniform(-np.pi, np.pi, b)
    obs = np.stack([np.cos(th), np.sin(th), rng.uniform(-3, 3, b)],
                   -1).astype(np.float32)
    return {"obs": obs,
            "action": np.asarray(jexperts.pendulum_expert(jnp.asarray(obs)))}


def _step_draws(name, key, b, act):
    """One JAX step's draws from its key, in the port's argument order
    (the single-device twins' rule)."""
    if name == "sac":
        k_next, k_new = jax.random.split(key)
        return [jax.random.normal(k, (b, act)) for k in (k_next, k_new)]
    if name in ("td3", "sac_v"):
        return [jax.random.normal(key, (b, act))]
    return []


def _run_jax(step, draws_of, state, per_rank_inputs, keys, mesh):
    """STEPS steps `step(state, inputs, key)` of every shard under one
    jitted shard_map (a scan over the steps): the state replicated, each
    shard's inputs and keys its own.  Returns the state after them (as
    numpy), each step's metrics [WORLD] and each rank's draws per step,
    `draws_of(key)` of the step's key."""
    def body(state, inputs, keys):
        def one(s, xk):
            s, m = step(s, *xk)
            return s, (m, draws_of(xk[1]))
        state, (metrics, draws) = jax.lax.scan(
            one, state, (jax.tree.map(lambda x: x[0], inputs), keys[0]))
        return state, jax.tree.map(lambda x: x[None], (metrics, draws))
    run = jax.jit(shard_map(body, mesh=mesh,
                            in_specs=(P(), P(AXIS), P(AXIS)),
                            out_specs=(P(), P(AXIS)), check_vma=False))
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *[
        jax.tree.map(lambda *ys: np.stack(ys), *r) for r in per_rank_inputs])
    state, (metrics, draws) = run(state, stacked, keys)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    metrics, draws = as_np(metrics), as_np(draws)
    return (as_np(state),
            [{k: v[:, i] for k, v in metrics.items()} for i in range(STEPS)],
            [[jax.tree.map(lambda x: x[r, i], draws) for i in range(STEPS)]
             for r in range(WORLD)])


def _trainer_case(name, mesh):
    jcls, jcfg, pcls, pcfg, kw, obs, act, h, b, from_jax, to_numpy = \
        TRAINERS[name]
    nets = dict(net_size=h, num_hidden_layers=2)
    jalgo = jcls(obs, act, jcfg(**kw), axis_name=AXIS, **nets)
    jstate = jax.tree.map(np.asarray,
                          jax.jit(jalgo.init)(jax.random.PRNGKey(0)))
    if name == "dqn":        # epsilon away from its ends
        jstate = jstate.replace(n_act_steps=np.asarray(30, np.int32))
    rng = np.random.RandomState(1)
    batches = [[(_bc_batch(rng, b) if name == "bc"
                 else _batch(rng, obs, act, b, name in DISCRETE))
                for _ in range(STEPS)] for _ in range(WORLD)]
    keys = jax.random.split(jax.random.PRNGKey(7), WORLD * STEPS).reshape(
        WORLD, STEPS, -1)
    jnext, jm, draws = _run_jax(jalgo.train_step,
                                partial(_step_draws, name, b=b, act=act),
                                jstate, batches, keys, mesh)
    plain = pcls(obs, act, pcfg(**kw), device="cpu", **nets)
    return dict(
        ctor=(pcls, (obs, act, pcfg(**kw)), nets),
        state=from_jax(plain, jstate), to_numpy=to_numpy,
        batches=[[convert.batches_from_numpy(x, "cpu") for x in r]
                 for r in batches],
        draws=draws), dict(want=to_numpy(from_jax(plain, jnext)),
                           metrics=jm)


def _ppo_rollout(rng):
    done = rng.rand(PPO_T, PPO_B) < 0.15
    return {
        "obs": rng.randn(PPO_T, PPO_B, PPO_OBS).astype(np.float32),
        "action": rng.randn(PPO_T, PPO_B, PPO_ACT).astype(np.float32),
        "reward": rng.randn(PPO_T, PPO_B).astype(np.float32),
        "terminal": done & (rng.rand(PPO_T, PPO_B) < 0.5),
        "done": done,
        "last_obs": rng.randn(PPO_B, PPO_OBS).astype(np.float32),
    }


def _ppo_case(mesh):
    """Two updates per rank from the init state."""
    nets = dict(net_size=PPO_NET, num_hidden_layers=2)
    jppo = JPPO(PPO_OBS, PPO_ACT, JPPOConfig(**PPO_CFG), axis_name=AXIS,
                **nets)
    rng = np.random.RandomState(3)
    jstate = jax.tree.map(np.asarray,
                          jax.jit(jppo.init)(jax.random.PRNGKey(0)))
    rollouts = [[_ppo_rollout(rng) for _ in range(STEPS)]
                for _ in range(WORLD)]
    keys = jax.random.split(jax.random.PRNGKey(2), WORLD * STEPS).reshape(
        WORLD, STEPS, -1)
    n = PPO_T * PPO_B

    def perms(key):
        return [jnp.stack([jax.random.permutation(k, n)
                           for k in jax.random.split(key, 2)])]
    jnext, jm, draws = _run_jax(jppo.train_step, perms, jstate, rollouts,
                                keys, mesh)
    plain = PPO(PPO_OBS, PPO_ACT, PPOConfig(**PPO_CFG), device="cpu", **nets)
    return dict(
        ctor=(PPO, (PPO_OBS, PPO_ACT, PPOConfig(**PPO_CFG)), nets),
        state=convert.ppo_state_from_jax(plain, jstate),
        to_numpy=convert.ppo_state_to_numpy,
        batches=[[{k: torch.as_tensor(v) for k, v in x.items()} for x in r]
                 for r in rollouts],
        draws=[[[d[0].astype(np.int64)] for d in r] for r in draws]), dict(
            want=convert.ppo_state_to_numpy(
                convert.ppo_state_from_jax(plain, jnext)),
            metrics=jm)


def _gail_ring(rng):
    return {"obs": rng.randn(GAIL_RING, 3).astype(np.float32),
            "action": rng.uniform(-1, 1, (GAIL_RING, 1)).astype(np.float32),
            "reward": rng.randn(GAIL_RING).astype(np.float32),
            "next_obs": rng.randn(GAIL_RING, 3).astype(np.float32),
            "terminal": (rng.rand(GAIL_RING) < 0.1).astype(np.float32)}


def _disc_draws(key, n):
    k_e, k_p, k_eps = jax.random.split(key, 3)
    return (jax.random.uniform(k_e, (n,)), jax.random.uniform(k_p, (n,)),
            jax.random.uniform(k_eps, (n, 1)))


def _adv_irl_case(mesh):
    """Two discriminator steps per rank from the init state, each on its
    own ring; the demos replicated."""
    demos_path = str(ROOT / "demos" / "pendulum_expert.npz")
    jsac = JSAC(3, 1, net_size=16, num_hidden_layers=2)
    cfg = JAdvIRLConfig(**GAIL_CFG)
    jalgo = JAdvIRL(3, 1, jsac, jload_demos(demos_path), cfg,
                    axis_name=AXIS)
    rng = np.random.RandomState(0)
    base = jreplay_init(GAIL_RING, 3, 1, write_batch=4).replace(
        size=jnp.asarray(GAIL_RING, jnp.int32))
    jstate = jax.tree.map(np.asarray,
                          jax.jit(jalgo.init)(jax.random.PRNGKey(0)))
    rings = [[_gail_ring(rng) for _ in range(STEPS)] for _ in range(WORLD)]
    keys = jax.random.split(jax.random.PRNGKey(5), WORLD * STEPS).reshape(
        WORLD, STEPS, -1)
    jnext, jm, draws = _run_jax(
        lambda s, d, k: jalgo._disc_update(s, base.replace(data=d), k),
        partial(_disc_draws, n=32), jstate, rings, keys, mesh)

    pcfg = AdvIRLConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(AdvIRLConfig)})
    demos = load_demos_npz(demos_path, device="cpu")
    sac_args = (3, 1)
    sac_kw = dict(net_size=16, num_hidden_layers=2)
    plain = AdvIRL(3, 1, SAC(*sac_args, device="cpu", **sac_kw), demos, pcfg)
    ring_state = convert.replay_from_jax(jax.tree.map(np.asarray, base),
                                         "cpu")

    def port_ring(data):
        return dataclasses.replace(ring_state, data={
            k: torch.as_tensor(v) for k, v in data.items()})
    return dict(
        ctor=(AdvIRL, (3, 1, demos, pcfg), {}), inner=(SAC, sac_args, sac_kw),
        state=convert.adv_irl_state_from_jax(plain, jstate),
        to_numpy=convert.adv_irl_state_to_numpy, disc_step=True,
        batches=[[port_ring(x) for x in r] for r in rings],
        draws=[[list(zip(("replay", "replay", "interpolation"), d))
                for d in r] for r in draws]), dict(
            want=convert.adv_irl_state_to_numpy(
                convert.adv_irl_state_from_jax(plain, jnext)),
            metrics=jm)


def _moments_case(mesh):
    rng = np.random.RandomState(1)
    jrms = jrs.running_mean_std_init((4,))
    jrms = jrs.running_mean_std_update(
        jrms, jnp.asarray((3.0 * rng.randn(5, 4)).astype(np.float32)))
    batches = [(3.0 * rng.randn(17, 4) + rng.randn(4)).astype(np.float32)
               for _ in range(WORLD)]
    merge = jax.jit(shard_map(
        lambda r, x: jrs.running_mean_std_update(r, x[0], axis_name=AXIS),
        mesh=mesh, in_specs=(P(), P(AXIS)), out_specs=P(),
        check_vma=False))
    want = merge(jrms, jnp.stack(batches))
    return dict(rms=convert.running_mean_std_from_jax(
        jax.tree.map(np.asarray, jrms), "cpu"),
        batches=[torch.as_tensor(x) for x in batches]), {
            k: np.asarray(getattr(want, k)) for k in ("mean", "var", "count")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, then one spawn of WORLD ranks that runs every
    case; per case the references and each rank's output."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    mesh = make_mesh(WORLD)
    inputs, refs = {}, {}
    for name in TRAINERS:
        inputs[name], refs[name] = _trainer_case(name, mesh)
    inputs["ppo"], refs["ppo"] = _ppo_case(mesh)
    inputs["adv_irl_disc"], refs["adv_irl_disc"] = _adv_irl_case(mesh)
    inputs["moments"], refs["moments"] = _moments_case(mesh)
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    pmesh.spawn_ranks(ranks.trainers, WORLD, (tmp,), timeout=JOIN_S)
    outs = [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return refs, outs


def _close(got, want, pin, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _close(got[k], want[k], pin, f"{path}/{k}")
    elif want is None or isinstance(want, int):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **pin)


def _equal(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.mark.parametrize("name", CASES)
def test_trainer_steps_match_jax_under_shard_map(runs, name):
    """Every rank's state after the steps holds against the JAX state
    (the shards' pmean'ed update), its metrics against its shard's, the
    ranks' states are equal, and each step made one collective per
    gradient group."""
    refs, outs = runs
    ref = refs[name]
    want = dict(ref["want"])
    for r, out in enumerate(outs):
        got = dict(out[name]["state"])
        if name == "dqn":
            got.pop("n_act_steps"), want.pop("n_act_steps", None)
        _close(got, want, PIN, name)
        _equal(out[name]["state"], outs[0][name]["state"], name)
        for i, m in enumerate(out[name]["metrics"]):
            jm = {k: float(v[r]) for k, v in ref["metrics"][i].items()}
            if name == "dqn":
                m.pop("epsilon"), jm.pop("epsilon")
            assert set(m) == set(jm)
            for k, v in jm.items():
                np.testing.assert_allclose(m[k], v, err_msg=f"{name} {k}",
                                           **PIN)
    # over both steps: SAC critics, policy, alpha; TD3 two critics, the
    # policy at step 0 only (period 2); DDPG critic, policy; SAC-V two
    # critics, V, policy; discrete SAC two critics, policy; DQN, BC and the
    # discriminator one; PPO value and policy per minibatch (2 updates of
    # 2 passes x 4)
    calls = {"sac": 6, "td3": 5, "ddpg": 4, "sac_v": 8, "discrete_sac": 6,
             "dqn": 2, "bc": 2, "adv_irl_disc": 2, "ppo": 32}[name]
    assert all(out[name]["calls"] == calls for out in outs)


def test_moments_merge_across_ranks_as_jax(runs):
    refs, outs = runs
    for out in outs:
        _close(out["moments"], refs["moments"], FWD)
    assert float(outs[0]["moments"]["count"]) == pytest.approx(
        5 + 1e-4 + WORLD * 17)


def test_all_reduce_mean_is_the_identity_without_a_group():
    x = [torch.randn(3, 2), torch.randn(5)]
    calls = dd.all_reduce_mean.calls
    got = dd.all_reduce_mean(x, None)
    assert all(g is t for g, t in zip(got, x))
    assert dd.all_reduce_mean.calls == calls


def test_fused_chain_never_launches_under_a_group(tmp_path):
    """A one-rank gloo group: the loop takes the eager steps, not
    `train_chain` (K2 applies local gradients only), issues no collective
    in a world of one, leaves K2's launch counter at 0, and ends where the
    same loop without the fused chain ends, bit for bit."""
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    group = pmesh.init_group(0, 1, store=store, device="cpu", timeout=30.0)
    assert (group.backend, group.world_size, group.device) == (
        "gloo", 1, torch.device("cpu"))

    def run(**kw):
        sac = SAC(3, 1, SACConfig(), net_size=16, num_hidden_layers=1,
                  device="cpu", **kw)
        loop = OffPolicyLoop(make_vec("pendulum", 2, device="cpu"), sac,
                             OffPolicyConfig(batch_size=8,
                                             replay_capacity=32,
                                             min_steps_before_training=4,
                                             grad_steps_per_iter=3))
        if "group" in kw:
            def refuse(*args, **kwargs):
                raise AssertionError("train_chain under a group")
            sac.train_chain = refuse
            factory = dd.DistributedOffPolicyRunner(loop, group)
            runner = factory.init(0)
            warmup, epoch = factory.build(4)
        else:
            runner = loop.init(0)
            warmup = loop.warmup
            epoch = partial(loop.train_epoch, steps_per_epoch=4)
        return epoch(warmup(runner))

    launches, calls = fused_sac.fused_sac_chain.launches, \
        dd.all_reduce_mean.calls
    got, got_m = run(group=group, use_fused_chain=True)
    torch.distributed.destroy_process_group()
    assert fused_sac.fused_sac_chain.launches == launches
    assert dd.all_reduce_mean.calls == calls
    assert got.algo_state.policy_opt.count == 2 * 3
    want, want_m = run()
    assert got_m == want_m
    for a, b in zip(got.algo_state.policy.parameters(),
                    want.algo_state.policy.parameters()):
        assert torch.equal(a, b)


def test_group_refuses_a_trainer_without_it_and_nccl_without_a_card(
        tmp_path):
    """The runner refuses an algorithm that would not average its
    gradients; nccl is never taken for the CPU, nor the CPU for a card."""
    sac = SAC(3, 1, SACConfig(), net_size=16, num_hidden_layers=1,
              device="cpu")
    loop = OffPolicyLoop(make_vec("pendulum", 2, device="cpu"), sac,
                         OffPolicyConfig(batch_size=8, replay_capacity=32))
    group = pmesh.RankGroup(rank=0, world_size=2, backend="gloo",
                            device=torch.device("cpu"), process_group=None)
    with pytest.raises(ValueError, match="group="):
        dd.DistributedOffPolicyRunner(loop, group)
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        pmesh.init_group(0, 1, store=store, device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.init_group(0, 1, store=store)
    with pytest.raises(ValueError, match="exactly one"):
        pmesh.init_group(0, 1, device="cpu")


def test_spawn_ranks_fails_with_a_rank_and_ends_the_others():
    """A rank that raises fails the call at once, naming it, and the rank
    still running (asleep) is ended rather than waited for."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[1\] of 2 failed"):
        pmesh.spawn_ranks(ranks.fail_or_sleep, 2, timeout=JOIN_S)
    assert time.monotonic() - t0 < JOIN_S / 2


def test_nccl_refuses_two_ranks_on_one_card(tmp_path):
    """The ranks' cards, published through the store, name one card
    twice: every rank raises before a group exists."""
    store = torch.distributed.FileStore(str(tmp_path / "store"), 2)
    store.set("ilswiss_nccl_device/1", f"{socket.gethostname()}:0")
    with pytest.raises(ValueError, match="one card per rank"):
        pmesh._check_devices(store, 0, 2, torch.device("cuda", 0),
                             timedelta(seconds=5))


def test_rank_onpolicy_runner_from_jax_takes_the_rank_rows():
    """Rank r of a stacked JAX on-policy runner: its env rows and env-step
    count; the PPO state and the moments of every rank the same."""
    rng = np.random.RandomState(0)
    n, b = WORLD, 3
    jppo = JPPO(PPO_OBS, PPO_ACT, JPPOConfig(**PPO_CFG), net_size=PPO_NET,
                num_hidden_layers=2)
    jstate = jax.tree.map(np.asarray,
                          jax.jit(jppo.init)(jax.random.PRNGKey(0)))
    stacked = SimpleNamespace(
        env_state=SimpleNamespace(
            internal=rng.randn(n * b, 2).astype(np.float32),
            obs=rng.randn(n * b, PPO_OBS).astype(np.float32),
            t=np.arange(n * b, dtype=np.int32)),
        algo_state=jstate, total_env_steps=np.arange(n, dtype=np.int32),
        obs_rms=SimpleNamespace(mean=rng.randn(PPO_OBS).astype(np.float32),
                                var=rng.rand(PPO_OBS).astype(np.float32),
                                count=np.float32(7.0)))
    ppo = PPO(PPO_OBS, PPO_ACT, PPOConfig(**PPO_CFG), net_size=PPO_NET,
              num_hidden_layers=2, device="cpu")
    loop = OnPolicyLoop(make_vec("pendulum", b, device="cpu"), ppo,
                        OnPolicyConfig(normalize_obs=True))
    want_ppo = convert.ppo_state_to_numpy(
        convert.ppo_state_from_jax(ppo, jstate))
    for r in range(n):
        got = convert.rank_onpolicy_runner_from_jax(loop, stacked, r, n,
                                                    None)
        rows = slice(r * b, (r + 1) * b)
        env = convert.env_state_to_numpy(got.env_state)
        np.testing.assert_array_equal(env["internal"][0],
                                      stacked.env_state.internal[rows])
        np.testing.assert_array_equal(env["obs"], stacked.env_state.obs[rows])
        np.testing.assert_array_equal(env["t"], stacked.env_state.t[rows])
        assert got.total_env_steps == r
        _close(convert.ppo_state_to_numpy(got.algo_state), want_ppo,
               dict(rtol=0, atol=0))
        _close(convert.running_mean_std_to_numpy(got.obs_rms),
               vars(stacked.obs_rms), dict(rtol=0, atol=0))
