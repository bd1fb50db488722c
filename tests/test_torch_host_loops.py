"""The port's host loops (ilswiss_tpu_torch/runtime/host_loop.py,
algorithms/her.py::HostHERLoop, algorithms/mbpo.py::HostMBPOLoop) and the
launchers' host branches against the JAX package's
(ilswiss_tpu/runtime/host_loop.py, launchers/experiments.py).

The learner's call is held to JAX's on one segment, ring and state: the
JAX state and ring are carried across by utils/convert.py, and every draw
of the JAX call is rebuilt from its keys and replayed to the port in the
port's documented order (`_Draws` checks the order).  The ring must match
exactly; the state and metrics at rtol 2e-4, atol 2e-5, the pins of the
SAC, AdvIRL and PPO twins (tests/test_torch_offpolicy_trainers.py,
test_torch_adv_irl.py, test_torch_ppo.py).  Widths are narrow (32 x 2),
segments 16 steps, 2 train steps.  The collector's acting copy, the seeded
warmup, HER and MBPO on host envs and the launchers' host branches are
checked on the port alone, with the JAX launcher's progress.csv keys and
snapshots as the reference.
"""

import csv
import functools
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ilswiss_tpu.algorithms.adv_irl import AdvIRL as JAdvIRL
from ilswiss_tpu.algorithms.adv_irl import AdvIRLConfig as JAdvIRLConfig
from ilswiss_tpu.algorithms.ppo import PPO as JPPO
from ilswiss_tpu.algorithms.ppo import PPOConfig as JPPOConfig
from ilswiss_tpu.algorithms.sac import SAC as JSAC
from ilswiss_tpu.data import demo as jdemo
from ilswiss_tpu.envs.host_mujoco import GymVectorEnv as JGymVectorEnv
from ilswiss_tpu.envs.vector import Transition as JTransition
from ilswiss_tpu.launchers import experiments as jexp
from ilswiss_tpu.runtime import host_loop as jhl
from ilswiss_tpu_torch.algorithms.adv_irl import AdvIRL, AdvIRLConfig
from ilswiss_tpu_torch.algorithms.bnn_trainer import BNNTrainerConfig
from ilswiss_tpu_torch.algorithms.her import (
    HER, HERLoopConfig, HostHERLoop,
)
from ilswiss_tpu_torch.algorithms.mbpo import MBPO, HostMBPOLoop, MBPOConfig
from ilswiss_tpu_torch.algorithms.ppo import PPO, PPOConfig
from ilswiss_tpu_torch.algorithms.sac import SAC
from ilswiss_tpu_torch.algorithms.td3 import TD3, TD3Config
from ilswiss_tpu_torch.data.demo import load_demos_npz
from ilswiss_tpu_torch.envs.host_mujoco import (
    GymVectorEnv, HostGoalVectorEnv,
)
from ilswiss_tpu_torch.envs.terminals import get_terminal_func
from ilswiss_tpu_torch.launchers import experiments as pexp
from ilswiss_tpu_torch.launchers.variant import build_variants
from ilswiss_tpu_torch.runtime.checkpoint import save_checkpoint
from ilswiss_tpu_torch.runtime.host_loop import (
    HostLoopConfig, HostOffPolicyLoop, HostOnPolicyLoop,
)
from ilswiss_tpu_torch.testing import DeviceEnvAsHost
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OBS, ACT, NET, B, BATCH, K, SEG = 3, 1, 32, 4, 16, 2, 4   # SEG x B = 16
PIN = dict(rtol=2e-4, atol=2e-5)
CONFIG = dict(batch_size=BATCH, replay_capacity=64,
              steps_between_train_calls=SEG * B, train_steps_per_call=K,
              min_steps_before_training=SEG * B)


class _Sizes:
    """A host env of B envs that only gives its sizes (the learner's twin
    never steps it)."""

    num_envs, observation_size, action_size = B, OBS, ACT
    name, max_episode_steps, discrete = "sizes", 50, False

    def reset(self, seed=None):
        return np.zeros((B, OBS), np.float32)

    def close(self):
        pass


class _Draws:
    """The port's `Noise` methods, answering each call with the next JAX
    draw; a call out of the documented order fails."""

    def __init__(self, seq):
        self.seq = list(seq)

    def _pop(self, kind):
        assert self.seq, f"no draw left for {kind}"
        got, value = self.seq.pop(0)
        assert got == kind, f"drew {kind} where the JAX order has {got}"
        return torch.as_tensor(np.array(value))

    def replay(self, n):
        return self._pop("replay")

    def interpolation(self, n):
        return self._pop("interpolation")

    def train(self, shape):
        return self._pop("eps_next"), self._pop("eps_new")

    def permutation(self, n):
        return self._pop("permutation")


def _segment(rng, T=SEG):
    done = rng.rand(T, B) < 0.2
    return {"obs": rng.randn(T, B, OBS).astype(np.float32),
            "action": rng.uniform(-1, 1, (T, B, ACT)).astype(np.float32),
            "reward": rng.randn(T, B).astype(np.float32),
            "next_obs": rng.randn(T, B, OBS).astype(np.float32),
            "terminal": done & (rng.rand(T, B) < 0.5),
            "done": done}


def _jt(seg):
    return JTransition(**{k: jnp.asarray(v) for k, v in seg.items()})


def _sac_draws(key):
    out = []
    for k in jax.random.split(key, K):
        k_s, k_t = jax.random.split(k)
        k_next, k_new = jax.random.split(k_t)
        out += [("replay", jax.random.uniform(k_s, (BATCH,))),
                ("eps_next", jax.random.normal(k_next, (BATCH, ACT))),
                ("eps_new", jax.random.normal(k_new, (BATCH, ACT)))]
    return out


def _adv_irl_draws(key, cfg):
    """One JAX `AdvIRL.train_call`'s draws (tests/test_torch_adv_irl.py's
    order)."""
    n, out = BATCH, []
    for k in jax.random.split(key, cfg.num_update_loops_per_train_call):
        kd, kp = jax.random.split(k)
        for kk in jax.random.split(kd, cfg.num_disc_updates_per_loop_iter):
            k_e, k_p, k_eps = jax.random.split(kk, 3)
            out += [("replay", jax.random.uniform(k_e, (n,))),
                    ("replay", jax.random.uniform(k_p, (n,))),
                    ("interpolation", jax.random.uniform(k_eps, (n, 1)))]
        for kk in jax.random.split(kp, cfg.num_policy_updates_per_loop_iter):
            k_p, _, k_t = jax.random.split(kk, 3)
            k_next, k_new = jax.random.split(k_t)
            out += [("replay", jax.random.uniform(k_p, (n,))),
                    ("eps_next", jax.random.normal(k_next, (n, ACT))),
                    ("eps_new", jax.random.normal(k_new, (n, ACT)))]
    return out


ADV = dict(mode="gail", disc_optim_batch_size=BATCH,
           policy_optim_batch_size=BATCH, disc_hid_dim=16,
           disc_use_bn=False, num_update_loops_per_train_call=1,
           num_disc_updates_per_loop_iter=2,
           num_policy_updates_per_loop_iter=2)
DEMOS = str(ROOT / "demos" / "pendulum_expert.npz")


@functools.cache
def _jax_call(kind):
    """The JAX host loop's learner call on one segment, from a runner one
    warmup segment in: (the runner before it as numpy, the segment, the
    call's draws, the runner after it as numpy, its metrics)."""
    jsac = JSAC(OBS, ACT, net_size=NET, num_hidden_layers=2)
    if kind == "adv_irl":
        algo = JAdvIRL(OBS, ACT, jsac, jdemo.load_demos_npz(DEMOS),
                       JAdvIRLConfig(**ADV))
    else:
        algo = jsac
    jloop = jhl.HostOffPolicyLoop(_Sizes(), algo,
                                  jhl.HostLoopConfig(**CONFIG))
    rng = np.random.RandomState(0)
    jr = jloop._ingest_only(jloop.init(seed=0), _jt(_segment(rng)))
    before = jax.tree.map(np.asarray, jr)
    seg = _segment(rng)
    _, key = jax.random.split(jr.rng)
    draws = (_adv_irl_draws(key, algo.config) if kind == "adv_irl"
             else _sac_draws(key))
    jnext, jm = jloop._ingest_and_train(jr, _jt(seg))
    return (before, seg, draws, jax.tree.map(np.asarray, jnext),
            {k: float(v) for k, v in jm.items()})


def _close(got, want, pin, path=""):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], pin, f"{path}/{k}")
    elif isinstance(want, int):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **pin)


def _jax_sac_numpy(s):
    opt = lambda o: {"count": int(o[0].count), "mu": o[0].mu,  # noqa: E731
                     "nu": o[0].nu}
    return {"policy_params": s.policy_params, "qf_params": s.qf_params,
            "target_qf_params": s.target_qf_params,
            "log_alpha": s.log_alpha, "policy_opt": opt(s.policy_opt),
            "qf_opt": opt(s.qf_opt), "alpha_opt": opt(s.alpha_opt)}


@pytest.mark.parametrize("kind", ["sac", "adv_irl"])
def test_ingest_and_train_matches_jax(kind):
    """SAC: the segment into the ring, then K = 2 eager steps; AdvIRL
    (`train_call` owns the schedule): one call of 2 discriminator and 2
    policy steps.  The ring exactly, the state and metrics at the pins."""
    before, seg, draws, jnext, jm = _jax_call(kind)
    sac = SAC(OBS, ACT, net_size=NET, num_hidden_layers=2, device="cpu")
    algo = (AdvIRL(OBS, ACT, sac, load_demos_npz(DEMOS, device="cpu"),
                   AdvIRLConfig(**ADV)) if kind == "adv_irl" else sac)
    loop = HostOffPolicyLoop(_Sizes(), algo, HostLoopConfig(**CONFIG))
    runner = convert.host_runner_from_jax(loop, before, _Draws(draws))
    runner, m = loop.ingest_and_train(runner, seg)
    assert not runner.noise.seq
    got = convert.replay_to_numpy(runner.replay)
    for k, v in jnext.replay.data.items():
        np.testing.assert_array_equal(got["data"][k], v, err_msg=k)
    np.testing.assert_array_equal(got["ep_id"], jnext.replay.ep_id)
    np.testing.assert_array_equal(got["env_ep"], jnext.replay.env_ep)
    assert (got["ptr"], got["size"]) == (int(jnext.replay.ptr),
                                         int(jnext.replay.size))
    assert set(m) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), v, err_msg=k, **PIN)
    if kind == "sac":
        _close(convert.sac_state_to_numpy(runner.algo_state),
               _jax_sac_numpy(jnext.algo_state), PIN)
        return
    state, js = convert.adv_irl_state_to_numpy(runner.algo_state), \
        jnext.algo_state
    _close(state["policy"], _jax_sac_numpy(js.policy), PIN, "policy")
    _close(state["disc_params"], js.disc_params, PIN, "disc")
    for k in ("mu", "nu"):
        _close(state["disc_opt"][k], getattr(js.disc_opt[0], k), PIN, k)


def test_on_policy_train_on_rollout_matches_jax():
    """`HostOnPolicyLoop.train_on_rollout` with obs_norm, from one JAX
    runner one update in: the moments merge the rollout before it is
    normalized, then PPO's update on the JAX permutations."""
    T, cfg = 8, dict(update_epoch=2, mini_batch_size=8, policy_lr=1e-3,
                     value_lr=2e-3)
    jppo = JPPO(OBS, ACT, JPPOConfig(**cfg), net_size=NET,
                num_hidden_layers=2)
    jloop = jhl.HostOnPolicyLoop(_Sizes(), jppo, rollout_length=T,
                                 normalize_obs=True)
    rng = np.random.RandomState(4)

    def rollout():
        done = rng.rand(T, B) < 0.2
        return {"obs": 3 * rng.randn(T, B, OBS).astype(np.float32) + 1,
                "action": rng.randn(T, B, ACT).astype(np.float32),
                "reward": rng.randn(T, B).astype(np.float32),
                "terminal": done & (rng.rand(T, B) < 0.5), "done": done,
                "last_obs": rng.randn(B, OBS).astype(np.float32)}

    as_jax = lambda r: {k: jnp.asarray(v) for k, v in r.items()}  # noqa
    jr, _ = jloop._train_on_rollout(jloop.init(seed=0), as_jax(rollout()))
    before, second = jax.tree.map(np.asarray, jr), rollout()
    _, key = jax.random.split(jr.rng)
    perms = [("permutation", jax.random.permutation(k, T * B))
             for k in jax.random.split(key, cfg["update_epoch"])]
    jnext, jm = jloop._train_on_rollout(jr, as_jax(second))
    jnext = jax.tree.map(np.asarray, jnext)

    loop = HostOnPolicyLoop(_Sizes(), PPO(OBS, ACT, PPOConfig(**cfg),
                                          net_size=NET, device="cpu"),
                            rollout_length=T, normalize_obs=True)
    runner = convert.host_onpolicy_runner_from_jax(loop, before,
                                                   _Draws(perms))
    runner, m = loop.train_on_rollout(runner, second)
    assert not runner.noise.seq
    _close(convert.running_mean_std_to_numpy(runner.obs_rms),
           {k: getattr(jnext.obs_rms, k) for k in ("mean", "var", "count")},
           PIN, "obs_rms")
    s = jnext.algo_state
    adam = lambda a: {"count": int(a.count), "mu": a.mu,  # noqa: E731
                      "nu": a.nu}
    _close(convert.ppo_state_to_numpy(runner.algo_state),
           {"policy_params": s.policy_params, "vf_params": s.vf_params,
            "policy_opt": adam(s.policy_opt[1][0]),
            "vf_opt": adam(s.vf_opt[0])}, PIN)
    assert set(m) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), err_msg=k, **PIN)


# --- the collector -----------------------------------------------------------
def _pendulum_loop(**cfg):
    sac = SAC(OBS, ACT, net_size=NET, num_hidden_layers=2, device="cpu")
    env = DeviceEnvAsHost("pendulum", B, max_episode_steps=20)
    return HostOffPolicyLoop(env, sac, HostLoopConfig(
        **dict(CONFIG, replay_capacity=512, **cfg)))


def _policy(state):
    return {k: v.clone() for k, v in state.policy.state_dict().items()}


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("overlap", [True, False],
                         ids=["overlap", "serial"])
def test_collector_acts_on_a_true_copy(overlap):
    """Overlapped, segment i + 1 acts with the weights from before train
    call i, in a copy that shares no storage with the learner (which
    trains in place on the CPU too); serially, segment i acts with those
    after train call i - 1.  Every segment's draws are its own."""
    loop = _pendulum_loop(overlap_collection=overlap)
    snaps, pre, post, seeds = [], [], [], []
    snapshot, collect, train = (loop.acting_snapshot, loop._collect_segment,
                                loop.ingest_and_train)

    def take(algo_state):
        out = snapshot(algo_state)
        snaps.append((out, _policy(algo_state)))
        return out

    def collecting(n, noise, state_cpu=None):
        seeds.append(noise.generator.initial_seed())
        return collect(n, noise, state_cpu)

    def training(runner, seg):
        pre.append(_policy(runner.algo_state))
        out = train(runner, seg)
        post.append(_policy(runner.algo_state))
        return out

    loop.acting_snapshot, loop._collect_segment = take, collecting
    loop.ingest_and_train = training
    runner = loop.warmup(loop.init(seed=7))
    runner, m = loop.train_epoch(runner, 3 * SEG * B)
    assert len(snaps) == len(pre) == 3
    assert all(np.isfinite(v) for v in m.values())
    assert runner.total_env_steps == 4 * SEG * B
    learner = dict(runner.algo_state.policy.named_parameters())
    for i, (copy, at_snapshot) in enumerate(snaps):
        got = {k: v.detach() for k, v in copy.policy.state_dict().items()}
        assert _equal(got, at_snapshot), i        # untouched by training
        assert copy.qf is None and copy.policy_opt is None
        assert all(p.data_ptr() != learner[k].data_ptr()
                   for k, p in copy.policy.named_parameters())
        if i:
            want = pre[i - 1] if overlap else post[i - 1]
            assert _equal(got, want), i
            assert not _equal(got, post[-1])
    # warmup, then three segments, each seeded from the steps before it
    assert len(set(seeds)) == 4


def test_fault_warmup_is_seeded():
    """The JAX warmup draws from the global, unseeded np.random
    (host_loop.py:203-206): two runs of one seed fill different rings.
    The port draws `Noise.warmup_action` from the run's seed: the same."""
    def port_ring():
        env = GymVectorEnv("hopper", num_envs=B, seed=0)
        sac = SAC(11, 3, net_size=NET, device="cpu")
        loop = HostOffPolicyLoop(env, sac, HostLoopConfig(**CONFIG))
        ring = loop.warmup(loop.init(seed=0)).replay
        env.close()
        return ring

    def jax_ring():
        env = JGymVectorEnv("hopper", num_envs=B, seed=0)
        jloop = jhl.HostOffPolicyLoop(env, JSAC(11, 3, net_size=NET),
                                      jhl.HostLoopConfig(**CONFIG))
        ring = jax.tree.map(np.asarray, jloop.warmup(jloop.init(0)).replay)
        env.close()
        return ring

    a, b = port_ring(), port_ring()
    assert a.size == b.size == SEG * B
    assert all(torch.equal(a.data[k], b.data[k]) for k in a.data)
    ja, jb = jax_ring(), jax_ring()
    assert not np.array_equal(ja.data["action"], jb.data["action"])


# --- HER and MBPO on host envs ----------------------------------------------
def test_host_her_segment_on_fetch_reach():
    """Warmup (two episodes an env) and one segment of HER-TD3 on
    FetchReach-v4: the hindsight ring's episodes, finite metrics, the
    evaluation's SuccessRate."""
    env = HostGoalVectorEnv("fetch-reach", num_envs=2, seed=0,
                            max_episode_steps=10)
    obs = env.observation_size + env.goal_size
    her = HER(TD3(obs, env.action_size, TD3Config(
        discount=0.98, q_target_min=-50.0, q_target_max=0.0,
        exploration_epsilon=0.3), net_size=NET, device="cpu"))
    loop = HostHERLoop(env, her, HERLoopConfig(batch_size=BATCH,
                                               num_episode_slots=8),
                       grad_steps_per_segment=K, segment_steps=20)
    try:
        runner = loop.warmup(loop.init(seed=0))
        assert runner.total_env_steps == 40
        runner, m = loop.train_epoch(runner, 20)
        assert runner.total_env_steps == 60
        assert runner.replay.completed.tolist() == [3, 3]
        assert all(np.isfinite(v) for v in m.values()) and "qf1_loss" in m
        stats = loop.evaluate(runner, 2, seed=1)
        assert 0.0 <= stats["SuccessRate"] <= 1.0
        assert stats["AvgPathLength"] == 10.0
    finally:
        env.close()


def test_host_mbpo_segment_on_hopper():
    """Warmup and one segment of MBPO on Hopper-v5: the ensemble fit, a
    model rollout into the model ring, 2 SAC steps on mixed batches."""
    env = GymVectorEnv("hopper", num_envs=B, seed=0, max_episode_steps=10)
    sac = SAC(11, 3, net_size=NET, device="cpu")
    mbpo = MBPO(None, sac, get_terminal_func("hopper"), MBPOConfig(
        model_train_freq=16, rollout_batch_size=32, batch_size=BATCH,
        replay_capacity=256, min_steps_before_training=32,
        max_path_length=10, rollout_schedule=(0, 1, 1, 1)),
        BNNTrainerConfig(num_nets=3, num_elites=2, hidden_sizes=(16, 16),
                         batch_size=BATCH, max_epochs=2),
        obs_size=11, action_size=3, num_envs=B)
    loop = HostMBPOLoop(env, mbpo, grad_steps_per_env_step=K / 16)
    try:
        runner = loop.warmup(loop.init(seed=0))
        assert runner.env_state is None and runner.replay.size == 32
        runner, m = loop.train_epoch(runner, 0, 16)
        assert runner.total_env_steps == 48 and runner.replay.size == 48
        assert 0 < runner.model_replay.size <= 32
        assert all(np.isfinite(v) for v in m.values())
        assert {"qf1_loss", "bnn_holdout_mse", "mean_rollout_length"} <= \
            set(m)
    finally:
        env.close()


# --- the launchers' host branches -------------------------------------------
CUT = dict(num_epochs=2, num_steps_per_epoch=32,
           num_steps_between_train_calls=16,
           num_train_steps_per_train_call=K, num_steps_per_eval=20,
           max_path_length=10, min_steps_before_training=16,
           batch_size=BATCH, replay_buffer_size=512)


def _native_spec(log_dir, **extra):
    with open(ROOT / "exp_specs" / "sac" / "sac_hopper_native.yaml") as f:
        (v,) = build_variants(yaml.safe_load(f))
    v["rl_alg_params"].update(CUT)
    v.update(net_size=NET, log_dir=str(log_dir), print_to_console=False,
             **extra)
    v["env_specs"] = dict(v["env_specs"], env_num=B)
    return v


def _rows(log_dir):
    with open(Path(log_dir) / "progress.csv") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def host_sac_runs(tmp_path_factory):
    """The cut sac_hopper_native.yaml through the port's run_sac (native
    engine) and the JAX one (its gymnasium env: building the JAX engine
    rewrites a file of the JAX package): straight for 2 epochs."""
    root = tmp_path_factory.mktemp("host_sac")
    pexp.run_sac(_native_spec(root / "port"), device="cpu")
    jexp.run_sac(_native_spec(root / "jax", use_native_engine=False))
    return root


def test_run_sac_host_writes_the_jax_keys_and_snapshots(host_sac_runs):
    port, jax_dir = host_sac_runs / "port", host_sac_runs / "jax"
    rows, jrows = _rows(port), _rows(jax_dir)
    assert set(rows[0]) == set(jrows[0])
    assert [float(r["TotalEnvSteps"]) for r in rows] == [48.0, 80.0]
    assert all(np.isfinite(float(v)) for r in rows for v in r.values())
    assert sorted(os.listdir(port / "checkpoints")) == sorted(
        os.listdir(jax_dir / "checkpoints"))
    assert "using native mjvec engine for hopper" in (
        port / "debug.log").read_text()


def test_run_sac_host_resumes_with_the_decided_total_env_steps(
        host_sac_runs, tmp_path):
    """A full resume continues the saved count (the JAX host path restarts
    its static count and logs max(count, epoch * steps): 64 here); a light
    resume logs start_epoch * steps_per_epoch plus the new warmup's and
    epochs' steps, the device path's convention."""
    v = _native_spec(tmp_path / "b")
    v["rl_alg_params"]["num_epochs"] = 1
    first = pexp.run_sac(v, device="cpu")
    assert [float(r["TotalEnvSteps"]) for r in _rows(tmp_path / "b")] == [
        48.0]
    pexp.run_sac(_native_spec(tmp_path / "b",
                              load_params=str(tmp_path / "b")), device="cpu")
    assert [float(r["TotalEnvSteps"]) for r in _rows(tmp_path / "b")] == [
        48.0, 80.0]
    light = tmp_path / "light"
    save_checkpoint(str(light), {"algo_state": first.algo_state})
    (light / "meta.json").write_text(json.dumps(
        {"epoch": 0, "best_value": -1e9, "light": True}))
    pexp.run_sac(_native_spec(tmp_path / "c", load_params=str(light)),
                 device="cpu")
    assert [float(r["TotalEnvSteps"]) for r in _rows(tmp_path / "c")] == [
        80.0]


def test_run_ppo_host_branch_refuses_load_params(tmp_path):
    with open(ROOT / "exp_specs" / "ppo" / "ppo_pendulum.yaml") as f:
        (v,) = build_variants(yaml.safe_load(f))
    v.update(log_dir=str(tmp_path / "p"), print_to_console=False,
             load_params=str(tmp_path / "x"))
    v["env_specs"] = dict(v["env_specs"], env_name="InvertedPendulum-v5")
    assert pexp._route_host(v, "InvertedPendulum-v5")
    with pytest.raises(ValueError, match="PPO has no resume"):
        pexp.run_ppo(v, device="cpu")
    assert not (tmp_path / "p").exists()


def test_gen_expert_host_branch_writes_the_jax_format(host_sac_runs,
                                                       tmp_path):
    """gen_expert on the host hopper from the run's 'best' snapshot: the
    file loads in the JAX package, and equals, key by key and dtype by
    dtype, what the JAX package writes for the same transitions."""
    with open(ROOT / "exp_specs" / "gen_expert" / "hopper.yaml") as f:
        (v,) = build_variants(yaml.safe_load(f))
    out = tmp_path / "demos.npz"
    v.update(expert_path=str(host_sac_runs / "port" / "checkpoints" /
                             "best"),
             net_size=NET, num_rollouts=2, max_path_length=10,
             save_path=str(out), demos_listing=str(tmp_path / "list.yaml"),
             log_dir=str(tmp_path / "g"), print_to_console=False)
    v["env_specs"] = dict(v["env_specs"], env_num=2, force_host=True)
    assert pexp.run_gen_expert(v, device="cpu") == str(out)
    got = dict(np.load(out))
    assert got["obs"].shape == (20, 11) and got["action"].shape == (20, 3)
    jstate = jdemo.load_demos_npz(str(out))
    assert int(jstate.size) == 20
    ref = tmp_path / "jax.npz"
    jdemo.save_demos_npz(str(ref), jdemo.demos_to_replay_state(
        got["obs"], got["action"], got["reward"], got["next_obs"],
        got["terminal"], got["ep_id"]))
    want = dict(np.load(ref))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    listing = yaml.safe_load((tmp_path / "list.yaml").read_text())
    assert listing[v["expert_name"]]["num_transitions"] == 20
