"""The port's TD3, DDPG, SAC-V, discrete SAC and DQN
(ilswiss_tpu_torch/algorithms/) against the JAX package's
(ilswiss_tpu/algorithms/), the twin of tests/test_offpolicy_trainers.py:
the state carried across by utils/convert.py, `act` from replayed draws,
one `train_step` and three in a row from the same state, batches and
draws, and one warmup and one training iteration of `OffPolicyLoop`
(pendulum for the continuous trainers, cartpole for the discrete ones, 4
envs, 32-wide nets) from the JAX loop's carried-over runner with every
draw of the JAX iteration replayed, in the order the port draws it (a
draw out of that order fails).

Pins: rtol 2e-4, atol 2e-5 on states and metrics (tests/test_torch_sac.py's,
two float32 implementations of one update that sum in different orders);
forwards (actions) at rtol 1e-5, atol 1e-6; integer actions exactly.
DQN counts epsilon's steps as the env steps of training iterations where
the JAX package counts gradient steps (ROADMAP.md section 3): its
`n_act_steps` and `epsilon` are held to that rule, not to the JAX values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilswiss_tpu.algorithms.ddpg import DDPG as JDDPG
from ilswiss_tpu.algorithms.ddpg import DDPGConfig as JDDPGConfig
from ilswiss_tpu.algorithms.discrete_sac import DiscreteSAC as JDiscreteSAC
from ilswiss_tpu.algorithms.discrete_sac import (
    DiscreteSACConfig as JDiscreteSACConfig,
)
from ilswiss_tpu.algorithms.dqn import DQN as JDQN
from ilswiss_tpu.algorithms.dqn import DQNConfig as JDQNConfig
from ilswiss_tpu.algorithms.sac_v import SACV as JSACV
from ilswiss_tpu.algorithms.sac_v import SACVConfig as JSACVConfig
from ilswiss_tpu.algorithms.td3 import TD3 as JTD3
from ilswiss_tpu.algorithms.td3 import TD3Config as JTD3Config
from ilswiss_tpu.envs import make_vec as jmake_vec
from ilswiss_tpu.exploration import strategies as jstrat
from ilswiss_tpu.models import distributions as JD
from ilswiss_tpu.runtime.loop import OffPolicyConfig as JLoopConfig
from ilswiss_tpu.runtime.loop import OffPolicyLoop as JLoop
from ilswiss_tpu_torch.algorithms.ddpg import DDPG, DDPGConfig
from ilswiss_tpu_torch.algorithms.discrete_sac import (
    DiscreteSAC, DiscreteSACConfig,
)
from ilswiss_tpu_torch.algorithms.dqn import DQN, DQNConfig
from ilswiss_tpu_torch.algorithms.sac_v import SACV, SACVConfig
from ilswiss_tpu_torch.algorithms.td3 import TD3, TD3Config
from ilswiss_tpu_torch.envs import make_vec
from ilswiss_tpu_torch.exploration import strategies as strat
from ilswiss_tpu_torch.models import distributions as D
from ilswiss_tpu_torch.runtime.loop import (
    Noise, OffPolicyConfig, OffPolicyLoop, RunnerState,
)
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

PIN = dict(rtol=2e-4, atol=2e-5)
FWD = dict(rtol=1e-5, atol=1e-6)
OBS, ACT = 5, 2          # continuous trainers' unit cases
OBS_D, A_D = 4, 3        # discrete trainers' unit cases
H, B = 32, 16

# name: (JAX class, JAX config, port class, port config, config kwargs,
# discrete)
CASES = {
    "td3": (JTD3, JTD3Config, TD3, TD3Config,
            dict(reward_scale=2.0, discount=0.9, q_target_max=1.0,
                 policy_and_target_update_period=2), False),
    "td3_epsilon": (JTD3, JTD3Config, TD3, TD3Config,
                    dict(exploration_epsilon=0.5, exploration_noise=0.3),
                    False),
    "ddpg": (JDDPG, JDDPGConfig, DDPG, DDPGConfig,
             dict(reward_scale=2.0, max_q_value=1.0, policy_lr=1e-3),
             False),
    "ddpg_hard": (JDDPG, JDDPGConfig, DDPG, DDPGConfig,
                  dict(use_soft_update=False, target_update_period=2),
                  False),
    "sac_v": (JSACV, JSACVConfig, SACV, SACVConfig,
              dict(reward_scale=2.0, alpha=0.2, beta_1=0.5), False),
    "discrete_sac": (JDiscreteSAC, JDiscreteSACConfig, DiscreteSAC,
                     DiscreteSACConfig,
                     dict(alpha=0.3, beta_1=0.5, discount=0.95), True),
    "dqn": (JDQN, JDQNConfig, DQN, DQNConfig,
            dict(reward_scale=2.0, target_update_period=2,
                 epsilon_decay_steps=60), True),
    "dqn_single": (JDQN, JDQNConfig, DQN, DQNConfig,
                   dict(double_dqn=False, epsilon_decay_steps=60), True),
}


def _algos(name, obs=None, act=None, hidden=H):
    jcls, jcfg, pcls, pcfg, kw, discrete = CASES[name]
    obs = obs or (OBS_D if discrete else OBS)
    act = act or (A_D if discrete else ACT)
    nets = dict(net_size=hidden, num_hidden_layers=2)
    return (jcls(obs, act, jcfg(**kw), **nets),
            pcls(obs, act, pcfg(**kw), device="cpu", **nets))


def _batch(rng, discrete):
    obs, act = (OBS_D, A_D) if discrete else (OBS, ACT)
    return {
        "obs": rng.randn(B, obs).astype(np.float32),
        "action": (rng.randint(0, act, B).astype(np.int32) if discrete
                   else np.tanh(rng.randn(B, act)).astype(np.float32)),
        "reward": rng.randn(B).astype(np.float32),
        "next_obs": rng.randn(B, obs).astype(np.float32),
        "terminal": (rng.rand(B) < 0.2).astype(np.float32),
    }


def _step_draws(jalgo, key, batch_size):
    """The draws of one JAX `train_step` from its key, in the port's
    argument order: TD3's target smoothing and SAC-V's policy sample are
    one N(0, 1) [B, A] each; the others draw nothing."""
    if isinstance(jalgo, (JTD3, JSACV)):
        return [np.asarray(jax.random.normal(
            key, (batch_size, jalgo.action_size)))]
    return []


def _act_draws(jalgo, key, n):
    """The draws of one JAX stochastic `act` from its key, as the port's
    `act_noise` returns them: (kind, value) pairs."""
    if isinstance(jalgo, JDQN):
        k_eps, k_rand = jax.random.split(key)
        return [("flip", jax.random.uniform(k_eps, (n,))),
                ("random_index", jax.random.randint(
                    k_rand, (n,), 0, jalgo.num_actions))]
    if isinstance(jalgo, JDiscreteSAC):
        return [("gumbel", jax.random.gumbel(key, (n, jalgo.num_actions)))]
    shape = (n, jalgo.action_size)
    if isinstance(jalgo, JTD3) and jalgo.config.exploration_epsilon > 0:
        k_flip, k_rand, k_noise = jax.random.split(key, 3)
        return [("flip", jax.random.uniform(k_flip, ())),
                ("random_action", jax.random.uniform(
                    k_rand, shape, jnp.float32, -1.0, 1.0)),
                ("act", jax.random.normal(k_noise, shape))]
    return [("act", jax.random.normal(key, shape))]


def _jax_numpy(jstate, pstate):
    """The JAX state in `convert.offpolicy_state_to_numpy`'s layout."""
    s = jax.tree.map(np.asarray, jstate)
    modules, opts, counters = convert._LAYOUTS[type(pstate)]
    out = {f"{m}_params": getattr(s, f"{m}_params") for m in modules}
    for o in opts:
        adam = getattr(s, o)[0]
        out[o] = {"count": int(adam.count), "mu": adam.mu, "nu": adam.nu}
    out.update({c: int(getattr(s, c)) for c in counters})
    return out


def _close(got, want, pin, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _close(got[k], want[k], pin, f"{path}/{k}")
    elif isinstance(want, int):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **pin)


def _assert_state_close(pstate, jstate, pin=PIN, skip=()):
    got = convert.offpolicy_state_to_numpy(pstate)
    want = _jax_numpy(jstate, pstate)
    for k in skip:
        got.pop(k), want.pop(k)
    _close(got, want, pin)


# --- the JAX references, computed once ------------------------------------
@pytest.fixture(scope="module")
def unit_runs():
    """Per case: the JAX init state, three batches, the per-step draws,
    the states after 1, 2 and 3 `train_step`s and their metrics."""
    out = {}
    for name in CASES:
        jalgo, _ = _algos(name)
        discrete = CASES[name][5]
        jstate = jalgo.init(jax.random.PRNGKey(0))
        if isinstance(jalgo, JDQN):     # epsilon away from its ends
            jstate = jstate.replace(n_act_steps=jnp.asarray(30, jnp.int32))
        rng = np.random.RandomState(1)
        batches = [_batch(rng, discrete) for _ in range(3)]
        keys = jax.random.split(jax.random.PRNGKey(7), 3)
        step = jax.jit(jalgo.train_step)
        states, metrics, draws = [jstate], [], []
        for b, k in zip(batches, keys):
            draws.append(_step_draws(jalgo, k, B))
            s, m = step(states[-1], {n: jnp.asarray(v) for n, v in b.items()},
                        k)
            states.append(s)
            metrics.append(jax.tree.map(np.asarray, m))
        out[name] = dict(states=states, metrics=metrics, batches=batches,
                         draws=draws)
    return out


@pytest.mark.parametrize("name", CASES)
def test_bridge_round_trip(unit_runs, name):
    jalgo, algo = _algos(name)
    jstate = unit_runs[name]["states"][1]
    state = convert.offpolicy_state_from_jax(algo, jax.tree.map(np.asarray,
                                                                jstate))
    _assert_state_close(state, jstate, dict(rtol=0, atol=0))
    # the named bridge of each trainer is this one
    short = name.split("_")[0] if name not in ("sac_v", "discrete_sac") \
        else name
    assert getattr(convert, f"{short}_state_from_jax") is \
        convert.offpolicy_state_from_jax


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_jax(unit_runs, name, n_steps):
    run = unit_runs[name]
    jalgo, algo = _algos(name)
    state = convert.offpolicy_state_from_jax(
        algo, jax.tree.map(np.asarray, run["states"][0]))
    for i in range(n_steps):
        batch = convert.batches_from_numpy(run["batches"][i], "cpu")
        state, metrics = algo.train_step(
            state, batch, *[torch.as_tensor(np.array(d))
                            for d in run["draws"][i]])
        want = dict(run["metrics"][i])
        assert set(metrics) == set(want)
        if isinstance(algo, DQN):
            # the port's epsilon does not move with gradient steps; the
            # JAX one's first step reads the same count
            assert float(metrics.pop("epsilon")) == pytest.approx(
                float(run["metrics"][0]["epsilon"]), rel=1e-7)
            want.pop("epsilon")
        for k, v in want.items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       err_msg=k, **PIN)
    jstate = run["states"][n_steps]
    skip = ("n_act_steps",) if isinstance(algo, DQN) else ()
    _assert_state_close(state, jstate, skip=skip)
    if isinstance(algo, DQN):
        assert state.n_act_steps == 30
        assert int(jstate.n_act_steps) == 30 + n_steps


def test_td3_delays_the_policy_and_targets(unit_runs):
    """Three steps at period 2: the policy, its Adam and the three targets
    move at steps 0 and 2 (the count before the increment), the critics at
    every step, and the policy loss is reported at every step."""
    run = unit_runs["td3"]
    _, algo = _algos("td3")
    state = convert.offpolicy_state_from_jax(
        algo, jax.tree.map(np.asarray, run["states"][0]))
    moved = []
    for i in range(3):
        before = [p.detach().clone() for p in state.target_qf1.parameters()]
        policy = [p.detach().clone() for p in state.policy.parameters()]
        state, metrics = algo.train_step(
            state, convert.batches_from_numpy(run["batches"][i], "cpu"),
            torch.as_tensor(np.array(run["draws"][i][0])))
        moved.append((
            any(not torch.equal(a, b) for a, b in zip(
                policy, state.policy.parameters())),
            any(not torch.equal(a, b) for a, b in zip(
                before, state.target_qf1.parameters()))))
        assert torch.isfinite(metrics["policy_loss"])
    assert moved == [(True, True), (False, False), (True, True)]
    assert state.policy_opt.count == 2 and state.qf1_opt.count == 3
    assert state.n_train_steps == 3


def test_td3_delayed_update():
    """JAX tests/test_offpolicy_trainers.py::test_td3_delayed_update on the
    port: step 0 (counter 0) updates the policy, step 1 leaves it.  The
    JAX test reads the first leaf, hidden_0's bias (the inputs are zero,
    so the kernel gets no gradient)."""
    td3 = TD3(3, 1, TD3Config(policy_and_target_update_period=2),
              net_size=16, num_hidden_layers=1, device="cpu")
    state = td3.init(0)
    batch = {"obs": torch.zeros(8, 3), "action": torch.zeros(8, 1),
             "reward": torch.ones(8), "terminal": torch.zeros(8),
             "next_obs": torch.zeros(8, 3)}
    eps = torch.randn(8, 1, generator=torch.Generator().manual_seed(1))
    p0 = state.policy.mlp.hidden_0.bias.detach().clone()
    state, _ = td3.train_step(state, batch, eps)
    p1 = state.policy.mlp.hidden_0.bias.detach().clone()
    assert not torch.allclose(p0, p1)
    state, _ = td3.train_step(state, batch, eps)
    assert torch.equal(p1, state.policy.mlp.hidden_0.bias)


def test_dqn_epsilon_decay():
    """JAX tests/test_offpolicy_trainers.py::test_dqn_epsilon_decay on the
    port, and the count: `note_env_steps`, never a gradient step."""
    dqn = DQN(4, 2, DQNConfig(epsilon_start=1.0, epsilon_end=0.1,
                              epsilon_decay_steps=100), net_size=16,
              num_hidden_layers=1, device="cpu")
    state = dqn.init(0)
    assert dqn.epsilon(state) == 1.0
    state.n_act_steps = 100
    np.testing.assert_allclose(dqn.epsilon(state), 0.1, rtol=1e-5)
    dqn.note_env_steps(state, 16)
    assert state.n_act_steps == 116 and dqn.epsilon(state) == \
        pytest.approx(0.1)


@pytest.mark.parametrize("name", CASES)
def test_act_matches_jax(unit_runs, name):
    """Stochastic acting from the JAX act's own draws (several keys, so
    TD3's epsilon explorer takes both branches and DQN's both arms), and
    deterministic acting; discrete actions exactly."""
    jalgo, algo = _algos(name)
    jstate = unit_runs[name]["states"][1]
    state = convert.offpolicy_state_from_jax(algo, jax.tree.map(np.asarray,
                                                                jstate))
    n = 6
    obs = np.random.RandomState(3).randn(n, algo.obs_size).astype(
        np.float32)
    act = jax.jit(jalgo.act, static_argnames="deterministic")
    branches = set()
    for key in jax.random.split(jax.random.PRNGKey(4), 6):
        draws = _act_draws(jalgo, key, n)
        want = np.asarray(act(jstate, jnp.asarray(obs), key))
        got = algo.act(state, torch.as_tensor(obs),
                       *[torch.as_tensor(np.asarray(v)) for _, v in draws])
        if CASES[name][5]:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, **FWD)
        if name == "td3_epsilon":
            branches.add(bool(float(draws[0][1]) < 0.5))
        if isinstance(algo, DQN):
            branches.update(np.asarray(draws[0][1]) < algo.epsilon(state))
    if name == "td3_epsilon" or isinstance(algo, DQN):
        assert branches == {True, False}
    want = np.asarray(act(jstate, jnp.asarray(obs), key, deterministic=True))
    got = algo.act(state, torch.as_tensor(obs), deterministic=True)
    if CASES[name][5]:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **FWD)


# --- one warmup and one training iteration of the loop ----------------------
N_ENVS, LOOP_BATCH, K, WARMUP = 4, 16, 4, 16
LOOP_CASES = ["td3", "ddpg", "sac_v", "discrete_sac", "dqn"]


class _Draws:
    """The port's `Noise` methods, answering each call with the next of
    the JAX draws; a call out of the JAX order fails."""

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
        # warmup_action, warmup_index, act, replay, smoothing, sample,
        # gumbel, flip, random_index, random_action
        if kind not in vars(Noise):
            raise AttributeError(kind)
        return lambda *args: self._pop(kind)


def _reset_draws(env_name, rngs):
    """The reset draws of one JAX `VectorEnv.step` (vector.py:95-99, then
    base.py `reset`, then the env's `_reset`) from the per-env keys."""
    draws = []
    for key in rngs:
        _, carry = jax.random.split(key)              # Environment.step
        reset_key = jax.random.split(carry)[1]        # VectorEnv.step
        k_reset, _ = jax.random.split(reset_key)      # Environment.reset
        if env_name == "pendulum":
            k1, k2 = jax.random.split(k_reset)
            draws.append((jax.random.uniform(k1, (), minval=-jnp.pi,
                                             maxval=jnp.pi),
                          jax.random.uniform(k2, (), minval=-1.0,
                                             maxval=1.0)))
        else:
            draws.append((jax.random.uniform(k_reset, (4,), minval=-0.05,
                                             maxval=0.05),))
    return ("reset", tuple(np.stack([np.asarray(d[i]) for d in draws])
                           for i in range(len(draws[0]))))


def _iteration_draws(jloop, jrunner, env_name, warmup):
    """Every draw of one JAX `_collect_iter` (warmup) or `_train_iter`
    (loop.py:98-187) from the runner's keys, in the port's order."""
    jalgo, env = jloop.algo, jloop.vec_env.env
    rng, k_act = jax.random.split(jrunner.rng)
    if warmup and env.discrete:
        seq = [("warmup_index", jax.random.randint(
            k_act, (N_ENVS,), 0, env.action_size))]
    elif warmup:
        seq = [("warmup_action", jax.random.uniform(
            k_act, (N_ENVS, env.action_size), minval=-1.0, maxval=1.0))]
    else:
        seq = _act_draws(jalgo, k_act, N_ENVS)
    seq.append(_reset_draws(env_name, jrunner.env_state.rng))
    if not warmup:
        _, k_steps = jax.random.split(rng)
        for key in jax.random.split(k_steps, K):
            k_samp, k_train = jax.random.split(key)
            seq.append(("replay", jax.random.uniform(k_samp, (LOOP_BATCH,))))
            kind = "smoothing" if isinstance(jalgo, JTD3) else "sample"
            seq += [(kind, d) for d in _step_draws(jalgo, k_train,
                                                   LOOP_BATCH)]
    return [(k, v if isinstance(v, tuple) else np.asarray(v))
            for k, v in seq]


def _port_runner(loop, snapshot, draws):
    return RunnerState(
        noise=_Draws(draws),
        env_state=convert.env_state_from_jax(snapshot.env_state, "cpu"),
        replay=convert.replay_from_jax(snapshot.replay, "cpu"),
        algo_state=convert.offpolicy_state_from_jax(loop.algo,
                                                    snapshot.algo_state),
        total_env_steps=int(snapshot.total_env_steps))


def _assert_runner_close(runner, jrunner, pin=PIN):
    jr = jax.tree.map(np.asarray, jrunner)
    assert runner.total_env_steps == int(jr.total_env_steps)
    assert not runner.noise.seq, "draws left over"
    got = convert.env_state_to_numpy(runner.env_state)
    np.testing.assert_allclose(got["internal"][0], jr.env_state.internal,
                               **pin)
    np.testing.assert_allclose(got["obs"], jr.env_state.obs, **pin)
    np.testing.assert_array_equal(got["t"], jr.env_state.t)
    rep = convert.replay_to_numpy(runner.replay)
    assert (rep["ptr"], rep["size"]) == (int(jr.replay.ptr),
                                         int(jr.replay.size))
    np.testing.assert_array_equal(rep["ep_id"], jr.replay.ep_id)
    np.testing.assert_array_equal(rep["env_ep"], jr.replay.env_ep)
    for k, v in jr.replay.data.items():
        assert rep["data"][k].dtype == v.dtype, k
        if v.dtype == np.int32:
            np.testing.assert_array_equal(rep["data"][k], v, err_msg=k)
        else:
            np.testing.assert_allclose(rep["data"][k], v, err_msg=k, **pin)


@pytest.mark.parametrize("name", LOOP_CASES)
def test_loop_iterations_match_jax(name):
    discrete = CASES[name][5]
    env_name = "cartpole" if discrete else "pendulum"
    jvec = jmake_vec(env_name, num_envs=N_ENVS)
    jalgo, algo = _algos(name, jvec.env.observation_size,
                         jvec.env.action_size)
    jloop = JLoop(jvec, jalgo, JLoopConfig(
        batch_size=LOOP_BATCH, replay_capacity=64,
        min_steps_before_training=WARMUP, grad_steps_per_iter=K))
    loop = OffPolicyLoop(make_vec(env_name, N_ENVS, device="cpu"), algo,
                         OffPolicyConfig(batch_size=LOOP_BATCH,
                                         replay_capacity=64,
                                         min_steps_before_training=WARMUP,
                                         grad_steps_per_iter=K))
    collect = jax.jit(lambda r: jloop._collect_iter(r, random_actions=True))
    jrunner = jloop.init(jax.random.PRNGKey(0))

    # one warmup iteration
    snapshot = jax.tree.map(np.asarray, jrunner)
    runner = _port_runner(loop, snapshot, _iteration_draws(
        jloop, snapshot, env_name, warmup=True))
    runner = loop._collect_iter(runner, random_actions=True)
    jrunner = collect(jrunner)
    _assert_runner_close(runner, jrunner, dict(rtol=1e-6, atol=1e-6))
    for _ in range(WARMUP // N_ENVS - 1):
        jrunner = collect(jrunner)

    # one training iteration (DQN: epsilon away from its ends, and K =
    # num_envs, where both packages count the same steps)
    if discrete and name == "dqn":
        jrunner = jrunner.replace(algo_state=jrunner.algo_state.replace(
            n_act_steps=jnp.asarray(30, jnp.int32)))
    snapshot = jax.tree.map(np.asarray, jrunner)
    runner = _port_runner(loop, snapshot, _iteration_draws(
        jloop, snapshot, env_name, warmup=False))
    runner, metrics = loop.train_epoch(runner, steps_per_epoch=N_ENVS)
    jnext, jmetrics = jax.jit(jloop._train_iter)(jrunner)
    _assert_runner_close(runner, jnext)
    _assert_state_close(runner.algo_state, jnext.algo_state)
    want = {k: float(v) for k, v in jmetrics.items()}
    assert set(metrics) == set(want)
    if isinstance(algo, DQN):
        # the iteration's acting epsilon, at the count it started from
        assert metrics.pop("epsilon") == pytest.approx(
            float(jalgo.epsilon(snapshot.algo_state)))
        want.pop("epsilon")
        assert runner.algo_state.n_act_steps == 30 + N_ENVS
    for k, v in want.items():
        np.testing.assert_allclose(metrics[k], v, err_msg=k, **PIN)


def test_fault_dqn_epsilon_counts_env_steps():
    """Reference fault: the JAX DQN counts epsilon's steps per gradient
    step (dqn.py:143-145), so at fewer gradient steps than envs an
    iteration its epsilon decays too slowly.  Here 4 envs, K = 2: after 4
    training iterations (16 env steps) the port, which counts env steps,
    reaches its end value at epsilon_decay_steps 16, the JAX loop is
    halfway.  At exp_specs/dqn/dqn_cartpole.yaml's schedule (16 envs, K =
    8, 250 iterations an epoch, 20 epochs) the port counts 80,000 steps
    and ends at 0.05, the JAX package 40,000 and ends at 0.24."""
    cfg = dict(epsilon_decay_steps=16)
    jvec = jmake_vec("cartpole", num_envs=4)
    jdqn = JDQN(4, 2, JDQNConfig(**cfg), net_size=16, num_hidden_layers=1)
    jloop = JLoop(jvec, jdqn, JLoopConfig(
        batch_size=8, replay_capacity=64, min_steps_before_training=8,
        grad_steps_per_iter=2))
    warmup, epoch = jloop.build(steps_per_epoch=16)
    jrunner, _ = epoch(warmup(jloop.init(jax.random.PRNGKey(0))))
    dqn = DQN(4, 2, DQNConfig(**cfg), net_size=16, num_hidden_layers=1,
              device="cpu")
    loop = OffPolicyLoop(make_vec("cartpole", 4, device="cpu"), dqn,
                         OffPolicyConfig(batch_size=8, replay_capacity=64,
                                         min_steps_before_training=8,
                                         grad_steps_per_iter=2))
    runner, metrics = loop.train_epoch(loop.warmup(loop.init(0)), 16)
    assert int(jrunner.algo_state.n_act_steps) == 8
    assert float(jdqn.epsilon(jrunner.algo_state)) == pytest.approx(0.525)
    assert runner.algo_state.n_act_steps == 16
    assert dqn.epsilon(runner.algo_state) == pytest.approx(0.05)
    # the spec's schedule, through each package's own epsilon
    jstate = jdqn.init(jax.random.PRNGKey(0))
    spec = dict(envs=16, k=8, iters=250, epochs=20)
    big = DQN(4, 2, DQNConfig(), device="cpu")
    jbig = JDQN(4, 2, JDQNConfig())
    total = spec["iters"] * spec["epochs"]
    jeps = float(jbig.epsilon(jstate.replace(
        n_act_steps=jnp.asarray(total * spec["k"], jnp.int32))))
    state = big.init(0)
    big.note_env_steps(state, total * spec["envs"])
    assert jeps == pytest.approx(0.24) and big.epsilon(state) == \
        pytest.approx(0.05)


def test_draws_replay_in_order_and_fail_out_of_order():
    """The replayed-draw helper this file relies on refuses a draw of the
    wrong kind, so a port that drew in another order than the JAX keys
    would fail the loop tests."""
    d = _Draws([("flip", np.zeros(2)), ("random_index", np.zeros(2))])
    with pytest.raises(AssertionError, match="drew random_index"):
        d.random_index((2,), 2)
    d = _Draws([("flip", np.zeros(2))])
    assert d.flip((2,)).shape == (2,)
    with pytest.raises(AttributeError):
        d.no_such_draw


def test_configs_match_jax_fields():
    """Every port config has the JAX config's fields and defaults."""
    for name in ("td3", "ddpg", "sac_v", "discrete_sac", "dqn"):
        _, jcfg, _, pcfg, _, _ = CASES[name]
        want = {f.name: f.default for f in dataclasses.fields(jcfg)}
        got = {f.name: f.default for f in dataclasses.fields(pcfg)}
        assert set(got) == set(want), name
        for k, v in want.items():
            assert float(got[k]) == float(v), (name, k)


def test_strategies_and_categorical_match_jax():
    """exploration/strategies.py and the categorical functions of
    models/distributions.py against the JAX functions, from the draws the
    JAX functions make from their keys (forward pin; integers exactly)."""
    T = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    shape = (6, 2)
    # Ornstein-Uhlenbeck, three steps with the state carried
    jst, st = jstrat.ou_init(shape), strat.ou_init(shape)
    for k in keys[:3]:
        want, jst = jstrat.ou_noise(jst, k, theta=0.2, sigma=0.4, mu=0.1)
        got, st = strat.ou_noise(st, T(jax.random.normal(k, shape)),
                                 theta=0.2, sigma=0.4, mu=0.1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    action = np.tanh(np.random.RandomState(2).randn(*shape)).astype(
        np.float32)
    a, t = jnp.asarray(action), jnp.asarray(4)
    # Gaussian noise with its linear sigma decay
    want = jstrat.gaussian_noise(a, keys[0], sigma=0.5, min_sigma=0.1,
                                 decay_period=10, t=t)
    got = strat.gaussian_noise(T(action), T(jax.random.normal(keys[0], shape)),
                               sigma=0.5, min_sigma=0.1, decay_period=10,
                               t=torch.tensor(4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    # epsilon-greedy: the flip and the random action of the JAX keys
    greedy = jnp.asarray([0, 1, 2, 0, 1, 2])
    want = jstrat.epsilon_greedy(greedy, keys[1], 3, 0.5)
    k_flip, k_rand = jax.random.split(keys[1])
    got = strat.epsilon_greedy(T(greedy), T(jax.random.uniform(k_flip, (6,))),
                               T(jax.random.randint(k_rand, (6,), 0, 3)), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Gaussian-and-epsilon with a decaying sigma, both branches
    seen = set()
    for k in keys:
        want = jstrat.gaussian_and_epsilon(a, k, epsilon=0.5, sigma=0.3,
                                           min_sigma=0.1, decay_period=8, t=t)
        k_flip, k_rand, k_noise = jax.random.split(k, 3)
        flip = jax.random.uniform(k_flip, ())
        got = strat.gaussian_and_epsilon(
            T(action), T(flip),
            T(jax.random.uniform(k_rand, shape, jnp.float32, -1.0, 1.0)),
            T(jax.random.normal(k_noise, shape)), epsilon=0.5, sigma=0.3,
            min_sigma=0.1, decay_period=8, t=torch.tensor(4))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
        seen.add(bool(flip < 0.5))
    assert seen == {True, False}
    # categorical: Gumbel-max sample, log-prob, entropy
    logits = jnp.asarray(np.random.RandomState(3).randn(6, 4), jnp.float32)
    want = jax.random.categorical(keys[2], logits)
    got = D.categorical_sample(T(logits), T(jax.random.gumbel(keys[2],
                                                              (6, 4))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        D.categorical_log_prob(T(logits), got).numpy(),
        np.asarray(JD.categorical_log_prob(logits, want)), **FWD)
    np.testing.assert_allclose(D.categorical_entropy(T(logits)).numpy(),
                               np.asarray(JD.categorical_entropy(logits)),
                               **FWD)
