"""Goal-conditioned learning in the port (ilswiss_tpu_torch/envs/goal.py,
the dict observations of envs/vector.py and runtime/evaluator.py,
envs/wrappers.py's DiscretEnv, data/her.py, algorithms/her.py,
algorithms/gcsl.py and the her and gcsl launchers) against the JAX
package's, the twin of tests/test_her.py and tests/test_gcsl_dagger.py's
GCSL cases: GoalReach2D's reset, step, reward and termination, the vec
env and the evaluator on dict observations with every JAX reset draw
replayed, DiscretEnv's action table, the hindsight ring's bookkeeping over
more than K episodes an env and its sampled batches (future, final, no
relabeling, the horizons, discrete actions), `HER.train_step` over SAC and
over TD3, `GCSL.train_step` in each mode and its `act` at `eval_horizon`,
one warmup and one epoch of `HERLoop` and `GCSLLoop` from the JAX runner
with every draw replayed in order, and the three reach2d specs through the
CLI in a process without JAX.

Pins (tests/test_torch_offpolicy_trainers.py's): forwards at rtol 1e-5,
atol 1e-6; updates, and the env rows of rollouts, at rtol 2e-4, atol
2e-5; the hindsight ring filled with identical transitions, its
bookkeeping and its sampled batches exactly (rtol = atol = 0).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ilswiss_tpu.algorithms.gcsl import GCSL as JGCSL
from ilswiss_tpu.algorithms.gcsl import GCSLConfig as JGCSLConfig
from ilswiss_tpu.algorithms.gcsl import GCSLLoop as JGCSLLoop
from ilswiss_tpu.algorithms.her import HER as JHER
from ilswiss_tpu.algorithms.her import HERLoop as JHERLoop
from ilswiss_tpu.algorithms.her import HERLoopConfig as JHERLoopConfig
from ilswiss_tpu.algorithms.sac import SAC as JSAC
from ilswiss_tpu.algorithms.sac import SACConfig as JSACConfig
from ilswiss_tpu.algorithms.td3 import TD3 as JTD3
from ilswiss_tpu.algorithms.td3 import TD3Config as JTD3Config
from ilswiss_tpu.data.her import HindsightReplayBuffer as JBuffer
from ilswiss_tpu.envs import make as jmake
from ilswiss_tpu.envs import make_vec as jmake_vec
from ilswiss_tpu.envs.vector import Transition as JTransition
from ilswiss_tpu.envs.vector import VectorEnv as JVectorEnv
from ilswiss_tpu.envs.wrappers import DiscretEnv as JDiscretEnv
from ilswiss_tpu.runtime.evaluator import make_evaluator as jmake_evaluator
from ilswiss_tpu_torch.algorithms.gcsl import GCSL, GCSLConfig, GCSLLoop
from ilswiss_tpu_torch.algorithms.her import (
    HER, HERLoop, HERLoopConfig, HERRunnerState, goal_concat,
)
from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.algorithms.td3 import TD3, TD3Config
from ilswiss_tpu_torch.data.her import HindsightReplayBuffer
from ilswiss_tpu_torch.envs import make, make_vec
from ilswiss_tpu_torch.envs.vector import Transition, VectorEnv
from ilswiss_tpu_torch.envs.wrappers import DiscretEnv
from ilswiss_tpu_torch.launchers import experiments as pexp
from ilswiss_tpu_torch.runtime.evaluator import make_evaluator
from ilswiss_tpu_torch.runtime.loop import Noise
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PIN = dict(rtol=2e-4, atol=2e-5)
FWD = dict(rtol=1e-5, atol=1e-6)
EXACT = dict(rtol=0, atol=0)
NB, EPL, H, BS = 4, 6, 32, 16   # envs, episode horizon, width, batch


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


# --- the JAX draws ----------------------------------------------------------
def _reach_reset(k_reset):
    """The draws of the JAX reach2d `_reset(k_reset)`."""
    k1, k2 = jax.random.split(k_reset)
    return (jax.random.uniform(k1, (2,), minval=-1.0, maxval=1.0),
            jax.random.uniform(k2, (2,), minval=-1.0, maxval=1.0))


@jax.jit
def _initial_reset_draws(key):
    n = NB
    return jax.vmap(lambda k: _reach_reset(jax.random.split(k)[0]))(
        jax.random.split(key, n))


@jax.jit
def _step_reset_draws(rngs):
    def one(key):
        _, carry = jax.random.split(key)
        k_reset, _ = jax.random.split(jax.random.split(carry)[1])
        return _reach_reset(k_reset)
    return jax.vmap(one)(rngs)


def _reset(draws):
    return ("reset", tuple(np.asarray(d) for d in draws))


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
            return tuple(T(v) for v in value)
        return T(value)

    def reset(self, env, n):
        return self._pop("reset")

    def __getattr__(self, kind):
        if kind not in vars(Noise):
            raise AttributeError(kind)
        return lambda *args: self._pop(kind)


def _close(got, want, pin, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _close(got[k], want[k], pin, f"{path}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, pin, f"{path}[{i}]")
    elif isinstance(want, int):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **pin)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --- 1. the goal env, the vec env and the evaluator on dict obs ------------
def test_goal_env_reset_step_reward_and_termination_match_jax():
    jenv, env = jmake("reach2d"), make("reach2d", device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    want = [jenv._reset(k) for k in keys]
    draws = [_reach_reset(k) for k in keys]
    internal, obs = env._reset(tuple(
        T(np.stack([np.asarray(d[i]) for d in draws])) for i in range(2)))
    _close([x.numpy() for x in internal],
           [np.stack([np.asarray(w[0][i]) for w in want]) for i in range(2)],
           EXACT)
    _close({k: v.numpy() for k, v in obs.items()},
           {k: np.stack([np.asarray(w[1][k]) for w in want])
            for k in want[0][1]}, EXACT)
    # env 0 lands on its goal (success: reward 0, terminal), env 1 hits
    # the wall, the others move freely
    pv = np.array([[0.5, 0.5, 0, 0], [0.98, 0.0, 0, 0], [0, 0, 0, 0],
                   [-0.3, 0.2, 0, 0], [0.1, -0.9, 0, 0]], np.float32)
    goal = np.array([[0.55, 0.52], [0.0, 0.0], [0.5, 0.5], [0.9, 0.9],
                     [-0.5, 0.5]], np.float32)
    act = np.array([[0.5, 0.2], [0.9, 0.1], [1.5, -2.0], [0.3, 0.3],
                    [-0.2, 0.7]], np.float32)
    step = jax.jit(lambda i, a: jenv._step(i, a, None))
    want = [step((jnp.asarray(pv[i]), jnp.asarray(goal[i])),
                 jnp.asarray(act[i])) for i in range(5)]
    (pv2, g2), obs2, reward, terminal = env._step((T(pv), T(goal)), T(act))
    np.testing.assert_allclose(
        pv2.numpy(), np.stack([np.asarray(w[0][0]) for w in want]), **FWD)
    np.testing.assert_array_equal(g2.numpy(), goal)
    np.testing.assert_array_equal(
        reward.numpy(), np.stack([np.asarray(w[2]) for w in want]))
    np.testing.assert_array_equal(
        terminal.numpy(), np.stack([np.asarray(w[3]) for w in want]))
    assert terminal.tolist() == [True, False, False, False, False]
    assert float(pv2[1, 0]) == 1.0                   # the wall
    assert set(obs2) == {"observation", "achieved_goal", "desired_goal"}
    # compute_reward on its own (tests/test_her.py's cases)
    assert float(env.compute_reward(T([[0.0, 0.0]]), T([[0.0, 0.01]]))) == 0
    assert float(env.compute_reward(T([[0.0, 0.0]]), T([[1.0, 1.0]]))) == -1


def test_vec_env_and_evaluator_on_dict_obs_match_jax():
    """The vec env's autoreset maps over the obs dict; the evaluator runs
    on it.  A policy heading for the goal, so episodes end by success and
    by truncation, every JAX reset draw replayed."""
    jvec = jmake_vec("reach2d", num_envs=NB, max_episode_steps=EPL)
    vec = make_vec("reach2d", NB, device="cpu", max_episode_steps=EPL)

    def jact(s, o, k=None):
        return jnp.clip(8.0 * (o["desired_goal"] - o["achieved_goal"]),
                        -1.0, 1.0)

    def act(s, o):
        return torch.clamp(8.0 * (o["desired_goal"] - o["achieved_goal"]),
                           -1.0, 1.0)

    key = jax.random.PRNGKey(4)
    k_reset, _ = jax.random.split(key)
    seq = [_reset(_initial_reset_draws(k_reset))]
    jstate = jvec.reset(k_reset)
    state = vec.reset(_Draws(seq[:1]).reset(None, NB))
    step = jax.jit(lambda s: jvec.step(s, jact(None, s.obs)))
    ended = 0
    for _ in range(3 * EPL):
        draws = _reset(_step_reset_draws(jstate.rng))
        seq.append(draws)
        jstate, jtr = step(jstate)
        state, tr = vec.step(state, act(None, state.obs),
                             _Draws([draws]).reset(None, NB))
        _close(convert.env_state_to_numpy(state)["obs"], _np(jstate.obs),
               PIN)
        _close({k: v.numpy() for k, v in tr.next_obs.items()},
               _np(jtr.next_obs), PIN)
        np.testing.assert_array_equal(state.t.numpy(), np.asarray(jstate.t))
        np.testing.assert_array_equal(tr.terminal.numpy(),
                                      np.asarray(jtr.terminal))
        ended += int(tr.terminal.sum())
    assert ended > 0       # some episodes end by success

    jstats = jmake_evaluator(jvec, jact, 2 * EPL)(None, key)
    stats = make_evaluator(vec, act, 2 * EPL)(None, _Draws(seq[:2 * EPL + 1]))
    _close(stats, {k: float(v) for k, v in jstats.items()}, PIN)
    assert stats["AvgPathLength"] < EPL


def test_discret_env_table_and_step_match_jax():
    jenv = JDiscretEnv(jmake("reach2d"), granularity=5)
    env = DiscretEnv(make("reach2d", device="cpu"), granularity=5)
    np.testing.assert_array_equal(env.base_actions.numpy(),
                                  np.asarray(jenv.base_actions))
    assert env.action_size == jenv.action_size == 25 and env.discrete
    assert env.goal_size == 2 and env.compute_reward is not None
    idx = np.array([0, 7, 12, 24], np.int32)
    np.testing.assert_array_equal(env.scale_action(T(idx)).numpy(), idx)
    jvec = JVectorEnv(jenv, 4)
    vec = VectorEnv(env, 4)
    key = jax.random.PRNGKey(2)
    jstate = jvec.reset(key)
    state = vec.reset(_Draws([_reset(_initial_reset_draws(key))])
                      .reset(None, 4))
    draws = _Draws([_reset(_step_reset_draws(jstate.rng))])
    jstate, jtr = jvec.step(jstate, jnp.asarray(idx))
    state, tr = vec.step(state, T(idx), draws.reset(None, 4))
    _close({k: v.numpy() for k, v in tr.next_obs.items()},
           _np(jtr.next_obs), FWD)
    # an explicit 1-D table
    j1 = JDiscretEnv(jmake("pendulum"), possible_actions=[-1.0, 0.0, 1.0])
    p1 = DiscretEnv(make("pendulum", device="cpu"),
                    possible_actions=[-1.0, 0.0, 1.0])
    np.testing.assert_array_equal(p1.base_actions.numpy(),
                                  np.asarray(j1.base_actions))
    assert not hasattr(p1, "goal_size")


# --- 2. the hindsight ring --------------------------------------------------
KSLOTS = 3


def _transitions(rng, n_steps, discrete):
    """Identical dict-obs transitions for both rings: episodes of 1 to
    EPL steps (ended by a terminal or the horizon), so each env completes
    more than KSLOTS episodes and slots are recycled."""
    t = np.zeros(NB, int)
    out = []
    for _ in range(n_steps):
        obs = {"observation": rng.randn(NB, 4), "achieved_goal":
               rng.randn(NB, 2), "desired_goal": rng.randn(NB, 2)}
        nxt = {"observation": rng.randn(NB, 4), "achieved_goal":
               np.where(rng.rand(NB, 1) < 0.3, obs["desired_goal"],
                        rng.randn(NB, 2))}
        terminal = rng.rand(NB) < 0.15
        done = terminal | (t + 1 >= EPL) | (rng.rand(NB) < 0.15)
        t = np.where(done, 0, t + 1)
        action = (rng.randint(0, 9, NB).astype(np.int32) if discrete
                  else rng.uniform(-1, 1, (NB, 2)))
        f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa: E731
        out.append(dict(obs=f32(obs), next_obs=f32(nxt),
                        action=np.asarray(action).astype(
                            np.int32 if discrete else np.float32),
                        reward=rng.randn(NB).astype(np.float32),
                        terminal=terminal, done=done))
    return out


def _fill(jbuf, buf, trs):
    jstate, state = jbuf.init(), buf.init()
    jadd = jax.jit(jbuf.add)
    for tr in trs:
        jstate = jadd(jstate, JTransition(**jax.tree.map(jnp.asarray, tr)))
        buf.add(state, Transition(
            obs={k: T(v) for k, v in tr["obs"].items()},
            next_obs={k: T(v) for k, v in tr["next_obs"].items()},
            action=T(tr["action"]), reward=T(tr["reward"]),
            terminal=T(tr["terminal"]), done=T(tr["done"])))
    return jstate, state


def _hindsight_draws(key, bs):
    k_env, k_ep, k_t, k_fut = jax.random.split(key, 4)
    return (np.asarray(jax.random.randint(k_env, (bs,), 0, NB)),
            *(np.asarray(jax.random.uniform(k, (bs,)))
              for k in (k_ep, k_t, k_fut)))


@pytest.mark.parametrize("relabel,ratio,discrete,horizon", [
    ("future", 0.8, False, False), ("final", 0.5, False, True),
    ("future", 1.0, True, True), (None, 0.8, False, False)])
def test_hindsight_ring_and_batches_match_jax(relabel, ratio, discrete,
                                              horizon):
    jenv, env = jmake("reach2d"), make("reach2d", device="cpu")
    if discrete:
        jenv = JDiscretEnv(jenv, granularity=3)
        env = DiscretEnv(env, granularity=3)
    args = (NB, NB * KSLOTS, EPL)
    jbuf = JBuffer(jenv, *args, relabel_type=relabel, her_ratio=ratio)
    buf = HindsightReplayBuffer(env, *args, relabel_type=relabel,
                                her_ratio=ratio)
    trs = _transitions(np.random.RandomState(0), 40, discrete)
    jstate, state = _fill(jbuf, buf, trs)
    _close(convert.hindsight_to_numpy(state),
           {"data": _np(jstate.data), "ep_len": np.asarray(jstate.ep_len),
            "cur_slot": np.asarray(jstate.cur_slot),
            "cur_t": np.asarray(jstate.cur_t),
            "completed": np.asarray(jstate.completed)}, EXACT)
    # more than K episodes an env: slots recycled, the claimed one invalid
    assert (state.completed.numpy() > KSLOTS).all()
    assert (state.ep_len[state.cur_slot.long()] == 0).all()
    if discrete:
        assert state.data["action"].dtype == torch.int32
    sample = jax.jit(lambda s, k: jbuf.sample(s, k, 64,
                                              return_horizon=horizon))
    for key in jax.random.split(jax.random.PRNGKey(5), 3):
        want = _np(sample(jstate, key))
        got = buf.sample(state, tuple(T(d) for d in _hindsight_draws(key,
                                                                     64)),
                         64, return_horizon=horizon)
        _close({k: v.numpy() for k, v in got.items()}, want, EXACT)
        assert ("horizon" in got) == horizon
    if relabel is not None:
        # the relabeled rows' rewards follow their new goals
        assert (got["reward"] == env.compute_reward(
            got["next_achieved_goal"], got["desired_goal"])).all()


# --- 3. the trainers ------------------------------------------------------
def _her_batch(rng, bs=BS):
    return {"observation": rng.randn(bs, 4), "achieved_goal":
            rng.randn(bs, 2), "desired_goal": rng.randn(bs, 2),
            "action": np.tanh(rng.randn(bs, 2)),
            "reward": -(rng.rand(bs) < 0.7).astype(np.float32),
            "terminal": (rng.rand(bs) < 0.2).astype(np.float32),
            "next_observation": rng.randn(bs, 4),
            "next_achieved_goal": rng.randn(bs, 2)}


def _f32(b):
    return {k: np.asarray(v, np.float32 if np.asarray(v).dtype.kind == "f"
                          else np.asarray(v).dtype) for k, v in b.items()}


INNER = {
    "sac": (JSAC, JSACConfig, SAC, SACConfig, dict(discount=0.98)),
    "td3": (JTD3, JTD3Config, TD3, TD3Config,
            dict(discount=0.98, q_target_min=-50.0, q_target_max=0.0,
                 exploration_noise=0.2, exploration_epsilon=0.3)),
}


def _inner(name, hidden=H):
    jcls, jcfg, pcls, pcfg, kw = INNER[name]
    nets = dict(net_size=hidden, num_hidden_layers=2)
    return (jcls(6, 2, jcfg(**kw), **nets),
            pcls(6, 2, pcfg(**kw), device="cpu", **nets))


def _inner_from_jax(algo, jstate):
    if isinstance(algo, SAC):
        return convert.sac_state_from_jax(algo, _np(jstate))
    return convert.offpolicy_state_from_jax(algo, _np(jstate))


def _inner_numpy(state):
    if isinstance(state, type(SAC(1, 1, device="cpu").init(0))):
        return convert.sac_state_to_numpy(state)
    return convert.offpolicy_state_to_numpy(state)


def _jax_inner_numpy(jstate, state):
    s = _np(jstate)
    if isinstance(state, type(SAC(1, 1, device="cpu").init(0))):
        opt = lambda o: {"count": int(o[0].count), "mu": o[0].mu,  # noqa
                         "nu": o[0].nu}
        return {"policy_params": s.policy_params, "qf_params": s.qf_params,
                "target_qf_params": s.target_qf_params,
                "log_alpha": s.log_alpha, "policy_opt": opt(s.policy_opt),
                "qf_opt": opt(s.qf_opt), "alpha_opt": opt(s.alpha_opt)}
    modules, opts, counters = convert._LAYOUTS[type(state)]
    out = {f"{m}_params": getattr(s, f"{m}_params") for m in modules}
    for o in opts:
        adam = getattr(s, o)[0]
        out[o] = {"count": int(adam.count), "mu": adam.mu, "nu": adam.nu}
    out.update({c: int(getattr(s, c)) for c in counters})
    return out


def _train_draws(name, key, bs):
    """The draws of one inner JAX `train_step` from its key, as the
    port's `train_noise` asks for them."""
    if name == "sac":
        k_next, k_new = jax.random.split(key)
        return [("train", (np.asarray(jax.random.normal(k_next, (bs, 2))),
                           np.asarray(jax.random.normal(k_new, (bs, 2)))))]
    return [("smoothing", np.asarray(jax.random.normal(key, (bs, 2))))]


def _act_draws(name, key, n, num_actions=2):
    if name == "td3":
        k_flip, k_rand, k_noise = jax.random.split(key, 3)
        return [("flip", np.asarray(jax.random.uniform(k_flip, ()))),
                ("random_action", np.asarray(jax.random.uniform(
                    k_rand, (n, 2), jnp.float32, -1.0, 1.0))),
                ("act", np.asarray(jax.random.normal(k_noise, (n, 2))))]
    if name == "CLASS":
        return [("gumbel", np.asarray(jax.random.gumbel(
            key, (n, num_actions))))]
    return [("act", np.asarray(jax.random.normal(key, (n, 2))))]


@pytest.mark.parametrize("name", ["sac", "td3"])
def test_her_train_step_matches_jax(name):
    jinner, inner = _inner(name)
    jher, her = JHER(jinner), HER(inner)
    jstate = jher.init(jax.random.PRNGKey(0))
    state = _inner_from_jax(inner, jstate)
    rng = np.random.RandomState(1)
    step = jax.jit(jher.train_step)
    for key in jax.random.split(jax.random.PRNGKey(3), 2):
        b = _f32(_her_batch(rng))
        jstate, jm = step(jstate, jax.tree.map(jnp.asarray, b), key)
        draws = [v for _, v in _train_draws(name, key, BS)]
        flat = [T(x) for d in draws for x in (d if isinstance(d, tuple)
                                              else (d,))]
        state, m = her.train_step(state, {k: T(v) for k, v in b.items()},
                                  *flat)
        for k, v in jm.items():
            np.testing.assert_allclose(float(m[k]), float(v), err_msg=k,
                                       **PIN)
    _close(_inner_numpy(state), _jax_inner_numpy(jstate, state), PIN)
    # acting on concat(observation, desired_goal)
    obs = {k: T(v) for k, v in _f32(_her_batch(rng, 5)).items()}
    jobs = {k: jnp.asarray(v.numpy()) for k, v in obs.items()}
    want = jher.act(jstate, jobs, jax.random.PRNGKey(0), deterministic=True)
    got = her.act(state, obs, deterministic=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    assert goal_concat(obs).shape == (5, 6)


GCSL_MODES = ["MLE", "MSE", "CLASS"]


def _gcsl_pair(mode, max_horizon=EPL, eval_horizon=0):
    n_act = 9 if mode == "CLASS" else 2
    cfg = dict(mode=mode, lr=1e-3, max_horizon=max_horizon,
               eval_horizon=eval_horizon)
    return (JGCSL(4, 2, n_act, JGCSLConfig(**cfg), net_size=H,
                  num_hidden_layers=2),
            GCSL(4, 2, n_act, GCSLConfig(**cfg), net_size=H,
                 num_hidden_layers=2, device="cpu"))


@pytest.mark.parametrize("mode", GCSL_MODES)
def test_gcsl_train_steps_match_jax(mode):
    jg, g = _gcsl_pair(mode)
    jstate = jg.init(jax.random.PRNGKey(0))
    state = convert.gcsl_state_from_jax(g, _np(jstate))
    rng = np.random.RandomState(2)
    step = jax.jit(jg.train_step)
    for key in jax.random.split(jax.random.PRNGKey(3), 3):
        b = _f32(_her_batch(rng))
        if mode == "CLASS":
            b["action"] = rng.randint(0, 9, BS).astype(np.int32)
        else:
            b["action"][:3] = np.sign(b["action"][:3])   # saturated rows
        b["horizon"] = rng.randint(-2, EPL + 3, BS).astype(np.int32)
        jstate, jm = step(jstate, jax.tree.map(jnp.asarray, b), key)
        state, m = g.train_step(state, {k: T(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["gcsl_loss"]),
                                   float(jm["gcsl_loss"]), **PIN)
    s = _np(jstate)
    _close(convert.gcsl_state_to_numpy(state),
           {"policy_params": s.policy_params,
            "policy_opt": {"count": int(s.policy_opt[0].count),
                           "mu": s.policy_opt[0].mu,
                           "nu": s.policy_opt[0].nu}}, PIN)


@pytest.mark.parametrize("mode", GCSL_MODES)
def test_gcsl_act_at_eval_horizon_matches_jax(mode):
    """tests/test_gcsl_dagger.py::test_gcsl_act_uses_eval_horizon on the
    port, and stochastic acting from the JAX act's own draws."""
    jg, g = _gcsl_pair(mode, max_horizon=8, eval_horizon=3)
    jstate = jg.init(jax.random.PRNGKey(0))
    state = convert.gcsl_state_from_jax(g, _np(jstate))
    rng = np.random.RandomState(4)
    obs = {"observation": rng.randn(5, 4).astype(np.float32),
           "desired_goal": rng.randn(5, 2).astype(np.float32)}
    tobs = {k: T(v) for k, v in obs.items()}
    jobs = jax.tree.map(jnp.asarray, obs)
    key = jax.random.PRNGKey(1)
    for det in (True, False):
        want = np.asarray(jg.act(jstate, jobs, key, deterministic=det))
        draws = [] if det else [T(v) for _, v in _act_draws(
            "CLASS" if mode == "CLASS" else "sac", key, 5, 9)]
        got = g.act(state, tobs, *draws, deterministic=det).numpy()
        if mode == "CLASS":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **FWD)
    x = g._input(tobs, None)
    assert x[:, 6:].argmax(-1).tolist() == [3] * 5
    if mode != "CLASS":
        mean, _ = state.policy(x)
        np.testing.assert_allclose(
            g.act(state, tobs, deterministic=True).numpy(),
            torch.tanh(mean).detach().numpy(), rtol=1e-6)
        x_max = g._input(tobs, torch.full((5,), 7))
        assert not torch.allclose(state.policy(x_max)[0], mean)


# --- 4. one warmup and one epoch of the loops ---------------------------------
KG, ITERS = 2, 2


def _port_runner(loop, jr, seq, algo_from_jax):
    return HERRunnerState(
        noise=_Draws(seq),
        env_state=convert.env_state_from_jax(jr.env_state, "cpu"),
        replay=convert.hindsight_from_jax(jr.replay, "cpu"),
        algo_state=algo_from_jax(jr.algo_state),
        total_env_steps=int(jr.total_env_steps))


def _assert_runner(runner, jrunner):
    jr = _np(jrunner)
    assert not runner.noise.seq, "draws left over"
    assert runner.total_env_steps == int(jr.total_env_steps)
    got = convert.env_state_to_numpy(runner.env_state)
    _close(got["obs"], jr.env_state.obs, PIN)
    _close(list(got["internal"]), list(jr.env_state.internal), PIN)
    np.testing.assert_array_equal(got["t"], jr.env_state.t)
    rep = convert.hindsight_to_numpy(runner.replay)
    for k in ("ep_len", "cur_slot", "cur_t", "completed"):
        np.testing.assert_array_equal(rep[k], getattr(jr.replay, k), k)
    for k, v in jr.replay.data.items():
        assert rep["data"][k].dtype == v.dtype, k
        np.testing.assert_allclose(rep["data"][k], v, err_msg=k, **PIN)


def _run_loop_case(jloop, loop, act_kind, train_kind, random_draw,
                   algo_from_jax, algo_numpy, jalgo_numpy):
    """JAX: init, the warmup's `_collect`s, then ITERS `_train_iter`s
    jitted one by one, every draw recorded in the port's order; the port:
    the same from the JAX init runner."""
    jrunner = jloop.init(jax.random.PRNGKey(0))
    start = _np(jrunner)
    collect = jax.jit(lambda r: jloop._collect(r, random_actions=True))
    warm = jloop.config.min_episodes_before_training * EPL
    seq = []
    for _ in range(warm):
        _, k_act = jax.random.split(jrunner.rng)
        seq += [random_draw(k_act), _reset(_step_reset_draws(
            jrunner.env_state.rng))]
        jrunner = collect(jrunner)
    runner = _port_runner(loop, start, seq, algo_from_jax)
    runner = loop.warmup(runner)
    _assert_runner(runner, jrunner)

    it = jax.jit(jloop._train_iter)
    metrics = []
    for _ in range(ITERS):
        rng1, k_act = jax.random.split(jrunner.rng)
        seq = _act_draws(act_kind, k_act, NB,
                         loop.vec_env.env.action_size)
        seq.append(_reset(_step_reset_draws(jrunner.env_state.rng)))
        _, k = jax.random.split(rng1)
        for key in jax.random.split(k, KG):
            k_s, k_t = jax.random.split(key)
            seq.append(("hindsight", _hindsight_draws(k_s, BS)))
            if train_kind is not None:
                seq += _train_draws(train_kind, k_t, BS)
        runner.noise.seq += seq
        jrunner, m = it(jrunner)
        metrics.append(_np(m))
    runner, got = loop.train_epoch(runner, ITERS * NB)
    _assert_runner(runner, jrunner)
    for k in metrics[0]:
        np.testing.assert_allclose(got[k], np.mean([m[k] for m in metrics]),
                                   err_msg=k, **PIN)
    _close(algo_numpy(runner.algo_state), jalgo_numpy(jrunner.algo_state,
                                                      runner.algo_state),
           PIN)


def _uniform_draw(k):
    return ("warmup_action", np.asarray(jax.random.uniform(
        k, (NB, 2), minval=-1.0, maxval=1.0)))


@pytest.mark.parametrize("name", ["sac", "td3"])
def test_her_loop_warmup_and_epoch_match_jax(name):
    jinner, inner = _inner(name)
    cfg = dict(batch_size=BS, num_episode_slots=NB * KSLOTS,
               grad_steps_per_iter=KG)
    jloop = JHERLoop(jmake_vec("reach2d", num_envs=NB, max_episode_steps=EPL),
                     JHER(jinner), JHERLoopConfig(**cfg),
                     relabel_type="future", her_ratio=0.8)
    loop = HERLoop(make_vec("reach2d", NB, device="cpu",
                            max_episode_steps=EPL),
                   HER(inner), HERLoopConfig(**cfg), relabel_type="future",
                   her_ratio=0.8)
    _run_loop_case(jloop, loop, name, name, _uniform_draw,
                   lambda s: _inner_from_jax(inner, s), _inner_numpy,
                   _jax_inner_numpy)


@pytest.mark.parametrize("mode", ["MSE", "CLASS"])
def test_gcsl_loop_warmup_and_epoch_match_jax(mode):
    """Continuous MSE on reach2d, and CLASS on its DiscretEnv (integer
    warmup actions, Gumbel acting, int32 actions in the ring)."""
    jg, g = _gcsl_pair(mode)
    cfg = dict(batch_size=BS, num_episode_slots=NB * KSLOTS,
               grad_steps_per_iter=KG)
    jenv = jmake("reach2d", max_episode_steps=EPL)
    env = make("reach2d", device="cpu", max_episode_steps=EPL)
    if mode == "CLASS":
        jenv, env = JDiscretEnv(jenv, granularity=3), DiscretEnv(
            env, granularity=3)
    jloop = JGCSLLoop(JVectorEnv(jenv, NB), jg, JHERLoopConfig(**cfg))
    loop = GCSLLoop(VectorEnv(env, NB), g, HERLoopConfig(**cfg))

    def random_draw(k):
        if mode == "CLASS":
            return ("warmup_index", np.asarray(jax.random.randint(
                k, (NB,), 0, 9)))
        return _uniform_draw(k)

    def jnumpy(js, _):
        s = _np(js)
        adam = s.policy_opt[0]
        return {"policy_params": s.policy_params,
                "policy_opt": {"count": int(adam.count), "mu": adam.mu,
                               "nu": adam.nu}}

    _run_loop_case(jloop, loop, "CLASS" if mode == "CLASS" else "sac", None,
                   random_draw, lambda s: convert.gcsl_state_from_jax(g, s),
                   convert.gcsl_state_to_numpy, jnumpy)


# --- 5. the launchers ------------------------------------------------------
def test_cli_runs_the_reach2d_specs_in_a_process_without_jax(tmp_path):
    """her_sac_reach2d.yaml, gcsl_reach2d.yaml and gcsl_reach_dis.yaml, cut
    in length (1 epoch of 64 steps, 4 envs, 16 episode slots), through
    `python -m ilswiss_tpu_torch.run_experiment --device cpu`."""
    specs = ["her/her_sac_reach2d", "gcsl/gcsl_reach2d",
             "gcsl/gcsl_reach_dis"]
    paths = []
    for name in specs:
        spec = yaml.safe_load((ROOT / "exp_specs" / f"{name}.yaml")
                              .read_text())
        c = spec["constants"]
        c.update(log_dir=str(tmp_path / name), print_to_console=False,
                 net_size=16)
        c["rl_alg_params"].update(num_epochs=1, num_steps_per_epoch=64)
        c["env_specs"]["env_num"] = 4
        for block in ("her_params", "gcsl_params"):
            if block in c:
                c[block]["num_episode_slots"] = 16
        path = tmp_path / f"{name.split('/')[1]}.yaml"
        path.write_text(yaml.safe_dump(spec))
        paths.append(str(path))
    code = (
        "import runpy, sys\n"
        f"for p in {paths!r}:\n"
        "    sys.argv = ['run_experiment', '-e', p, '--device', 'cpu']\n"
        "    runpy.run_module('ilswiss_tpu_torch.run_experiment', "
        "run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ilswiss_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
    for name in specs:
        rows = (tmp_path / name / "progress.csv").read_text().splitlines()
        head = rows[0].split(",")
        assert len(rows) == 2 and "AverageReturn" in head, name
        row = dict(zip(head, rows[1].split(",")))
        # warmup 2 x 50 iterations of 4 envs, then 16 iterations
        assert float(row["TotalEnvSteps"]) == 4 * (100 + 16), name
        assert all(np.isfinite(float(v)) for v in row.values()), name
    log = (tmp_path / "gcsl" / "gcsl_reach_dis" / "debug.log").read_text()
    assert "mode='CLASS'" in log and "max_horizon=50" in log


def test_run_her_td3_inner_takes_the_reference_bounds(tmp_path):
    """The TD3 inner trainer: target clip [-1 / (1 - discount), 0] and the
    Gaussian-and-epsilon explorer from max_sigma / epsilon."""
    v = {"seed": 0, "net_size": 16, "num_hidden_layers": 1,
         "inner_algo": "td3", "log_dir": str(tmp_path / "h"),
         "print_to_console": False,
         "td3_params": {"discount": 0.9, "max_sigma": 0.1, "epsilon": 0.2},
         "her_params": {"num_episode_slots": 8},
         "rl_alg_params": {"num_epochs": 1, "num_steps_per_epoch": 8,
                           "max_path_length": 4, "batch_size": 8,
                           "num_steps_between_train_calls": 2,
                           "num_train_steps_per_train_call": 1},
         "env_specs": {"env_name": "reach2d", "env_num": 2}}
    runner = pexp.run_her(v, device="cpu")
    cfg = runner.algo_state
    assert runner.total_env_steps == 2 * (2 * 4 + 4)
    assert cfg.n_train_steps == 4     # 4 iterations of K = 1
    log = (tmp_path / "h" / "debug.log").read_text()
    assert "q_target_min=-10.0" in log and "q_target_max=0.0" in log
    assert "exploration_noise=0.1" in log and "exploration_epsilon=0.2" \
        in log


def test_host_goal_env_raises_naming_item_2_8(tmp_path, monkeypatch):
    """Item 2.8 is ported: her_reach_td3.yaml takes the host path with
    FetchReach-v4, the spec's relabeling and the reference's TD3; GCSL,
    which the JAX launcher never routes, reads no `force_host` and builds
    a device env, so a host env name raises KeyError there as in JAX."""
    spec = yaml.safe_load((ROOT / "exp_specs" / "her" /
                           "her_reach_td3.yaml").read_text())
    v = dict(spec["constants"], seed=0, log_dir=str(tmp_path / "h"),
             print_to_console=False)
    seen = {}

    def host_her(her, env, rl, logger, seed, relabel, slots):
        seen.update(her=her, env=env, relabel=relabel, slots=slots)
        env.close()

    monkeypatch.setattr(pexp, "_run_host_her", host_her)
    pexp.run_her(v, device="cpu")
    env, inner = seen["env"], seen["her"].inner
    assert type(env).__name__ == "HostGoalVectorEnv"
    assert env.envs[0].spec.id == "FetchReach-v4"
    assert (env.num_envs, env.max_episode_steps) == (8, 50)
    assert seen["relabel"] == {"relabel_type": "future", "her_ratio": 0.8}
    assert seen["slots"] == 2048
    assert inner.config.q_target_min == pytest.approx(-100.0)
    assert inner.config.exploration_epsilon == 0.3
    ran = {}
    monkeypatch.setattr(pexp, "_run_epochs",
                        lambda *a, **k: ran.setdefault("ran", True))
    pexp.run_gcsl(dict(v, env_specs={"env_name": "reach2d",
                                     "force_host": True}), device="cpu")
    assert ran == {"ran": True}
    with pytest.raises(KeyError, match="Unknown env"):
        pexp.run_gcsl(v, device="cpu")
