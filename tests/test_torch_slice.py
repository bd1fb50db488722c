"""The port's main path as a whole: SAC on hopper through `make_vec`,
`SAC` and `OffPolicyLoop` (ilswiss_tpu_torch/runtime/loop.py), and, in
the slow cases, one training iteration (eager, and through the fused
chain) held against the JAX loop (ilswiss_tpu/runtime/loop.py) from the
same carried-over RunnerState with every random draw of the JAX iteration
replayed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.envs import make_vec
from ilswiss_tpu_torch.ops import fused_mlp
from ilswiss_tpu_torch.ops import planar_dynamics as pd
from ilswiss_tpu_torch.runtime.evaluator import make_evaluator
from ilswiss_tpu_torch.runtime.loop import (
    OffPolicyConfig, OffPolicyLoop, RunnerState,
)
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

NUM_ENVS, BATCH, HIDDEN, K = 2, 8, 16, 2


def _port_loop(device="cpu", use_fused_chain=False):
    vec = make_vec("hopper", NUM_ENVS, device=device)
    sac = SAC(vec.env.observation_size, vec.env.action_size, SACConfig(),
              net_size=HIDDEN, num_hidden_layers=2, use_fused_act=True,
              use_fused_chain=use_fused_chain, device=device)
    cfg = OffPolicyConfig(batch_size=BATCH, replay_capacity=64,
                          min_steps_before_training=4,
                          grad_steps_per_iter=K)
    return OffPolicyLoop(vec, sac, cfg)


def test_loop_runs_hopper_on_cpu():
    loop = _port_loop()
    k1 = pd.planar_forward.launches
    k3 = fused_mlp.fused_gaussian_policy_forward.launches
    runner = loop.init(0)
    runner = loop.warmup(runner)
    assert runner.total_env_steps == 2 * NUM_ENVS
    runner, metrics = loop.train_epoch(runner, steps_per_epoch=NUM_ENVS)
    assert runner.total_env_steps == 3 * NUM_ENVS
    assert runner.replay.size == 3 * NUM_ENVS
    assert set(metrics) == {"qf1_loss", "qf2_loss", "policy_loss",
                            "alpha_loss", "alpha", "q1_pred_mean",
                            "q2_pred_mean", "log_pi_mean"}
    assert all(math.isfinite(v) for v in metrics.values())
    assert torch.isfinite(runner.env_state.obs).all()
    # the CPU takes the plain versions: no kernel launches
    assert pd.planar_forward.launches == k1
    assert fused_mlp.fused_gaussian_policy_forward.launches == k3
    stats = make_evaluator(
        loop.vec_env,
        lambda s, o: loop.algo.act(s, o, deterministic=True), 3,
    )(runner.algo_state, runner.noise)
    assert all(math.isfinite(v) for v in stats.values())
    assert stats["AvgPathLength"] <= 3.0


class _ReplayNoise:
    """The port's `Noise` interface, answering each call with the next of
    the draws the JAX iteration makes from its keys."""

    def __init__(self, draws):
        self.draws = {k: list(v) for k, v in draws.items()}

    def _next(self, kind):
        return torch.as_tensor(np.array(self.draws[kind].pop(0)))

    def act(self, shape):
        return self._next("act")

    def reset(self, env, n):
        return self._next("reset_q"), self._next("reset_qd")

    def replay(self, batch_size):
        return self._next("replay")

    def train(self, shape):
        return self._next("eps_next"), self._next("eps_new")


def _jax_iteration_draws(jloop, jrunner):
    """Every draw of one JAX `_train_iter` (loop.py:100-117, 151-175),
    derived from the runner's keys as the JAX code derives them."""
    env = jloop.vec_env.env
    m = env.model
    s = env.reset_noise_scale
    rng, k_act = jax.random.split(jrunner.rng)
    draws = {"act": [jax.random.normal(k_act, (NUM_ENVS, m.nu))]}
    # vector.py:71-74 reset keys from the stepped per-env rng; then
    # base.py reset -> locomotion._sample_state
    q_noise, qd_noise = [], []
    for key in jrunner.env_state.rng:
        _, carry = jax.random.split(key)              # Environment.step
        reset_key = jax.random.split(carry)[1]        # VectorEnv.step
        k_reset, _ = jax.random.split(reset_key)      # Environment.reset
        kq, kv = jax.random.split(k_reset)            # _sample_state
        q_noise.append(jax.random.uniform(kq, (m.nq,), jnp.float32, -s, s))
        qd_noise.append(jax.random.uniform(kv, (m.nv,), jnp.float32, -s, s))
    draws["reset_q"] = [jnp.stack(q_noise)]
    draws["reset_qd"] = [jnp.stack(qd_noise)]
    _, k_steps = jax.random.split(rng)
    draws.update(replay=[], eps_next=[], eps_new=[])
    for key in jax.random.split(k_steps, K):
        k_samp, k_train = jax.random.split(key)
        draws["replay"].append(jax.random.uniform(k_samp, (BATCH,)))
        k_next, k_new = jax.random.split(k_train)
        for name, k in (("eps_next", k_next), ("eps_new", k_new)):
            draws[name].append(jax.random.normal(k, (BATCH, m.nu)))
    return {k: [np.asarray(x) for x in v] for k, v in draws.items()}


@pytest.mark.slow
def test_training_iteration_matches_jax_loop():
    """One training iteration from the JAX loop's carried-over
    RunnerState.  rtol 2e-4, atol 5e-3: the JAX env on the CPU runs the
    general engine, not the planar math."""
    _iteration_against_jax(use_fused_chain=False)


@pytest.mark.slow
def test_fused_training_iteration_matches_jax_loop():
    """The same iteration with the port's K gradient steps taken as one
    fused chain; the JAX side stays the scan of `train_step`."""
    _iteration_against_jax(use_fused_chain=True)


def _iteration_against_jax(use_fused_chain):
    from ilswiss_tpu.algorithms.sac import SAC as JSAC
    from ilswiss_tpu.envs import make_vec as jmake_vec
    from ilswiss_tpu.runtime.loop import OffPolicyConfig as JConfig
    from ilswiss_tpu.runtime.loop import OffPolicyLoop as JLoop

    jvec = jmake_vec("hopper", num_envs=NUM_ENVS)
    jsac = JSAC(11, 3, net_size=HIDDEN, num_hidden_layers=2)
    jloop = JLoop(jvec, jsac, JConfig(batch_size=BATCH, replay_capacity=64,
                                      min_steps_before_training=4,
                                      grad_steps_per_iter=K))
    warmup, train_epoch = jloop.build(steps_per_epoch=NUM_ENVS)
    jrunner = warmup(jloop.init(jax.random.PRNGKey(0)))
    jrunner = jax.block_until_ready(jrunner)
    draws = _jax_iteration_draws(jloop, jrunner)
    snapshot = jax.tree.map(np.asarray, jrunner)
    jnext, jmetrics = train_epoch(jrunner)
    jnext = jax.tree.map(np.asarray, jnext)

    loop = _port_loop(use_fused_chain=use_fused_chain)
    runner = RunnerState(
        noise=_ReplayNoise(draws),
        env_state=convert.env_state_from_jax(snapshot.env_state, "cpu"),
        replay=convert.replay_from_jax(snapshot.replay, "cpu"),
        algo_state=convert.sac_state_from_jax(loop.algo,
                                              snapshot.algo_state),
        total_env_steps=int(snapshot.total_env_steps))
    runner, metrics = loop.train_epoch(runner, steps_per_epoch=NUM_ENVS)
    assert all(not v for v in runner.noise.draws.values())

    tol = dict(rtol=2e-4, atol=5e-3)
    assert runner.total_env_steps == int(jnext.total_env_steps)
    got_env = convert.env_state_to_numpy(runner.env_state)
    for g, w in zip(got_env["internal"], jnext.env_state.internal):
        np.testing.assert_allclose(g, w, **tol)
    np.testing.assert_allclose(got_env["obs"], jnext.env_state.obs, **tol)
    np.testing.assert_array_equal(got_env["t"], jnext.env_state.t)
    got_replay = convert.replay_to_numpy(runner.replay)
    assert got_replay["ptr"] == int(jnext.replay.ptr)
    assert got_replay["size"] == int(jnext.replay.size)
    np.testing.assert_array_equal(got_replay["ep_id"], jnext.replay.ep_id)
    np.testing.assert_array_equal(got_replay["env_ep"], jnext.replay.env_ep)
    for k, v in jnext.replay.data.items():
        np.testing.assert_allclose(got_replay["data"][k], v, **tol,
                                   err_msg=k)
    got = convert.sac_state_to_numpy(runner.algo_state)
    a = jnext.algo_state
    for name in ("policy_params", "qf_params", "target_qf_params"):
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **tol),
                     got[name], getattr(a, name))
    np.testing.assert_allclose(got["log_alpha"], a.log_alpha, **tol)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], float(v), **tol, err_msg=k)
