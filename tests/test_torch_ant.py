"""The ant slice of the port against the JAX package: a float32 control
step of the general engine, the `AntDevice` env
(ilswiss_tpu_torch/envs/locomotion.py vs ilswiss_tpu/envs/locomotion.py),
the SAC-Ant loop on the CPU and, in the slow case, one training iteration
held against the JAX loop with every draw replayed.

Compiling the JAX ant control step takes about a minute on a CPU, so the
tier-1 cases compile ONE single-env `forward` (about 15 s) and compose the
reference control step from it in the test: `_rk4_step` of
ilswiss_tpu/ops/rigid_body.py written out with the JAX `integrate_pos`,
`_RK4_A` and `_RK4_B`.  The JAX env's own `_step` then runs eagerly with
that composed step put in the place of its `physics_step`.

Tolerance, float32: rtol 2e-4, atol 5e-3 on values divided by max(1, max
|reference|).  A control step is 20 forward evaluations of 15 unconverged
Gauss-Seidel sweeps each, on forces of size 1e3, summed in another order
by the two engines; the pin is the planar path's
(tests/test_torch_planar.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilswiss_tpu.envs.locomotion as jloco
import ilswiss_tpu.ops.rigid_body as jrb
from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.envs import make, make_vec
from ilswiss_tpu_torch.ops import fused_mlp, pgs
from ilswiss_tpu_torch.ops import planar_dynamics as pd
from ilswiss_tpu_torch.ops import rigid_body as rb
from ilswiss_tpu_torch.runtime.loop import (
    OffPolicyConfig, OffPolicyLoop, RunnerState,
)
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

B, ITERS = 2, 15
F32 = dict(rtol=2e-4, atol=5e-3)


def _assert_scaled_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(got / scale, want / scale, err_msg=what, **F32)


def _ant_states(seed=0):
    """(q, qd, action, warm) [B, .] float32: grounded, tilted ants with an
    un-normalized quaternion, as a gym reset leaves it."""
    m = jloco._model("ant")
    rng = np.random.RandomState(seed)
    q = m.qpos0 + 0.1 * rng.randn(B, m.nq)
    q[:, 2] = 0.5 + 0.1 * rng.rand(B)
    q[:, 3:7] = (np.array([1.0, 0, 0, 0]) + 0.1 * rng.randn(B, 4)) * 1.05
    qd = 0.3 * rng.randn(B, m.nv)
    action = rng.uniform(-1, 1, (B, m.nu))
    warm = 0.2 * np.abs(rng.randn(B, m.nrow))
    return tuple(x.astype(np.float32) for x in (q, qd, action, warm))


@pytest.fixture(scope="module")
def jax_control_step():
    """`physics_step(m, q, qd, ctrl, iters, f0)` for ONE ant, composed from
    one compiled JAX `forward`."""
    m = jloco._model("ant")
    forward = jax.jit(lambda q, qd, c, f0: jrb.forward(
        m, q, qd, c, iters=ITERS, f0=f0))
    h = m.timestep

    def rk4(q, qd, ctrl, f0):
        qacc0, _, _, con, f = forward(q, qd, ctrl, f0)
        vels, accs = [qd], [qacc0]
        for i in range(3):
            dq = sum(a * v for a, v in zip(jrb._RK4_A[i], vels) if a != 0.0)
            dv = sum(a * acc for a, acc in zip(jrb._RK4_A[i], accs)
                     if a != 0.0)
            qi = jrb.integrate_pos(m, q, dq, h)
            vi = qd + h * dv
            qacci, _, _, _, f = forward(qi, vi, ctrl, f)
            vels.append(vi)
            accs.append(qacci)
        dq = sum(b * v for b, v in zip(jrb._RK4_B, vels))
        dv = sum(b * acc for b, acc in zip(jrb._RK4_B, accs))
        return jrb.integrate_pos(m, q, dq, h), qd + h * dv, con, f, (qi, vi)

    def step(model, q, qd, ctrl, iters=ITERS, f0=None):
        assert model is m and iters == ITERS
        carry = (q, qd, None, f0, None)
        for _ in range(m.frame_skip):
            carry = rk4(carry[0], carry[1], ctrl, carry[3])
        return carry

    return step


def test_control_step_float32_matches_jax(jax_control_step):
    m = jloco._model("ant")
    q, qd, action, warm = _ant_states()
    want = [jax_control_step(m, *(jnp.asarray(x[i]) for x in
                                  (q, qd, action)), f0=jnp.asarray(warm[i]))
            for i in range(B)]
    T = torch.as_tensor
    before = pgs.pgs_solve.launches
    got = rb.physics_step(make("ant", device="cpu").model, T(q), T(qd),
                          T(action), iters=ITERS, f0=T(warm))
    assert pgs.pgs_solve.launches == before      # CPU: the plain solve
    flat = lambda s: [s[0], s[1], s[2], s[3], s[4][0], s[4][1]]
    for k, what in enumerate(("q", "qd", "con", "f", "q_ev", "qd_ev")):
        _assert_scaled_close(
            flat(got)[k].numpy(),
            np.stack([np.asarray(flat(w)[k]) for w in want]), what)
    # the stored quaternion is normalized by the integrator
    np.testing.assert_allclose(np.linalg.norm(got[0][:, 3:7].numpy(),
                                              axis=1), 1.0, atol=1e-6)


def _jax_reset_draws(env, keys):
    """The (dq, dqd) that `_sample_state` draws from each key."""
    m, s = env.model, env.reset_noise_scale
    dq, dqd = [], []
    for key in keys:
        kq, kv = jax.random.split(key)
        dq.append(jax.random.uniform(kq, (m.nq,), jnp.float32, -s, s))
        dqd.append(s * jax.random.normal(kv, (m.nv,), jnp.float32)
                   if env.gaussian_qvel_noise else
                   jax.random.uniform(kv, (m.nv,), jnp.float32, -s, s))
    return np.stack(dq), np.stack(dqd)


def test_ant_reset_matches_jax():
    jenv = jloco.AntDevice()
    env = make("ant", device="cpu")
    keys = list(jax.random.split(jax.random.PRNGKey(3), B))
    want = [jenv._reset(k) for k in keys]
    dq, dqd = _jax_reset_draws(jenv, keys)
    internal, obs = env._reset((torch.as_tensor(dq), torch.as_tensor(dqd)))
    assert tuple(obs.shape) == (B, 105) and tuple(internal[2].shape) == (
        B, 116)
    for k in range(3):
        np.testing.assert_allclose(
            internal[k].numpy(), np.stack([np.asarray(w[0][k])
                                           for w in want]), atol=1e-7)
    np.testing.assert_allclose(obs.numpy(), np.stack(
        [np.asarray(w[1]) for w in want]), atol=1e-7)
    assert torch.all(obs[:, 27:] == 0.0)         # no cfrc_ext at a reset


def test_ant_step_matches_jax(jax_control_step, monkeypatch):
    """obs, reward and terminal of `AntDevice._step`: the JAX env's own
    `_step`, run eagerly per env over the composed control step, against
    the port's batched one; one env starts too high and terminates."""
    monkeypatch.setattr(jloco, "physics_step", jax_control_step)
    jenv = jloco.AntDevice()
    env = make("ant", device="cpu")
    q, qd, action, warm = _ant_states(seed=1)
    q[0, 2] = 0.45
    q[1, 2] = 1.02
    qd[1, 2] = 1.0
    want = [jenv._step(tuple(jnp.asarray(x[i]) for x in (q, qd, warm)),
                       jnp.asarray(action[i]), None) for i in range(B)]
    T = torch.as_tensor
    internal, obs, reward, terminal = env._step((T(q), T(qd), T(warm)),
                                                T(action))
    for k, what in enumerate(("q", "qd", "warm")):
        _assert_scaled_close(internal[k].numpy(), np.stack(
            [np.asarray(w[0][k]) for w in want]), what)
    want_obs = np.stack([np.asarray(w[1]) for w in want])
    np.testing.assert_allclose(obs.numpy(), want_obs, **F32)
    assert np.abs(want_obs[:, 27:]).max() > 0.1   # contact forces are seen
    np.testing.assert_allclose(reward.numpy(), np.stack(
        [np.asarray(w[2]) for w in want]), **F32)
    want_terminal = np.stack([np.asarray(w[3]) for w in want])
    np.testing.assert_array_equal(terminal.numpy(), want_terminal)
    assert want_terminal.tolist() == [False, True]


def test_ant_trunc_obs_is_ant_without_contact_forces():
    """`ant_trunc_obs` keeps [qpos[2:], qvel] of ant's observation, with
    ant's reward and termination.  (The JAX package cannot build it: see
    ROADMAP.md, faults against the reference.)"""
    full, trunc = make("ant", device="cpu"), make("ant_trunc_obs",
                                                  device="cpu")
    assert trunc.observation_size == 27 and trunc.model is full.model
    T = torch.as_tensor
    q, qd, action, warm = (T(x[:1]) for x in _ant_states(seed=2))
    a = full._step((q, qd, warm), action)
    b = trunc._step((q, qd, warm), action)
    assert torch.equal(b[1], a[1][:, :27])
    assert torch.equal(b[2], a[2]) and torch.equal(b[3], a[3])


def test_reset_noise_is_gaussian_on_qvel_where_gym_draws_it_so():
    g = torch.Generator().manual_seed(0)
    ant, hopper = make("ant", device="cpu"), make("hopper", device="cpu")
    dq, dqd = ant.sample_reset_noise(4000, g)
    assert tuple(dq.shape) == (4000, 15) and tuple(dqd.shape) == (4000, 14)
    assert float(dq.abs().max()) <= 0.1
    assert float(dqd.abs().max()) > 0.25          # beyond any uniform(+-s)
    assert abs(float(dqd.std()) - 0.1) < 5e-3
    _, dqd = hopper.sample_reset_noise(4000, g)
    assert float(dqd.abs().max()) <= 5e-3


def test_ant_vector_env_autoresets_on_cpu():
    vec = make_vec("ant", B, device="cpu")
    g = torch.Generator().manual_seed(1)
    state = vec.reset(vec.env.sample_reset_noise(B, g))
    state.internal[0][1, 2] = 1.2                 # env 1 is above z = 1
    reset_noise = vec.env.sample_reset_noise(B, g)
    new_state, tr = vec.step(state, torch.zeros(B, 8), reset_noise)
    assert tr.terminal.tolist() == [False, True]
    assert tuple(tr.next_obs.shape) == (B, 105)
    fresh = vec.env.reset(reset_noise)
    assert torch.equal(new_state.obs[1], fresh.obs[1])
    assert torch.equal(new_state.internal[0][1], fresh.internal[0][1])
    assert torch.all(new_state.internal[2][1] == 0.0)
    assert new_state.t.tolist() == [1, 0]
    assert torch.equal(new_state.obs[0], tr.next_obs[0])


NUM_ENVS, BATCH, HIDDEN, K = 2, 8, 16, 2


def _port_loop(use_fused_chain):
    vec = make_vec("ant", NUM_ENVS, device="cpu")
    sac = SAC(vec.env.observation_size, vec.env.action_size, SACConfig(),
              net_size=HIDDEN, num_hidden_layers=2, use_fused_act=True,
              use_fused_chain=use_fused_chain, device="cpu")
    cfg = OffPolicyConfig(batch_size=BATCH, replay_capacity=64,
                          min_steps_before_training=2,
                          grad_steps_per_iter=K)
    return OffPolicyLoop(vec, sac, cfg)


def test_loop_runs_ant_on_cpu():
    """Warmup and one fused training iteration of SAC-Ant through
    `make_vec`, `SAC` and `OffPolicyLoop`; on the CPU no kernel launches."""
    loop = _port_loop(use_fused_chain=True)
    counts = (pgs.pgs_solve.launches, pd.planar_forward.launches,
              fused_mlp.fused_gaussian_policy_forward.launches)
    runner = loop.warmup(loop.init(0))
    runner, metrics = loop.train_epoch(runner, steps_per_epoch=NUM_ENVS)
    assert runner.total_env_steps == runner.replay.size == 2 * NUM_ENVS
    assert tuple(runner.env_state.obs.shape) == (NUM_ENVS, 105)
    assert tuple(runner.env_state.internal[2].shape) == (NUM_ENVS, 116)
    assert torch.isfinite(runner.env_state.obs).all()
    assert len(metrics) == 8
    assert all(math.isfinite(v) for v in metrics.values())
    assert counts == (pgs.pgs_solve.launches, pd.planar_forward.launches,
                      fused_mlp.fused_gaussian_policy_forward.launches)


# ---- the slice as a whole against the JAX loop (slow: compiles the JAX ant
# ---- control step and learner, several minutes on a CPU)


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
    """Every draw of one JAX `_train_iter`, derived from the runner's keys
    as the JAX code derives them (runtime/loop.py, envs/vector.py,
    envs/base.py, envs/locomotion.py::_sample_state)."""
    env = jloop.vec_env.env
    rng, k_act = jax.random.split(jrunner.rng)
    draws = {"act": [jax.random.normal(k_act, (NUM_ENVS, env.model.nu))]}
    reset_keys = []
    for key in jrunner.env_state.rng:
        _, carry = jax.random.split(key)              # Environment.step
        reset_key = jax.random.split(carry)[1]        # VectorEnv.step
        reset_keys.append(jax.random.split(reset_key)[0])  # Environment.reset
    dq, dqd = _jax_reset_draws(env, reset_keys)
    draws["reset_q"], draws["reset_qd"] = [dq], [dqd]
    _, k_steps = jax.random.split(rng)
    draws.update(replay=[], eps_next=[], eps_new=[])
    for key in jax.random.split(k_steps, K):
        k_samp, k_train = jax.random.split(key)
        draws["replay"].append(jax.random.uniform(k_samp, (BATCH,)))
        k_next, k_new = jax.random.split(k_train)
        for name, k in (("eps_next", k_next), ("eps_new", k_new)):
            draws[name].append(jax.random.normal(k, (BATCH, env.model.nu)))
    return {k: [np.asarray(x) for x in v] for k, v in draws.items()}


@pytest.mark.slow
def test_fused_training_iteration_matches_jax_loop():
    """One training iteration of SAC-Ant (act, control step, replay write,
    K gradient steps as one fused chain) from the JAX loop's carried-over
    RunnerState, warm-start forces [B, 116] included."""
    from ilswiss_tpu.algorithms.sac import SAC as JSAC
    from ilswiss_tpu.envs import make_vec as jmake_vec
    from ilswiss_tpu.runtime.loop import OffPolicyConfig as JConfig
    from ilswiss_tpu.runtime.loop import OffPolicyLoop as JLoop

    jvec = jmake_vec("ant", num_envs=NUM_ENVS)
    jsac = JSAC(105, 8, net_size=HIDDEN, num_hidden_layers=2)
    jloop = JLoop(jvec, jsac, JConfig(batch_size=BATCH, replay_capacity=64,
                                      min_steps_before_training=2,
                                      grad_steps_per_iter=K))
    warmup, train_epoch = jloop.build(steps_per_epoch=NUM_ENVS)
    jrunner = jax.block_until_ready(warmup(jloop.init(jax.random.PRNGKey(0))))
    draws = _jax_iteration_draws(jloop, jrunner)
    snapshot = jax.tree.map(np.asarray, jrunner)
    jnext, jmetrics = train_epoch(jrunner)
    jnext = jax.tree.map(np.asarray, jnext)

    loop = _port_loop(use_fused_chain=True)
    runner = RunnerState(
        noise=_ReplayNoise(draws),
        env_state=convert.env_state_from_jax(snapshot.env_state, "cpu"),
        replay=convert.replay_from_jax(snapshot.replay, "cpu"),
        algo_state=convert.sac_state_from_jax(loop.algo,
                                              snapshot.algo_state),
        total_env_steps=int(snapshot.total_env_steps))
    assert tuple(runner.env_state.internal[2].shape) == (NUM_ENVS, 116)
    runner, metrics = loop.train_epoch(runner, steps_per_epoch=NUM_ENVS)
    assert all(not v for v in runner.noise.draws.values())

    assert runner.total_env_steps == int(jnext.total_env_steps)
    got_env = convert.env_state_to_numpy(runner.env_state)
    for g, w, what in zip(got_env["internal"], jnext.env_state.internal,
                          ("q", "qd", "warm")):
        _assert_scaled_close(g, w, what)
    np.testing.assert_allclose(got_env["obs"], jnext.env_state.obs, **F32)
    np.testing.assert_array_equal(got_env["t"], jnext.env_state.t)
    got_replay = convert.replay_to_numpy(runner.replay)
    assert got_replay["ptr"] == int(jnext.replay.ptr)
    assert got_replay["size"] == int(jnext.replay.size)
    for k, v in jnext.replay.data.items():
        np.testing.assert_allclose(got_replay["data"][k], v, **F32,
                                   err_msg=k)
    got = convert.sac_state_to_numpy(runner.algo_state)
    a = jnext.algo_state
    for name in ("policy_params", "qf_params", "target_qf_params"):
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **F32),
                     got[name], getattr(a, name))
    np.testing.assert_allclose(got["log_alpha"], a.log_alpha, **F32)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], float(v), **F32, err_msg=k)
