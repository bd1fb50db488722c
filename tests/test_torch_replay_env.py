"""The port's replay ring and vector env against the JAX package
(ilswiss_tpu_torch/data/replay.py, envs/{base,vector,locomotion}.py vs
the same modules of ilswiss_tpu).  Integers and ids are exact, stored and
gathered floats equal; no physics runs here (the whole-slice test steps
hopper through both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilswiss_tpu.data import replay as jreplay
from ilswiss_tpu.envs import make as jmake
from ilswiss_tpu.envs.base import Environment as JEnvironment
from ilswiss_tpu.envs.vector import Transition as JTransition
from ilswiss_tpu.envs.vector import VectorEnv as JVectorEnv
from ilswiss_tpu_torch.data import replay
from ilswiss_tpu_torch.envs import make
from ilswiss_tpu_torch.envs.base import Environment
from ilswiss_tpu_torch.envs.vector import Transition, VectorEnv

torch.set_num_threads(1)


def _transitions(rng, n, B, obs=3, act=2):
    out = []
    for _ in range(n):
        out.append(dict(
            obs=rng.randn(B, obs).astype(np.float32),
            action=rng.randn(B, act).astype(np.float32),
            reward=rng.randn(B).astype(np.float32),
            next_obs=rng.randn(B, obs).astype(np.float32),
            terminal=rng.rand(B) < 0.3,
            done=rng.rand(B) < 0.5,
        ))
    return out


def test_replay_add_wraps_and_samples_like_jax():
    B, cap = 4, 10                      # capacity rounds up to 12
    assert replay.round_capacity(cap, B) == jreplay.round_capacity(cap, B)
    js = jreplay.replay_init(cap, 3, 2, write_batch=B)
    ps = replay.replay_init(cap, 3, 2, write_batch=B, device="cpu")
    for tr in _transitions(np.random.RandomState(0), 5, B):
        tr["done"] = tr["done"] | tr["terminal"]
        js = jreplay.replay_add(js, JTransition(
            **{k: jnp.asarray(v) for k, v in tr.items()}))
        ps = replay.replay_add(ps, Transition(
            **{k: torch.as_tensor(v) for k, v in tr.items()}))
    assert ps.ptr == int(js.ptr) == 8 and ps.size == int(js.size) == 12
    np.testing.assert_array_equal(ps.ep_id.numpy(), np.asarray(js.ep_id))
    np.testing.assert_array_equal(ps.env_ep.numpy(), np.asarray(js.env_ep))
    for k, v in js.data.items():
        np.testing.assert_array_equal(ps.data[k].numpy(), np.asarray(v))
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (64,)))
    want = jreplay.replay_sample(js, key, 64)
    got = replay.replay_sample(ps, torch.as_tensor(u))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    # u -> 1 must land on the last valid row, never past it
    edge = replay.replay_sample(ps, torch.tensor([0.0, 0.99999994]))
    np.testing.assert_array_equal(edge["reward"].numpy(),
                                  ps.data["reward"][[0, 11]].numpy())


class _JCounter(JEnvironment):
    """obs = [position, t-independent counter]; terminal at position >= 3."""

    observation_size, action_size, max_episode_steps = 2, 1, 4
    action_low = np.array([-2.0], np.float32)
    action_high = np.array([2.0], np.float32)

    def _reset(self, key):
        x = jax.random.uniform(key, (), jnp.float32, 0.0, 1.0)
        return x, jnp.stack([x, 0.0 * x])

    def _step(self, internal, action, key):
        x = internal + action[0]
        return x, jnp.stack([x, 1.0 + 0.0 * x]), x * 2.0, x >= 3.0


class _Counter(Environment):
    """The port twin of _JCounter; reset noise is the drawn position."""

    observation_size, action_size, max_episode_steps = 2, 1, 4
    action_low = np.array([-2.0], np.float32)
    action_high = np.array([2.0], np.float32)

    def _reset(self, noise):
        (x,) = noise
        return (x,), torch.stack([x, 0.0 * x], -1)

    def _step(self, internal, action):
        x = internal[0] + action[:, 0]
        return (x,), torch.stack([x, 1.0 + 0.0 * x], -1), x * 2.0, x >= 3.0


def _jax_reset_draws(env_rng):
    """The reset position each env would draw at this step (vector.py
    reset keys from the stepped per-env rng)."""
    out = []
    for key in env_rng:
        _, carry = jax.random.split(key)
        k_reset, _ = jax.random.split(jax.random.split(carry)[1])
        out.append(jax.random.uniform(k_reset, (), jnp.float32, 0.0, 1.0))
    return np.asarray(jnp.stack(out))


def test_vector_autoreset_and_truncation_match_jax():
    B = 3
    jvec = JVectorEnv(_JCounter(), B)
    vec = VectorEnv(_Counter(device="cpu"), B)
    jstate = jvec.reset(jax.random.PRNGKey(0))
    state = vec.reset((torch.as_tensor(np.asarray(jstate.internal)),))
    rng = np.random.RandomState(1)
    saw = {"terminal": False, "truncation": False}
    for _ in range(8):
        # env 0 drifts up to the terminal, env 1 down to the time limit
        a = rng.uniform(-1.2, 1.2, (B, 1)).astype(np.float32)
        a[0, 0], a[1, 0] = 0.8, -0.5
        draws = _jax_reset_draws(jstate.rng)
        jstate, jtr = jvec.step(jstate, jnp.asarray(a))
        state, tr = vec.step(state, torch.as_tensor(a),
                             (torch.as_tensor(draws),))
        for k in ("obs", "action", "reward", "next_obs", "terminal", "done"):
            np.testing.assert_array_equal(getattr(tr, k).numpy(),
                                          np.asarray(getattr(jtr, k)),
                                          err_msg=k)
        np.testing.assert_array_equal(state.obs.numpy(),
                                      np.asarray(jstate.obs))
        np.testing.assert_array_equal(state.t.numpy(), np.asarray(jstate.t))
        np.testing.assert_array_equal(state.internal[0].numpy(),
                                      np.asarray(jstate.internal))
        saw["terminal"] |= bool(np.any(jtr.terminal))
        saw["truncation"] |= bool(np.any(jtr.done & ~jtr.terminal))
    assert saw["terminal"] and saw["truncation"]


def test_hopper_reset_obs_reward_and_scale_action_match_jax():
    jenv = jmake("hopper")
    env = make("hopper", device="cpu")
    # reset: the JAX draws from a key, the same draws handed to the port
    jstate = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), 4))
    q, qd, warm = (np.asarray(x) for x in jstate.internal)
    noise = (torch.as_tensor(q - env.model.qpos0.astype(np.float32)),
             torch.as_tensor(qd))
    state = env.reset(noise)
    np.testing.assert_array_equal(state.internal[1].numpy(), qd)
    np.testing.assert_allclose(state.internal[0].numpy(), q, rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(state.internal[2].numpy(), warm)
    assert state.t.dtype == torch.int32 and not state.t.any()
    # reward and termination on given states, healthy and not
    rng = np.random.RandomState(2)
    q0 = (env.model.qpos0 + 0.05 * rng.randn(6, 6)).astype(np.float32)
    q1 = q0 + (0.1 * rng.randn(6, 6)).astype(np.float32)
    q1[1, 1], q1[2, 2], q1[3, 3] = 0.5, 0.3, np.nan
    qd1 = rng.randn(6, 6).astype(np.float32)
    qd1[4, 0] = 150.0
    act = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    zero = np.zeros((6, 6), np.float32)
    want = jax.vmap(jenv._reward_terminal)(q0, q1, qd1, zero, act)
    T = torch.as_tensor
    got = env._reward_terminal(T(q0), T(q1), T(qd1), T(zero), T(act))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].numpy().tolist() == [False, True, True, True, True, False]
    np.testing.assert_array_equal(
        env._obs(T(q1), T(qd1), T(zero)).numpy(),
        np.asarray(jax.vmap(jenv._obs)(q1, qd1, zero)))
    # scale_action: lerp, then clip
    a = rng.uniform(-1.5, 1.5, (5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        env.scale_action(T(a)).numpy(),
        np.asarray(jax.vmap(jenv.scale_action)(jnp.asarray(a))))


def test_reset_noise_bounds():
    env = make("hopper", device="cpu")
    dq, dqd = env.sample_reset_noise(256, torch.Generator().manual_seed(0))
    assert dq.shape == (256, 6) and dqd.shape == (256, 6)
    for x in (dq, dqd):
        assert float(x.abs().max()) <= 5e-3 and float(x.abs().max()) > 4e-3
    with pytest.raises(TypeError):
        make("hopper", device="cpu", no_such_option=1)
