"""The env classes that exp_specs/sac/ names beside hopper, ant and
humanoid: pendulum, mountain (ilswiss_tpu_torch/envs/classic/ vs
ilswiss_tpu/envs/classic/), walker and halfcheetah
(ilswiss_tpu_torch/envs/locomotion.py vs ilswiss_tpu/envs/locomotion.py).

As tests/test_torch_locomotion.py does it: `_reset` gets the draws the JAX
env makes from its key, and `_step` gets the same state and action as the
JAX `_step`, jitted whole.  Pins: the classic envs are a few float32
operations, summed in the same order on both sides, rtol = atol = 1e-6
(the constant pi enters the angle wrap once as a float64 Python number,
once as a float32 array); walker and halfcheetah keep the planar path's
float32 pin, rtol 2e-4 and atol 5e-3 on values divided by max(1, max
|reference|), as tests/test_torch_locomotion.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilswiss_tpu.envs.locomotion as jloco
from ilswiss_tpu.envs.classic import MountainCarContinuous as JMountain
from ilswiss_tpu.envs.classic import Pendulum as JPendulum
from ilswiss_tpu_torch.envs import make, make_vec

torch.set_num_threads(1)

B = 4
CLASSIC_PIN = dict(rtol=1e-6, atol=1e-6)
F32 = dict(rtol=2e-4, atol=5e-3)
T = torch.as_tensor


def _stack(outs, i):
    return np.stack([np.asarray(o[i]) for o in outs])


def _scaled_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(got / scale, want / scale, err_msg=what, **F32)


KEYS = list(jax.random.split(jax.random.PRNGKey(7), B))


def test_pendulum_reset_and_step_match_jax():
    jenv, env = JPendulum(), make("pendulum", device="cpu")
    want = [jenv._reset(k) for k in KEYS]
    th, thdot = [], []
    for key in KEYS:                     # the draws of the JAX `_reset`
        k1, k2 = jax.random.split(key)
        th.append(jax.random.uniform(k1, (), minval=-jnp.pi, maxval=jnp.pi))
        thdot.append(jax.random.uniform(k2, (), minval=-1.0, maxval=1.0))
    (state,), obs = env._reset((T(np.stack(th)), T(np.stack(thdot))))
    np.testing.assert_array_equal(state.numpy(), _stack(want, 0))
    np.testing.assert_allclose(obs.numpy(), _stack(want, 1), **CLASSIC_PIN)
    # one step from states that wrap the angle and saturate the speed and
    # the torque clamp
    rng = np.random.RandomState(0)
    states = np.stack([rng.uniform(-7, 7, B), rng.uniform(-8, 8, B)],
                      -1).astype(np.float32)
    states[0] = (3.1, 7.9)
    action = rng.uniform(-3, 3, (B, 1)).astype(np.float32)
    step = jax.jit(lambda s, a: jenv._step(s, a, None))
    want = [step(jnp.asarray(states[i]), jnp.asarray(action[i]))
            for i in range(B)]
    (state,), obs, reward, terminal = env._step((T(states),), T(action))
    np.testing.assert_allclose(state.numpy(), _stack(want, 0), **CLASSIC_PIN)
    np.testing.assert_allclose(obs.numpy(), _stack(want, 1), **CLASSIC_PIN)
    np.testing.assert_allclose(reward.numpy(), _stack(want, 2),
                               **CLASSIC_PIN)
    np.testing.assert_array_equal(terminal.numpy(), _stack(want, 3))
    assert abs(float(state[0, 1])) == 8.0      # the speed clamp
    # the time limit: 200 steps, then truncation
    vec = make_vec("pendulum", 2, device="cpu")
    g = torch.Generator().manual_seed(0)
    s = vec.reset(vec.env.sample_reset_noise(2, g))
    for t in range(200):
        s, tr = vec.step(s, torch.zeros(2, 1),
                         vec.env.sample_reset_noise(2, g))
        assert bool(tr.done.all()) == (t == 199)
    assert not tr.terminal.any()


def test_mountain_reset_and_step_match_jax():
    jenv, env = JMountain(), make("mountain", device="cpu")
    want = [jenv._reset(k) for k in KEYS]
    pos = [jax.random.uniform(k, (), minval=-0.6, maxval=-0.4) for k in KEYS]
    (state,), obs = env._reset((T(np.stack(pos)),))
    np.testing.assert_array_equal(state.numpy(), _stack(want, 0))
    np.testing.assert_array_equal(obs.numpy(), _stack(want, 1))
    assert obs.data_ptr() != state.data_ptr()
    # env 0 reaches the goal, env 1 hits the left wall moving left
    states = np.array([[0.449, 0.05], [-1.19, -0.05], [-0.5, 0.01],
                       [0.2, -0.07]], np.float32)
    action = np.array([[1.0], [-1.0], [0.3], [-2.0]], np.float32)
    step = jax.jit(lambda s, a: jenv._step(s, a, None))
    want = [step(jnp.asarray(states[i]), jnp.asarray(action[i]))
            for i in range(B)]
    (state,), obs, reward, terminal = env._step((T(states),), T(action))
    for got, k in ((state, 0), (obs, 1), (reward, 2)):
        np.testing.assert_allclose(got.numpy(), _stack(want, k),
                                   **CLASSIC_PIN)
    np.testing.assert_array_equal(terminal.numpy(), _stack(want, 3))
    assert terminal.tolist() == [True, False, False, False]
    assert state[1].tolist() == [-1.2000000476837158, 0.0]


@pytest.mark.parametrize("name, cls", [("walker", jloco.WalkerDevice),
                                       ("halfcheetah",
                                        jloco.HalfCheetahDevice)])
def test_planar_locomotion_reset_and_step_match_jax(name, cls):
    """Reset from the JAX env's own draws (halfcheetah: uniform(+-0.1) on
    qpos and 0.1 N(0, 1) on qvel), then one control step through the
    planar path; walker's env 1 starts too low and terminates, halfcheetah
    never does."""
    jenv, env = cls(), make(name, device="cpu")
    m, s = jenv.model, jenv.reset_noise_scale
    assert (s, jenv.gaussian_qvel_noise) == (env.reset_noise_scale,
                                             env.gaussian_qvel_noise)
    want = [jenv._reset(k) for k in KEYS]
    dq, dqd = [], []
    for key in KEYS:
        kq, kv = jax.random.split(key)
        dq.append(jax.random.uniform(kq, (m.nq,), jnp.float32, -s, s))
        dqd.append(s * jax.random.normal(kv, (m.nv,), jnp.float32)
                   if jenv.gaussian_qvel_noise else
                   jax.random.uniform(kv, (m.nv,), jnp.float32, -s, s))
    internal, obs = env._reset((T(np.stack(dq)), T(np.stack(dqd))))
    assert tuple(obs.shape) == (B, 17)
    for k in range(3):
        np.testing.assert_allclose(internal[k].numpy(), np.stack(
            [np.asarray(w[0][k]) for w in want]), atol=1e-6)
    _scaled_close(obs.numpy(), _stack(want, 1), "reset obs")

    rng = np.random.RandomState(1)
    q = (m.qpos0 + 0.05 * rng.randn(B, m.nq)).astype(np.float32)
    if name == "walker":
        q[1, 1] = 0.5
    qd = (0.3 * rng.randn(B, m.nv)).astype(np.float32)
    lo, hi = m.ctrl_range[:, 0], m.ctrl_range[:, 1]
    action = rng.uniform(lo, hi, (B, m.nu)).astype(np.float32)
    warm = np.zeros((B, m.nrow), np.float32)
    step = jax.jit(lambda internal, a: jenv._step(internal, a, None))
    want = [step(tuple(jnp.asarray(x[i]) for x in (q, qd, warm)),
                 jnp.asarray(action[i])) for i in range(B)]
    internal, obs, reward, terminal = env._step((T(q), T(qd), T(warm)),
                                                T(action))
    for k, what in enumerate(("q", "qd", "warm")):
        _scaled_close(internal[k].numpy(), np.stack(
            [np.asarray(w[0][k]) for w in want]), what)
    _scaled_close(obs.numpy(), _stack(want, 1), "obs")
    np.testing.assert_allclose(reward.numpy(), _stack(want, 2), **F32)
    np.testing.assert_array_equal(terminal.numpy(), _stack(want, 3))
    assert terminal.tolist() == [False, name == "walker", False, False]
