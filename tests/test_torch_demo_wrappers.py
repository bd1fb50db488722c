"""The demo buffers (ilswiss_tpu_torch/data/demo.py) and the env wrappers
(ilswiss_tpu_torch/envs/wrappers.py) against their JAX twins
(ilswiss_tpu/data/demo.py, ilswiss_tpu/envs/wrappers.py).

The demo functions are numpy work and elementwise float32 maps on both
sides: their outputs are held equal.  The wrappers run on pendulum through
each package's `VectorEnv` with the same actions and the reset draws the
JAX env makes from its keys, over a reset and several steps that include
an episode's end and an autoreset, at rtol 1e-5, atol 1e-6.
`AbsorbingEnv` runs on a pendulum that terminates (the angular velocity
above 1), defined below for both packages, since pendulum itself never
terminates.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilswiss_tpu.data import demo as jdemo
from ilswiss_tpu.envs.classic import Pendulum as JPendulum
from ilswiss_tpu.envs import wrappers as jwrap
from ilswiss_tpu.envs.vector import VectorEnv as JVectorEnv
from ilswiss_tpu_torch.data import demo as pdemo
from ilswiss_tpu_torch.envs import wrappers as pwrap
from ilswiss_tpu_torch.envs.classic import Pendulum
from ilswiss_tpu_torch.envs.vector import VectorEnv
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DEMOS = str(ROOT / "demos" / "pendulum_expert.npz")
PIN = dict(rtol=1e-5, atol=1e-6)


def _numpy(state):
    return convert.replay_to_numpy(state)


def _assert_equal_buffers(got, want):
    """A port buffer equal to a JAX one; the JAX stride-1 env_ep=None is a
    zero vector of length 1."""
    g = _numpy(got)
    assert set(g["data"]) == set(want.data)
    for k, v in want.data.items():
        np.testing.assert_array_equal(g["data"][k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(g["ep_id"], np.asarray(want.ep_id))
    assert g["ptr"] == int(want.ptr) and g["size"] == int(want.size)
    want_ep = (np.zeros(1, np.int32) if want.env_ep is None
               else np.asarray(want.env_ep))
    np.testing.assert_array_equal(g["env_ep"], want_ep)


def _small_demos(rng, n=12, d=3, a=2):
    """Flat transitions with terminals and non-contiguous episode ids."""
    return dict(
        obs=rng.randn(n, d).astype(np.float32),
        action=rng.uniform(-1, 1, (n, a)).astype(np.float32),
        reward=rng.randn(n).astype(np.float32),
        next_obs=rng.randn(n, d).astype(np.float32),
        terminal=(np.arange(n) % 5 == 4).astype(np.float32),
        ep_id=np.repeat(np.array([6, 2, 4, 0], np.int32), n // 4),
    )


def test_demo_functions_match_jax(tmp_path):
    want = jdemo.load_demos_npz(DEMOS)
    got = pdemo.load_demos_npz(DEMOS, device="cpu")
    _assert_equal_buffers(got, want)

    _assert_equal_buffers(pdemo.subsample_trajs(got, 3),
                          jdemo.subsample_trajs(want, 3))
    jstats, pstats = jdemo.demo_obs_stats(want), pdemo.demo_obs_stats(got)
    assert set(jstats) == set(pstats)
    for k in jstats:
        np.testing.assert_array_equal(pstats[k], jstats[k], err_msg=k)
    _assert_equal_buffers(
        pdemo.scale_demos(got, pstats["obs_mean"], pstats["obs_std"]),
        jdemo.scale_demos(want, jstats["obs_mean"], jstats["obs_std"]))
    _assert_equal_buffers(
        pdemo.minmax_demos(got, pstats["obs_min"], pstats["obs_max"]),
        jdemo.minmax_demos(want, jstats["obs_min"], jstats["obs_max"]))

    # terminals, the absorbing rows, ids that are not contiguous, a stride
    arrays = _small_demos(np.random.RandomState(0))
    jsmall = jdemo.demos_to_replay_state(**arrays)
    small = pdemo.demos_to_replay_state(**arrays, device="cpu")
    _assert_equal_buffers(small, jsmall)
    absorbed = pdemo.wrap_absorbing_demos(small)
    _assert_equal_buffers(absorbed, jdemo.wrap_absorbing_demos(jsmall))
    assert absorbed.size == 12 + 2           # two terminal rows
    _assert_equal_buffers(pdemo.subsample_trajs(small, 2),
                          jdemo.subsample_trajs(jsmall, 2))
    strided = pdemo.demos_to_replay_state(**arrays, stride=4, device="cpu")
    _assert_equal_buffers(strided, jdemo.demos_to_replay_state(**arrays,
                                                               stride=4))
    assert strided.env_ep.shape == (4,)

    # the saved file: dense ids in order of first appearance, the same
    # arrays as the JAX package writes
    pdemo.save_demos_npz(str(tmp_path / "p.npz"), small)
    jdemo.save_demos_npz(str(tmp_path / "j.npz"), jsmall)
    p, j = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert set(p.files) == set(j.files)
    for k in j.files:
        assert p[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    np.testing.assert_array_equal(p["ep_id"], np.repeat([0, 1, 2, 3], 3))
    _assert_equal_buffers(pdemo.load_demos_npz(str(tmp_path / "p.npz"),
                                               device="cpu"),
                          jdemo.load_demos_npz(str(tmp_path / "j.npz")))


# --- wrappers -----------------------------------------------------------------
B, STEPS, HORIZON = 6, 6, 4


class JTermPendulum(JPendulum):
    """Pendulum that terminates where the angular velocity exceeds 1."""

    def _step(self, internal, action, key):
        internal, obs, reward, _ = super()._step(internal, action, key)
        return internal, obs, reward, obs[2] > 1.0


class TermPendulum(Pendulum):
    def _step(self, internal, action):
        internal, obs, reward, _ = super()._step(internal, action)
        return internal, obs, reward, obs[:, 2] > 1.0


def _pendulum_draws(keys):
    """(theta, theta dot) of the JAX pendulum `_reset` for each reset key
    that `Environment.reset` receives."""
    th, thdot = [], []
    for key in keys:
        k_reset, _ = jax.random.split(key)
        k1, k2 = jax.random.split(k_reset)
        th.append(jax.random.uniform(k1, (), minval=-jnp.pi, maxval=jnp.pi))
        thdot.append(jax.random.uniform(k2, (), minval=-1.0, maxval=1.0))
    return (torch.as_tensor(np.array(jnp.stack(th))),
            torch.as_tensor(np.array(jnp.stack(thdot))))


def _autoreset_draws(rng_before_step):
    """The reset draws of a JAX `VectorEnv.step` (vector.py: the key
    split from the stepped per-env rng, Environment.step's carry)."""
    keys = []
    for k in rng_before_step:
        _, carry = jax.random.split(k)             # Environment.step
        keys.append(jax.random.split(carry)[1])    # VectorEnv.step
    return _pendulum_draws(keys)


def _wrapped(kind, stats):
    if kind == "scaled":
        return (jwrap.ScaledEnv(JPendulum(max_episode_steps=HORIZON),
                                **stats),
                pwrap.ScaledEnv(Pendulum(device="cpu",
                                         max_episode_steps=HORIZON),
                                **stats))
    if kind == "minmax":
        args = stats["obs_mean"] - 1.0, stats["obs_mean"] + 2.0
        return (jwrap.MinmaxEnv(JPendulum(max_episode_steps=HORIZON), *args),
                pwrap.MinmaxEnv(Pendulum(device="cpu",
                                         max_episode_steps=HORIZON), *args))
    return (jwrap.AbsorbingEnv(JTermPendulum(max_episode_steps=HORIZON)),
            pwrap.AbsorbingEnv(TermPendulum(device="cpu",
                                            max_episode_steps=HORIZON)))


@pytest.mark.parametrize("kind", ["scaled", "minmax", "absorbing"])
def test_wrapper_reset_and_steps_match_jax(kind):
    rng = np.random.RandomState(1)
    stats = {"obs_mean": rng.randn(3).astype(np.float32),
             "obs_std": rng.uniform(0.5, 2, 3).astype(np.float32),
             "acts_mean": rng.randn(1).astype(np.float32) * 0.1,
             "acts_std": rng.uniform(0.5, 1, 1).astype(np.float32)}
    jenv, env = _wrapped(kind, stats)
    assert (env.observation_size, env.action_size, env.max_episode_steps) \
        == (jenv.observation_size, jenv.action_size, jenv.max_episode_steps)
    jvec, vec = JVectorEnv(jenv, B), VectorEnv(env, B)
    key = jax.random.PRNGKey(3)
    jstate = jvec.reset(key)
    state = vec.reset(_pendulum_draws(jax.random.split(key, B)))
    jstep = jax.jit(jvec.step)
    seen = {"terminal": 0, "truncation": 0, "absorbing": 0}
    for _ in range(STEPS):
        np.testing.assert_allclose(state.obs.numpy(),
                                   np.asarray(jstate.obs), **PIN)
        action = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
        draws = _autoreset_draws(jstate.rng)
        jstate, jtr = jstep(jstate, jnp.asarray(action))
        state, tr = vec.step(state, torch.as_tensor(action), draws)
        for name in ("obs", "action", "reward", "next_obs"):
            np.testing.assert_allclose(getattr(tr, name).numpy(),
                                       np.asarray(getattr(jtr, name)),
                                       err_msg=name, **PIN)
        for name in ("terminal", "done"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                          np.asarray(getattr(jtr, name)))
        np.testing.assert_array_equal(state.t.numpy(), np.asarray(jstate.t))
        jinternal = jax.tree.leaves(jstate.internal)
        assert len(state.internal) == len(jinternal)
        for g, w in zip(state.internal, jinternal):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **PIN)
        seen["terminal"] += int(tr.terminal.sum())
        seen["truncation"] += int((tr.done & ~tr.terminal).sum())
        if kind == "absorbing":
            seen["absorbing"] += int(state.internal[-1].sum())
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs),
                               **PIN)
    # the run covers an episode's end (the horizon) in every case, and the
    # absorbing state and its terminal self-loop where it is wrapped
    assert seen["truncation"] > 0
    if kind == "absorbing":
        assert seen["absorbing"] > 0 and seen["terminal"] > 0
