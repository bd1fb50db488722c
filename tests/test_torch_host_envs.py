"""The port's host envs (ilswiss_tpu_torch/envs/host_mujoco.py,
envs/native_mujoco.py and the launcher's `_make_host_env`) against the JAX
package's (ilswiss_tpu/envs/host_mujoco.py).

Both sides are numpy over the same gymnasium envs, so the vector envs and
the wrappers are held bit for bit.  The port's native engine, built from
its own copy of mjvec.cpp into build/native/, is held to the port's
gymnasium env at tests/test_native_mujoco.py's tolerances (obs rtol 1e-4,
reward rtol 1e-3, atol widening from 1e-5 with the horizon): the JAX
engine rewrites ilswiss_tpu/native/libmjvec.so in place when it builds,
so it is not built here.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilswiss_tpu.envs import host_mujoco as jhost
from ilswiss_tpu_torch.envs import host_mujoco as phost
from ilswiss_tpu_torch.envs import native_mujoco as native
from ilswiss_tpu_torch.launchers import experiments as pexp

torch.set_num_threads(1)

gym = pytest.importorskip("gymnasium")

ROOT = Path(__file__).resolve().parents[1]


def _assert_same(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}.{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name", ["hopper", "lunarlandercont"])
def test_gym_vector_env_is_bit_equal_to_jax(name):
    """4 envs, seed 0, the same 40 action rows, a 10-step horizon (so
    every env resets along the way, several in one step): all six outputs
    bit-equal.  The JAX env runs one worker thread: with more, its envs
    draw their reset seeds in thread order (the fault
    test_fault_reset_seeds_follow_env_order shows the port not copying)."""
    kw = dict(num_envs=4, seed=0, max_episode_steps=10)
    port = phost.GymVectorEnv(name, **kw)
    ref = jhost.GymVectorEnv(name, num_threads=1, **kw)
    try:
        assert (port.observation_size, port.action_size,
                port.max_episode_steps) == (ref.observation_size,
                                            ref.action_size,
                                            ref.max_episode_steps)
        _assert_same(port.reset(), ref.reset(), "reset")
        rng = np.random.RandomState(0)
        resets = 0
        for t in range(40):
            a = rng.uniform(-1.2, 1.2, (4, port.action_size)).astype(
                np.float32)
            got, want = port.step(a), ref.step(a)
            for i, (g, w) in enumerate(zip(got, want)):
                _assert_same(g, w, f"step {t} output {i}")
            resets += int(want[4].sum())
        assert resets >= 4
        # a new seed reseeds both alike
        _assert_same(port.reset(seed=3), ref.reset(seed=3), "reset(3)")
    finally:
        port.close()
        ref.close()


def test_goal_vector_env_matches_jax_on_fetch_reach():
    """FetchReach-v4: the dict observations, rewards, terminals, dones and
    is_success of every step bit-equal; `compute_reward` on tensors equal
    to the JAX function and to the env's own, in both reward types."""
    kw = dict(num_envs=2, seed=1, max_episode_steps=5)
    port = phost.HostGoalVectorEnv("fetch-reach", **kw)
    ref = jhost.HostGoalVectorEnv("fetch-reach", num_threads=1, **kw)
    try:
        assert (port.observation_size, port.goal_size, port.action_size,
                port.distance_threshold, port.reward_type) == (
            ref.observation_size, ref.goal_size, ref.action_size,
            ref.distance_threshold, ref.reward_type)
        _assert_same(port.reset(), ref.reset(), "reset")
        rng = np.random.RandomState(1)
        achieved, desired = [], []
        for t in range(12):
            a = rng.uniform(-1, 1, (2, port.action_size)).astype(np.float32)
            got, want = port.step(a), ref.step(a)
            assert len(got) == len(want) == 7
            for i, (g, w) in enumerate(zip(got, want)):
                _assert_same(g, w, f"step {t} output {i}")
            achieved.append(want[1]["achieved_goal"])
            desired.append(want[1]["desired_goal"])
        ag, dg = np.concatenate(achieved), np.concatenate(desired)
        # goals near the threshold on both sides of it
        dg[:4] = ag[:4] + np.array([0.049, 0.0, 0.0], np.float32)
        dg[4:8] = ag[4:8] + np.array([0.0, 0.051, 0.0], np.float32)
        env = ref.envs[0].unwrapped
        for reward_type in ("sparse", "dense"):
            port.reward_type = ref.reward_type = reward_type
            env.reward_type = reward_type
            got = port.compute_reward(torch.as_tensor(ag),
                                      torch.as_tensor(dg)).numpy()
            want = np.asarray(ref.compute_reward(jnp.asarray(ag),
                                                 jnp.asarray(dg)))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=reward_type)
            np.testing.assert_allclose(
                got, env.compute_reward(ag, dg, None), rtol=1e-6,
                atol=1e-7, err_msg=reward_type)
    finally:
        port.close()
        ref.close()


def test_fault_reset_seeds_follow_env_order():
    """The JAX env draws the seed of each reset inside its worker thread
    (ilswiss_tpu/envs/host_mujoco.py:100-110), so envs that end in one step
    take the seeds in the order the threads reach the generator.  Here the
    steps of 4 hopper envs are made to finish in reverse env order: the JAX
    env's resets then differ from its one-thread run's, the port's equal
    the JAX one-thread run's."""
    import time

    def delayed(env):
        for i, e in enumerate(env.envs):
            e.step = (lambda a, _step=e.step, _d=0.03 * (3 - i):
                      (time.sleep(_d), _step(a))[1])
        return env

    kw = dict(num_envs=4, seed=2, max_episode_steps=3)
    envs = {"port": delayed(phost.GymVectorEnv("hopper", **kw)),
            "jax": delayed(jhost.GymVectorEnv("hopper", **kw)),
            "jax_one_thread": jhost.GymVectorEnv("hopper", num_threads=1,
                                                 **kw)}
    try:
        out = {k: [e.reset()] for k, e in envs.items()}
        a = np.zeros((4, 3), np.float32)
        for _ in range(3):
            for k, e in envs.items():
                out[k].append(e.step(a)[5])
        want = np.stack(out["jax_one_thread"])
        np.testing.assert_array_equal(np.stack(out["port"]), want)
        assert not np.array_equal(np.stack(out["jax"]), want)
    finally:
        for e in envs.values():
            e.close()


class _Stream:
    """A host env of 3 envs whose step outputs are a seeded stream, with
    terminals and truncations, for the wrappers."""

    num_envs, name, observation_size, action_size = 3, "stream", 4, 2
    max_episode_steps = 7

    def __init__(self):
        self.rng = np.random.RandomState(5)

    def _obs(self):
        return self.rng.randn(3, 4).astype(np.float32)

    def reset(self, seed=None):
        return self._obs()

    def step(self, actions):
        terminal = self.rng.rand(3) < 0.3
        done = terminal | (self.rng.rand(3) < 0.2)
        return (self._obs(), self._obs(),
                self.rng.randn(3).astype(np.float32), terminal, done,
                self._obs())

    def close(self):
        pass


@pytest.mark.parametrize("wrap", ["scaled", "minmax", "absorbing",
                                  "scaled_absorbing"])
def test_host_wrappers_match_jax_on_one_stream(wrap):
    """The three wrappers (and the launcher's stack of two) over identical
    inner streams give bit-equal outputs for 25 steps."""
    mean = np.array([0.5, -1.0, 0.0, 2.0], np.float32)
    std = np.array([2.0, 0.5, 1.0, 3.0], np.float32)

    def build(mod):
        env = _Stream()
        if wrap.startswith("scaled"):
            env = mod.ScaledHostEnv(env, mean, std)
        elif wrap == "minmax":
            env = mod.MinmaxHostEnv(env, mean - std, mean + std)
        if wrap.endswith("absorbing"):
            env = mod.AbsorbingHostEnv(env)
        return env

    port, ref = build(phost), build(jhost)
    assert (port.observation_size, port.max_episode_steps) == (
        ref.observation_size, ref.max_episode_steps)
    _assert_same(port.reset(), ref.reset(), "reset")
    for t in range(25):
        a = np.zeros((3, 2), np.float32)
        for i, (g, w) in enumerate(zip(port.step(a), ref.step(a))):
            _assert_same(g, w, f"{wrap} step {t} output {i}")


# --- the native engine -------------------------------------------------------
@pytest.mark.parametrize("name", sorted(native._ENV_TYPES))
def test_native_engine_matches_the_port_gym_env(name):
    """The state injected into both, then up to 15 steps of one action
    sequence: observations, rewards and terminals at
    tests/test_native_mujoco.py's tolerances."""
    eng = native.NativeMjVectorEnv(name, num_envs=1, seed=0)
    gv = phost.GymVectorEnv(name, num_envs=1, seed=0)
    try:
        ref = gv.envs[0].unwrapped
        gv.reset()
        rng = np.random.RandomState(0)
        qpos = ref.init_qpos + rng.uniform(-0.005, 0.005, ref.model.nq)
        qvel = ref.init_qvel + rng.uniform(-0.005, 0.005, ref.model.nv)
        ref.set_state(qpos, qvel)
        eng.set_state(0, qpos, qvel)
        for t in range(15):
            a = rng.uniform(-1, 1, (1, eng.action_size)).astype(np.float32)
            _, want_obs, want_rew, want_term, _, _ = gv.step(a)
            _, got_obs, got_rew, got_term, got_done, _ = eng.step(a)
            tol = 1e-5 * (10 ** (t / 5))
            np.testing.assert_allclose(got_obs, want_obs, rtol=1e-4,
                                       atol=tol, err_msg=f"{name} t={t}")
            np.testing.assert_allclose(got_rew, want_rew, rtol=1e-3,
                                       atol=tol)
            assert bool(got_term[0]) == bool(want_term[0])
            if want_term[0] or got_done[0]:
                break
    finally:
        eng.close()
        gv.close()


def test_native_build_writes_only_under_build():
    """The library lands in build/native/ under a hash of its source and
    command; the port's package directory holds only the source."""
    lib = native.build_library()
    assert lib.parent == ROOT / "build" / "native"
    assert lib.name.startswith("libmjvec-") and lib.suffix == ".so"
    assert native.build_library() == lib          # reused, not rebuilt
    pkg_native = ROOT / "ilswiss_tpu_torch" / "native"
    assert sorted(p.name for p in pkg_native.iterdir()) == ["mjvec.cpp"]


def test_native_engine_names_a_missing_package(monkeypatch):
    real = native.importlib.import_module

    def missing(name, *a):
        if name.split(".")[0] in ("mujoco", "gymnasium"):
            raise ImportError(f"No module named '{name}'")
        return real(name, *a)

    monkeypatch.setattr(native.importlib, "import_module", missing)
    with pytest.raises(ImportError, match="'mujoco' package"):
        native.build_library()
    with pytest.raises(ImportError, match="'gymnasium' package"):
        native._assets_dir()
    with pytest.raises(ValueError, match="GymVectorEnv runs the rest"):
        native.NativeMjVectorEnv("lunarlandercont", 1)


class _Log:
    def __init__(self):
        self.lines = []

    def log(self, msg):
        self.lines.append(msg)


def test_fault_native_engine_falls_back_only_without_it(monkeypatch):
    """Not the JAX launcher's `except Exception` (experiments.py:88-101):
    a machine without the engine (ImportError, OSError) falls back to
    gymnasium with the JAX log line; any other error, a compile error of
    mjvec.cpp (RuntimeError) among them, raises."""
    log = _Log()
    env = pexp._make_host_env({}, "hopper", {"max_episode_steps": 10}, 2, 0,
                              log)
    assert isinstance(env, native.NativeMjVectorEnv)
    assert log.lines == ["using native mjvec engine for hopper"]
    env.close()
    for err in (ImportError("the native MuJoCo engine needs the 'mujoco' "
                            "package"), FileNotFoundError("g++")):
        def fail(*a, err=err, **k):
            raise err
        monkeypatch.setattr(native, "NativeMjVectorEnv", fail)
        log = _Log()
        env = pexp._make_host_env({}, "hopper", {}, 2, 0, log)
        assert isinstance(env, phost.GymVectorEnv)
        assert log.lines == [f"native engine unavailable ({err}); using gym"]
        env.close()

    def compile_error(*a, **k):
        raise RuntimeError("g++ failed to build mjvec.cpp")

    monkeypatch.setattr(native, "NativeMjVectorEnv", compile_error)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pexp._make_host_env({}, "hopper", {}, 2, 0, _Log())
    # use_native_engine: false takes gymnasium without trying
    env = pexp._make_host_env({"use_native_engine": False}, "hopper", {}, 2,
                              0, _Log())
    assert isinstance(env, phost.GymVectorEnv)
    env.close()
