"""CartPole (ilswiss_tpu_torch/envs/classic/cartpole.py), the discrete
ring and n-step sampling (ilswiss_tpu_torch/data/replay.py) against the
JAX package's (ilswiss_tpu/envs/classic/cartpole.py,
ilswiss_tpu/data/replay.py).

CartPole: 4 envs through `VectorEnv` for 200 steps from the same resets
(the JAX env's own reset draws, rebuilt from its per-env keys) and the
same integer actions, autoresets included: terminals, truncations and
step counts exactly, states and observations within rtol = atol = 1e-6
(a few float32 operations a step in the same order on both sides).  The
ring: those transitions stored by both `replay_add`s, exactly, with int32
actions.  `replay_sample_nstep`: the cases of tests/test_nstep.py and a
random ring with episode ends, terminals and a wrapped cursor, from the
same uniforms: integers (n_step_used, actions) exactly, reward sums and
observations within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilswiss_tpu.data.replay import replay_add as jreplay_add
from ilswiss_tpu.data.replay import replay_init as jreplay_init
from ilswiss_tpu.data.replay import replay_sample_nstep as jsample_nstep
from ilswiss_tpu.envs import make_vec as jmake_vec
from ilswiss_tpu.envs.vector import Transition as JTransition
from ilswiss_tpu_torch.data.replay import (
    replay_add, replay_init, replay_sample_nstep,
)
from ilswiss_tpu_torch.envs import make, make_vec
from ilswiss_tpu_torch.envs.vector import Transition
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

N, STEPS = 4, 200
EXACT6 = dict(rtol=1e-6, atol=1e-6)


def _reset_draws(rngs):
    """The reset draw of one JAX `VectorEnv.step` for each env: the
    stepped key's carry, split for the reset, split again by
    `Environment.reset`, then CartPole's uniform(+-0.05) [4]."""
    out = []
    for key in rngs:
        _, carry = jax.random.split(key)
        k_reset, _ = jax.random.split(jax.random.split(carry)[1])
        out.append(jax.random.uniform(k_reset, (4,), minval=-0.05,
                                      maxval=0.05))
    return (torch.as_tensor(np.array(np.stack(out))),)


@pytest.fixture(scope="module")
def rollout():
    """The JAX rollout: 200 steps of 4 envs, every state and transition;
    the actions from a seeded numpy generator."""
    jvec = jmake_vec("cartpole", num_envs=N)
    state = jvec.reset(jax.random.PRNGKey(3))
    actions = np.random.RandomState(0).randint(0, 2, (STEPS, N)).astype(
        np.int32)
    step = jax.jit(jvec.step)
    states, transitions = [jax.tree.map(np.asarray, state)], []
    for a in actions:
        state, tr = step(state, jnp.asarray(a))
        states.append(jax.tree.map(np.asarray, state))
        transitions.append(jax.tree.map(np.asarray, tr))
    return dict(states=states, transitions=transitions, actions=actions)


def test_cartpole_reset_matches_jax():
    jvec = jmake_vec("cartpole", num_envs=N)
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    want = jax.tree.map(np.asarray, jvec.reset(jax.random.PRNGKey(3)))
    draws = []
    for key in keys:                    # base.py reset: split, then _reset
        reset_key, _ = jax.random.split(key)
        draws.append(jax.random.uniform(reset_key, (4,), minval=-0.05,
                                        maxval=0.05))
    env = make("cartpole", device="cpu")
    state = env.reset((torch.as_tensor(np.array(np.stack(draws))),))
    np.testing.assert_array_equal(state.internal[0].numpy(), want.internal)
    np.testing.assert_array_equal(state.obs.numpy(), want.obs)
    assert state.obs.data_ptr() != state.internal[0].data_ptr()
    assert (env.observation_size, env.action_size, env.discrete,
            env.max_episode_steps) == (4, 2, True, 500)
    # the sampler draws inside the JAX reset's bounds
    (u,) = env.sample_reset_noise(1000, torch.Generator().manual_seed(0))
    assert u.shape == (1000, 4) and float(u.abs().max()) <= 0.05


def test_cartpole_200_steps_match_jax(rollout):
    states, trs = rollout["states"], rollout["transitions"]
    vec = make_vec("cartpole", N, device="cpu")
    state = convert.env_state_from_jax(states[0], "cpu")
    episodes = 0
    for i, a in enumerate(rollout["actions"]):
        state, tr = vec.step(state, torch.as_tensor(a.astype(np.int64)),
                             _reset_draws(states[i].rng))
        want, jtr = states[i + 1], trs[i]
        np.testing.assert_array_equal(tr.terminal.numpy(), jtr.terminal,
                                      err_msg=f"step {i}")
        np.testing.assert_array_equal(tr.done.numpy(), jtr.done)
        np.testing.assert_array_equal(tr.reward.numpy(), jtr.reward)
        np.testing.assert_allclose(tr.next_obs.numpy(), jtr.next_obs,
                                   err_msg=f"step {i}", **EXACT6)
        np.testing.assert_allclose(state.internal[0].numpy(),
                                   want.internal, err_msg=f"step {i}",
                                   **EXACT6)
        np.testing.assert_allclose(state.obs.numpy(), want.obs, **EXACT6)
        np.testing.assert_array_equal(state.t.numpy(), want.t)
        episodes += int(tr.done.sum())
    assert episodes > 10            # random actions end many episodes


def test_cartpole_time_limit_and_float_actions():
    """Truncation at max_episode_steps, and an action that is not 0 or 1
    as an integer pushes left, as the JAX `astype(int32) == 1`."""
    env = make("cartpole", device="cpu", max_episode_steps=3)
    state = env.reset((torch.zeros(2, 4),))
    for t in range(3):
        out = env.step(state, torch.tensor([1, 0]))
        state = out.state
    assert out.truncation.tolist() == [True, True]
    assert not out.terminal.any()
    a = env._step((torch.zeros(3, 4),), torch.tensor([0.7, 1.2, 2.0]))
    x_dot_acc = a[0][0][:, 3]
    assert x_dot_acc[0] > 0 and x_dot_acc[1] < 0 and x_dot_acc[2] > 0


def test_discrete_ring_matches_replay_add(rollout):
    """The 200 transitions into a 64-row ring of each package (the cursor
    wraps 12 times): int32 actions [capacity], every field and episode id
    exactly."""
    jring = jreplay_init(64, 4, 2, write_batch=N, discrete=True)
    add = jax.jit(jreplay_add)
    ring = replay_init(64, 4, 2, write_batch=N, device="cpu", discrete=True)
    assert ring.data["action"].shape == (64,)
    assert ring.data["action"].dtype == torch.int32
    for jtr in rollout["transitions"]:
        jring = add(jring, jax.tree.map(jnp.asarray, jtr))
        ring = replay_add(ring, Transition(
            obs=torch.as_tensor(jtr.obs),
            action=torch.as_tensor(jtr.action.astype(np.int64)),
            reward=torch.as_tensor(jtr.reward),
            next_obs=torch.as_tensor(jtr.next_obs),
            terminal=torch.as_tensor(jtr.terminal),
            done=torch.as_tensor(jtr.done)))
    got = convert.replay_to_numpy(ring)
    want = jax.tree.map(np.asarray, jring)
    assert (got["ptr"], got["size"]) == (int(want.ptr), int(want.size))
    for k, v in want.data.items():
        assert got["data"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got["data"][k], v, err_msg=k)
    np.testing.assert_array_equal(got["ep_id"], want.ep_id)
    np.testing.assert_array_equal(got["env_ep"], want.env_ep)


# --- n-step sampling ---------------------------------------------------------
def _fill(num_envs=2, steps=10, done_at=None, terminal_at=None):
    """tests/test_nstep.py's ring (obs = step, reward 1), in both
    packages; `terminal_at` also marks a step terminal in one env."""
    jst = jreplay_init(capacity=64, obs_size=1, action_size=1,
                       write_batch=num_envs)
    st = replay_init(64, 1, 1, write_batch=num_envs, device="cpu")
    for t in range(steps):
        done = np.zeros((num_envs,), bool)
        if done_at is not None and t == done_at:
            done[:] = True
        term = done.copy()
        if terminal_at is not None and t == terminal_at:
            term[0] = True
        tr = dict(obs=np.full((num_envs, 1), float(t), np.float32),
                  action=np.zeros((num_envs, 1), np.float32),
                  reward=np.full((num_envs,), 1.0 + 0.1 * t, np.float32),
                  next_obs=np.full((num_envs, 1), float(t + 1), np.float32),
                  terminal=term, done=done)
        jst = jreplay_add(jst, JTransition(**{k: jnp.asarray(v)
                                              for k, v in tr.items()}))
        st = replay_add(st, Transition(**{k: torch.as_tensor(v)
                                          for k, v in tr.items()}))
    return jst, st


def _random_ring(seed=0, num_envs=3, steps=40, capacity=48):
    """Random rewards, episode ends and terminals; the cursor wraps."""
    rng = np.random.RandomState(seed)
    jst = jreplay_init(capacity, 2, 1, write_batch=num_envs, discrete=True)
    st = replay_init(capacity, 2, 1, write_batch=num_envs, device="cpu",
                     discrete=True)
    for _ in range(steps):
        term = rng.rand(num_envs) < 0.1
        done = term | (rng.rand(num_envs) < 0.1)
        tr = dict(obs=rng.randn(num_envs, 2).astype(np.float32),
                  action=rng.randint(0, 3, num_envs).astype(np.int32),
                  reward=rng.randn(num_envs).astype(np.float32),
                  next_obs=rng.randn(num_envs, 2).astype(np.float32),
                  terminal=term, done=done)
        jst = jreplay_add(jst, JTransition(**{k: jnp.asarray(v)
                                              for k, v in tr.items()}))
        st = replay_add(st, Transition(**{k: torch.as_tensor(v)
                                          for k, v in tr.items()}))
    return jst, st


def _check_nstep(jst, st, key, batch, n_step, discount):
    want = jax.tree.map(np.asarray, jsample_nstep(jst, key, batch, n_step,
                                                  discount))
    u = torch.as_tensor(np.asarray(jax.random.uniform(key, (batch,))))
    got = {k: v.numpy() for k, v in replay_sample_nstep(
        st, u, n_step, discount).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        if np.issubdtype(v.dtype, np.integer):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, err_msg=k, **EXACT6)
    return got


def test_nstep_rewards_within_episode():
    jst, st = _fill(num_envs=2, steps=10)
    got = _check_nstep(jst, st, jax.random.PRNGKey(0), 64, 3, 0.9)
    np.testing.assert_allclose(got["next_obs"][:, 0],
                               got["obs"][:, 0] + got["n_step_used"],
                               rtol=1e-5)
    assert got["n_step_used"].max() == 3


def test_nstep_stops_at_episode_ends_and_terminals():
    for done_at, terminal_at in ((4, None), (None, 3), (6, 2)):
        jst, st = _fill(num_envs=2, steps=10, done_at=done_at,
                        terminal_at=terminal_at)
        got = _check_nstep(jst, st, jax.random.PRNGKey(1), 256, 5, 1.0)
        if done_at is not None:
            start = got["obs"][:, 0]
            assert (start + got["n_step_used"] <= done_at + 1 + 1e-6)[
                start <= done_at].all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nstep_on_a_random_wrapped_ring(seed):
    jst, st = _random_ring(seed)
    assert st.size == 48 and st.ptr == 40 * 3 % 48
    got = _check_nstep(jst, st, jax.random.PRNGKey(10 + seed), 128, 4, 0.95)
    assert got["action"].dtype == np.int32
    assert set(np.unique(got["n_step_used"])) > {1}
