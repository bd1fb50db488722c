"""The env classes that reach the general engine, beside ant
(tests/test_torch_ant.py): humanoid, humanoid_trunc_obs, swimmer, the
inverted double pendulum, and the planar inverted pendulum
(ilswiss_tpu_torch/envs/locomotion.py vs ilswiss_tpu/envs/locomotion.py).

`_reset` gets the draws the JAX env makes from its key; `_step` gets the
same state and action.  The JAX `_step` of the three small models is jitted
whole (seconds).  Humanoid's control step would take minutes to compile, so
its reference is composed in the test from one compiled single-env
`forward`, as tests/test_torch_ant.py does for ant, and the JAX env's own
`_step` runs eagerly over it.

Tolerance, float32: rtol 2e-4, atol 5e-3 on values divided by max(1, max
|reference|): up to 20 forward evaluations of 15 unconverged Gauss-Seidel
sweeps each, summed in another order by the two engines (the planar path's
pin, tests/test_torch_planar.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilswiss_tpu.envs.locomotion as jloco
import ilswiss_tpu.ops.rigid_body as jrb
from ilswiss_tpu_torch.envs import ENV_REGISTRY, make, make_vec
from ilswiss_tpu_torch.ops import pgs
from ilswiss_tpu_torch.ops import planar_dynamics as pd

torch.set_num_threads(1)

B, ITERS = 2, 15
F32 = dict(rtol=2e-4, atol=5e-3)
JAX_CLASSES = {
    "humanoid": jloco.HumanoidDevice,
    "swimmer": jloco.SwimmerDevice,
    "inverteddoublependulum": jloco.InvertedDoublePendulumDevice,
    "invertedpendulum": jloco.InvertedPendulumDevice,
}
WIDTHS = {"hopper": 11, "ant": 105, "ant_trunc_obs": 27, "humanoid": 348,
          "humanoid_trunc_obs": 45, "swimmer": 8,
          "inverteddoublependulum": 9, "invertedpendulum": 4,
          "walker": 17, "halfcheetah": 17}
# the registry's other envs, held against JAX in test_torch_envs_classic.py
# (pendulum, mountain), test_torch_cartpole_nstep.py (cartpole) and
# test_torch_her_gcsl.py (the goal env reach2d)
CLASSIC = {"pendulum", "mountain", "cartpole", "reach2d", "pendulum_pixels"}


def _assert_scaled_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(got / scale, want / scale, err_msg=what, **F32)


def _states(name, seed=0):
    """(q, qd, action, warm) [B, .] float32 near the model's rest pose;
    humanoid lowered onto its feet with an un-normalized quaternion."""
    m = jloco._model(name)
    rng = np.random.RandomState(seed)
    q = m.qpos0 + 0.05 * rng.randn(B, m.nq)
    if name == "humanoid":
        q[:, 2] = 1.28 + 0.05 * rng.rand(B)
        q[:, 3:7] = (np.array([1.0, 0, 0, 0]) + 0.05 * rng.randn(B, 4)) * 1.02
    qd = 0.3 * rng.randn(B, m.nv)
    lo, hi = m.ctrl_range[:, 0], m.ctrl_range[:, 1]
    action = rng.uniform(lo, hi, (B, m.nu))
    warm = 0.2 * np.abs(rng.randn(B, m.nrow))
    return tuple(x.astype(np.float32) for x in (q, qd, action, warm))


@pytest.mark.parametrize("name", sorted(JAX_CLASSES))
def test_reset_matches_jax(name):
    jenv = JAX_CLASSES[name]()
    env = make(name, device="cpu")
    m, s = jenv.model, jenv.reset_noise_scale
    keys = list(jax.random.split(jax.random.PRNGKey(5), B))
    want = [jenv._reset(k) for k in keys]
    dq, dqd = [], []
    for key in keys:                       # the draws of `_sample_state`
        kq, kv = jax.random.split(key)
        dq.append(jax.random.uniform(kq, (m.nq,), jnp.float32, -s, s))
        dqd.append(s * jax.random.normal(kv, (m.nv,), jnp.float32)
                   if jenv.gaussian_qvel_noise else
                   jax.random.uniform(kv, (m.nv,), jnp.float32, -s, s))
    internal, obs = env._reset((torch.as_tensor(np.stack(dq)),
                                torch.as_tensor(np.stack(dqd))))
    assert tuple(obs.shape) == (B, WIDTHS[name])
    for k in range(3):
        np.testing.assert_allclose(internal[k].numpy(), np.stack(
            [np.asarray(w[0][k]) for w in want]), atol=1e-6)
    _assert_scaled_close(obs.numpy(),
                         np.stack([np.asarray(w[1]) for w in want]), "obs")


def _compare_step(env, want, q, qd, action, warm):
    T = torch.as_tensor
    internal, obs, reward, terminal = env._step((T(q), T(qd), T(warm)),
                                                T(action))
    for k, what in enumerate(("q", "qd", "warm")):
        _assert_scaled_close(internal[k].numpy(), np.stack(
            [np.asarray(w[0][k]) for w in want]), what)
    _assert_scaled_close(obs.numpy(),
                         np.stack([np.asarray(w[1]) for w in want]), "obs")
    np.testing.assert_allclose(reward.numpy(), np.stack(
        [np.asarray(w[2]) for w in want]), **F32)
    want_terminal = np.stack([np.asarray(w[3]) for w in want])
    np.testing.assert_array_equal(terminal.numpy(), want_terminal)
    return obs, want_terminal


@pytest.mark.parametrize("name", ["swimmer", "inverteddoublependulum",
                                  "invertedpendulum"])
def test_step_matches_jax(name):
    """obs, reward and terminal after one control step; env 1 of the two
    pendulums starts tipped over and terminates."""
    jenv = JAX_CLASSES[name]()
    env = make(name, device="cpu")
    q, qd, action, warm = _states(name)
    if name == "swimmer":
        q[0, 3] = 1.8                      # past the joint limit
    else:
        q[1, 1] = 0.9
    step = jax.jit(lambda internal, a: jenv._step(internal, a, None))
    want = [step(tuple(jnp.asarray(x[i]) for x in (q, qd, warm)),
                 jnp.asarray(action[i])) for i in range(B)]
    k1, k4 = pd.planar_forward.launches, pgs.pgs_solve.launches
    obs, terminal = _compare_step(env, want, q, qd, action, warm)
    assert (k1, k4) == (pd.planar_forward.launches, pgs.pgs_solve.launches)
    assert tuple(obs.shape) == (B, WIDTHS[name])
    assert terminal.tolist() == [False, name != "swimmer"]


@pytest.fixture(scope="module")
def jax_humanoid_step():
    """`physics_step(m, q, qd, ctrl, iters, f0)` for ONE humanoid, composed
    from one compiled JAX `forward` as `_rk4_step` composes it."""
    m = jloco._model("humanoid")
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


def test_humanoid_step_matches_jax(jax_humanoid_step, monkeypatch):
    """The 348 observation entries (cinert and cvel at the last forward
    evaluation's state, the actuator forces, cfrc_ext), the mass-center
    reward and the height check; env 1 starts too low and terminates."""
    monkeypatch.setattr(jloco, "physics_step", jax_humanoid_step)
    jenv = jloco.HumanoidDevice()
    q, qd, action, warm = _states("humanoid")
    q[1, 2] = 0.95
    want = [jenv._step(tuple(jnp.asarray(x[i]) for x in (q, qd, warm)),
                       jnp.asarray(action[i]), None) for i in range(B)]
    obs, terminal = _compare_step(make("humanoid", device="cpu"), want, q, qd,
                                  action, warm)
    assert terminal.tolist() == [False, True]
    assert float(obs[:, -78:].abs().max()) > 1.0  # contact forces are seen
    # the truncated-observation variant: the same step, 45 entries
    trunc = make("humanoid_trunc_obs", device="cpu")
    T = torch.as_tensor
    _, t_obs, t_reward, t_terminal = trunc._step((T(q), T(qd), T(warm)),
                                                 T(action))
    assert torch.equal(t_obs, obs[:, :45])
    np.testing.assert_allclose(t_reward.numpy(),
                               np.stack([np.asarray(w[2]) for w in want]),
                               **F32)
    assert t_terminal.tolist() == [False, True]


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_registered_envs_step_on_cpu(name):
    """`make_vec(name, device="cpu")` resets and steps every registered
    locomotion env at its observation width."""
    assert set(ENV_REGISTRY) == set(WIDTHS) | CLASSIC
    vec = make_vec(name, B, device="cpu")
    assert vec.env.observation_size == WIDTHS[name]
    g = torch.Generator().manual_seed(0)
    state = vec.reset(vec.env.sample_reset_noise(B, g))
    action = torch.rand(B, vec.env.action_size, generator=g) * 2 - 1
    state, tr = vec.step(state, action, vec.env.sample_reset_noise(B, g))
    assert tuple(tr.next_obs.shape) == tuple(state.obs.shape) == (
        B, WIDTHS[name])
    assert torch.isfinite(tr.next_obs).all() and torch.isfinite(
        tr.reward).all()
    assert tr.reward.dtype == torch.float32 and tr.terminal.dtype == torch.bool
    assert tuple(state.internal[2].shape) == (B, vec.env.model.nrow)
