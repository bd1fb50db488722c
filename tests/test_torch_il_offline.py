"""Imitation without an adversary in the port (ilswiss_tpu_torch/
envs/experts.py, runtime/collector.py, algorithms/bc.py,
runtime/offline.py, algorithms/dagger.py and the bc, dagger, gen_expert
and eval_policy launchers) against the JAX package's, the twin of
tests/test_il.py's collector and BC cases, tests/test_gcsl_dagger.py's
DAgger case and tests/test_gen_expert.py: the scripted experts over a
grid that crosses their thresholds, `collect_transitions` on pendulum
with every JAX reset draw replayed, three BC steps in each mode, the MLE
gradient on expert actions at +-1, one `OfflineLoop` epoch, `DAggerLoop`'s
seeded ring, pretraining and one epoch, the ring's write across the wrap
(with the JAX clamp shown as the fault), `_subsample_transitions`, and
the launchers end to end on pendulum: scripted and trained experts,
`eval_policy`'s `save_samples`, a DAgger run querying a trained snapshot,
the bc and dagger specs through the CLI in a process without JAX, and
`load_params` refused.

Pins (tests/test_torch_offpolicy_trainers.py's): forwards at rtol 1e-5,
atol 1e-6; updates, and rows of env rollouts (their steps' rounding
summed), at rtol 2e-4, atol 2e-5; ring cursors, episode ids, seeded rows
and integer draws exactly.
"""

import math
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

from ilswiss_tpu.algorithms.bc import BC as JBC
from ilswiss_tpu.algorithms.bc import BCConfig as JBCConfig
from ilswiss_tpu.algorithms.dagger import DAggerLoop as JDAggerLoop
from ilswiss_tpu.algorithms.dagger import (
    DAggerLoopConfig as JDAggerLoopConfig,
)
from ilswiss_tpu.data.demo import subsample_trajs as jsubsample_trajs
from ilswiss_tpu.data.replay import replay_add as jreplay_add
from ilswiss_tpu.envs import make_vec as jmake_vec
from ilswiss_tpu.envs import experts as jexperts
from ilswiss_tpu.envs.vector import Transition as JTransition
from ilswiss_tpu.launchers import experiments as jexp
from ilswiss_tpu.models import distributions as JD
from ilswiss_tpu.runtime.collector import (
    collect_transitions as jcollect_transitions,
)
from ilswiss_tpu.runtime.offline import OfflineLoop as JOfflineLoop
from ilswiss_tpu_torch.algorithms.bc import BC, BCConfig
from ilswiss_tpu_torch.algorithms.dagger import (
    DAggerLoop, DAggerLoopConfig, DAggerRunnerState,
)
from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.algorithms.td3 import TD3, TD3Config
from ilswiss_tpu_torch.data.demo import load_demos_npz
from ilswiss_tpu_torch.envs import experts, make_vec
from ilswiss_tpu_torch.launchers import experiments as pexp
from ilswiss_tpu_torch.launchers.variant import build_variants
from ilswiss_tpu_torch.runtime.checkpoint import restore_subtree
from ilswiss_tpu_torch.runtime.collector import collect_transitions
from ilswiss_tpu_torch.runtime.loop import Noise
from ilswiss_tpu_torch.runtime.offline import (
    OfflineLoop, OfflineRunnerState,
)
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LISTING = (ROOT / "demos_listing.yaml").read_bytes()
PIN = dict(rtol=2e-4, atol=2e-5)
FWD = dict(rtol=1e-5, atol=1e-6)
EXACT = dict(rtol=0, atol=0)
B, H, BS = 8, 32, 16          # envs, net width, batch rows
EP_STEPS, T = 50, 200          # pendulum's horizon here, collector steps


# --- the JAX draws ----------------------------------------------------------
def _pendulum_reset(k_reset):
    """The draws of the JAX pendulum `_reset(k_reset)`."""
    k1, k2 = jax.random.split(k_reset)
    return (jax.random.uniform(k1, (), minval=-jnp.pi, maxval=jnp.pi),
            jax.random.uniform(k2, (), minval=-1.0, maxval=1.0))


@jax.jit
def _initial_reset_draws(key):
    """The draws of the JAX `VectorEnv.reset(key)` (B envs)."""
    return jax.vmap(lambda k: _pendulum_reset(jax.random.split(k)[0]))(
        jax.random.split(key, B))


@jax.jit
def _step_reset_draws(rngs):
    """The reset draws of one JAX `VectorEnv.step` from the per-env keys
    (Environment.step, VectorEnv.step, Environment.reset)."""
    def one(key):
        _, carry = jax.random.split(key)
        k_reset, _ = jax.random.split(jax.random.split(carry)[1])
        return _pendulum_reset(k_reset)
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
            return tuple(torch.as_tensor(np.array(v)) for v in value)
        return torch.as_tensor(np.array(value))

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
    elif isinstance(want, int):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **pin)


def _jax_policy_state(jstate):
    s = jax.tree.map(np.asarray, jstate)
    adam = s.policy_opt[0]
    return {"policy_params": s.policy_params,
            "policy_opt": {"count": int(adam.count), "mu": adam.mu,
                           "nu": adam.nu}}


def _assert_ring(ring, jring, pin=FWD):
    rep = convert.replay_to_numpy(ring)
    jr = jax.tree.map(np.asarray, jring)
    assert (rep["ptr"], rep["size"]) == (int(jr.ptr), int(jr.size))
    np.testing.assert_array_equal(rep["ep_id"], jr.ep_id)
    for k, v in jr.data.items():
        np.testing.assert_allclose(rep["data"][k], v, err_msg=k, **pin)


# --- 1. the scripted experts --------------------------------------------------
def test_scripted_experts_match_jax_across_their_thresholds():
    """A grid of angles and velocities crossing |angle| = 0.35, |thdot| =
    8 and thdot = -1e-6 (the pump's sign), and mountain velocities around
    -1e-8: the same branch everywhere and the same actions."""
    angle = np.concatenate([np.linspace(-np.pi, np.pi, 61),
                            [-0.35, 0.35, -0.3499999, 0.3500001]])
    thdot = np.concatenate([np.linspace(-9.0, 9.0, 37),
                            [-8.0, 8.0, -7.999999, 0.0, -1e-6, -2e-6,
                             1e-7]])
    a, v = (x.ravel() for x in np.meshgrid(angle, thdot))
    obs = np.stack([np.cos(a), np.sin(a), v], -1).astype(np.float32)
    want = np.asarray(jexperts.pendulum_expert(jnp.asarray(obs)))
    got = experts.pendulum_expert(torch.as_tensor(obs)).numpy()
    assert got.shape == want.shape == (len(a), 1)
    np.testing.assert_array_equal(got, want)
    # both branches and both saturations of the pump are on the grid
    near_top = (np.abs(a) < 0.35) & (np.abs(v) < 8.0)
    assert near_top.any() and (~near_top).any()
    assert (np.abs(want[~near_top]) == 1.0).any()
    vel = np.array([-1.0, -1e-8, -2e-8, -5e-9, 0.0, 1e-9, 0.7], np.float32)
    mobs = np.stack([np.zeros_like(vel), vel], -1)
    np.testing.assert_array_equal(
        experts.mountain_expert(torch.as_tensor(mobs)).numpy(),
        np.asarray(jexperts.mountain_expert(jnp.asarray(mobs))))
    assert set(experts.SCRIPTED_EXPERTS) == set(jexperts.SCRIPTED_EXPERTS)


# --- 2. the collector -----------------------------------------------------------
# a smooth deterministic policy (a trained policy's stand-in): the
# scripted expert's branches would flip on the last-bit differences of
# the two packages' sin and cos and part the trajectories
W = np.array([[0.3], [-0.8], [-0.25]], np.float32)


def _jpolicy(obs):
    return jnp.tanh(obs @ jnp.asarray(W))


def _policy(obs, noise=None):
    return torch.tanh(obs @ torch.as_tensor(W))


@pytest.fixture(scope="module")
def collected():
    """The JAX `collect_transitions` of `_jpolicy` (B envs, T steps,
    episodes of EP_STEPS), and every reset draw it made."""
    jvec = jmake_vec("pendulum", num_envs=B, max_episode_steps=EP_STEPS)
    key = jax.random.PRNGKey(3)
    jdemos = jcollect_transitions(jvec, lambda o, k: _jpolicy(o), T, key)
    k_reset, _ = jax.random.split(key)
    seq = [_reset(_initial_reset_draws(k_reset))]
    step = jax.jit(lambda s: jvec.step(s, _jpolicy(s.obs)))
    jstate = jvec.reset(k_reset)
    for _ in range(T):
        seq.append(_reset(_step_reset_draws(jstate.rng)))
        jstate, _ = step(jstate)
    return jdemos, seq


def test_collect_transitions_matches_jax(collected):
    jdemos, seq = collected
    vec = make_vec("pendulum", B, device="cpu", max_episode_steps=EP_STEPS)
    noise = _Draws(seq)
    demos = collect_transitions(vec, _policy, T, noise)
    assert not noise.seq, "draws left over"
    # rows of episodes up to 50 steps long carry the steps' rounding (one
    # step agrees at 1e-6, tests/test_torch_envs_classic.py): the loop
    # tests' runner pin; the cursor, size and episode ids exactly
    _assert_ring(demos, jdemos, PIN)
    assert demos.size == T * B and demos.env_ep.shape == (B,)
    assert int(jax.device_get(jdemos.env_ep).shape[0]) == B
    # T / EP_STEPS episodes per env, each with its own id
    assert len(np.unique(demos.ep_id.numpy())) == B * T // EP_STEPS


# --- 3. BC ----------------------------------------------------------------------
def _bc_pair(mode):
    cfg = dict(mode=mode, lr=1e-3, momentum=0.5)
    return (JBC(3, 1, JBCConfig(**cfg), net_size=H, num_hidden_layers=2),
            BC(3, 1, BCConfig(**cfg), net_size=H, num_hidden_layers=2,
               device="cpu"))


def _expert_batch(rng, n=BS):
    """Pendulum observations with the scripted expert's actions, most of
    them exactly at +-1."""
    th = rng.uniform(-np.pi, np.pi, n)
    obs = np.stack([np.cos(th), np.sin(th), rng.uniform(-3, 3, n)],
                   -1).astype(np.float32)
    act = np.asarray(jexperts.pendulum_expert(jnp.asarray(obs)))
    return {"obs": obs, "action": act}


@pytest.fixture(scope="module")
def bc_runs():
    """Per mode: the JAX init state, three batches, the step draws, the
    states after each step and the losses."""
    out = {}
    for mode in ("MLE", "MSE"):
        jbc, _ = _bc_pair(mode)
        rng = np.random.RandomState(1)
        batches = [_expert_batch(rng) for _ in range(3)]
        step = jax.jit(jbc.train_step)
        states, losses, draws = [jbc.init(jax.random.PRNGKey(0))], [], []
        for b, k in zip(batches, jax.random.split(jax.random.PRNGKey(7), 3)):
            draws.append([np.asarray(jax.random.normal(k, (BS, 1)))]
                         if mode == "MSE" else [])
            s, m = step(states[-1], jax.tree.map(jnp.asarray, b), k)
            states.append(s)
            losses.append(float(m["bc_loss"]))
        out[mode] = dict(states=states, losses=losses, batches=batches,
                         draws=draws)
    return out


@pytest.mark.parametrize("mode", ["MLE", "MSE"])
def test_bc_train_steps_match_jax(bc_runs, mode):
    run = bc_runs[mode]
    _, bc = _bc_pair(mode)
    state = convert.bc_state_from_jax(
        bc, jax.tree.map(np.asarray, run["states"][0]))
    _close(convert.bc_state_to_numpy(state),
           _jax_policy_state(run["states"][0]), EXACT)
    assert (np.abs(run["batches"][0]["action"]) == 1.0).mean() > 0.5
    for i in range(3):
        batch = convert.batches_from_numpy(run["batches"][i], "cpu")
        state, metrics = bc.train_step(
            state, batch, *[torch.as_tensor(np.array(d))
                            for d in run["draws"][i]])
        np.testing.assert_allclose(float(metrics["bc_loss"]),
                                   run["losses"][i], **PIN)
        _close(convert.bc_state_to_numpy(state),
               _jax_policy_state(run["states"][i + 1]), PIN)


def test_bc_mle_gradient_at_saturated_actions(bc_runs):
    """MLE on the expert's +-1 actions: log(1 -+ a + 1e-6) makes the
    atanh about +-7.25 and dominates the loss.  One step's gradients,
    those rows kept, against jitted JAX autodiff at the update pin."""
    run = bc_runs["MLE"]
    jbc, bc = _bc_pair("MLE")
    b = run["batches"][0]
    jparams = run["states"][0].policy_params

    def loss_fn(p, obs, acts):
        mean, log_std = jbc.policy.apply(p, obs)
        return -jnp.mean(JD.tanh_normal_log_prob(mean, log_std, acts))

    # jitted with the batch as arguments, as the JAX step is: XLA folds
    # 1.0 + 1e-6 there (models/distributions.py::expert_action_log_prob)
    jgrad = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(
        jparams, jnp.asarray(b["obs"]), jnp.asarray(b["action"])))
    state = convert.bc_state_from_jax(bc, jax.tree.map(np.asarray,
                                                       run["states"][0]))
    from ilswiss_tpu_torch.models import distributions as D
    mean, log_std = state.policy(torch.as_tensor(b["obs"]))
    loss = -torch.mean(D.expert_action_log_prob(
        mean, log_std, torch.as_tensor(np.array(b["action"]))))
    leaves = convert._module_leaves(state.policy)
    grads = torch.autograd.grad(loss, [t for t, _, _ in leaves])
    got = convert._dump_leaves([(g, path, tr) for g, (_, path, tr)
                                in zip(grads, leaves)])
    _close(got, jgrad, PIN)
    assert float(loss.detach()) > 10.0   # the saturated rows dominate


# --- 4. the offline loop ------------------------------------------------------
def test_offline_loop_epoch_matches_jax(collected):
    jdemos, _ = collected
    jbc, bc = _bc_pair("MSE")
    jloop = JOfflineLoop(jbc, jdemos, batch_size=BS)
    jrunner = jloop.init(jax.random.PRNGKey(0))
    steps = 5
    _, k = jax.random.split(jrunner.rng)
    seq = []
    for key in jax.random.split(k, steps):
        k_s, k_t = jax.random.split(key)
        seq += [("replay", np.asarray(jax.random.uniform(k_s, (BS,)))),
                ("sample", np.asarray(jax.random.normal(k_t, (BS, 1))))]
    start = jax.tree.map(np.asarray, jrunner)
    _, epoch = jloop.build(steps)
    jrunner, jmetrics = epoch(jrunner)

    loop = OfflineLoop(bc, convert.replay_from_jax(start.expert, "cpu"),
                       batch_size=BS)
    fresh = loop.init(0)
    assert fresh.expert.data["obs"] is not loop.expert_replay.data["obs"]
    runner = OfflineRunnerState(
        noise=_Draws(seq),
        algo_state=convert.bc_state_from_jax(bc, start.algo_state),
        expert=fresh.expert, total_train_steps=0)
    runner, metrics = loop.train_epoch(runner, steps)
    assert not runner.noise.seq, "draws left over"
    assert runner.total_train_steps == int(jrunner.total_train_steps)
    np.testing.assert_allclose(metrics["bc_loss"],
                               float(jmetrics["bc_loss"]), **PIN)
    _close(convert.bc_state_to_numpy(runner.algo_state),
           _jax_policy_state(jrunner.algo_state), PIN)


# --- 5. DAgger ----------------------------------------------------------------
K_DAGGER, PRETRAIN, CAP = 3, 4, 4096


@pytest.fixture(scope="module")
def dagger_setup(collected):
    """jloop(traj_num, cap) -> the demos' first traj_num episodes (50
    rows each, so n is no multiple of B) and a JAX DAggerLoop on them."""
    jvec = jmake_vec("pendulum", num_envs=B, max_episode_steps=EP_STEPS)
    jbc, _ = _bc_pair("MLE")

    def jloop(traj_num, cap):
        jdemos = jsubsample_trajs(collected[0], traj_num)
        return jdemos, JDAggerLoop(
            jvec, jbc, jexperts.pendulum_expert, jdemos,
            JDAggerLoopConfig(batch_size=BS, aggregate_capacity=cap,
                              grad_steps_per_iter=K_DAGGER))
    return jloop


def _port_dagger(jdemos, cap):
    _, bc = _bc_pair("MLE")
    demos = convert.replay_from_jax(jax.tree.map(np.asarray, jdemos), "cpu")
    return DAggerLoop(make_vec("pendulum", B, device="cpu",
                               max_episode_steps=EP_STEPS),
                      bc, experts.pendulum_expert, demos,
                      DAggerLoopConfig(batch_size=BS, aggregate_capacity=cap,
                                       grad_steps_per_iter=K_DAGGER))


def _port_runner(loop, jr, seq):
    return DAggerRunnerState(
        noise=_Draws(seq),
        env_state=convert.env_state_from_jax(jr.env_state, "cpu"),
        aggregate=convert.replay_from_jax(jr.aggregate, "cpu"),
        algo_state=convert.bc_state_from_jax(loop.algo, jr.algo_state),
        total_env_steps=int(jr.total_env_steps))


def _dagger_iter_draws(jrunner):
    """Every draw of one JAX `DAggerLoop._iter` (dagger.py:87-111)."""
    _, k_act, k_train = jax.random.split(jrunner.rng, 3)
    seq = [("act", np.asarray(jax.random.normal(k_act, (B, 1)))),
           _reset(_step_reset_draws(jrunner.env_state.rng))]
    for key in jax.random.split(k_train, K_DAGGER):
        k_s, _ = jax.random.split(key)
        seq.append(("replay", np.asarray(jax.random.uniform(k_s, (BS,)))))
    return seq


def test_dagger_seed_pretrain_and_epoch_match_jax(dagger_setup):
    jdemos, jloop = dagger_setup(3, CAP)
    loop = _port_dagger(jdemos, CAP)
    jrunner = jloop.init(jax.random.PRNGKey(0))
    n = int(jdemos.size)
    assert n == 150 and n % B
    # the seeded ring: the demo rows at the front, the cursor at n
    seeded = loop.init(0)
    assert (seeded.aggregate.ptr, seeded.aggregate.size) == (n, n)
    _assert_ring(seeded.aggregate, jrunner.aggregate, EXACT)

    # pretraining: PRETRAIN MLE steps on the seeded ring
    _, k = jax.random.split(jrunner.rng)
    seq = [("replay", np.asarray(jax.random.uniform(
        jax.random.split(key)[0], (BS,))))
        for key in jax.random.split(k, PRETRAIN)]
    pretrain, _ = jloop.build(steps_per_epoch=2 * B,
                              initial_train_steps=PRETRAIN)
    runner = _port_runner(loop, jax.tree.map(np.asarray, jrunner), seq)
    jrunner = pretrain(jrunner)
    loop.pretrain(runner, PRETRAIN)
    _close(convert.bc_state_to_numpy(runner.algo_state),
           _jax_policy_state(jrunner.algo_state), PIN)

    # one epoch of two iterations, each JAX iteration's draws replayed
    it = jax.jit(jloop._iter)
    losses = []
    for _ in range(2):
        runner.noise.seq += _dagger_iter_draws(jrunner)
        jrunner, m = it(jrunner)
        losses.append(float(m["bc_loss"]))
    runner, metrics = loop.train_epoch(runner, 2 * B)
    assert not runner.noise.seq, "draws left over"
    np.testing.assert_allclose(metrics["bc_loss"], np.mean(losses), **PIN)
    assert runner.total_env_steps == int(jrunner.total_env_steps) == 2 * B
    _assert_ring(runner.aggregate, jrunner.aggregate)
    _close(convert.bc_state_to_numpy(runner.algo_state),
           _jax_policy_state(jrunner.algo_state), PIN)
    # the stored actions are the expert's on the stored pre-step obs
    rows = slice(n, n + 2 * B)
    agg = runner.aggregate.data
    np.testing.assert_array_equal(
        agg["action"][rows].numpy(),
        experts.pendulum_expert(agg["obs"][rows]).numpy())


def test_dagger_ring_writes_across_the_wrap(dagger_setup):
    """A 96-row ring seeded with n = 50 rows: the sixth iteration's write
    starts at 90 and must fill rows 90..95 and 0..1.  The JAX
    `dynamic_update_slice` clamps it to 88..95 instead (ROADMAP.md
    section 3): it overwrites the fifth write's rows 88..89 and leaves
    the demo rows 0..1 stale."""
    jdemos, jloop = dagger_setup(1, 96)
    cap, n, iters = 96, int(jdemos.size), 6
    assert n == 50
    loop = _port_dagger(jdemos, cap)
    runner = loop.init(0)
    assert runner.aggregate.data["reward"].shape[0] == cap
    demo_rows = runner.aggregate.data["obs"][:n].clone()
    written = []
    for _ in range(iters):
        written.append(runner.env_state.obs.clone())
        loop._iter(runner)
    assert (runner.aggregate.ptr, runner.aggregate.size) == (
        (n + B * iters) % cap, cap)
    agg = runner.aggregate.data
    for i, obs in enumerate(written):
        rows = [(n + B * i + j) % cap for j in range(B)]
        np.testing.assert_array_equal(agg["obs"][rows].numpy(), obs.numpy())
        np.testing.assert_array_equal(
            agg["action"][rows].numpy(),
            experts.pendulum_expert(obs).numpy())
    np.testing.assert_array_equal(agg["obs"][2:n].numpy(),
                                  demo_rows[2:].numpy())

    # the JAX loop on the same configuration, its own rollout
    jrunner = jloop.init(jax.random.PRNGKey(0))
    it = jax.jit(jloop._iter)
    jwritten = []
    for _ in range(iters):
        jwritten.append(np.asarray(jrunner.env_state.obs))
        jrunner, _ = it(jrunner)
    jobs = np.asarray(jrunner.aggregate.data["obs"])
    np.testing.assert_array_equal(jobs[88:96], jwritten[5])     # clamped
    assert not np.array_equal(jobs[88:90], jwritten[4][6:8])   # overwritten
    np.testing.assert_array_equal(jobs[0:2],
                                  np.asarray(jdemos.data["obs"][0:2]))
    assert int(jrunner.aggregate.ptr) == (n + B * iters) % cap


def test_replay_add_at_multiples_of_the_batch_is_unchanged():
    """Every earlier path writes at ptr % B == 0: one slice, as before,
    across the wrap of a full ring too."""
    from ilswiss_tpu_torch.data.replay import replay_add, replay_init
    from ilswiss_tpu_torch.envs.vector import Transition
    ring = replay_init(32, 3, 1, write_batch=8, device="cpu")
    rng = np.random.RandomState(0)
    for i in range(6):
        tr = Transition(*(torch.as_tensor(rng.randn(*s).astype(np.float32))
                          for s in ((8, 3), (8, 1), (8,), (8, 3))),
                        terminal=torch.zeros(8, dtype=torch.bool),
                        done=torch.as_tensor(rng.rand(8) < 0.3))
        replay_add(ring, tr)
        rows = slice(8 * (i % 4), 8 * (i % 4) + 8)
        np.testing.assert_array_equal(ring.data["obs"][rows].numpy(),
                                      tr.obs.numpy())
    assert (ring.ptr, ring.size) == (16, 32)


def test_jax_replay_add_clamps_at_the_wrap():
    """The reference fault itself, on the JAX function: a write of 8 rows
    at ptr 28 of a 32-row ring lands at 24..31."""
    from ilswiss_tpu.data.replay import replay_init as jreplay_init
    ring = jreplay_init(32, 3, 1, write_batch=8)
    ring = ring.replace(ptr=jnp.asarray(28, jnp.int32),
                        size=jnp.asarray(28, jnp.int32))
    obs = jnp.arange(24, dtype=jnp.float32).reshape(8, 3) + 1
    tr = JTransition(obs=obs, action=jnp.zeros((8, 1)),
                     reward=jnp.zeros(8), next_obs=obs,
                     terminal=jnp.zeros(8, bool), done=jnp.zeros(8, bool))
    out = jreplay_add(ring, tr)
    np.testing.assert_array_equal(np.asarray(out.data["obs"][24:32]),
                                  np.asarray(obs))
    assert not np.asarray(out.data["obs"][:4]).any()
    assert int(out.ptr) == 4


# --- 6. the launchers -----------------------------------------------------------
def test_subsample_transitions_matches_jax(collected):
    jdemos = collected[0]
    demos = convert.replay_from_jax(jax.tree.map(np.asarray, jdemos), "cpu")
    for factor, seed in ((1, 0), (3, 5), (7, 11)):
        want = jexp._subsample_transitions(jdemos, factor, seed)
        got = pexp._subsample_transitions(demos, factor, seed)
        assert got.size == int(want.size)
        _assert_ring(got, want, EXACT)
    # tests/test_gen_expert.py's case
    n = 40
    obs = np.arange(n, dtype=np.float32)[:, None]
    from ilswiss_tpu_torch.data.demo import demos_to_replay_state
    st = demos_to_replay_state(obs, obs.copy(), np.zeros(n, np.float32),
                               obs.copy(), np.zeros(n, np.float32),
                               np.repeat(np.arange(4, dtype=np.int32), 10),
                               device="cpu")
    sub = pexp._subsample_transitions(st, 5, seed=0)
    kept_ep, kept = sub.ep_id.numpy(), sub.data["obs"].numpy().ravel()
    assert sub.size == 8
    for e in range(4):
        rows = kept[kept_ep == e]
        assert len(rows) == 2 and rows[1] - rows[0] == 5


def _spec(path):
    with open(ROOT / path) as f:
        (variant,) = build_variants(yaml.safe_load(f))
    return variant


def test_run_gen_expert_scripted(tmp_path):
    """tests/test_gen_expert.py:34-52 on the port."""
    v = _spec("exp_specs/gen_expert/pendulum.yaml")
    v.update(log_dir=str(tmp_path / "log"), save_path=str(tmp_path /
                                                          "pend.npz"),
             demos_listing=str(tmp_path / "listing.yaml"), num_rollouts=2,
             max_path_length=50, subsample_factor=2, print_to_console=False)
    v["env_specs"] = dict(v["env_specs"], env_num=2)
    out = pexp.run_gen_expert(v, device="cpu")
    d = np.load(out)
    assert d["obs"].shape == (50, 3)
    np.testing.assert_array_equal(
        d["action"], experts.pendulum_expert(torch.as_tensor(d["obs"])))
    listing = yaml.safe_load(open(v["demos_listing"]))
    assert listing["pendulum_expert"] == {
        "file_path": out, "env": "pendulum", "num_transitions": 50}
    demos = load_demos_npz(out, device="cpu")
    assert demos.size == 50 and len(np.unique(demos.ep_id.numpy())) == 2


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Cut SAC and TD3 runs of the port on pendulum (1 epoch, 16 x 1
    nets), whose snapshots play the trained experts."""
    root = tmp_path_factory.mktemp("experts")
    out = {}
    for name in ("sac", "td3"):
        spec = {"meta_data": {"algorithm": name, "exp_name": name},
                "variables": {"seed": [0]},
                "constants": {
                    "net_size": 16, "num_hidden_layers": 1,
                    "log_dir": str(root / name), "print_to_console": False,
                    "rl_alg_params": {
                        "num_epochs": 1, "num_steps_per_epoch": 16,
                        "num_steps_between_train_calls": 8,
                        "num_train_steps_per_train_call": 8,
                        "max_path_length": 20, "min_steps_before_training": 8,
                        "batch_size": 8, "replay_buffer_size": 256,
                        "min_eval_episodes": 2},
                    "env_specs": {"env_name": "pendulum", "env_num": 2}}}
        (v,) = build_variants(spec)
        pexp.EXPERIMENTS[name](v, device="cpu")
        out[name] = root / name / "checkpoints"
    return out


def _restored(name, path):
    cls, cfg = (SAC, SACConfig) if name == "sac" else (TD3, TD3Config)
    algo = cls(3, 1, cfg(), net_size=16, num_hidden_layers=1, device="cpu")
    return algo, restore_subtree(str(path), algo.init(1))


@pytest.mark.parametrize("name", ["sac", "td3"])
def test_run_gen_expert_from_a_trained_snapshot(trained, tmp_path, name):
    """The device branch with `expert_algo` sac / td3 from the run's full
    'last' snapshot: the demos hold the policy's deterministic actions."""
    v = _spec("exp_specs/gen_expert/hopper.yaml")
    v.update(expert_algo=name, expert_path=str(trained[name] / "last"),
             net_size=16, num_hidden_layers=1, num_rollouts=2,
             max_path_length=20, log_dir=str(tmp_path / "log"),
             save_path=str(tmp_path / "d.npz"),
             demos_listing=str(tmp_path / "listing.yaml"),
             print_to_console=False)
    v["env_specs"] = {"env_name": "pendulum", "env_kwargs": {},
                      "env_num": 4}
    out = pexp.run_gen_expert(v, device="cpu")
    d = np.load(out)
    assert d["obs"].shape == (40, 3)
    algo, state = _restored(name, trained[name] / "last")
    want = algo.act(state, torch.as_tensor(d["obs"]), deterministic=True)
    np.testing.assert_allclose(d["action"], want.numpy(), **FWD)


def test_run_eval_policy_saves_samples(trained, tmp_path):
    """`save_samples` (JAX experiments.py:902-917): num_eval_steps //
    num_envs steps of the deterministic policy into eval_samples.npz in
    the log dir, with per-env episode ids."""
    v = {"seed": 0, "policy_checkpoint": str(trained["sac"] / "best"),
         "policy_net_size": 16, "policy_num_hidden_layers": 1,
         "max_path_length": 20, "num_eval_steps": 96, "save_samples": True,
         "log_dir": str(tmp_path / "eval"), "print_to_console": False,
         "env_specs": {"env_name": "pendulum", "env_num": 8,
                       "env_kwargs": {"max_episode_steps": 5}}}
    stats = pexp.run_eval_policy(v, device="cpu")
    assert all(math.isfinite(x) for x in stats.values())
    d = np.load(tmp_path / "eval" / "eval_samples.npz")
    assert d["obs"].shape == (96, 3)
    algo, state = _restored("sac", trained["sac"] / "best")
    np.testing.assert_allclose(
        d["action"], algo.act(state, torch.as_tensor(d["obs"]),
                              deterministic=True).numpy(), **FWD)
    # 12 steps of episodes of 5 per env: 3 episodes each, ids renumbered
    assert len(np.unique(d["ep_id"])) == 8 * 3


def test_run_dagger_queries_a_trained_snapshot(trained, tmp_path):
    """DAgger from `expert_policy_path` (a 'best' snapshot): the rows the
    learner added hold the expert policy's deterministic actions."""
    v = _spec("exp_specs/dagger/dagger_hopper.yaml")
    v.update(expert_policy_path=str(trained["sac"] / "best"),
             expert_net_size=16, expert_num_hidden_layers=1,
             net_size=16, num_hidden_layers=1,
             demo_path=str(ROOT / "demos" / "pendulum_expert.npz"),
             log_dir=str(tmp_path / "d"), print_to_console=False)
    v["dagger_params"].update(num_epochs=1, num_steps_per_epoch=16,
                              max_path_length=10, num_initial_train_steps=2,
                              batch_size=8, replay_buffer_size=4096,
                              num_train_steps_per_train_call=2)
    v["env_specs"] = {"env_name": "pendulum", "env_kwargs": {}, "env_num": 8}
    runner = pexp.run_dagger(v, device="cpu")
    n = 4 * 200                       # traj_num 4 of the 200-step demos
    assert runner.aggregate.size == n + 16
    agg = runner.aggregate.data
    algo, state = _restored("sac", trained["sac"] / "best")
    added = slice(n, n + 16)
    np.testing.assert_allclose(
        agg["action"][added].numpy(),
        algo.act(state, agg["obs"][added], deterministic=True).numpy(),
        **FWD)
    # K = round(8 * 2 / 1000) floored at 1: one BC step an iteration
    assert runner.algo_state.policy_opt.count == 2 + 2


def test_dagger_and_bc_schedules_match_jax():
    """K of both dagger specs (`num_updates_per_train_call` unread, as in
    JAX) and BC's epoch length."""
    for path, k in (("exp_specs/dagger/dagger_pendulum.yaml", 2),
                    ("exp_specs/dagger/dagger_hopper.yaml", 8)):
        v = _spec(path)
        rl = dict(v.get("rl_alg_params") or {})
        for key, val in v["dagger_params"].items():
            rl.setdefault(key, val)
        n = max(v["env_specs"]["env_num"], 8)
        assert pexp._grad_steps_per_iter(rl, n) == \
            jexp._grad_steps_per_iter(rl, n) == k


def test_cli_runs_bc_and_dagger_in_a_process_without_jax(tmp_path):
    """Cut copies of bc_pendulum.yaml and dagger_pendulum.yaml through
    `python -m ilswiss_tpu_torch.run_experiment --device cpu`, run from
    the checkout's root (the demos listing's paths are relative to it):
    the scripted expert named `ilswiss_tpu.envs.experts:pendulum_expert`
    resolves to the port's, and no JAX module is ever imported."""
    paths = []
    for name, cut in (("bc/bc_pendulum", {"num_epochs": 1,
                                          "num_train_steps_per_train_call":
                                          4, "max_path_length": 10}),
                      ("dagger/dagger_pendulum", None)):
        spec = yaml.safe_load((ROOT / "exp_specs" / f"{name}.yaml")
                              .read_text())
        c = spec["constants"]
        c.update(log_dir=str(tmp_path / name), print_to_console=False)
        if cut:
            c["rl_alg_params"].update(cut)
        else:
            c.update(policy_net_size=16, policy_num_hidden_layers=1)
            c["dagger_params"].update(
                num_epochs=1, num_steps_per_epoch=32, max_path_length=10,
                num_initial_train_steps=2, batch_size=8,
                replay_buffer_size=2048)
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
        "assert 'ilswiss_tpu_torch.envs.experts' in sys.modules\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
    for name in ("bc/bc_pendulum", "dagger/dagger_pendulum"):
        rows = (tmp_path / name / "progress.csv").read_text().splitlines()
        assert len(rows) == 2, name
    log = (tmp_path / "dagger" / "dagger_pendulum" / "debug.log").read_text()
    # traj_num 4 of the 200-step demos; 16 envs, K = 16 * 1000 / 8000
    assert "seeded with 800 demo rows" in log and "2 steps an iteration" \
        in log


@pytest.mark.parametrize("name", ["bc", "dagger", "gen_expert", "her",
                                  "gcsl"])
def test_load_params_is_refused(tmp_path, name):
    """The JAX launchers never read `load_params` for these five; the
    port raises ValueError before any work."""
    v = {"seed": 0, "load_params": str(tmp_path / "x"),
         "log_dir": str(tmp_path / "log"), "print_to_console": False,
         "env_specs": {"env_name": "pendulum", "env_num": 2}}
    with pytest.raises(ValueError, match="has no resume"):
        pexp.EXPERIMENTS[name](v, device="cpu")


def test_unported_gen_expert_branches_name_their_items(tmp_path):
    """The DMC pixel branch renders on the host (envs/host_dmc.py): it
    builds the DMC env with the spec's frame stack and env_kwargs (the
    launcher's max_episode_steps dropped, DMC's own limit kept) and
    restores its SAC-AE expert whatever `use_scripted_policy` says, as the
    JAX branch; the gymnasium branch asks, as the JAX one, for a scripted
    expert that exists."""
    from ilswiss_tpu_torch.envs import host_dmc

    base = {"seed": 0, "log_dir": str(tmp_path / "log"),
            "print_to_console": False, "use_scripted_policy": True}
    built = []

    class Reached(Exception):
        pass

    def dmc(**kwargs):
        built.append(kwargs)
        raise Reached

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host_dmc, "DMCVectorEnv", dmc)
        with pytest.raises(Reached):
            pexp.run_gen_expert(dict(base, env_specs={
                "env_name": "dmc", "frame_stack": 2, "env_num": 3,
                "env_kwargs": {"domain_name": "cartpole", "height": 32,
                               "visualize_reward": False}}), device="cpu")
    assert built == [{"num_envs": 3, "seed": 0, "frame_stack": 2,
                      "domain_name": "cartpole", "height": 32}]
    with pytest.raises(KeyError, match="no scripted expert for "
                                       "'lunarlandercont'"):
        pexp.run_gen_expert(dict(base, env_specs={"env_name": "lunarlandercont"}),
                            device="cpu")


def test_committed_demos_listing_is_untouched():
    assert (ROOT / "demos_listing.yaml").read_bytes() == LISTING
