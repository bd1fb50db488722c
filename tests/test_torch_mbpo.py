"""MBPO in the port (ilswiss_tpu_torch/data/replay.py::replay_add_masked,
algorithms/mbpo.py, utils/convert.py's MBPO bridge,
launchers/experiments.py::run_mbpo) against the JAX package's
(ilswiss_tpu/data/replay.py, algorithms/mbpo.py, launchers/experiments.py).

Inputs come from a numpy seed; the JAX state is carried across by
utils/convert.py, and every draw of a JAX model rollout, mixed batch or
epoch segment is rebuilt from its keys and replayed to the port in the
order algorithms/mbpo.py's docstring gives (`_Draws` checks the order).
Pins: forwards rtol 1e-5, atol 1e-6; updates rtol 2e-4, atol 2e-5
(tests/test_torch_offpolicy_trainers.py's); ring cursors, sizes, elites
and epoch counts exactly.
"""

import csv
import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ilswiss_tpu.algorithms.bnn_trainer import (
    BNNTrainerConfig as JBNNTrainerConfig,
)
from ilswiss_tpu.algorithms.mbpo import MBPO as JMBPO
from ilswiss_tpu.algorithms.mbpo import MBPOConfig as JMBPOConfig
from ilswiss_tpu.algorithms.sac import SAC as JSAC
from ilswiss_tpu.algorithms.sac import SACConfig as JSACConfig
from ilswiss_tpu.data import replay as jreplay
from ilswiss_tpu.envs import make_vec as jmake_vec
from ilswiss_tpu.envs.terminals import get_terminal_func as jterminal
from ilswiss_tpu.launchers import experiments as jexp
from ilswiss_tpu.models.bnn import fit_input_normalizer as jfit_normalizer
from ilswiss_tpu_torch.algorithms.bnn_trainer import BNNTrainerConfig
from ilswiss_tpu_torch.algorithms.mbpo import (
    MBPO, MBPOConfig, MBPORunnerState,
)
from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.data import replay
from ilswiss_tpu_torch.envs import make_vec
from ilswiss_tpu_torch.envs.terminals import get_terminal_func
from ilswiss_tpu_torch.launchers import experiments as pexp
from ilswiss_tpu_torch.launchers.variant import build_variants
from ilswiss_tpu_torch.runtime.checkpoint import restore_checkpoint, to_tree
from ilswiss_tpu_torch.testing import tree_diff
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FWD = dict(rtol=1e-5, atol=1e-6)
PIN = dict(rtol=2e-4, atol=2e-5)
E, ELITES, H, NET = 3, 2, (16, 16), 32


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


def _jax_sac_numpy(jstate):
    """The JAX SACState in `convert.sac_state_to_numpy`'s layout."""
    s = jax.tree.map(np.asarray, jstate)
    adam = lambda a: {"count": int(a.count), "mu": a.mu,  # noqa: E731
                      "nu": a.nu}
    return {"policy_params": s.policy_params, "qf_params": s.qf_params,
            "target_qf_params": s.target_qf_params,
            "log_alpha": s.log_alpha, "policy_opt": adam(s.policy_opt[0]),
            "qf_opt": adam(s.qf_opt[0]), "alpha_opt": adam(s.alpha_opt[0])}


def _jax_bnn_numpy(jstate):
    s = jax.tree.map(np.asarray, jstate)
    adam = s.opt_state[0]
    return {"params": s.params,
            "opt_state": {"count": int(adam.count), "mu": adam.mu,
                          "nu": adam.nu},
            "normalizer": {"mean": s.normalizer.mean,
                           "std": s.normalizer.std},
            "elites": s.elites, "holdout_mse": s.holdout_mse}


def _jax_ring_numpy(jring):
    r = jax.tree.map(np.asarray, jring)
    return {"data": dict(r.data), "ep_id": r.ep_id, "ptr": int(r.ptr),
            "size": int(r.size), "env_ep": r.env_ep}


def _assert_ring(got, jring, pin):
    """A port ring against a JAX one: cursor, size, episode ids and
    counters exactly, the rows at `pin`."""
    want = _jax_ring_numpy(jring)
    got = convert.replay_to_numpy(got)
    assert (got["ptr"], got["size"]) == (want["ptr"], want["size"])
    np.testing.assert_array_equal(got["ep_id"], want["ep_id"])
    np.testing.assert_array_equal(got["env_ep"], want["env_ep"])
    _close(got["data"], want["data"], pin)


class _Draws:
    """The port's `Noise` methods, answering each call with the next of
    the JAX draws; a call out of the documented order fails."""

    def __init__(self, seq):
        self.seq = list(seq)

    def _pop(self, kind):
        assert self.seq, f"no draw left for {kind}"
        got, value = self.seq.pop(0)
        assert got == kind, f"drew {kind} where the JAX order has {got}"
        if isinstance(value, tuple):
            return tuple(torch.as_tensor(np.array(v)) for v in value)
        value = np.array(value)
        return torch.as_tensor(value, dtype=torch.int64 if np.issubdtype(
            value.dtype, np.integer) else torch.float32)

    def train(self, shape):
        return self._pop("eps_next"), self._pop("eps_new")

    def __getattr__(self, kind):
        # act, reset, replay, permutation, bootstrap, shuffle, elite, model
        if kind.startswith("_"):
            raise AttributeError(kind)
        return lambda *args: self._pop(kind)


# --- replay_add_masked ---------------------------------------------------------
MASKS = {"all": np.ones(8, bool), "none": np.zeros(8, bool),
         "mixed": np.array([1, 0, 1, 1, 0, 0, 1, 1], bool)}


def _rows(rng, n=8):
    return {"obs": rng.randn(n, 2).astype(np.float32),
            "action": rng.randn(n, 1).astype(np.float32),
            "reward": rng.randn(n).astype(np.float32),
            "next_obs": rng.randn(n, 2).astype(np.float32),
            "terminal": (rng.rand(n) < 0.3).astype(np.float32)}


@pytest.mark.parametrize("case", MASKS)
def test_replay_add_masked_matches_jax(case):
    """A ring of 16 rows (write batch 8): a first write of 7 alive rows
    moves the cursor off 0, then the case's mask (all: the write crosses
    the wrap), then a mixed mask; rows, cursor and size exactly."""
    rng = np.random.RandomState(0)
    jring = jreplay.replay_init(16, 2, 1, write_batch=8)
    ring = replay.replay_init(16, 2, 1, write_batch=8, device="cpu")
    masks = [np.array([1, 1, 1, 0, 1, 1, 1, 1], bool), MASKS[case],
             MASKS["mixed"]]
    for mask in masks:
        rows = _rows(rng)
        jring = jreplay.replay_add_masked(
            jring, {k: jnp.asarray(v) for k, v in rows.items()},
            jnp.asarray(mask))
        replay.replay_add_masked(
            ring, {k: torch.as_tensor(v) for k, v in rows.items()},
            torch.as_tensor(mask))
        _assert_ring(ring, jring, dict(rtol=0, atol=0))
    assert ring.size == min(16, 7 + int(MASKS[case].sum()) + 5)
    with pytest.raises(ValueError, match="do not fit"):
        replay.replay_add_masked(ring, {}, torch.ones(17, dtype=torch.bool))


# --- the model rollout and the mixed batch --------------------------------------
OBS_H, ACT_H, R = 11, 3, 32


def _hopper_configs():
    """A model ring of 3 * 32 * 10 / 8 = 120 -> 128 rows; batch 16 of
    which int(16 * 0.25) = 4 real."""
    mb = dict(model_train_freq=8, rollout_batch_size=R, real_ratio=0.25,
              rollout_schedule=(0, 1, 3, 3), batch_size=16,
              replay_capacity=64, min_steps_before_training=16,
              max_path_length=10)
    bnn = dict(num_nets=E, num_elites=ELITES, hidden_sizes=H, batch_size=8,
               max_epochs=2)
    return mb, bnn


@pytest.fixture(scope="module")
def hopper_mbpo():
    """A JAX MBPO on hopper's sizes without an env, its runner holding a
    64-row real ring of near-healthy hopper rows, a model ring with its
    cursor at 100 of 128, a perturbed ensemble with fitted moments and
    elites (2, 0); and the port's MBPO on the same sizes (its hopper
    vector env is never stepped)."""
    mb, bnn = _hopper_configs()
    jsac = JSAC(OBS_H, ACT_H, JSACConfig(), net_size=NET,
                num_hidden_layers=2)
    jm = JMBPO(None, jsac, jterminal("hopper"), JMBPOConfig(**mb),
               JBNNTrainerConfig(**bnn), obs_size=OBS_H,
               action_size=ACT_H, num_envs=4)
    jr = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    obs = 0.1 * rng.randn(64, OBS_H).astype(np.float32)
    obs[:, 0] += 1.25
    data = {"obs": obs,
            "action": np.tanh(rng.randn(64, ACT_H)).astype(np.float32),
            "reward": rng.randn(64).astype(np.float32),
            "next_obs": obs + 0.05 * rng.randn(64, OBS_H).astype(np.float32),
            "terminal": np.zeros(64, np.float32)}
    real = jr.replay.replace(
        data={k: jnp.asarray(v) for k, v in data.items()},
        ptr=jnp.asarray(0, jnp.int32), size=jnp.asarray(64, jnp.int32))
    model = jr.model_replay.replace(
        data={k: jnp.asarray(rng.randn(*v.shape).astype(np.float32))
              for k, v in jr.model_replay.data.items()},
        ptr=jnp.asarray(100, jnp.int32), size=jnp.asarray(100, jnp.int32))
    params = jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x) + 0.1 * rng.randn(*x.shape),
                              jnp.float32), jr.bnn_state.params)
    inputs = np.concatenate([data["obs"], data["action"]], -1)
    bnn_state = jr.bnn_state.replace(
        params=params, normalizer=jfit_normalizer(jnp.asarray(inputs)),
        elites=jnp.asarray([2, 0], jnp.int32))
    jr = jr.replace(replay=real, model_replay=model, bnn_state=bnn_state)
    assert jm.model_capacity == 120 and model.data["reward"].shape == (128,)

    sac = SAC(OBS_H, ACT_H, SACConfig(), net_size=NET, num_hidden_layers=2,
              device="cpu")
    m = MBPO(make_vec("hopper", 4, device="cpu", max_episode_steps=10), sac,
             get_terminal_func("hopper"), MBPOConfig(**mb),
             BNNTrainerConfig(**bnn))
    return jm, jax.tree.map(np.asarray, jr), m


def _port_runner(m, jr, draws):
    """The port's runner from the JAX one without an env state."""
    return MBPORunnerState(
        noise=_Draws(draws), env_state=None,
        replay=convert.replay_from_jax(jr.replay, "cpu"),
        model_replay=convert.replay_from_jax(jr.model_replay, "cpu"),
        algo_state=convert.sac_state_from_jax(m.algo, jr.algo_state),
        bnn_state=convert.bnn_state_from_jax(m.bnn, jr.bnn_state),
        total_env_steps=int(jr.total_env_steps))


def rollout_draws(jm, key, elites, length):
    """Every draw of a JAX `_rollout_model` from its key, in the port's
    order: the start uniforms, then per step the act noise, the elite
    picks and the model noise of the picked net's row (the JAX rollout
    draws [E, R, 1 + obs] and gathers)."""
    cfg = jm.config
    R_ = cfg.rollout_batch_size
    k_init, k_scan = jax.random.split(key)
    seq = [("replay", jax.random.uniform(k_init, (R_,)))]
    for k in jax.random.split(k_scan, length):
        k_act, k_noise, k_pick = jax.random.split(k, 3)
        pick = jax.random.randint(k_pick, (R_,), 0, len(elites))
        full = np.asarray(jax.random.normal(
            k_noise, (jm.bnn.config.num_nets, R_, 1 + jm.obs_size)))
        seq += [("act", jax.random.normal(k_act, (R_, jm.action_size))),
                ("elite", pick),
                ("model", full[np.asarray(elites)[np.asarray(pick)],
                               np.arange(R_)])]
    return seq


def test_rollout_model_matches_jax(hopper_mbpo):
    """Three model steps with the hopper terminal from converted SAC and
    ensemble states: the model ring's rows at the pin (the write crosses
    the wrap), its cursor and size exactly; branches die on the way."""
    jm, jr, m = hopper_mbpo
    key = jax.random.PRNGKey(3)
    jring = jax.jit(jm._rollout_model, static_argnums=2)(jr, key, 3)
    runner = _port_runner(m, jr, rollout_draws(jm, key, jr.bnn_state.elites,
                                               3))
    written = m._rollout_model(runner, 3)
    assert not runner.noise.seq, "draws left over"
    _assert_ring(runner.model_replay, jring, PIN)
    assert written[0] == R and written == sorted(written, reverse=True)
    assert runner.model_replay.size == min(128, 100 + sum(written))
    # some branches die, not all
    assert written[-1] < R and written[-1] > 0, written


def test_mixed_batch_matches_jax(hopper_mbpo):
    """int(16 * 0.25) = 4 real rows, then 12 model rows, from the same
    uniforms: exactly the JAX batch."""
    jm, jr, m = hopper_mbpo
    key = jax.random.PRNGKey(4)
    want = jm._mixed_batch(jr, key)
    k_r, k_m = jax.random.split(key)
    runner = _port_runner(m, jr, [])
    noise = _Draws([("replay", jax.random.uniform(k_r, (4,))),
                    ("replay", jax.random.uniform(k_m, (12,)))])
    got = m._mixed_batch(runner, noise)
    assert not noise.seq
    assert got["obs"].shape == (16, OBS_H)
    _close({k: v.numpy() for k, v in got.items()},
           {k: np.asarray(v) for k, v in want.items()},
           dict(rtol=0, atol=0))


# --- one epoch segment on pendulum ------------------------------------------
N_ENVS = 4


def train_draws(key, n_total, n_train, num_nets, epochs):
    """Every draw of a JAX `BNNTrainer.train` from its key, in the port's
    order (tests/test_torch_bnn.py has the same)."""
    k_perm, k_boot, k_shuf = jax.random.split(key, 3)
    seq = [("permutation", jax.random.permutation(k_perm, n_total)),
           ("bootstrap", jax.random.randint(k_boot, (num_nets, n_train), 0,
                                            n_train))]
    rng = np.random.default_rng(int(jax.device_get(k_shuf)[0]))
    for _ in range(epochs):
        seq.append(("shuffle", rng.permuted(np.broadcast_to(
            np.arange(n_train), (num_nets, n_train)).copy(), axis=1)))
    return seq


def _pendulum_reset_draws(rngs):
    """The reset draws of one JAX `VectorEnv.step` on pendulum from the
    per-env keys of the state it steps (vector.py, base.py, pendulum.py)."""
    th, thdot = [], []
    for key in rngs:
        _, carry = jax.random.split(key)              # Environment.step
        reset_key = jax.random.split(carry)[1]        # VectorEnv.step
        k_reset, _ = jax.random.split(reset_key)      # Environment.reset
        k1, k2 = jax.random.split(k_reset)
        th.append(jax.random.uniform(k1, (), minval=-jnp.pi, maxval=jnp.pi))
        thdot.append(jax.random.uniform(k2, (), minval=-1.0, maxval=1.0))
    return ("reset", (np.stack(th), np.stack(thdot)))


def segment_draws(jm, jr, bnn_epochs, elites):
    """Every draw of one JAX `train_epoch` of one segment (mbpo.py) from
    the runner's keys, in the port's order: the ensemble fit, the model
    rollout, then per iteration the act noise and the resets (the env's
    keys, which no action changes while no episode ends) and per gradient
    step the real and model uniforms and SAC's pair."""
    cfg = jm.config
    k_model, k_roll = jax.random.split(jax.random.fold_in(jr.rng, 0))
    n_total = int(jr.replay.size)
    n_holdout = min(int(n_total * jm.bnn.config.holdout_ratio),
                    jm.bnn.config.max_holdout)
    seq = train_draws(k_model, n_total, n_total - n_holdout,
                      jm.bnn.config.num_nets, bnn_epochs)
    seq += rollout_draws(jm, k_roll, elites, jm.rollout_length(0))
    n_real = int(cfg.batch_size * cfg.real_ratio)
    rng, env_state = jr.rng, jr.env_state
    step = jax.jit(jm.vec_env.step)
    for _ in range(cfg.model_train_freq // N_ENVS):
        rng, k_act, k_train = jax.random.split(rng, 3)
        seq.append(("act", jax.random.normal(k_act, (N_ENVS, 1))))
        seq.append(_pendulum_reset_draws(env_state.rng))
        env_state, _ = step(env_state, jnp.zeros((N_ENVS, 1)))
        for k in jax.random.split(k_train, jm.grad_steps_per_iter):
            k_b, k_t = jax.random.split(k)
            k_r, k_m = jax.random.split(k_b)
            k_next, k_new = jax.random.split(k_t)
            shape = (cfg.batch_size, 1)
            seq += [("replay", jax.random.uniform(k_r, (n_real,))),
                    ("replay", jax.random.uniform(
                        k_m, (cfg.batch_size - n_real,))),
                    ("eps_next", jax.random.normal(k_next, shape)),
                    ("eps_new", jax.random.normal(k_new, shape))]
    return [(k, v if isinstance(v, tuple) else np.asarray(v))
            for k, v in seq]


def test_train_epoch_matches_jax():
    """One epoch of one segment on pendulum (4 envs; 2 iterations of 2
    SAC steps on batches of 4 real and 12 model rows; the ensemble fit
    on the 48 warmup rows, 2 epochs; a rollout of 2 steps of 16
    branches), from the JAX runner after warmup with every draw
    replayed: the env state, both rings, the SAC and ensemble states, the
    step count and the metrics."""
    mb = dict(model_train_freq=8, rollout_batch_size=16, real_ratio=0.25,
              rollout_schedule=(0, 1, 2, 2), batch_size=16,
              grad_steps_per_iter=2, replay_capacity=128,
              min_steps_before_training=48, max_path_length=200)
    bnn = dict(num_nets=E, num_elites=ELITES, hidden_sizes=H, batch_size=8,
               max_epochs=2)
    sac_kw = dict(reward_scale=2.0)
    jvec = jmake_vec("pendulum", num_envs=N_ENVS)
    jm = JMBPO(jvec, JSAC(3, 1, JSACConfig(**sac_kw), net_size=NET,
                          num_hidden_layers=2),
               jterminal("pendulum"), JMBPOConfig(**mb),
               JBNNTrainerConfig(**bnn))
    jr = jm.warmup(jm.init(jax.random.PRNGKey(0)))
    snap = jax.tree.map(np.asarray, jr)
    jnext, jmetrics = jm.train_epoch(jr, 0, steps_per_epoch=8)
    jnext = jax.tree.map(np.asarray, jnext)
    assert jmetrics["bnn_epochs"] == 2

    m = MBPO(make_vec("pendulum", N_ENVS, device="cpu"),
             SAC(3, 1, SACConfig(**sac_kw), net_size=NET,
                 num_hidden_layers=2, device="cpu"),
             get_terminal_func("pendulum"), MBPOConfig(**mb),
             BNNTrainerConfig(**bnn))
    runner = convert.mbpo_runner_from_jax(m, snap, _Draws(segment_draws(
        jm, snap, 2, jnext.bnn_state.elites)))
    runner, metrics = m.train_epoch(runner, 0, steps_per_epoch=8)
    assert not runner.noise.seq, "draws left over"
    assert runner.total_env_steps == int(jnext.total_env_steps) == 48 + 8
    got = convert.mbpo_runner_to_numpy(runner)
    _close(got["env_state"]["internal"][0], jnext.env_state.internal, PIN)
    _close(got["env_state"]["obs"], jnext.env_state.obs, PIN)
    np.testing.assert_array_equal(got["env_state"]["t"], jnext.env_state.t)
    _assert_ring(runner.replay, jnext.replay, PIN)
    _assert_ring(runner.model_replay, jnext.model_replay, PIN)
    assert runner.model_replay.size == 2 * 16
    _close(got["algo_state"], _jax_sac_numpy(jnext.algo_state), PIN)
    want_bnn = _jax_bnn_numpy(jnext.bnn_state)
    np.testing.assert_array_equal(got["bnn_state"].pop("elites"),
                                  want_bnn.pop("elites"))
    _close(got["bnn_state"], want_bnn, PIN)
    assert set(metrics) == set(jmetrics)
    assert metrics["bnn_epochs"] == 2 and metrics["mean_rollout_length"] == 2
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], v, err_msg=k, **PIN)


# --- the launcher ---------------------------------------------------------
def _tiny_mbpo(log_dir, **extra):
    """exp_specs/mbpo/mbpo_pendulum.yaml cut to 1 epoch of 2 segments (4
    envs, model_train_freq 16: 4 iterations a segment), a rollout batch of
    64, 3 nets with 2 elites of 16 x 2 at most 2 epochs a fit, a 32 x 1
    SAC, 64 warmup steps and 50-step evaluation episodes."""
    with open(ROOT / "exp_specs" / "mbpo" / "mbpo_pendulum.yaml") as f:
        (v,) = build_variants(yaml.safe_load(f))
    v.update(net_size=32, num_hidden_layers=1, log_dir=str(log_dir),
             print_to_console=False, **extra)
    v["rl_alg_params"].update(num_epochs=1, num_steps_per_epoch=32,
                              max_path_length=50,
                              min_steps_before_training=64)
    v["mbpo_params"].update(model_train_freq=16, rollout_batch_size=64)
    v["bnn_params"].update(num_nets=3, num_elites=2, hidden_sizes=[16, 16],
                           max_epochs=2, batch_size=16)
    v["env_specs"].update(env_num=4)
    return v


def test_run_mbpo_trains_logs_and_snapshots(tmp_path, monkeypatch):
    """One epoch through `EXPERIMENTS["mbpo"]`: progress.csv's keys and
    TotalEnvSteps, every value finite, the rings' counts, and a 'last'
    snapshot that restores into a fresh runner bit for bit."""
    made = []
    init = MBPO.init

    def keep(self, *args, **kwargs):
        made.append(self)
        return init(self, *args, **kwargs)

    monkeypatch.setattr(MBPO, "init", keep)
    runner = pexp.EXPERIMENTS["mbpo"](_tiny_mbpo(tmp_path / "a"),
                                      device="cpu")
    with open(tmp_path / "a" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    for key in ("trainer/qf1_loss", "trainer/policy_loss", "trainer/alpha",
                "trainer/bnn_epochs", "trainer/bnn_train_loss",
                "trainer/bnn_holdout_mse", "trainer/mean_rollout_length",
                "AverageReturn", "StdReturn", "AvgPathLength",
                "TotalEnvSteps", "TrainTime", "EvalTime", "EnvStepsPerSec"):
        assert key in rows[0], key
    assert float(rows[0]["TotalEnvSteps"]) == 64 + 32
    assert float(rows[0]["trainer/bnn_epochs"]) == 2
    assert float(rows[0]["trainer/mean_rollout_length"]) == 1
    assert all(math.isfinite(float(x)) for x in rows[0].values())
    (mbpo,) = made
    assert mbpo.model_capacity == 1000
    assert runner.model_replay.data["reward"].shape == (1024,)
    assert runner.model_replay.size == 2 * 64      # pendulum never ends
    assert runner.replay.size == 96
    assert runner.algo_state.policy_opt.count == 2 * 4 * 4
    # 2 epochs a fit, on 64 rows (12 held out) and on 80 (16)
    assert runner.bnn_state.opt_state.count == 2 * (
        (64 - 12) // 16 + (80 - 16) // 16)

    fresh = mbpo.init(5)
    restore_checkpoint(str(tmp_path / "a" / "checkpoints" / "last"), fresh)
    assert not tree_diff(to_tree(runner), to_tree(fresh))


def test_fault_run_mbpo_refuses_load_params(tmp_path):
    """The JAX device branch never reads `load_params` and starts afresh
    over the run's snapshots; the port refuses."""
    v = _tiny_mbpo(tmp_path / "r", load_params=str(tmp_path / "a"))
    with pytest.raises(ValueError, match="MBPO has no resume"):
        pexp.run_mbpo(v, device="cpu")


def test_run_mbpo_raises_for_the_host_path(tmp_path):
    """The JAX launcher sends a host env to `HostMBPOLoop` (ROADMAP.md
    section 1 item 2.8), and so does the port now: the cut spec with
    `force_host` on hopper runs its epoch on the host MuJoCo env, with
    the learner's model and rings on the CPU."""
    v = _tiny_mbpo(tmp_path / "h")
    v["env_specs"] = dict(v["env_specs"], env_name="hopper",
                          force_host=True)
    v["rl_alg_params"].update(max_path_length=10, num_steps_per_eval=20)
    runner = pexp.run_mbpo(v, device="cpu")
    assert runner.env_state is None
    with open(tmp_path / "h" / "progress.csv") as f:
        (row,) = list(csv.DictReader(f))
    assert float(row["TotalEnvSteps"]) == runner.total_env_steps == \
        runner.replay.size
    assert all(math.isfinite(float(x)) for x in row.values())
    assert "trainer/bnn_holdout_mse" in row and "AverageReturn" in row


SPECS = sorted(p.name for p in (ROOT / "exp_specs" / "mbpo").glob("*.yaml"))


def _spec(name):
    with open(ROOT / "exp_specs" / "mbpo" / name) as f:
        (v,) = build_variants(yaml.safe_load(f))
    return v


def _built(run, mbpo_cls, variant, log_dir, **kw):
    """The MBPO object `run` (a launcher's `run_mbpo`) builds from
    `variant`, stopped at its `init`."""
    seen = []

    class Stop(Exception):
        pass

    def init(self, *args, **kwargs):
        seen.append(self)
        raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mbpo_cls, "init", init)
        with pytest.raises(Stop):
            run(dict(variant, log_dir=str(log_dir), print_to_console=False),
                **kw)
    return seen[0]


@pytest.mark.parametrize("spec", SPECS)
def test_run_mbpo_reads_the_specs_as_the_jax_launcher(tmp_path, spec):
    """The MBPOConfig, BNNTrainerConfig and SAC configuration `run_mbpo`
    builds from each exp_specs/mbpo/ spec, field by field against the JAX
    launcher's.  The JAX launcher cannot build the trunc_obs envs
    (ROADMAP.md section 3), so those two are held to their spec's values.
    SAC's target entropy is the spec's in the port, where the JAX launcher
    drops it (and tau and both learning rates, which equal its defaults in
    every spec)."""
    v = _spec(spec)
    p = _built(pexp.run_mbpo, MBPO, v, tmp_path / "port", device="cpu")
    mp, bp, rl = v["mbpo_params"], v["bnn_params"], v["rl_alg_params"]
    sp = v["sac_params"]
    assert (p.config.model_train_freq, p.config.rollout_batch_size,
            p.config.real_ratio, p.config.rollout_schedule) == (
        mp["model_train_freq"], mp["rollout_batch_size"], mp["real_ratio"],
        tuple(mp["rollout_schedule"]))
    assert p.grad_steps_per_iter == round(
        v["env_specs"]["env_num"] * rl["num_train_steps_per_train_call"]
        / rl["num_steps_between_train_calls"])
    assert (p.bnn.config.num_nets, p.bnn.config.num_elites,
            p.bnn.config.hidden_sizes) == (
        bp["num_nets"], bp["num_elites"], tuple(bp["hidden_sizes"]))
    assert p.algo.hidden == (v["net_size"],) * v["num_hidden_layers"]
    assert p.algo.target_entropy == sp.get("target_entropy",
                                           -p.action_size / 2)
    for k in ("discount", "reward_scale", "soft_target_tau", "policy_lr",
              "qf_lr"):
        assert getattr(p.algo.config, k) == sp.get(
            k, getattr(SACConfig(), k)), k
    if v["env_specs"]["env_name"].endswith("_trunc_obs"):
        with pytest.raises(KeyError):
            jexp.run_mbpo(dict(v, log_dir=str(tmp_path / "jax"),
                               print_to_console=False))
        return
    j = _built(jexp.run_mbpo, JMBPO, v, tmp_path / "jax")
    assert dataclasses.asdict(p.config) == dataclasses.asdict(j.config)
    assert dataclasses.asdict(p.bnn.config) == \
        dataclasses.asdict(j.bnn.config)
    jcfg = dataclasses.asdict(j.algo.config)
    pcfg = {k: x for k, x in dataclasses.asdict(p.algo.config).items()
            if k in jcfg}
    assert set(pcfg) == set(jcfg)
    assert pcfg.pop("target_entropy") == sp.get("target_entropy")
    assert jcfg.pop("target_entropy") is None
    assert pcfg == jcfg
    assert (p.model_capacity, p.num_envs, p.grad_steps_per_iter,
            p.obs_size, p.action_size) == (
        j.model_capacity, j.num_envs, j.grad_steps_per_iter, j.obs_size,
        j.action_size)


def test_fault_mbpo_reads_every_sac_param(tmp_path):
    """mbpo_hopper.yaml sets target_entropy -1.0: the JAX launcher's SAC
    trains at -A/2 = -1.5, the port's at -1.0; mbpo_humanoid.yaml's -2.0
    (where the JAX trainer would take -17/2 = -8.5) reaches the port's."""
    hopper, humanoid = (
        _built(pexp.run_mbpo, MBPO, _spec(s), tmp_path / s, device="cpu")
        for s in ("mbpo_hopper.yaml", "mbpo_humanoid.yaml"))
    assert hopper.algo.target_entropy == -1.0
    assert (humanoid.algo.target_entropy, humanoid.action_size) == (-2.0, 17)
    j = _built(jexp.run_mbpo, JMBPO, _spec("mbpo_hopper.yaml"),
               tmp_path / "jax")
    assert j.algo.target_entropy == -1.5
