"""The trajectory-window (rnn) discriminator in the port
(ilswiss_tpu_torch/models/rnn_discriminators.py,
data/replay.py::replay_sample_window, the rnn branches of
algorithms/adv_irl.py and launchers/experiments.py::run_adv_irl) against
the JAX package's (ilswiss_tpu/models/rnn_discriminators.py,
data/replay.py, algorithms/adv_irl.py).

Inputs come from a numpy seed; the JAX state is carried across by
utils/convert.py, and every draw of a JAX update is rebuilt from its keys
and replayed to the port in the port's documented order (`_Draws` checks
the order).  Pins: the forward rtol 1e-5, atol 1e-6; every update rtol
2e-4, atol 2e-5 (tests/test_torch_adv_irl.py's); window sampling exactly.
"""

import csv
import dataclasses
import functools
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ilswiss_tpu.algorithms.adv_irl import AdvIRL as JAdvIRL
from ilswiss_tpu.algorithms.adv_irl import AdvIRLConfig as JAdvIRLConfig
from ilswiss_tpu.algorithms.sac import SAC as JSAC
from ilswiss_tpu.data import replay as jreplay
from ilswiss_tpu.data.demo import load_demos_npz as jload_demos
from ilswiss_tpu.envs.vector import Transition as JTransition
from ilswiss_tpu.models.rnn_discriminators import RNNDisc as JRNNDisc
from ilswiss_tpu_torch.algorithms.adv_irl import AdvIRL, AdvIRLConfig
from ilswiss_tpu_torch.algorithms.sac import SAC
from ilswiss_tpu_torch.data.demo import load_demos_npz
from ilswiss_tpu_torch.data.replay import replay_sample_window
from ilswiss_tpu_torch.launchers import experiments as pexp
from ilswiss_tpu_torch.launchers.variant import build_variants
from ilswiss_tpu_torch.models.rnn_discriminators import RNNDisc
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DEMOS = str(ROOT / "demos" / "pendulum_expert.npz")
FWD = dict(rtol=1e-5, atol=1e-6)
PIN = dict(rtol=2e-4, atol=2e-5)
OBS, ACT, NET, HID, WIN, BATCH = 3, 1, 16, 16, 4, 16
RING, WRITE = 64, 4


def _close(got, want, pin, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _close(got[k], want[k], pin, f"{path}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **pin)


# --- the discriminator ------------------------------------------------------
@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_rnn_disc_forward_matches_flax(cell, bidirectional):
    """[3, 8, 5] windows through 2 layers of hid 16, from flax variables
    with every leaf moved off its init (the biases start at zero); the
    clamp at 0.5 cuts some logits."""
    rng = np.random.RandomState(0)
    jdisc = JRNNDisc(hid_dim=HID, cell_type=cell, num_layers=2,
                     bidirectional=bidirectional, clamp_magnitude=0.5)
    # jitted: eager flax runs each recurrence's scan op by op
    variables = jax.tree.map(np.asarray, jax.jit(jdisc.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 8, 5))))
    variables = jax.tree.map(
        lambda x: (x + 0.2 * rng.randn(*x.shape)).astype(np.float32),
        variables)
    disc = RNNDisc(5, torch.Generator(), hid_dim=HID, cell_type=cell,
                   num_layers=2, bidirectional=bidirectional,
                   clamp_magnitude=0.5)
    convert.rnn_disc_from_jax(disc, variables)
    _close(convert.rnn_disc_to_numpy(disc), variables, dict(rtol=0, atol=0))
    x = (2.0 * rng.randn(3, 8, 5)).astype(np.float32)
    want = np.asarray(jax.jit(jdisc.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = disc(torch.as_tensor(x)).numpy()
    assert got.shape == (3, 8, 1)
    assert 0 < np.sum(np.abs(want) == 0.5) < want.size
    np.testing.assert_allclose(got, want, **FWD)


def test_rnn_disc_init_matches_flax_shapes_and_scales():
    """The port's own init: flax's parameter set (no hidden-side biases on
    the GRU's r and z gates), orthogonal hidden kernels, zero biases."""
    jdisc = JRNNDisc(hid_dim=HID, cell_type="gru", num_layers=2)
    want = jax.tree.map(lambda x: x.shape, jax.eval_shape(
        jdisc.init, jax.random.PRNGKey(0), jnp.zeros((2, 8, 5))))
    disc = RNNDisc(5, torch.Generator().manual_seed(0), hid_dim=HID)
    got = jax.tree.map(lambda x: x.shape, convert.rnn_disc_to_numpy(disc))
    assert got == want
    w = disc.cell_b1.hz.weight.detach()
    np.testing.assert_allclose((w @ w.t()).numpy(), np.eye(HID), atol=1e-5)
    assert float(disc.cell_f0.hn.bias.abs().max()) == 0.0
    assert disc.cell_f0.hr.bias is None


# --- window sampling ----------------------------------------------------------
def _jax_ring(seed=0):
    """A lockstep ring of 64 rows written 20 times by 4 envs (it has
    wrapped), episodes ending at random."""
    rng = np.random.RandomState(seed)
    state = jreplay.replay_init(RING, OBS, ACT, write_batch=WRITE)
    for _ in range(20):
        state = jreplay.replay_add(state, JTransition(
            obs=jnp.asarray(rng.randn(WRITE, OBS), jnp.float32),
            action=jnp.asarray(rng.uniform(-1, 1, (WRITE, ACT)), jnp.float32),
            reward=jnp.asarray(rng.randn(WRITE), jnp.float32),
            next_obs=jnp.asarray(rng.randn(WRITE, OBS), jnp.float32),
            terminal=jnp.asarray(rng.rand(WRITE) < 0.1),
            done=jnp.asarray(rng.rand(WRITE) < 0.25)))
    return state


@pytest.mark.parametrize("buffer", ["ring", "demos"])
def test_replay_sample_window_matches_jax(buffer):
    """24 windows of 6 steps from the wrapped ring (stride 4) and from the
    demo buffer (stride 1), with the JAX uniforms fed: every field and the
    mask exactly; the windows cross episode ends and the wrap."""
    jstate = _jax_ring() if buffer == "ring" else jload_demos(DEMOS)
    assert int(jstate.size) == (RING if buffer == "ring" else 4000)
    state = convert.replay_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    key = jax.random.PRNGKey(3)
    want = jreplay.replay_sample_window(jstate, key, 24, 6)
    u = torch.as_tensor(np.asarray(jax.random.uniform(key, (24,))))
    got = replay_sample_window(state, u, 6)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    valid = np.asarray(want["valid"])
    if buffer == "ring":
        assert 0 < valid.mean() < 1


# --- the updates ------------------------------------------------------------
class _Draws:
    """The port's `Noise` methods, answering each call with the next JAX
    draw; a call out of the documented order fails."""

    def __init__(self, seq):
        self.seq = list(seq)

    def _pop(self, kind):
        assert self.seq, f"no draw left for {kind}"
        got, value = self.seq.pop(0)
        assert got == kind, f"drew {kind} where the JAX order has {got}"
        return torch.as_tensor(np.array(value))

    def replay(self, n):
        return self._pop("replay")

    def interpolation(self, n):
        return self._pop("interpolation")

    def train(self, shape):
        return self._pop("eps_next"), self._pop("eps_new")


def _disc_draws(key, cfg):
    n = max(1, cfg.disc_optim_batch_size // cfg.disc_traj_len)
    k_e, k_p, k_eps = jax.random.split(key, 3)
    return [("replay", jax.random.uniform(k_e, (n,))),
            ("replay", jax.random.uniform(k_p, (n,))),
            ("interpolation", jax.random.uniform(k_eps, (n, 1, 1)))]


def _policy_draws(key, cfg):
    n = max(1, cfg.policy_optim_batch_size // cfg.disc_traj_len)
    k_p, _, k_t = jax.random.split(key, 3)
    k_next, k_new = jax.random.split(k_t)
    rows = n * cfg.disc_traj_len
    return [("replay", jax.random.uniform(k_p, (n,))),
            ("eps_next", jax.random.normal(k_next, (rows, ACT))),
            ("eps_new", jax.random.normal(k_new, (rows, ACT)))]


def _train_call_draws(key, cfg):
    out = []
    for k in jax.random.split(key, cfg.num_update_loops_per_train_call):
        kd, kp = jax.random.split(k)
        for kk in jax.random.split(kd, cfg.num_disc_updates_per_loop_iter):
            out += _disc_draws(kk, cfg)
        for kk in jax.random.split(kp, cfg.num_policy_updates_per_loop_iter):
            out += _policy_draws(kk, cfg)
    return out


def _config(**kw):
    base = dict(mode="gail", disc_type="rnn", disc_traj_len=WIN,
                disc_optim_batch_size=BATCH, policy_optim_batch_size=BATCH,
                disc_lr=1e-3, disc_momentum=0.5, grad_pen_weight=4.0,
                disc_hid_dim=HID, disc_rnn_cell="gru", disc_rnn_layers=2,
                disc_rnn_bidirectional=True)
    base.update(kw)
    return base


@functools.cache
def _jsac():
    jsac = JSAC(OBS, ACT, net_size=NET, num_hidden_layers=2)
    jsac.init = jax.jit(jsac.init)
    jsac.train_step = jax.jit(jsac.train_step)
    return jsac


def _jalgo(**kw):
    jalgo = JAdvIRL(OBS, ACT, _jsac(), jload_demos(DEMOS),
                    JAdvIRLConfig(**_config(**kw)))
    jalgo.disc_update = jax.jit(jalgo._disc_update)
    return jalgo


@functools.cache
def _jax_setup():
    """The JAX trainer (reward normalization on), its state one
    discriminator step in (so Adam's moments are away from zero) with
    running reward moments, and the wrapped ring."""
    jalgo = _jalgo(reward_norm=True)
    replay = _jax_ring()
    state = jax.jit(jalgo.init)(jax.random.PRNGKey(0))
    state, _ = jalgo.disc_update(state, replay, jax.random.PRNGKey(99))
    state = state.replace(rew_stats=tuple(
        jnp.asarray(v, jnp.float32) for v in (5.0, 0.3, 2.0)))
    return jalgo, state, replay


def _port(jalgo, jstate, jreplay_state):
    cfg = AdvIRLConfig(**{f.name: getattr(jalgo.config, f.name)
                          for f in dataclasses.fields(AdvIRLConfig)})
    sac = SAC(OBS, ACT, net_size=NET, num_hidden_layers=2, device="cpu")
    algo = AdvIRL(OBS, ACT, sac, load_demos_npz(DEMOS, device="cpu"), cfg)
    state = convert.adv_irl_state_from_jax(
        algo, jax.tree.map(np.asarray, jstate))
    replay = convert.replay_from_jax(
        jax.tree.map(np.asarray, jreplay_state), "cpu")
    return algo, state, replay


def _jax_numpy(jstate):
    s = jax.tree.map(np.asarray, jstate)
    adam = s.disc_opt[0]
    opt = lambda o: {"count": int(o[0].count), "mu": o[0].mu,  # noqa: E731
                     "nu": o[0].nu}
    p = s.policy
    return {
        "disc_params": s.disc_params,
        "disc_opt": {"count": int(adam.count), "mu": adam.mu,
                     "nu": adam.nu},
        "policy": {"policy_params": p.policy_params,
                   "qf_params": p.qf_params,
                   "target_qf_params": p.target_qf_params,
                   "log_alpha": p.log_alpha,
                   "policy_opt": opt(p.policy_opt),
                   "qf_opt": opt(p.qf_opt),
                   "alpha_opt": opt(p.alpha_opt)},
    }


def _assert_state_close(state, jstate, pin):
    got = convert.adv_irl_state_to_numpy(state)
    want = _jax_numpy(jstate)
    assert got["disc_opt"].pop("count") == want["disc_opt"].pop("count")
    for k in ("disc_params", "disc_opt"):
        _close(got[k], want[k], pin, k)
    for k in ("policy_opt", "qf_opt", "alpha_opt"):
        assert got["policy"][k].pop("count") == want["policy"][k].pop(
            "count"), k
    _close(got["policy"], want["policy"], pin, "policy")
    if jstate.rew_stats is not None:
        _close(list(got["rew_stats"]),
               [np.asarray(v) for v in jstate.rew_stats], pin, "rew_stats")


def _assert_metrics_close(m, jm):
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **PIN)


def test_converted_state_round_trips():
    jalgo, jstate, jreplay_state = _jax_setup()
    _, state, _ = _port(jalgo, jstate, jreplay_state)
    _assert_state_close(state, jstate, dict(rtol=0, atol=0))


def test_disc_update_matches_jax():
    """One rnn discriminator step with the gradient penalty: 4 windows of
    4 steps from the demos and from the ring, inputs zeroed outside the
    mask, BCE and accuracy over the valid steps."""
    jalgo, jstate, jreplay_state = _jax_setup()
    key = jax.random.PRNGKey(5)
    jnext, jm = jalgo.disc_update(jstate, jreplay_state, key)
    algo, state, replay = _port(jalgo, jstate, jreplay_state)
    noise = _Draws(_disc_draws(key, algo.config))
    state, m = algo._disc_update(state, replay, noise)
    assert not noise.seq
    assert float(jm["disc_grad_pen"]) > 0
    _assert_metrics_close(m, jm)
    _assert_state_close(state, jnext, PIN)


def test_policy_update_matches_jax():
    """One policy step on 4 windows of the ring with reward normalization:
    rewards zeroed outside the mask and left out of the moments, SAC
    trained on the 16 flattened steps."""
    jalgo, jstate, jreplay_state = _jax_setup()
    key = jax.random.PRNGKey(6)
    jnext, jm = jax.jit(jalgo._policy_update)(jstate, jreplay_state, key)
    algo, state, replay = _port(jalgo, jstate, jreplay_state)
    noise = _Draws(_policy_draws(key, algo.config))
    state, m = algo._policy_update(state, replay, noise)
    assert not noise.seq
    _assert_metrics_close(m, jm)
    _assert_state_close(state, jnext, PIN)


def test_train_call_matches_jax():
    """Two loops of (2 discriminator, 2 policy) steps in gail2 mode with
    reward normalization, from the shared state."""
    _, jstate, jreplay_state = _jax_setup()
    jalgo = _jalgo(mode="gail2", reward_norm=True,
                   num_update_loops_per_train_call=2,
                   num_disc_updates_per_loop_iter=2,
                   num_policy_updates_per_loop_iter=2)
    key = jax.random.PRNGKey(8)
    jnext, jm = jax.jit(jalgo.train_call)(jstate, jreplay_state, key)
    algo, state, replay = _port(jalgo, jstate, jreplay_state)
    noise = _Draws(_train_call_draws(key, algo.config))
    state, m = algo.train_call(state, replay, noise)
    assert not noise.seq
    _assert_metrics_close(m, jm)
    _assert_state_close(state, jnext, PIN)


# --- the launcher -------------------------------------------------------------
def test_run_adv_irl_trains_the_rnn_disc(tmp_path, monkeypatch):
    """exp_specs/gail/gail_pendulum.yaml cut in length (as
    tests/test_torch_adv_irl.py cuts it) with `disc_type: rnn` and the
    JAX defaults of the rnn keys: 1 epoch on the CPU, the discriminator
    a 2-layer bidirectional GRU over windows of 16, every metric finite."""
    monkeypatch.chdir(ROOT)
    with open(ROOT / "exp_specs" / "gail" / "gail_pendulum.yaml") as f:
        (v,) = build_variants(yaml.safe_load(f))
    v["rl_alg_params"].update(
        num_epochs=1, num_steps_per_epoch=16, min_steps_before_training=32,
        max_path_length=50, num_steps_per_eval=1600,
        replay_buffer_size=1024, snapshot_mode="last")
    v["adv_irl_params"].update(num_policy_updates_per_loop_iter=2)
    v.update(log_dir=str(tmp_path), print_to_console=False,
             disc_type="rnn")
    runner = pexp.EXPERIMENTS["gail"](v, device="cpu")
    algo_state = runner.algo_state
    disc = algo_state.disc
    assert isinstance(disc, RNNDisc)
    assert disc.num_layers == 2 and disc.bidirectional
    assert hasattr(disc, "cell_b1") and disc.cell_f0.features == 128
    assert algo_state.disc_opt.count == 2           # 2 iterations x 1
    with open(tmp_path / "progress.csv") as f:
        (row,) = list(csv.DictReader(f))
    for key in ("disc_ce_loss", "disc_acc", "disc_grad_pen",
                "disc_rew_mean", "policy_qf1_loss"):
        assert math.isfinite(float(row[f"trainer/{key}"])), key
    assert float(row["trainer/disc_rew_mean"]) >= 0      # gail: softplus
