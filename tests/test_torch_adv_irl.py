"""Adversarial IL in the port (ilswiss_tpu_torch/algorithms/adv_irl.py,
models/discriminators.py, the loop's `train_call` branch and
launchers/experiments.py::run_adv_irl) against the JAX package's
(ilswiss_tpu/algorithms/adv_irl.py, models/discriminators.py,
launchers/experiments.py::run_adv_irl).

Inputs come from a numpy seed; the JAX state is carried across by
utils/convert.py, and every draw of a JAX update is rebuilt from its keys
and replayed to the port in the port's documented order (`_Draws` checks
the order).  Pins: the discriminator's forward and running averages rtol
1e-5, atol 1e-6; every update, rtol 2e-4, atol 2e-5, the pins the JAX
package holds a float32 learner chain to (tests/test_fused_sac.py:81-121).
Then `run_adv_irl` builds the JAX configuration on every exp_specs/gail/
spec, trains a cut copy of gail_pendulum.yaml on the CPU with a full
resume that is bit-equal to the straight run, and raises, naming the
ROADMAP.md item, where a part is not ported.
"""

import copy
import csv
import dataclasses
import functools
import glob
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
from ilswiss_tpu.data.demo import load_demos_npz as jload_demos
from ilswiss_tpu.data.replay import replay_init as jreplay_init
from ilswiss_tpu.launchers import experiments as jexp
from ilswiss_tpu.models.discriminators import MLPDisc as JMLPDisc
from ilswiss_tpu_torch.algorithms.adv_irl import AdvIRL, AdvIRLConfig
from ilswiss_tpu_torch.algorithms.sac import SAC
from ilswiss_tpu_torch.data.demo import load_demos_npz
from ilswiss_tpu_torch.launchers import experiments as pexp
from ilswiss_tpu_torch.launchers.variant import build_variants
from ilswiss_tpu_torch.models.discriminators import MLPDisc
from ilswiss_tpu_torch.runtime.checkpoint import to_tree
from ilswiss_tpu_torch.testing import tree_diff
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GAIL_SPECS = sorted(glob.glob(str(ROOT / "exp_specs" / "gail" / "*.yaml")))
OBS, ACT, NET, HID, BATCH, RING = 3, 1, 16, 16, 32, 64
FWD = dict(rtol=1e-5, atol=1e-6)
PIN = dict(rtol=2e-4, atol=2e-5)
CLOCKS = {"TrainTime", "EvalTime", "EnvStepsPerSec", "WallTime"}


def _close(got, want, pin, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], pin, f"{path}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **pin)


# --- the discriminator ----------------------------------------------------------
@pytest.mark.parametrize("use_bn", [False, True], ids=["plain", "bn"])
def test_mlp_disc_matches_flax(use_bn):
    """Forward in train and eval mode, and the running averages after two
    train-mode steps, from flax variables with random scale, bias and
    statistics."""
    rng = np.random.RandomState(0)
    jdisc = JMLPDisc(num_layer_blocks=2, hid_dim=HID, hid_act="tanh",
                     use_bn=use_bn, clamp_magnitude=2.0)
    variables = jax.tree.map(np.asarray, jdisc.init(
        jax.random.PRNGKey(1), jnp.zeros((2, 5)), train=True))
    # scaled kernels push some logits past the clamp
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (v * 3 if p[-1].key == "kernel"
                      else v + rng.uniform(0.1, 0.5, v.shape)
                      .astype(np.float32)), variables)
    disc = MLPDisc(5, torch.Generator().manual_seed(0), num_layer_blocks=2,
                   hid_dim=HID, hid_act="tanh", use_bn=use_bn,
                   clamp_magnitude=2.0)
    convert.disc_from_jax(disc, variables)
    _close(convert.disc_to_numpy(disc), variables, dict(rtol=0, atol=0))
    x = rng.randn(24, 5).astype(np.float32)
    want = jdisc.apply(variables, x, train=False)
    got = disc(torch.as_tensor(x), train=False)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    assert float(np.abs(want).max()) == 2.0      # the clamp is reached
    for step in range(2):
        x = rng.randn(24, 5).astype(np.float32) * (step + 1)
        if use_bn:
            want, upd = jdisc.apply(variables, x, train=True,
                                    mutable=["batch_stats"])
            variables = {**variables, **jax.tree.map(np.asarray, upd)}
        else:
            want = jdisc.apply(variables, x, train=True)
        stats = []
        got = disc(torch.as_tensor(x), train=True, stats=stats)
        disc.update_batch_stats(stats)
        np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
        assert len(stats) == (2 if use_bn else 0)
    _close(convert.disc_to_numpy(disc), variables, FWD)


def test_mlp_disc_init_draws_as_flax():
    """flax Dense's init, from the port's own generator: kernels from a
    normal truncated at 2 standard deviations with variance 1 / fan_in
    (lecun_normal), zero biases; the BatchNorm at scale 1, bias 0, running
    mean 0 and variance 1."""
    fan_in, width = 256, 512
    disc = MLPDisc(fan_in, torch.Generator().manual_seed(0),
                   num_layer_blocks=1, hid_dim=width, use_bn=True)
    jvars = JMLPDisc(num_layer_blocks=1, hid_dim=width, use_bn=True).init(
        jax.random.PRNGKey(0), jnp.zeros((2, fan_in)), train=True)
    want = np.asarray(jvars["params"]["dense_0"]["kernel"])
    got = disc.dense_0.weight.detach().numpy()
    bound = 2 * fan_in ** -0.5 / 0.87962566103423978
    for w in (got, want):
        assert abs(w.std() * fan_in ** 0.5 - 1.0) < 0.02
        assert np.abs(w).max() <= bound
    np.testing.assert_allclose(np.abs(got).max(), np.abs(want).max(),
                               rtol=1e-3)
    assert not disc.dense_0.bias.any() and not disc.logit.bias.any()
    _close(convert.disc_to_numpy(disc)["batch_stats"], jax.tree.map(
        np.asarray, jvars["batch_stats"]), dict(rtol=0, atol=0))
    for name in ("scale", "bias"):
        np.testing.assert_array_equal(
            getattr(disc.bn_0, name).detach().numpy(),
            np.asarray(jvars["params"]["bn_0"][name]))


def test_unknown_activation_raises():
    with pytest.raises(NotImplementedError, match="activation"):
        MLPDisc(3, torch.Generator(), hid_act="gelu")


# --- the algorithm --------------------------------------------------------------
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
    n = cfg.disc_optim_batch_size
    k_e, k_p, k_eps = jax.random.split(key, 3)
    return [("replay", jax.random.uniform(k_e, (n,))),
            ("replay", jax.random.uniform(k_p, (n,))),
            ("interpolation", jax.random.uniform(k_eps, (n, 1)))]


def _policy_draws(key, cfg):
    n, n_exp = cfg.policy_optim_batch_size, \
        cfg.policy_optim_batch_size_from_expert
    k_p, k_e, k_t = jax.random.split(key, 3)
    out = [("replay", jax.random.uniform(k_p, (n - n_exp,)))]
    if n_exp:
        out.append(("replay", jax.random.uniform(k_e, (n_exp,))))
    k_next, k_new = jax.random.split(k_t)
    return out + [("eps_next", jax.random.normal(k_next, (n, ACT))),
                  ("eps_new", jax.random.normal(k_new, (n, ACT)))]


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
    base = dict(mode="gail", disc_optim_batch_size=BATCH,
                policy_optim_batch_size=BATCH, disc_lr=1e-3,
                disc_momentum=0.5, grad_pen_weight=4.0, disc_hid_dim=HID,
                disc_hid_act="tanh", disc_use_bn=False)
    base.update(kw)
    return base


@functools.cache
def _jsac():
    """One JAX SAC for every configuration, its `init` and `train_step`
    jitted once (eager, each configuration would dispatch them op by op)."""
    jsac = JSAC(OBS, ACT, net_size=NET, num_hidden_layers=2)
    jsac.init = jax.jit(jsac.init)
    jsac.train_step = jax.jit(jsac.train_step)
    return jsac


@functools.cache
def _jax_setup(**kw):
    """The JAX trainer, its state (one disc step in, so the moments and a
    BatchNorm's running averages are not at their init) and its ring."""
    demos = jload_demos(str(ROOT / "demos" / "pendulum_expert.npz"))
    jalgo = JAdvIRL(OBS, ACT, _jsac(), demos,
                    JAdvIRLConfig(**_config(**kw)))
    rng = np.random.RandomState(0)
    replay = jreplay_init(RING, OBS, ACT, write_batch=4)
    replay = replay.replace(data={
        "obs": jnp.asarray(rng.randn(RING, OBS), jnp.float32),
        "action": jnp.asarray(rng.uniform(-1, 1, (RING, ACT)), jnp.float32),
        "reward": jnp.asarray(rng.randn(RING), jnp.float32),
        "next_obs": jnp.asarray(rng.randn(RING, OBS), jnp.float32),
        "terminal": jnp.asarray(rng.rand(RING) < 0.1, jnp.float32),
    }, size=jnp.asarray(RING, jnp.int32))
    state = jalgo.init(jax.random.PRNGKey(0))
    state, _ = jalgo._disc_update(state, replay, jax.random.PRNGKey(99))
    if jalgo.config.reward_norm:
        state = state.replace(rew_stats=tuple(
            jnp.asarray(v, jnp.float32) for v in (5.0, 0.3, 2.0)))
    return jalgo, state, replay


def _port(jalgo, jstate, jreplay):
    cfg = AdvIRLConfig(**{f.name: getattr(jalgo.config, f.name)
                          for f in dataclasses.fields(AdvIRLConfig)})
    sac = SAC(OBS, ACT, net_size=NET, num_hidden_layers=2, device="cpu")
    algo = AdvIRL(OBS, ACT, sac, load_demos_npz(
        str(ROOT / "demos" / "pendulum_expert.npz"), device="cpu"), cfg)
    state = convert.adv_irl_state_from_jax(
        algo, jax.tree.map(np.asarray, jstate))
    replay = convert.replay_from_jax(jax.tree.map(np.asarray, jreplay),
                                     "cpu")
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


def _split_bn_biases(tree, n_blocks):
    """The dense biases that feed a BatchNorm, taken out of a params (or
    moments) tree.  BatchNorm subtracts the batch mean, so in exact
    arithmetic these biases get no gradient at all: what each side
    computes for them is rounding noise (about 1e-8 against 1e-2 for the
    other leaves), which Adam, dividing by the gradient's own size, turns
    into steps of up to lr in either direction."""
    tree = copy.deepcopy(tree)
    return tree, [tree[f"dense_{i}"].pop("bias") for i in range(n_blocks)]


def _assert_state_close(state, jstate, pin):
    """Every leaf at `pin`; with BatchNorm on, the dense biases that feed
    it are held instead to a gradient at rounding level on both sides
    (their first moments under 1e-6), see `_split_bn_biases`."""
    got = convert.adv_irl_state_to_numpy(state)
    want = _jax_numpy(jstate)
    bn = state.disc.use_bn
    n = state.disc.num_layer_blocks
    _close(got["policy"], want["policy"], pin, "policy")
    trees = [(got["disc_params"], want["disc_params"], "disc_params")]
    trees += [(got["disc_opt"][m], want["disc_opt"][m], m)
              for m in ("mu", "nu")]
    for g, w, name in trees:
        if bn:
            params = name == "disc_params"
            g, gb = _split_bn_biases(g["params"] if params else g, n)
            w, wb = _split_bn_biases(w["params"] if params else w, n)
            if name == "mu":
                assert max(np.abs(x).max() for x in gb + wb) < 1e-6
            if params:
                _close(got["disc_params"]["batch_stats"],
                       want["disc_params"]["batch_stats"], pin, "stats")
        _close(g, w, pin, name)
    assert got["disc_opt"]["count"] == want["disc_opt"]["count"]
    if jstate.rew_stats is None:
        assert got["rew_stats"] is None
    else:
        _close(list(got["rew_stats"]), [np.asarray(v)
                                        for v in jstate.rew_stats], pin)


def test_converted_state_round_trips():
    jalgo, jstate, jreplay = _jax_setup(disc_use_bn=True, reward_norm=True)
    _, state, _ = _port(jalgo, jstate, jreplay)
    _assert_state_close(state, jstate, dict(rtol=0, atol=0))
    got = convert.replay_to_numpy(state.expert)
    for k, v in jstate.expert.data.items():
        np.testing.assert_array_equal(got["data"][k], np.asarray(v))
    assert got["size"] == 4000 and got["env_ep"].shape == (1,)


@pytest.mark.parametrize("use_bn", [False, True], ids=["plain", "bn"])
@pytest.mark.parametrize("use_grad_pen", [True, False], ids=["gp", "nogp"])
def test_disc_update_matches_jax(use_bn, use_grad_pen):
    jalgo, jstate, jreplay = _jax_setup(disc_use_bn=use_bn,
                                        use_grad_pen=use_grad_pen)
    key = jax.random.PRNGKey(5)
    jnext, jm = jalgo._disc_update(jstate, jreplay, key)
    algo, state, replay = _port(jalgo, jstate, jreplay)
    noise = _Draws(_disc_draws(key, algo.config))
    state, m = algo._disc_update(state, replay, noise)
    assert not noise.seq
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **PIN)
    assert (float(jm["disc_grad_pen"]) > 0) == use_grad_pen
    _assert_state_close(state, jnext, PIN)


@pytest.mark.parametrize("mode", ["airl", "gail", "gail2", "fairl"])
def test_synthesize_rewards_matches_jax(mode):
    """Each mode without and with clips, on a discriminator whose logits
    reach the clamp."""
    jalgo, jstate, jreplay = _jax_setup()
    scale = lambda p, v: v * (12 if p[-2].key == "logit" else 4) \
        if p[-1].key == "kernel" else v  # noqa: E731
    jstate = jstate.replace(disc_params=jax.tree_util.tree_map_with_path(
        scale, jstate.disc_params))
    rng = np.random.RandomState(2)
    batch = {"obs": rng.randn(64, OBS).astype(np.float32) * 3,
             "action": rng.uniform(-1, 1, (64, ACT)).astype(np.float32),
             "next_obs": rng.randn(64, OBS).astype(np.float32)}
    unclipped = None
    for clips in ({}, {"rew_clip_min": -0.5, "rew_clip_max": 0.7}):
        cfg = dataclasses.replace(jalgo.config, mode=mode, **clips)
        j = JAdvIRL(OBS, ACT, jalgo.policy_trainer, jalgo.expert_replay, cfg)
        want = np.asarray(j.synthesize_rewards(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}))
        algo, state, _ = _port(j, jstate, jreplay)
        got = algo.synthesize_rewards(
            state, {k: torch.as_tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(got.numpy(), want, err_msg=str(clips),
                                   **FWD)
        if clips:       # a clip binds on some rows (which, by the mode)
            bound = np.isin(want, np.float32([-0.5, 0.7]))
            assert bound.any() and (want[bound] != unclipped[bound]).all()
        unclipped = want
    logits = np.asarray(j.disc.apply(jstate.disc_params, np.concatenate(
        [batch["obs"], batch["action"]], -1), train=False))
    assert np.abs(logits).max() == 10.0


@pytest.mark.parametrize("weighted", [False, True], ids=["all", "weighted"])
def test_normalize_rewards_matches_jax(weighted):
    jalgo, jstate, jreplay = _jax_setup(reward_norm=True)
    rng = np.random.RandomState(3)
    rew = rng.randn(BATCH).astype(np.float32) * 2 + 1
    weight = ((rng.rand(BATCH) < 0.6).astype(np.float32) if weighted
              else None)
    jnext, jrew = jalgo._normalize_rewards(
        jstate, jnp.asarray(rew), None if weight is None
        else jnp.asarray(weight))
    algo, state, _ = _port(jalgo, jstate, jreplay)
    state, got = algo._normalize_rewards(
        state, torch.as_tensor(rew),
        None if weight is None else torch.as_tensor(weight))
    np.testing.assert_allclose(got.numpy(), np.asarray(jrew), **FWD)
    for g, w in zip(state.rew_stats, jnext.rew_stats):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)
    # an all-masked batch leaves the moments as they were
    if weighted:
        state, _ = algo._normalize_rewards(state, torch.as_tensor(rew),
                                           torch.zeros(BATCH))
        for g, w in zip(state.rew_stats, jnext.rew_stats):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)


@pytest.mark.parametrize("n_exp", [0, 8], ids=["policy_rows", "expert_mix"])
def test_policy_update_matches_jax(n_exp):
    jalgo, jstate, jreplay = _jax_setup(
        policy_optim_batch_size_from_expert=n_exp, reward_norm=bool(n_exp))
    key = jax.random.PRNGKey(6)
    jnext, jm = jalgo._policy_update(jstate, jreplay, key)
    algo, state, replay = _port(jalgo, jstate, jreplay)
    noise = _Draws(_policy_draws(key, algo.config))
    state, m = algo._policy_update(state, replay, noise)
    assert not noise.seq
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **PIN)
    _assert_state_close(state, jnext, PIN)


def test_train_call_matches_jax():
    """Two loops of (2 disc, 2 policy) steps, with the gradient penalty,
    expert rows in the policy batches and reward normalization, in gail2
    mode (gail_hopper.yaml's discriminator: no BatchNorm; with it, the
    rounding noise of `_split_bn_biases` reaches the synthesized rewards
    through the running mean)."""
    kw = dict(reward_norm=True, mode="gail2",
              policy_optim_batch_size_from_expert=8,
              num_update_loops_per_train_call=2,
              num_disc_updates_per_loop_iter=2,
              num_policy_updates_per_loop_iter=2)
    jalgo, jstate, jreplay = _jax_setup(**kw)
    key = jax.random.PRNGKey(8)
    jnext, jm = jalgo.train_call(jstate, jreplay, key)
    algo, state, replay = _port(jalgo, jstate, jreplay)
    noise = _Draws(_train_call_draws(key, algo.config))
    state, m = algo.train_call(state, replay, noise)
    assert not noise.seq
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **PIN)
    _assert_state_close(state, jnext, PIN)


# --- the launcher ---------------------------------------------------------------
def _spec(path):
    with open(path) as f:
        return build_variants(yaml.safe_load(f))[0]


def _captured(module, monkeypatch, variant, **kw):
    """The algorithm and env that `module.run_adv_irl` hands its
    `_run_off_policy`."""
    seen = {}

    def capture(algo, vec, rl, logger, seed, **_):
        seen.update(algo=algo, vec=vec, rl=rl)
        logger.close()

    monkeypatch.setattr(module, "_run_off_policy", capture)
    module.run_adv_irl(variant, **kw)
    return seen


def _env_chain(env):
    chain = []
    while hasattr(env, "inner"):
        chain.append(type(env).__name__)
        env = env.inner
    return chain + [type(env).__name__]


def test_run_adv_irl_builds_the_jax_configuration_on_every_gail_spec(
        tmp_path, monkeypatch):
    """Trainer and discriminator settings, the rescaled update loops, the
    Q-target bounds, the env wrappers with their statistics and the demos,
    as the JAX launcher builds them, on all ten exp_specs/gail/ specs."""
    monkeypatch.chdir(ROOT)
    assert len(GAIL_SPECS) == 10
    modes = set()
    for path in GAIL_SPECS:
        v = _spec(path)
        v.update(log_dir=str(tmp_path / Path(path).stem),
                 print_to_console=False)
        want = _captured(jexp, monkeypatch, copy.deepcopy(v))
        got = _captured(pexp, monkeypatch, copy.deepcopy(v), device="cpu")
        ja, pa = want["algo"], got["algo"]
        for f in dataclasses.fields(pa.config):
            assert getattr(pa.config, f.name) == getattr(ja.config, f.name), \
                (path, f.name)
        assert dataclasses.asdict(pa.policy_trainer.config) == \
            dataclasses.asdict(ja.policy_trainer.config), path
        assert pa.policy_trainer.hidden == tuple(
            ja.policy_trainer.qf.hidden_sizes), path
        assert got["rl"] == want["rl"], path
        jenv, penv = want["vec"].env, got["vec"].env
        assert _env_chain(penv) == _env_chain(jenv), path
        assert (penv.observation_size, penv.action_size,
                got["vec"].num_envs) == (jenv.observation_size,
                                         jenv.action_size,
                                         want["vec"].num_envs)
        for name in ("obs_mean", "obs_std", "obs_min", "obs_max"):
            if hasattr(jenv, name):
                np.testing.assert_array_equal(
                    getattr(penv, name).numpy(), np.asarray(getattr(jenv,
                                                                    name)))
        e = convert.replay_to_numpy(pa.expert_replay)
        for k, x in ja.expert_replay.data.items():
            np.testing.assert_array_equal(e["data"][k], np.asarray(x),
                                          err_msg=f"{path} {k}")
        modes.add(pa.config.mode)
    assert modes == {"airl", "gail", "gail2", "fairl"}


def _gail_pendulum(log_dir, num_epochs=2, **extra):
    """exp_specs/gail/gail_pendulum.yaml cut in length (8 envs, 64 x 2
    policy, 2 x 128 tanh discriminator as the spec), 2 iterations an
    epoch, 50-step episodes."""
    v = _spec(ROOT / "exp_specs" / "gail" / "gail_pendulum.yaml")
    rl = v["rl_alg_params"]
    rl.update(num_epochs=num_epochs, num_steps_per_epoch=16,
              min_steps_before_training=32, max_path_length=50,
              num_steps_per_eval=1600, replay_buffer_size=1024,
              snapshot_mode="last")
    v["adv_irl_params"].update(num_policy_updates_per_loop_iter=2)
    v.update(log_dir=str(log_dir), print_to_console=False, **extra)
    return v


def _rows(log_dir):
    with open(Path(log_dir) / "progress.csv") as f:
        return list(csv.DictReader(f))


def test_gail_pendulum_trains_and_resumes_bit_for_bit(tmp_path,
                                                      monkeypatch):
    """A 2-epoch run, and a 1-epoch run resumed in full to 2 epochs: the
    end states bit-equal, progress.csv rows equal but for the clocks, the
    discriminator's metrics logged and finite."""
    monkeypatch.chdir(ROOT)
    a = pexp.EXPERIMENTS["gail"](_gail_pendulum(tmp_path / "a"),
                                 device="cpu")
    pexp.EXPERIMENTS["adv_irl"](_gail_pendulum(tmp_path / "b", 1),
                                device="cpu")
    b = pexp.EXPERIMENTS["adv_irl"](
        _gail_pendulum(tmp_path / "b", load_params=str(tmp_path / "b")),
        device="cpu")
    assert not tree_diff(to_tree(a), to_tree(b))
    assert a.algo_state.disc_opt.count == 2 * 2      # 2 iterations x 2
    rows_a, rows_b = _rows(tmp_path / "a"), _rows(tmp_path / "b")
    assert len(rows_a) == len(rows_b) == 2
    for key in ("disc_ce_loss", "disc_acc", "disc_grad_pen",
                "disc_rew_mean", "policy_qf1_loss", "policy_alpha"):
        assert f"trainer/{key}" in rows_a[0], key
    for ra, rb in zip(rows_a, rows_b):
        assert all(math.isfinite(float(x)) for x in ra.values())
        assert {k: x for k, x in ra.items() if k not in CLOCKS} == \
            {k: x for k, x in rb.items() if k not in CLOCKS}
    # gail rewards are softplus(logits) >= 0
    assert all(float(r["trainer/disc_rew_mean"]) >= 0 for r in rows_a)
    assert [float(r["TotalEnvSteps"]) for r in rows_a] == [48.0, 64.0]


def test_unported_parts_raise_naming_their_item(tmp_path, monkeypatch):
    """The host envs (item 2.8) and the visual parts (item 2.7) are
    ported: a host env name goes to the host path with the host env's
    sizes (+1 for the absorbing flag), the spec's update loops a train
    call (not rescaled) and the demo stats for the host wrappers; the cnn
    discriminator refuses vector observations, and `feature_fn` takes the
    width of its features."""
    monkeypatch.chdir(ROOT)
    with pytest.raises(ValueError, match="image observations"):
        pexp.run_adv_irl(_gail_pendulum(tmp_path / "x", disc_type="cnn"),
                         device="cpu")
    host = _gail_pendulum(tmp_path / "x", scale_env_with_demo_stats=True)
    host["env_specs"]["env_name"] = "lunarlandercont"
    host["adv_irl_params"].update(wrap_absorbing=True,
                                  num_update_loops_per_train_call=3)
    seen = {}
    monkeypatch.setattr(pexp, "_run_host_off_policy",
                        lambda algo, *a, **kw: seen.update(algo=algo, kw=kw))
    pexp.run_adv_irl(host, device="cpu")
    algo = seen["algo"]
    assert (algo.obs_size, algo.action_size) == (8 + 1, 2)
    assert algo.config.num_update_loops_per_train_call == 3
    assert seen["kw"]["wrap_absorbing"] is True
    assert set(seen["kw"]["demo_stats"]) >= {"obs_mean", "obs_std"}
    sac = SAC(OBS, ACT, net_size=NET, num_hidden_layers=2, device="cpu")
    with pytest.raises(ValueError, match="feature_dim"):
        AdvIRL(OBS, ACT, sac, None, feature_fn=lambda s, o: o)
    algo = AdvIRL(OBS, ACT, sac, None, feature_fn=lambda s, o: o,
                  feature_dim=5)
    assert algo.disc_input_dim == 5 + ACT
