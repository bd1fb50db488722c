"""PPO in the port (ilswiss_tpu_torch/data/rollout.py, utils/running_stats.py,
models/policies.py::GaussianPolicy, algorithms/ppo.py, runtime/onpolicy.py,
launchers/experiments.py::run_ppo) against the JAX package's
(ilswiss_tpu/data/rollout.py, utils/running_stats.py, models/policies.py,
algorithms/ppo.py, runtime/onpolicy.py).

Inputs come from a numpy seed; the JAX state is carried across by
utils/convert.py, and every draw of a JAX update or loop iteration is
rebuilt from its keys and replayed to the port in the port's documented
order (`_Draws` checks the order).  Pins: forwards rtol 1e-5, atol 1e-6;
updates rtol 2e-4, atol 2e-5 (tests/test_torch_offpolicy_trainers.py's).
Each update runs from a state one JAX update in, so both Adams' moments
are away from zero, and is held to 2 passes of 4 minibatches.
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

from ilswiss_tpu.algorithms.ppo import PPO as JPPO
from ilswiss_tpu.algorithms.ppo import PPOConfig as JPPOConfig
from ilswiss_tpu.data import rollout as jrollout
from ilswiss_tpu.envs import make_vec as jmake_vec
from ilswiss_tpu.models.policies import GaussianPolicy as JGaussianPolicy
from ilswiss_tpu.runtime.onpolicy import OnPolicyConfig as JOnPolicyConfig
from ilswiss_tpu.runtime.onpolicy import OnPolicyLoop as JOnPolicyLoop
from ilswiss_tpu.utils import running_stats as jrs
from ilswiss_tpu_torch.algorithms.ppo import PPO, PPOConfig
from ilswiss_tpu_torch.data import rollout
from ilswiss_tpu_torch.envs import make_vec
from ilswiss_tpu_torch.launchers import experiments as pexp
from ilswiss_tpu_torch.launchers.variant import build_variants
from ilswiss_tpu_torch.models.policies import GaussianPolicy
from ilswiss_tpu_torch.runtime.checkpoint import restore_checkpoint, to_tree
from ilswiss_tpu_torch.runtime.onpolicy import OnPolicyConfig, OnPolicyLoop
from ilswiss_tpu_torch.testing import tree_diff
from ilswiss_tpu_torch.utils import convert
from ilswiss_tpu_torch.utils import running_stats as rs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FWD = dict(rtol=1e-5, atol=1e-6)
PIN = dict(rtol=2e-4, atol=2e-5)
OBS, ACT, NET = 3, 2, 16
T, B, MB, EPOCHS = 8, 4, 8, 2          # N = 32 rows, 4 minibatches a pass


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


def _jax_numpy(jstate):
    """The JAX PPOState in `convert.ppo_state_to_numpy`'s layout."""
    s = jax.tree.map(np.asarray, jstate)
    adam = lambda a: {"count": int(a.count), "mu": a.mu,  # noqa: E731
                      "nu": a.nu}
    return {"policy_params": s.policy_params, "vf_params": s.vf_params,
            "policy_opt": adam(s.policy_opt[1][0]),
            "vf_opt": adam(s.vf_opt[0])}


def _assert_state_close(state, jstate, pin=PIN):
    _close(convert.ppo_state_to_numpy(state), _jax_numpy(jstate), pin)


# --- GAE, the moments, the policy ---------------------------------------------
def test_gae_and_advantage_normalization_match_jax():
    """A [6, 3] rollout with a termination and a truncation inside it."""
    rng = np.random.RandomState(0)
    r, v = rng.randn(6, 3).astype(np.float32), rng.randn(6, 3).astype(
        np.float32)
    last = rng.randn(3).astype(np.float32)
    term = np.zeros((6, 3), np.float32)
    done = np.zeros((6, 3), np.float32)
    term[2, 0] = done[2, 0] = 1.0        # a termination
    done[4, 1] = 1.0                     # a truncation: bootstrap kept
    want = jrollout.gae(*(jnp.asarray(x) for x in (r, v, last, term, done)),
                        0.97, 0.9)
    got = rollout.gae(*(torch.as_tensor(x) for x in (r, v, last, term, done)),
                      0.97, 0.9)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)
    np.testing.assert_allclose(
        rollout.normalize_advantages(got[0]).numpy(),
        np.asarray(jrollout.normalize_advantages(want[0])), **FWD)


def test_running_moments_and_normalize_match_jax():
    """Three batches merged in turn, then `normalize` (with its clip) and
    `unnormalize`."""
    rng = np.random.RandomState(1)
    jrms = jrs.running_mean_std_init((4,))
    rms = rs.running_mean_std_init((4,), "cpu")
    for n in (5, 17, 3):
        batch = (3.0 * rng.randn(n, 4) + rng.randn(4)).astype(np.float32)
        jrms = jrs.running_mean_std_update(jrms, jnp.asarray(batch))
        rms = rs.running_mean_std_update(rms, torch.as_tensor(batch))
        _close(convert.running_mean_std_to_numpy(rms),
               {k: np.asarray(getattr(jrms, k))
                for k in ("mean", "var", "count")}, FWD)
    x = (20.0 * rng.randn(8, 4)).astype(np.float32)
    y = rs.normalize(rms, torch.as_tensor(x), clip=1.5)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jrs.normalize(jrms, jnp.asarray(x), clip=1.5)),
        **FWD)
    assert float(y.abs().max()) == 1.5
    np.testing.assert_allclose(
        rs.unnormalize(rms, rs.normalize(rms, torch.as_tensor(x), None)
                       ).numpy(), x, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("state_dependent_std", [False, True],
                         ids=["param_std", "head_std"])
def test_gaussian_policy_forward_matches_flax(state_dependent_std):
    rng = np.random.RandomState(2)
    jpol = JGaussianPolicy(action_dim=ACT, hidden_sizes=(NET, NET),
                           state_dependent_std=state_dependent_std)
    params = jax.tree.map(np.asarray, jpol.init(
        jax.random.PRNGKey(0), jnp.zeros((1, OBS))))
    # every leaf away from its init (the log-std parameter starts at 0)
    params = jax.tree.map(
        lambda x: (x + 0.3 * rng.randn(*x.shape)).astype(np.float32), params)
    pol = GaussianPolicy(OBS, ACT, (NET, NET), torch.Generator(),
                         state_dependent_std=state_dependent_std)
    convert.gaussian_policy_from_jax(pol, params)
    obs = rng.randn(7, OBS).astype(np.float32)
    want = jpol.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        got = pol(torch.as_tensor(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)
    _close(convert.gaussian_policy_to_numpy(pol), params, dict(rtol=0, atol=0))


# --- one train_step ---------------------------------------------------------
CONFIGS = {
    "default": {},
    "value_clip": dict(use_value_clip=True),
    "zero_bootstrap": dict(zero_bootstrap_at_done=True),
}


def _ppo_config(**kw):
    base = dict(discount=0.97, reward_scale=2.0, gae_tau=0.9, clip_eps=0.2,
                policy_lr=1e-3, value_lr=2e-3, value_l2_reg=1e-2,
                update_epoch=EPOCHS, mini_batch_size=MB,
                policy_grad_clip=0.5)
    base.update(kw)
    return base


def _rollout(rng):
    done = rng.rand(T, B) < 0.15
    return {
        "obs": rng.randn(T, B, OBS).astype(np.float32),
        "action": rng.randn(T, B, ACT).astype(np.float32),
        "reward": rng.randn(T, B).astype(np.float32),
        "terminal": done & (rng.rand(T, B) < 0.5),
        "done": done,
        "last_obs": rng.randn(B, OBS).astype(np.float32),
    }


def _perms(key, n):
    """The passes' permutations of one JAX `train_step` from its key."""
    return np.stack([np.asarray(jax.random.permutation(k, n))
                     for k in jax.random.split(key, EPOCHS)])


@pytest.fixture(scope="module")
def step_runs():
    """Per configuration: the JAX state one `train_step` in, the next
    rollout, key and the state and metrics after it."""
    out = {}
    for name, kw in CONFIGS.items():
        jppo = JPPO(OBS, ACT, JPPOConfig(**_ppo_config(**kw)), net_size=NET,
                    num_hidden_layers=2)
        step = jax.jit(jppo.train_step)
        rng = np.random.RandomState(3)
        first, second = _rollout(rng), _rollout(rng)
        as_jax = lambda r: {k: jnp.asarray(v)  # noqa: E731
                            for k, v in r.items()}
        jstate, _ = step(jppo.init(jax.random.PRNGKey(0)), as_jax(first),
                         jax.random.PRNGKey(1))
        key = jax.random.PRNGKey(2)
        jnext, jm = step(jstate, as_jax(second), key)
        out[name] = dict(jppo=jppo, jstate=jstate, rollout=second, key=key,
                         jnext=jnext, metrics=jax.tree.map(np.asarray, jm))
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_matches_jax(step_runs, name):
    run = step_runs[name]
    ppo = PPO(OBS, ACT, PPOConfig(**_ppo_config(**CONFIGS[name])),
              net_size=NET, num_hidden_layers=2, device="cpu")
    state = convert.ppo_state_from_jax(ppo, jax.tree.map(np.asarray,
                                                         run["jstate"]))
    _assert_state_close(state, run["jstate"], dict(rtol=0, atol=0))
    batch = {k: torch.as_tensor(v) for k, v in run["rollout"].items()}
    perms = torch.as_tensor(_perms(run["key"], T * B), dtype=torch.int64)
    state, m = ppo.train_step(state, batch, perms)
    assert state.policy_opt.count == state.vf_opt.count == 2 * EPOCHS * 4
    _assert_state_close(state, run["jnext"])
    assert set(m) == set(run["metrics"])
    for k, v in run["metrics"].items():
        np.testing.assert_allclose(float(m[k]), float(v), err_msg=k, **PIN)


def test_global_norm_clip_matches_optax():
    import optax
    from ilswiss_tpu_torch.algorithms.ppo import clip_by_global_norm
    rng = np.random.RandomState(4)
    grads = [rng.randn(3, 2).astype(np.float32), rng.randn(5).astype(
        np.float32)]
    for max_norm in (0.5, 100.0):
        tx = optax.clip_by_global_norm(max_norm)
        want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(grads))
        got = clip_by_global_norm([torch.as_tensor(g) for g in grads],
                                  max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)


# --- two loop iterations ------------------------------------------------------
class _Draws:
    """The port's `Noise` methods, answering each call with the next JAX
    draw; a call out of the documented order fails."""

    def __init__(self, seq):
        self.seq = list(seq)

    def _pop(self, kind):
        assert self.seq, f"no draw left for {kind}"
        got, value = self.seq.pop(0)
        assert got == kind, f"drew {kind} where the JAX order has {got}"
        if isinstance(value, tuple):
            return tuple(torch.as_tensor(np.array(v)) for v in value)
        return torch.as_tensor(np.array(value))

    def act(self, shape):
        return self._pop("act")

    def reset(self, env, n):
        return self._pop("reset")

    def permutation(self, n):
        return self._pop("permutation").to(torch.int64)


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


def _iteration_draws(jloop, jrunner, act, step, action_size):
    """Every draw of one JAX `OnPolicyLoop._iter` from the runner's keys,
    in the port's order: per acting step the act noise and the resets
    (the env states' keys, replayed by stepping as `_iter` does), then the
    update's permutations."""
    _, k_roll, k_train = jax.random.split(jrunner.rng, 3)
    env_state, seq = jrunner.env_state, []
    for key in jax.random.split(k_roll, T):
        seq.append(("act", jax.random.normal(key, (B, action_size))))
        seq.append(_pendulum_reset_draws(env_state.rng))
        obs = jloop._norm(jrunner, env_state.obs)
        env_state, _ = step(env_state, act(jrunner.algo_state, obs, key))
    seq += [("permutation", p) for p in _perms(k_train, T * B)]
    return seq


def test_loop_iterations_match_jax():
    """Two iterations on pendulum (4 envs, T = 8, episodes cut at 5 steps,
    so resets fall inside the rollouts) with observation normalization:
    the env state, the PPO state, the moments, the step count and the
    metrics, from the JAX loop's runner with every draw replayed."""
    ACT_P = 1
    cfg = _ppo_config()
    jvec = jmake_vec("pendulum", num_envs=B, max_episode_steps=5)
    jppo = JPPO(OBS, ACT_P, JPPOConfig(**cfg), net_size=NET,
                num_hidden_layers=2)
    jloop = JOnPolicyLoop(jvec, jppo, JOnPolicyConfig(rollout_length=T,
                                                      normalize_obs=True))
    ppo = PPO(OBS, ACT_P, PPOConfig(**cfg), net_size=NET,
              num_hidden_layers=2, device="cpu")
    loop = OnPolicyLoop(make_vec("pendulum", B, device="cpu",
                                 max_episode_steps=5), ppo,
                        OnPolicyConfig(rollout_length=T, normalize_obs=True))
    jiter = jax.jit(jloop._iter)
    act = jax.jit(jppo.act)
    step = jax.jit(jvec.step)
    jrunner = jloop.init(jax.random.PRNGKey(0))
    seq = []
    snapshot = jax.tree.map(np.asarray, jrunner)
    jmetrics = []
    for _ in range(2):
        draws = _iteration_draws(jloop, jrunner, act, step, ACT_P)
        seq += [(k, v if isinstance(v, tuple) else np.asarray(v))
                for k, v in draws]
        jrunner, m = jiter(jrunner)
        jmetrics.append(jax.tree.map(np.asarray, m))
    acts = [v for k, v in seq if k == "act"]
    assert all(a.shape == (B, ACT_P) for a in acts)

    runner = convert.onpolicy_runner_from_jax(loop, snapshot, _Draws(seq))
    runner, metrics = loop.train_epoch(runner, steps_per_epoch=2 * T * B)
    assert not runner.noise.seq, "draws left over"
    jr = jax.tree.map(np.asarray, jrunner)
    assert runner.total_env_steps == int(jr.total_env_steps) == 2 * T * B
    got = convert.env_state_to_numpy(runner.env_state)
    np.testing.assert_allclose(got["internal"][0], jr.env_state.internal,
                               **PIN)
    np.testing.assert_allclose(got["obs"], jr.env_state.obs, **PIN)
    np.testing.assert_array_equal(got["t"], jr.env_state.t)
    _close(convert.running_mean_std_to_numpy(runner.obs_rms),
           {k: getattr(jr.obs_rms, k) for k in ("mean", "var", "count")},
           PIN)
    _assert_state_close(runner.algo_state, jrunner.algo_state)
    want = {k: np.mean([float(m[k]) for m in jmetrics]) for k in jmetrics[0]}
    assert set(metrics) == set(want) >= {"rollout_reward_mean", "vf_loss",
                                         "pg_loss", "adv_mean_abs",
                                         "value_mean"}
    for k, v in want.items():
        np.testing.assert_allclose(metrics[k], v, err_msg=k, **PIN)


# --- the launcher -------------------------------------------------------------
def _tiny_ppo(log_dir, **extra):
    """exp_specs/ppo/ppo_pendulum.yaml cut to 2 epochs of 2 iterations, 4
    envs, T = 8, 32 x 1 nets, 50-step evaluation episodes, with obs_norm
    on."""
    with open(ROOT / "exp_specs" / "ppo" / "ppo_pendulum.yaml") as f:
        (v,) = build_variants(yaml.safe_load(f))
    v.update(net_size=32, num_hidden_layers=1, log_dir=str(log_dir),
             print_to_console=False, **extra)
    v["rl_alg_params"].update(num_epochs=2, num_steps_per_epoch=64,
                              max_path_length=50)
    v["ppo_params"].update(rollout_length=8, update_epoch=2,
                           mini_batch_size=16)
    v["env_specs"].update(env_num=4, obs_norm=True)
    return v


def test_run_ppo_trains_logs_and_snapshots(tmp_path):
    """2 epochs through `EXPERIMENTS["ppo"]`: progress.csv's keys and
    TotalEnvSteps, every value finite, the configuration the spec names,
    and a 'last' snapshot that restores into a fresh runner bit for bit."""
    variant = _tiny_ppo(tmp_path / "a")
    runner = pexp.EXPERIMENTS["ppo"](variant, device="cpu")
    with open(tmp_path / "a" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2
    for key in ("trainer/vf_loss", "trainer/pg_loss", "trainer/adv_mean_abs",
                "trainer/value_mean", "trainer/rollout_reward_mean",
                "AverageReturn", "StdReturn", "AvgPathLength",
                "TotalEnvSteps", "TrainTime", "EvalTime", "EnvStepsPerSec"):
        assert key in rows[0], key
    assert [float(r["TotalEnvSteps"]) for r in rows] == [64.0, 128.0]
    assert all(math.isfinite(float(x)) for r in rows for x in r.values())
    assert float(runner.obs_rms.count) == pytest.approx(1e-4 + 128)
    assert runner.algo_state.policy_opt.count == 2 * 2 * 2 * 2

    ppo = PPO(3, 1, PPOConfig(), net_size=32, num_hidden_layers=1,
              device="cpu")
    loop = OnPolicyLoop(make_vec("pendulum", 4, device="cpu"), ppo,
                        OnPolicyConfig(rollout_length=8, normalize_obs=True))
    fresh = loop.init(5)
    restore_checkpoint(str(tmp_path / "a" / "checkpoints" / "last"), fresh)
    assert not tree_diff(to_tree(runner), to_tree(fresh))


def test_run_ppo_reads_the_spec_as_the_jax_launcher(tmp_path, monkeypatch):
    """The PPO and loop configurations `run_ppo` builds from
    ppo_hopper.yaml, field by field against the JAX launcher's."""
    import ilswiss_tpu.runtime.onpolicy as jon
    import ilswiss_tpu_torch.runtime.onpolicy as pon
    from ilswiss_tpu.launchers import experiments as jexp

    with open(ROOT / "exp_specs" / "ppo" / "ppo_hopper.yaml") as f:
        (v,) = build_variants(yaml.safe_load(f))
    seen = {}

    class Stop(Exception):
        pass

    for name, module in (("jax", jon), ("port", pon)):
        def init(self, *args, _name=name, **kwargs):
            seen[_name] = self
            raise Stop
        monkeypatch.setattr(module.OnPolicyLoop, "init", init)
    for module, kw in ((jexp, {}), (pexp, {"device": "cpu"})):
        with pytest.raises(Stop):
            module.run_ppo(dict(v, log_dir=str(tmp_path / module.__name__),
                                print_to_console=False), **kw)
    jl, pl = seen["jax"], seen["port"]
    assert dataclasses.asdict(pl.config) == dataclasses.asdict(jl.config)
    assert dataclasses.asdict(pl.algo.config) == \
        dataclasses.asdict(jl.algo.config)
    assert pl.algo.hidden == (256, 256)
    assert pl.config.normalize_obs and pl.config.rollout_length == 128
    assert pl.vec_env.num_envs == jl.vec_env.num_envs == 16


def test_run_ppo_refuses_load_params(tmp_path):
    v = _tiny_ppo(tmp_path / "r", load_params=str(tmp_path / "a"))
    with pytest.raises(ValueError, match="PPO has no resume"):
        pexp.run_ppo(v, device="cpu")
