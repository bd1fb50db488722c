"""The last stand-alone pieces of the port against the JAX package's:
N seeds in one process (launchers/experiments.py::run_sac_vmapped_seeds,
runtime/seeds.py), logging/vistools.py, utils/eval_util.py,
`run_render_policy`, models/discriminators.py::ResNetAIRLDisc and
models/rnn_discriminators.py::CNNDisc, the twins of
tests/test_misc_components.py (the engine's stand-alone functions are
tests/test_torch_engine_standalone.py's).

Inputs come from numpy seeds; JAX states cross by utils/convert.py, and
every draw of the JAX seed-vmapped run is rebuilt from its keys and
replayed to the port's seeds in the port's order (`_Draws`).  Sizes:
pendulum, 2 seeds of 4 envs, 32 x 2 nets, K = 2 at batch 16, 5-step
episodes.  Pins:
  - the seeds' runs: metrics and evaluations rtol 2e-4, atol 2e-5, states
    rtol 2e-4, atol 2e-5 (tests/test_torch_offpolicy_trainers.py's loop
    pins); seeds_summary.csv to its 2 rounded places; a seed against its
    one-seed run of the port: bit for bit;
  - vistools: the decoded images and video frames exactly; eval_util:
    exactly;
  - the discriminators: float32 logits rtol 1e-5, atol 1e-6, BatchNorm's
    running averages the same (tests/test_torch_adv_irl.py's forward pin).
"""

import csv
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ilswiss_tpu.algorithms.sac import SAC as JSAC
from ilswiss_tpu.algorithms.sac import SACConfig as JSACConfig
from ilswiss_tpu.envs import make_vec as jmake_vec
from ilswiss_tpu.launchers import experiments as jexp
from ilswiss_tpu.logging import vistools as jvis
from ilswiss_tpu.models import discriminators as jdisc
from ilswiss_tpu.models import rnn_discriminators as jrnn
from ilswiss_tpu.runtime.loop import OffPolicyConfig as JLoopConfig
from ilswiss_tpu.runtime.loop import OffPolicyLoop as JLoop
from ilswiss_tpu.utils import eval_util as jeval
from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.envs import make_vec
from ilswiss_tpu_torch.launchers import experiments as pexp
from ilswiss_tpu_torch.launchers.variant import build_variants
from ilswiss_tpu_torch.logging import vistools
from ilswiss_tpu_torch.models.discriminators import ResNetAIRLDisc
from ilswiss_tpu_torch.models.rnn_discriminators import CNNDisc
from ilswiss_tpu_torch.runtime import seeds as pseeds
from ilswiss_tpu_torch.runtime.checkpoint import save_checkpoint
from ilswiss_tpu_torch.runtime.loop import (
    Noise, OffPolicyConfig, OffPolicyLoop,
)
from ilswiss_tpu_torch.utils import convert, eval_util

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PIN = dict(rtol=2e-4, atol=2e-5)
FWD = dict(rtol=1e-5, atol=1e-6)
SEEDS, NE, NET, BATCH, K, MPL = [3, 7], 4, 32, 16, 2, 5
T = torch.as_tensor


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
            return tuple(T(np.array(v)) for v in value)
        return T(np.array(value))

    def reset(self, env, n):
        return self._pop("reset")

    def state_dict(self):
        return {}

    def __getattr__(self, kind):
        if kind not in vars(Noise):
            raise AttributeError(kind)
        return lambda *args: self._pop(kind)


def _close(got, want, pin, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _close(got[k], want[k], pin, f"{path}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, pin, f"{path}/{i}")
    elif isinstance(want, int):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   err_msg=path, **pin)


# --- the JAX draws on pendulum -----------------------------------------------
def _pend_reset(k_reset):
    k1, k2 = jax.random.split(k_reset)
    return (jax.random.uniform(k1, (), minval=-jnp.pi, maxval=jnp.pi),
            jax.random.uniform(k2, (), minval=-1.0, maxval=1.0))


@jax.jit
def _initial_reset_draws(keys):
    return jax.vmap(lambda k: _pend_reset(jax.random.split(k)[0]))(keys)


@jax.jit
def _step_reset_draws(rngs):
    def one(key):
        _, carry = jax.random.split(key)
        return _pend_reset(jax.random.split(jax.random.split(carry)[1])[0])
    return jax.vmap(one)(rngs)


def _reset(draws):
    return ("reset", tuple(np.asarray(d) for d in draws))


# --- 1. N seeds in one process ------------------------------------------------
def _seeds_spec(log_dir, **rl):
    """sac_hopper_seeds.yaml on pendulum, cut: seeds 3 and 7, 4 envs a
    seed, 32 x 2, batch 16, K = 2 (4 steps between calls of 2 steps), a
    2-iteration warmup and one epoch of 2 iterations, 5-step episodes, 4
    evaluation envs a seed (num_envs, above the 2 that num_steps_per_eval
    and min_eval_episodes ask)."""
    with open(ROOT / "exp_specs" / "sac" / "sac_hopper_seeds.yaml") as f:
        (v,) = build_variants(yaml.safe_load(f))
    v.update(seeds=SEEDS, net_size=NET, log_dir=str(log_dir),
             print_to_console=False)
    v["env_specs"] = dict(v["env_specs"], env_name="pendulum", env_num=NE)
    v["rl_alg_params"] = dict(
        v["rl_alg_params"], num_epochs=1, num_steps_per_epoch=2 * NE,
        num_steps_between_train_calls=4, num_train_steps_per_train_call=2,
        num_steps_per_eval=2 * MPL, min_eval_episodes=2,
        max_path_length=MPL, min_steps_before_training=2 * NE,
        batch_size=BATCH, replay_buffer_size=64)
    v["rl_alg_params"].update(rl)
    return v


def _jax_loop(v):
    rl, p = v["rl_alg_params"], v["sac_params"]
    jvec = jmake_vec("pendulum", num_envs=NE, max_episode_steps=MPL)
    jsac = JSAC(3, 1, JSACConfig(
        discount=p["discount"], reward_scale=p["reward_scale"],
        soft_target_tau=p["soft_target_tau"], policy_lr=p["policy_lr"],
        qf_lr=p["qf_lr"]), net_size=NET, num_hidden_layers=2)
    return JLoop(jvec, jsac, JLoopConfig(
        batch_size=BATCH, replay_capacity=64,
        min_steps_before_training=rl["min_steps_before_training"],
        grad_steps_per_iter=K))


def _seed_draws(jloop, start, i, warmup_iters, train_iters):
    """Every draw of seed i's JAX warmup and training iterations, in the
    port's order: the acting draws, the reset draws (from the env keys,
    which do not depend on the actions), then per step the batch's and the
    step's."""
    jvec = jloop.vec_env
    jstep = jax.jit(lambda s: jvec.step(s, jnp.zeros((NE, 1)))[0])
    s0 = convert.stacked_slice(start, i)
    env = jax.tree.map(jnp.asarray, s0.env_state)
    rng, seq = jnp.asarray(s0.rng), []
    for it in range(warmup_iters + train_iters):
        rng, k_act = jax.random.split(rng)
        if it < warmup_iters:
            seq.append(("warmup_action", np.asarray(jax.random.uniform(
                k_act, (NE, 1), minval=-1.0, maxval=1.0))))
        else:
            seq.append(("act", np.asarray(jax.random.normal(k_act,
                                                            (NE, 1)))))
        seq.append(_reset(_step_reset_draws(env.rng)))
        env = jstep(env)
        if it >= warmup_iters:
            rng, k_steps = jax.random.split(rng)
            for key in jax.random.split(k_steps, K):
                k_samp, k_train = jax.random.split(key)
                k_next, k_new = jax.random.split(k_train)
                seq += [("replay", np.asarray(jax.random.uniform(
                            k_samp, (BATCH,)))),
                        ("train", (np.asarray(jax.random.normal(
                            k_next, (BATCH, 1))), np.asarray(
                            jax.random.normal(k_new, (BATCH, 1)))))]
    return seq


def _eval_draws(key, n_eval):
    """The reset draws of the JAX evaluator (runtime/evaluator.py) on
    n_eval pendulum envs of MPL steps from `key`."""
    jvec = jmake_vec("pendulum", num_envs=n_eval, max_episode_steps=MPL)
    jstep = jax.jit(lambda s: jvec.step(s, jnp.zeros((n_eval, 1)))[0])
    k_reset, _ = jax.random.split(key)
    env = jax.jit(jvec.reset)(k_reset)
    seq = [_reset(_initial_reset_draws(jax.random.split(k_reset, n_eval)))]
    for _ in range(MPL):
        seq.append(_reset(_step_reset_draws(env.rng)))
        env = jstep(env)
    return seq


def _progress(path):
    with open(path) as f:
        return [{k: float(x) for k, x in r.items()}
                for r in csv.DictReader(f)]


@pytest.fixture(scope="module")
def jax_seeds(tmp_path_factory):
    """The JAX launcher's seed-vmapped run of `_seeds_spec`, its initial
    runner (the launcher's `jax.vmap(loop.init)`) and every seed's draws."""
    root = tmp_path_factory.mktemp("seeds")
    v = _seeds_spec(root / "jax")
    jr = jax.tree.map(np.asarray, jexp.run_sac_vmapped_seeds(dict(v)))
    jloop = _jax_loop(v)
    start = jax.tree.map(np.asarray, jax.vmap(jloop.init)(
        jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])))
    draws = [_seed_draws(jloop, start, i, 2, 2) for i in range(len(SEEDS))]
    evals = {100_000 + s: _eval_draws(jax.random.PRNGKey(100_000 + s), NE)
             for s in SEEDS}
    return root, v, jr, start, draws, evals


def test_seeds_match_the_jax_vmapped_run(jax_seeds, monkeypatch):
    """Each seed of the port's run, from the JAX launcher's initial runner
    with every JAX draw replayed: its end state (trainer, env, ring,
    env-step count) against the JAX run's slice, its progress.csv, and
    seeds_summary.csv's header and row."""
    root, v, jr, start, draws, evals = jax_seeds
    seqs = [_Draws(d) for d in draws]

    def init(self, seeds, noises=None):
        return convert.seeds_runner_from_jax(self, start, seqs)

    monkeypatch.setattr(pseeds.SeedsOffPolicyLoop, "init", init)
    monkeypatch.setattr(pexp, "Noise",
                        lambda seed, device: _Draws(evals[seed]))
    runner = pexp.run_sac_vmapped_seeds(dict(v, log_dir=str(root / "port")),
                                        device="cpu")
    assert all(not d.seq for d in seqs)
    for i, (r, s) in enumerate(zip(runner.runners, SEEDS)):
        want = convert.stacked_slice(jr, i)
        assert r.total_env_steps == int(want.total_env_steps) == 4 * NE
        js = want.algo_state
        opt = lambda o: {"count": int(o[0].count), "mu": o[0].mu,  # noqa
                         "nu": o[0].nu}
        _close(convert.sac_state_to_numpy(r.algo_state), {
            "policy_params": js.policy_params, "qf_params": js.qf_params,
            "target_qf_params": js.target_qf_params,
            "log_alpha": js.log_alpha, "policy_opt": opt(js.policy_opt),
            "qf_opt": opt(js.qf_opt), "alpha_opt": opt(js.alpha_opt)},
            PIN, f"seed {s}")
        _close(convert.env_state_to_numpy(r.env_state)["obs"],
               want.env_state.obs, PIN)
        ring = convert.replay_to_numpy(r.replay)
        for k, x in want.replay.data.items():
            _close(ring["data"][k], x, PIN, k)
        got = _progress(root / "port" / f"seed_{s}_id0" / "progress.csv")
        ref = _progress(root / "jax" / f"seed_{s}_id0" / "progress.csv")
        assert set(got[0]) == set(ref[0])
        keys = set(ref[0]) - {"TrainTime", "EvalTime", "WallTime"}
        _close({k: got[0][k] for k in keys}, {k: ref[0][k] for k in keys},
               PIN)
        assert (root / "port" / f"seed_{s}_id0" / "variant.json").exists()
    with open(root / "port" / "seeds_summary.csv") as f:
        got = list(csv.reader(f))
    with open(root / "jax" / "seeds_summary.csv") as f:
        ref = list(csv.reader(f))
    assert got[0] == ref[0] == ["Epoch", "TotalEnvSteps", "MeanAverageReturn",
                                "StdAverageReturn", "Return_seed3",
                                "Return_seed7"]
    assert len(got) == len(ref) == 2 and got[1][:2] == ref[1][:2]
    np.testing.assert_allclose([float(x) for x in got[1][2:]],
                               [float(x) for x in ref[1][2:]], rtol=0,
                               atol=0.0100001)


def _one_seed(v, s, **kw):
    """The port's one-seed run of seed s of `v` through `OffPolicyLoop`
    (the warmup and one epoch of `run_sac_vmapped_seeds`)."""
    rl = v["rl_alg_params"]
    vec = make_vec("pendulum", NE, device="cpu", max_episode_steps=MPL)
    sac = SAC(3, 1, SACConfig(), net_size=NET, device="cpu", **kw)
    loop = OffPolicyLoop(vec, sac, OffPolicyConfig(
        batch_size=BATCH, replay_capacity=64,
        min_steps_before_training=rl["min_steps_before_training"],
        grad_steps_per_iter=K))
    runner = loop.warmup(loop.init(s))
    return loop.train_epoch(runner, rl["num_steps_per_epoch"])


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_each_seed_is_its_one_seed_run(tmp_path, capsys, fused):
    """Every seed's trainer state, env state, ring and metrics equal the
    port's one-seed run of that seed bit for bit (the envs' rows are
    independent and each seed draws from its own noise in the one-seed
    order), eagerly and with `use_fused_chain` (one K2 chain a seed an
    iteration; its plain version here); one seeds_summary.csv row an
    epoch and the JAX launcher's epoch line."""
    from ilswiss_tpu_torch.testing import tree_diff
    from ilswiss_tpu_torch.runtime.checkpoint import to_tree

    v = _seeds_spec(tmp_path / "s", num_epochs=2)
    v["sac_params"] = dict(v["sac_params"], use_fused_chain=fused)
    v["rl_alg_params"]["num_epochs"] = 1
    runner = pexp.run_sac_vmapped_seeds(v, device="cpu")
    assert "[sac_vmap_seeds] epoch 0: return" in capsys.readouterr().out
    for r, s in zip(runner.runners, SEEDS):
        alone, _ = _one_seed(v, s, use_fused_chain=fused)
        assert not tree_diff(to_tree(r), to_tree(alone))
    with open(tmp_path / "s" / "seeds_summary.csv") as f:
        assert len(list(csv.reader(f))) == 2


def test_seeds_full_resume_and_light_resume(tmp_path):
    """A full resume from the run's 'last' continues bit for bit as the
    uninterrupted 2-epoch run; a light resume (params only, 'best')
    refills every seed's ring through the warmup, where the JAX launcher
    warms up only at epoch 0 and would sample empty rings (ROADMAP.md
    section 3), and logs TotalEnvSteps by the decided convention
    (start_epoch * num_steps_per_epoch plus the steps since the new
    warmup)."""
    from ilswiss_tpu_torch.testing import tree_diff
    from ilswiss_tpu_torch.runtime.checkpoint import to_tree

    v = _seeds_spec(tmp_path / "a", num_epochs=2)
    straight = pexp.run_sac_vmapped_seeds(v, device="cpu")
    v = _seeds_spec(tmp_path / "b")
    pexp.run_sac_vmapped_seeds(v, device="cpu")
    v = _seeds_spec(tmp_path / "b", num_epochs=2)
    v["load_params"] = str(tmp_path / "b")
    resumed = pexp.run_sac_vmapped_seeds(v, device="cpu")
    assert not tree_diff(to_tree(resumed), to_tree(straight))
    rows = _progress(tmp_path / "b" / "seed_3_id0" / "progress.csv")
    assert [r["TotalEnvSteps"] for r in rows] == [4 * NE, 6 * NE]
    light = tmp_path / "light"
    save_checkpoint(str(light), {"algo_state": straight.algo_state})
    (light / "meta.json").write_text(json.dumps(
        {"epoch": 0, "best_value": -1e9, "light": True}))
    v = _seeds_spec(tmp_path / "c", num_epochs=2)
    v["load_params"] = str(light)
    resumed = pexp.run_sac_vmapped_seeds(v, device="cpu")
    for r in resumed.runners:
        assert r.replay.size == 4 * NE and r.total_env_steps == 4 * NE
    rows = _progress(tmp_path / "c" / "seed_7_id0" / "progress.csv")
    assert [r["TotalEnvSteps"] for r in rows] == [2 * NE + 4 * NE]


def test_seeds_refuse_a_host_env(tmp_path):
    v = _seeds_spec(tmp_path / "h")
    v["env_specs"] = dict(v["env_specs"], env_name="Hopper-v5")
    with pytest.raises(ValueError, match="on-device env"):
        pexp.run_sac_vmapped_seeds(v, device="cpu")
    with pytest.raises(ValueError, match="on-device env"):
        jexp.run_sac_vmapped_seeds(v)


def test_seeds_evaluator_is_each_seeds_evaluator():
    """`make_seeds_evaluator` steps the seeds' evaluation envs as one batch
    and gives each seed what `make_evaluator` gives it alone."""
    from ilswiss_tpu_torch.envs.vector import VectorEnv
    from ilswiss_tpu_torch.runtime.evaluator import make_evaluator

    vec = make_vec("pendulum", 3, device="cpu", max_episode_steps=MPL)
    sac = SAC(3, 1, SACConfig(), net_size=NET, device="cpu")
    states = [sac.init(s) for s in SEEDS]
    act = lambda s, o: sac.act(s, o, deterministic=True)  # noqa: E731
    both = pseeds.make_seeds_evaluator(VectorEnv(vec.env, 3), act, MPL, 2)(
        states, [Noise(s, "cpu") for s in SEEDS])
    alone = [make_evaluator(vec, act, MPL)(st, Noise(s, "cpu"))
             for st, s in zip(states, SEEDS)]
    assert both == alone


# --- 2. vistools and eval_util ------------------------------------------------
def _decoded(path):
    import imageio
    return np.stack([np.asarray(f) for f in imageio.mimread(path)]) \
        if path.endswith(".gif") else np.asarray(imageio.imread(path))


def test_vistools_match_jax(tmp_path):
    """`plot_learning_curves` (two runs, a file without the key skipped, a
    file without Epoch on the row index), `plot_histogram` and
    `save_video` (uint8, float in [0, 1] and one-channel frames; a gif
    where no ffmpeg backend writes mp4) against the JAX functions: the
    same paths, the same decoded pixels."""
    rng = np.random.RandomState(0)
    paths = []
    for i, text in enumerate((
            "Epoch,AverageReturn\n0,1.0\n1,2.0\n2,3.0\n",
            "Epoch,AverageReturn,x\n0,-1.0,a\n1,0.5,b\n",
            "Other\n1\n", "AverageReturn\n4.0\n5.0\n")):
        d = tmp_path / f"run{i}"
        d.mkdir()
        (d / "progress.csv").write_text(text)
        paths.append(str(d / "progress.csv"))
    for mod, name in ((vistools, "port"), (jvis, "jax")):
        out = tmp_path / name
        out.mkdir()
        assert mod.plot_learning_curves(
            paths, "AverageReturn", save_path=str(out / "c.png"),
            title="t") == str(out / "c.png")
        mod.plot_learning_curves(paths[:2], "AverageReturn",
                                 labels=["a", "b"],
                                 save_path=str(out / "l.png"))
    values = rng.randn(200)
    for mod, name in ((vistools, "port"), (jvis, "jax")):
        mod.plot_histogram(values, str(tmp_path / name / "h.png"),
                           title="returns")
    for f in ("c.png", "l.png", "h.png"):
        np.testing.assert_array_equal(_decoded(str(tmp_path / "port" / f)),
                                      _decoded(str(tmp_path / "jax" / f)))
    assert os.path.getsize(tmp_path / "port" / "c.png") > 1000
    frames = {"u8": rng.randint(0, 256, (4, 16, 16, 3)).astype(np.uint8),
              "float": rng.uniform(-0.2, 1.2, (3, 16, 16, 3)),
              "gray": rng.uniform(0, 1, (3, 16, 16, 1)).astype(np.float32)}
    for kind, fr in frames.items():
        got = vistools.save_video(fr, str(tmp_path / "port" / f"{kind}.mp4"),
                                  fps=10)
        want = jvis.save_video(fr, str(tmp_path / "jax" / f"{kind}.mp4"),
                               fps=10)
        assert Path(got).name == Path(want).name
        np.testing.assert_array_equal(_decoded(got), _decoded(want))


def test_eval_util_matches_jax():
    rng = np.random.RandomState(1)
    returns, lengths = rng.randn(7) * 10, rng.randint(1, 100, 7)
    success = rng.rand(7) < 0.5
    for args, kw in (((returns, lengths), {}),
                     ((returns, lengths, success), {"prefix": "Test "}),
                     ((returns[:1], lengths[:1]), {})):
        assert eval_util.get_path_information(*args, **kw) == \
            jeval.get_path_information(*args, **kw)
    for data in (returns, [], [3]):
        assert eval_util.create_stats_ordered_dict("Q", data) == \
            jeval.create_stats_ordered_dict("Q", data)


# --- 3. render_policy -----------------------------------------------------------
def test_render_policy_on_gymnasium_hopper(tmp_path):
    """render_hopper.yaml on the CPU from a port SAC snapshot, 2 rollouts
    of 3 steps: a video of 4 frames each (a gif where no ffmpeg backend
    writes mp4) and Return_<r> equal to the returns of the same
    deterministic actions on gymnasium's Hopper-v5, each rollout reset
    with seed + r."""
    gymnasium = pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    os.environ.setdefault("MUJOCO_GL", "egl")
    sac = SAC(11, 3, SACConfig(), net_size=NET, num_hidden_layers=2,
              device="cpu")
    state = sac.init(5)
    save_checkpoint(str(tmp_path / "best"), {"algo_state": state})
    with open(ROOT / "exp_specs" / "render" / "render_hopper.yaml") as f:
        (v,) = build_variants(yaml.safe_load(f))
    v.update(policy_checkpoint=str(tmp_path / "best"), policy_net_size=NET,
             max_path_length=3, log_dir=str(tmp_path / "r"),
             print_to_console=False, seed=4)
    try:
        pexp.run_render_policy(v, device="cpu")
    except Exception as e:          # no GL stack renders here
        if "render" not in repr(e).lower() and "gl" not in repr(e).lower():
            raise
        pytest.skip(f"gymnasium rendering unavailable: {e}")
    env = gymnasium.make("Hopper-v5")
    want = []
    for r in range(2):
        obs, _ = env.reset(seed=4 + r)
        ret = 0.0
        for _ in range(3):
            a = sac.act(state, T(np.asarray(obs, np.float32))[None],
                        deterministic=True)[0].numpy()
            obs, rew, *_ = env.step(a)
            ret += float(rew)
        want.append(ret)
    row = _progress(tmp_path / "r" / "progress.csv")[0]
    np.testing.assert_allclose([row["Return_0"], row["Return_1"]], want,
                               rtol=1e-6)
    for r in range(2):
        (out,) = [p for p in os.listdir(tmp_path / "r")
                  if p.startswith(f"rollout_{r}.")]
        frames = _decoded(str(tmp_path / "r" / out))
        assert frames.shape[0] == 4 and frames.ndim == 4
        assert frames.std() > 0


# --- 4. the discriminators ------------------------------------------------------
def _randomize(variables, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.randn(*np.shape(x))).astype(
            np.float32), variables)


@pytest.mark.parametrize("use_bn", [False, True], ids=["plain", "bn"])
def test_resnet_airl_disc_matches_jax(use_bn):
    """`ResNetAIRLDisc` from converted (perturbed) parameters: logits in
    eval and train mode, clamped at +-0.5 here, and, with BatchNorm, the
    running averages after one train-mode forward's statistics."""
    x = np.random.RandomState(2).randn(16, 7).astype(np.float32) * 2
    jd = jdisc.ResNetAIRLDisc(num_layer_blocks=2, hid_dim=24,
                              use_bn=use_bn, clamp_magnitude=0.5)
    # perturbed by 0.05: the BatchNorms' batch variance E[x^2] - E[x]^2
    # (flax's) cancels where a residual sum's mean outgrows its spread, and
    # two summation orders then part by more than the pin
    variables = _randomize(jd.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                           1, scale=0.05)
    if use_bn:
        variables["batch_stats"] = jax.tree.map(
            np.abs, variables["batch_stats"])
    disc = ResNetAIRLDisc(7, torch.Generator().manual_seed(0),
                          num_layer_blocks=2, hid_dim=24, use_bn=use_bn,
                          clamp_magnitude=0.5)
    convert.resnet_disc_from_jax(disc, variables)
    _close(convert.resnet_disc_to_numpy(disc), variables, dict(rtol=0,
                                                               atol=0))
    for train in (False, True):     # eval first: train mode moves them
        if use_bn and train:
            want, upd = jd.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        else:
            want = jd.apply(variables, jnp.asarray(x), train=train)
        stats = []
        got = disc(T(x), train=train, stats=stats)
        _close(got.detach().numpy(), np.asarray(want), FWD)
        assert float(got.abs().max()) <= 0.5
        if use_bn and train:
            disc.update_batch_stats(stats)
            _close(convert.resnet_disc_to_numpy(disc)["batch_stats"],
                   jax.tree.map(np.asarray, upd["batch_stats"]), FWD)
    assert (np.abs(np.asarray(want)) == 0.5).any()


def test_image_cnn_disc_matches_jax():
    """rnn_discriminators.py's 3-conv `CNNDisc` from converted parameters
    on float frames and on uint8 frames (divided by 255 by the batch's
    max), the JAX module's defaults (32 filters, 3 convs, 128 wide)."""
    rng = np.random.RandomState(3)
    frames = rng.uniform(0, 1, (4, 20, 20, 9)).astype(np.float32)
    u8 = rng.randint(0, 256, (4, 20, 20, 9)).astype(np.uint8)
    jd = jrnn.CNNDisc()
    variables = _randomize(jd.init(jax.random.PRNGKey(0),
                                   jnp.asarray(frames)), 4)
    disc = CNNDisc((20, 20, 9), torch.Generator().manual_seed(0))
    convert.image_disc_from_jax(disc, variables)
    _close(convert.image_disc_to_numpy(disc), variables, dict(rtol=0,
                                                              atol=0))
    for x in (frames, u8):
        _close(disc(T(x)).detach().numpy(),
               np.asarray(jd.apply(variables, jnp.asarray(x))), FWD)
    assert disc(T(frames)).shape == (4, 1)
    jdefault = jrnn.CNNDisc()
    shapes = jax.tree.map(np.shape, jdefault.init(jax.random.PRNGKey(1),
                                                  jnp.asarray(frames)))
    assert jax.tree.map(np.shape, convert.image_disc_to_numpy(
        CNNDisc((20, 20, 9), torch.Generator().manual_seed(1)))) == shapes
