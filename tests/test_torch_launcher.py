"""The YAML launcher (ilswiss_tpu_torch/launchers/, logging/, utils/guards.py,
utils/profiling.py and run_experiment.py) against the JAX package's:
variant grids on every file under exp_specs/, byte-equal logger output,
the schedule and evaluator rules on every exp_specs/sac/ spec and on the
td3, dqn and discrete-SAC specs, the guards and phase timer, routing, and
`run_sac` end to end on pendulum on the CPU (tests/test_harness.py:139-172's
tiny spec): progress.csv, snapshots, a full resume that continues the run
bit for bit, a light resume, policy evaluation from the best snapshot, and
the CLI in a process without JAX; `run_td3` on pendulum and `run_dqn` on
cartpole end to end with a full resume; the configurations the launchers
build from the specs, with the two readings where the port repairs the
JAX launcher.
"""

import copy
import csv
import dataclasses
import glob
import json
import math
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from ilswiss_tpu.launchers import experiments as jexp
from ilswiss_tpu.launchers import variant as jvariant
from ilswiss_tpu.logging.logger import Logger as JLogger
from ilswiss_tpu.utils.profiling import PhaseTimer as JPhaseTimer
from ilswiss_tpu_torch.launchers import experiments as pexp
from ilswiss_tpu_torch.launchers import variant as pvariant
from ilswiss_tpu_torch.logging.logger import Logger
from ilswiss_tpu_torch.ops import fused_sac
from ilswiss_tpu_torch.runtime.checkpoint import to_tree
from ilswiss_tpu_torch.testing import tree_diff
from ilswiss_tpu_torch.utils.guards import (
    NonFiniteMetricError, PreemptionGuard, check_finite_metrics,
)
from ilswiss_tpu_torch.utils.profiling import PhaseTimer, trace

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPECS = sorted(glob.glob(str(ROOT / "exp_specs" / "**" / "*.yaml"),
                         recursive=True))
SAC_SPECS = sorted(glob.glob(str(ROOT / "exp_specs" / "sac" / "*.yaml")))
EVAL_KEYS = ["AverageReturn", "MaxReturn", "MinReturn", "StdReturn",
             "AvgPathLength"]
# the columns of a JAX `_run_off_policy` epoch row (experiments.py:439-448)
# and the two the logger adds
COLUMNS = ([f"trainer/{k}" for k in fused_sac.METRIC_NAMES] + EVAL_KEYS
           + ["TotalEnvSteps", "TrainTime", "EvalTime", "EnvStepsPerSec",
              "Epoch", "WallTime"])
# wall clocks: the only columns in which a resumed run may differ
CLOCKS = {"TrainTime", "EvalTime", "EnvStepsPerSec", "WallTime"}


def _load(path):
    with open(path) as f:
        return yaml.safe_load(f)


# --- variants ---------------------------------------------------------------
def test_build_variants_match_jax_on_every_spec():
    assert len(SPECS) == 92
    for path in SPECS:
        spec = _load(path)
        assert pvariant.build_variants(spec) == jvariant.build_variants(
            spec), path
        flat = pvariant.flatten_dict(spec)
        assert flat == jvariant.flatten_dict(spec), path
        assert pvariant.unflatten_dict(flat) == jvariant.unflatten_dict(
            flat), path


def test_build_variants_grid_matches_jax():
    spec = {
        "meta_data": {"algorithm": "sac"},
        "variables": {"seed": [0, 1, 2],
                      "sac_params": {"qf_lr": [1e-3, 3e-4]}},
        "constants": {"net_size": 64, "sac_params": {"discount": 0.99}},
    }
    variants = pvariant.build_variants(spec)
    assert variants == jvariant.build_variants(spec) and len(variants) == 6


@pytest.mark.parametrize("spec", [
    {"constants": {}},
    {"meta_data": {}, "variables": {"seed": 3}},
    {"meta_data": {}, "variables": {"a": {"b": "x"}}},
    {"meta_data": {}, "bogus": {}},
])
def test_spec_format_validation_matches_jax(spec):
    with pytest.raises(ValueError):
        jvariant.check_exp_spec_format(spec)
    with pytest.raises(ValueError):
        pvariant.check_exp_spec_format(spec)


# --- logger -----------------------------------------------------------------
def test_logger_output_is_byte_equal_to_jax(tmp_path):
    variant = _load(ROOT / "exp_specs" / "sac" / "sac_hopper_optable.yaml")
    outputs = []
    for cls, d in ((JLogger, tmp_path / "jax"), (Logger, tmp_path / "port")):
        lg = cls(str(d), print_to_console=False)
        lg.save_variant(variant)
        lg.record_dict({"a": 1.0, "b": np.float32(2.5)}, prefix="t/")
        lg.record_tabular("WallTime", 0.5)
        lg.dump_tabular(0)
        lg.record_tabular("t/a", 2)
        lg.record_tabular("late", 3.25)          # a late-appearing key
        lg.record_tabular("WallTime", 1.5)
        lg.dump_tabular(1)
        lg.record_dict({"late": 4.0, "later": "x", "WallTime": 2.0})
        lg.dump_tabular(2)
        lg.close()
        outputs.append([(d / n).read_bytes()
                        for n in ("progress.csv", "variant.json")])
    assert outputs[0] == outputs[1]
    with open(tmp_path / "port" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["late"] for r in rows] == ["", "3.25", "4.0"]


# --- schedule, guards, timer ------------------------------------------------
def test_grad_steps_and_eval_envs_match_jax_on_sac_specs():
    assert len(SAC_SPECS) == 22
    for path in SAC_SPECS:
        for v in pvariant.build_variants(_load(path)):
            rl = dict(v.get("rl_alg_params") or {})
            n = int(v["env_specs"].get("env_num", 1))
            assert pexp._grad_steps_per_iter(rl, n) == \
                jexp._grad_steps_per_iter(rl, n), path
            # the JAX evaluator rule, experiments.py:362-367
            mpl = int(rl.get("max_path_length", 1000))
            assert pexp._num_eval_envs(rl) == max(
                int(rl.get("num_steps_per_eval", 10_000)) // mpl,
                int(rl.get("min_eval_episodes", 32))), path
    rl = _load(ROOT / "exp_specs/sac/sac_hopper_optable.yaml")[
        "constants"]["rl_alg_params"]
    assert pexp._grad_steps_per_iter(rl, 8) == 8
    assert pexp._num_eval_envs(rl) == 32


def test_nan_guard_and_preemption_flag():
    msgs = []
    assert check_finite_metrics({"a": 1.0}, 0, msgs.append)
    assert not check_finite_metrics({"a": float("nan")}, 1, msgs.append)
    assert "NON-FINITE" in msgs[0]
    with pytest.raises(NonFiniteMetricError):
        check_finite_metrics({"q": np.inf}, 2, msgs.append, abort=True)

    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    assert not guard.should_stop
    os.kill(os.getpid(), signal.SIGUSR1)
    assert guard.should_stop
    guard.restore()


def test_phase_timer_stamp_keys_match_jax_and_trace_writes_on_cpu(tmp_path):
    stamps = []
    for timer in (JPhaseTimer(), PhaseTimer()):
        for name in ("train", "eval", "train"):
            with timer.phase(name):
                pass
        stamps.append(timer.stamp())
    assert sorted(stamps[0]) == sorted(stamps[1]) == [
        "Time/eval", "Time/total", "Time/train"]
    timer = PhaseTimer()
    with trace(str(tmp_path / "prof")), timer.phase("train"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "train" in names
    with trace(None):                   # no directory: no trace
        pass


# --- routing ----------------------------------------------------------------
def _variant(tmp_path, env="pendulum", **extra):
    v = {"seed": 0, "log_dir": str(tmp_path / "run"),
         "print_to_console": False,
         "env_specs": {"env_name": env, "env_num": 2}}
    v.update(extra)
    return v


def test_routing_raises_naming_the_roadmap_item(tmp_path):
    run = pexp.run_sac
    # the host env paths are ported: one spec of each kind through
    # `_route_host`, as the JAX launcher routes it (the device registry
    # first, then force_host, the reference names and gymnasium ids)
    for name, extra, host in (("hopper", {}, False),
                              ("hopper", {"force_host": True}, True),
                              ("lunarlandercont", {}, True),
                              ("fetch-reach", {}, True),
                              ("Hopper-v5", {}, True),
                              ("reach2d", {}, False)):
        v = _variant(tmp_path, env_specs={"env_name": name, **extra})
        assert pexp._route_host(v, name) is host, name
        assert jexp._route_host(v, name) is host, name
    # a launcher the JAX package never routes builds a device env, which
    # has no host name
    with pytest.raises(KeyError, match="Unknown env"):
        pexp.run_sac_v(_variant(tmp_path, "lunarlandercont"), device="cpu")
    # `env_name: dmc` takes the DMC pixel branches, which render on the
    # host: SAC-AE, RAD and CURL reach `_run_host_sac_ae`, gen_expert
    # builds the DMC env (envs/host_dmc.py)
    class Reached(Exception):
        pass

    def reached(*args, **kwargs):
        raise Reached(args[1:5] if len(args) > 4 else args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pexp, "_run_host_sac_ae", reached)
        mp.setattr(pexp, "_dmc_env", reached)
        for name in ("sac_ae", "sac_rad", "sac_curl", "gen_expert"):
            with pytest.raises(Reached):
                pexp.EXPERIMENTS[name](_variant(tmp_path, "dmc"),
                                       device="cpu")
    with pytest.raises(ValueError, match="unknown env"):
        run(_variant(tmp_path, "no_such_env"), device="cpu")
    # every JAX experiment name reaches a runner of the port's launcher
    # module, item 2.10's names among them; none of them is a stub
    assert set(pexp.EXPERIMENTS) == set(jexp.EXPERIMENTS)
    assert pexp.EXPERIMENTS["render_policy"] is pexp.run_render_policy
    assert pexp.EXPERIMENTS["sac_vmap_seeds"] is pexp.run_sac_vmapped_seeds
    for name, fn in pexp.EXPERIMENTS.items():
        assert getattr(pexp, fn.__name__) is fn, name
    import inspect
    assert "NotImplementedError" not in inspect.getsource(pexp)
    with pytest.raises(ValueError, match="on-device env"):
        pexp.EXPERIMENTS["sac_vmap_seeds"](_variant(tmp_path, "Hopper-v5"),
                                           device="cpu")
    if not torch.cuda.is_available():      # the default device is the GPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(_variant(tmp_path))


def test_run_sac_ae_refuses_load_params(tmp_path):
    """The JAX device branch of `run_sac_ae` (experiments.py:1409-1516)
    never reads `load_params`, so a resume there silently starts afresh
    and overwrites the run's snapshots (ROADMAP.md section 3); the port
    raises ValueError before any work, for each of the three names."""
    for name in ("sac_ae", "sac_rad", "sac_curl"):
        v = _variant(tmp_path, "pendulum_pixels",
                     load_params=str(tmp_path / "run"))
        with pytest.raises(ValueError, match="has no resume"):
            pexp.EXPERIMENTS[name](v, device="cpu")
    assert not (tmp_path / "run").exists()


# --- run_sac end to end on pendulum -----------------------------------------
def _tiny(log_dir, num_epochs=2, fused=False, **rl):
    """tests/test_harness.py:139-172's spec (4 envs, 32 x 1 nets)."""
    spec = {
        "meta_data": {"algorithm": "sac", "exp_name": "t"},
        "variables": {"seed": [0]},
        "constants": {
            "net_size": 32, "num_hidden_layers": 1,
            "log_dir": str(log_dir),
            "print_to_console": False,
            "rl_alg_params": {
                "num_epochs": num_epochs, "num_steps_per_epoch": 64,
                "num_steps_between_train_calls": 8,
                "num_train_steps_per_train_call": 8,
                "max_path_length": 100,
                "min_steps_before_training": 32,
                "batch_size": 32, "replay_buffer_size": 1024,
                "freq_saving": 1, **rl,
            },
            "sac_params": {"reward_scale": 2.0, "use_fused_chain": fused},
            "env_specs": {"env_name": "pendulum", "env_num": 4},
        },
    }
    return pvariant.build_variants(spec)[0]


def _rows(log_dir):
    with open(Path(log_dir) / "progress.csv") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module", params=[False, True], ids=["eager", "fused"])
def runs(request, tmp_path_factory):
    """A: 2 epochs straight through; B: 1 epoch, then a full resume from
    its log_dir to 2 epochs in the same log_dir."""
    root = tmp_path_factory.mktemp("runs")
    fused = request.param
    a = pexp.run_sac(_tiny(root / "a", fused=fused), device="cpu")
    b1 = pexp.run_sac(_tiny(root / "b", num_epochs=1, fused=fused),
                      device="cpu")
    b1_tree = to_tree(b1)
    shutil.copytree(root / "b", root / "b_after_1")
    b2 = pexp.run_sac(dict(_tiny(root / "b", fused=fused),
                           load_params=str(root / "b")), device="cpu")
    return dict(root=root, fused=fused, a=a, b1_tree=b1_tree, b2=b2)


def test_run_sac_pendulum_end_to_end(runs):
    log_dir = runs["root"] / "a"
    rows = _rows(log_dir)
    assert len(rows) == 2 and list(rows[0]) == COLUMNS
    assert [float(r["TotalEnvSteps"]) for r in rows] == [96.0, 160.0]
    for r in rows:
        assert all(math.isfinite(float(v)) for v in r.values())
        assert float(r["AvgPathLength"]) == 100.0
    assert sorted(os.listdir(log_dir / "checkpoints")) == [
        "best", "last", "meta.json"]
    with open(log_dir / "variant.json") as f:
        assert json.load(f) == _tiny(log_dir, fused=runs["fused"])
    with open(log_dir / "checkpoints" / "meta.json") as f:
        meta = json.load(f)
    assert meta["epoch"] == 1 and meta["light"] is False
    assert meta["best_value"] == max(float(r["AverageReturn"]) for r in rows)
    policy = runs["a"].algo_state.policy_opt
    assert policy.count == 2 * 16 * 4       # 2 epochs x 16 iters x K = 4


def test_full_resume_continues_the_run_bit_for_bit(runs):
    """The resumed runner equals the uninterrupted one in every tensor and
    count (parameters, targets, moments, log alpha, ring, env state, step
    count, noise generator), and so does its epoch-1 row of progress.csv
    in every column but the wall clocks."""
    want = to_tree(runs["a"])
    got = to_tree(runs["b2"])
    assert want["algo_state"]["policy_opt"]["count"] == 128
    assert got["total_env_steps"] == want["total_env_steps"] == 160

    assert tree_diff(want, got) == []
    a_rows, b_rows = _rows(runs["root"] / "a"), _rows(runs["root"] / "b")
    assert len(b_rows) == 2
    for a_row, b_row in zip(a_rows, b_rows):
        assert {k: v for k, v in a_row.items() if k not in CLOCKS} == {
            k: v for k, v in b_row.items() if k not in CLOCKS}
    # the 1-epoch run's end state is what the resume started from
    assert runs["b1_tree"]["total_env_steps"] == 96


def test_light_resume_reruns_warmup_and_offsets_total_env_steps(runs,
                                                                tmp_path):
    """A light snapshot ('last' holds the algo state only) resumes the
    parameters, refills the ring through a second warmup, and logs
    TotalEnvSteps = start_epoch * num_steps_per_epoch + the runner's count
    (the JAX device path's convention, experiments.py:404-405)."""
    log_dir, fused = tmp_path / "light", runs["fused"]
    pexp.run_sac(_tiny(log_dir, num_epochs=1, fused=fused,
                       light_snapshots=True), device="cpu")
    with open(log_dir / "checkpoints" / "meta.json") as f:
        assert json.load(f)["light"] is True
    runner = pexp.run_sac(dict(_tiny(log_dir, fused=fused,
                                     light_snapshots=True),
                               load_params=str(log_dir)), device="cpu")
    rows = _rows(log_dir)
    assert [int(r["Epoch"]) for r in rows] == [0, 1]
    # 64 resumed + 32 of the second warmup + 64 of epoch 1
    assert runner.total_env_steps == 96 and runner.replay.size == 96
    assert float(rows[1]["TotalEnvSteps"]) == 64 + 96
    log = (log_dir / "debug.log").read_text()
    assert log.count("warmup done") == 2 and "light-resumed" in log
    # the policy continued from the snapshot: 16 + 16 iterations of K = 4
    assert runner.algo_state.policy_opt.count == 128


def test_fault_best_value_is_restored_on_resume(runs, tmp_path):
    """Reference fault 1: the JAX `SnapshotManager` starts every run at
    best_value = -inf and `_run_off_policy` never restores it
    (checkpoint.py:125, :161), so the first epoch after a resume overwrites
    the 'best' snapshot however bad it is.  The port seeds best_value from
    `resume_point`: the larger of meta.json's and the 'best' snapshot's.
    Here meta.json holds -inf, what a 'last' saved at a new best holds
    when the run dies before its end-of-run flush, and the 'best' snapshot
    a value the resumed epoch cannot beat."""
    from ilswiss_tpu.runtime.checkpoint import SnapshotManager as JSnap
    log_dir = tmp_path / "b"
    shutil.copytree(runs["root"] / "b_after_1", log_dir)
    ckpt = log_dir / "checkpoints"
    for path, value in ((ckpt / "meta.json", -math.inf),
                        (ckpt / "best" / "meta.json", 1e9)):
        meta = json.loads(path.read_text())
        meta["best_value"] = value
        path.write_text(json.dumps(meta))
    assert JSnap(str(tmp_path / "j")).best_value == -math.inf
    pexp.run_sac(dict(_tiny(log_dir, fused=runs["fused"]),
                      load_params=str(log_dir)), device="cpu")
    best = json.loads((ckpt / "best" / "meta.json").read_text())
    assert best["epoch"] == 0 and best["best_value"] == 1e9
    assert json.loads((ckpt / "meta.json").read_text())["best_value"] == 1e9


def test_run_eval_policy_from_the_best_snapshot(runs, tmp_path):
    variant = {
        "seed": 0,
        "policy_checkpoint": str(runs["root"] / "a" / "checkpoints" / "best"),
        "policy_net_size": 32, "policy_num_hidden_layers": 1,
        "max_path_length": 50,
        "log_dir": str(tmp_path / "eval"), "print_to_console": False,
        "env_specs": {"env_name": "pendulum", "env_num": 4},
    }
    stats = pexp.run_eval_policy(variant, device="cpu")
    assert set(stats) == set(EVAL_KEYS)
    assert stats["AvgPathLength"] == 50.0
    assert all(math.isfinite(v) for v in stats.values())
    again = pexp.run_eval_policy(dict(variant, eval_deterministic=False,
                                      log_dir=str(tmp_path / "e2")),
                                 device="cpu")
    assert again["AverageReturn"] != stats["AverageReturn"]
    # save_samples: num_eval_steps // env_num steps of every env as demos
    pexp.run_eval_policy(dict(variant, save_samples=True, num_eval_steps=40,
                              log_dir=str(tmp_path / "e3")), device="cpu")
    samples = np.load(tmp_path / "e3" / "eval_samples.npz")
    assert samples["obs"].shape == (40, 3)


def test_cli_runs_a_spec_in_a_process_without_jax(tmp_path):
    spec = {"meta_data": {"algorithm": "sac", "exp_name": "t"},
            "variables": {"seed": [0]},
            "constants": {k: v for k, v in _tiny(tmp_path / "cli").items()
                          if k not in ("exp_id",)}}
    spec["constants"]["rl_alg_params"]["num_epochs"] = 1
    path = tmp_path / "spec.yaml"
    path.write_text(yaml.safe_dump(spec))
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['run_experiment', '-e', {str(path)!r}, "
        "'--device', 'cpu', '-g', '3']\n"
        "runpy.run_module('ilswiss_tpu_torch.run_experiment', "
        "run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ilswiss_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
    assert len(_rows(tmp_path / "cli")) == 1


# --- the other off-policy trainers ---------------------------------------
OFF_POLICY_SPECS = {
    "td3": ["exp_specs/td3/td3_hopper.yaml",
            "exp_specs/td3/td3_humanoid.yaml"],
    "dqn": ["exp_specs/dqn/dqn_cartpole.yaml"],
    "discrete_sac": ["exp_specs/sac/sac_cartpole_d.yaml"],
}


def test_grad_steps_and_eval_envs_match_jax_on_offpolicy_specs():
    """K and the evaluator's env count on the td3, dqn and discrete-SAC
    specs: 8, 8 and 13 gradient steps an iteration, 32 eval envs."""
    got = {}
    for algo, paths in OFF_POLICY_SPECS.items():
        for path in paths:
            spec = _load(ROOT / path)
            assert spec["meta_data"]["algorithm"] == algo
            (v,) = pvariant.build_variants(spec)
            rl = dict(v["rl_alg_params"])
            n = int(v["env_specs"]["env_num"])
            k = pexp._grad_steps_per_iter(rl, n)
            assert k == jexp._grad_steps_per_iter(rl, n), path
            mpl = int(rl.get("max_path_length", 1000))
            assert pexp._num_eval_envs(rl) == max(
                int(rl.get("num_steps_per_eval", 10_000)) // mpl,
                int(rl.get("min_eval_episodes", 32))), path
            got[path] = (n, k, pexp._num_eval_envs(rl))
    assert got == {"exp_specs/td3/td3_hopper.yaml": (8, 8, 32),
                   "exp_specs/td3/td3_humanoid.yaml": (8, 8, 32),
                   "exp_specs/dqn/dqn_cartpole.yaml": (16, 8, 32),
                   "exp_specs/sac/sac_cartpole_d.yaml": (128, 13, 32)}


def _captured(module, name, variant, monkeypatch, **kw):
    """The algorithm and env that `module.EXPERIMENTS[name]` hands its
    `_run_off_policy`."""
    seen = {}

    def capture(algo, vec, rl, logger, seed, **_):
        seen.update(algo=algo, vec=vec, rl=rl)
        logger.close()

    monkeypatch.setattr(module, "_run_off_policy", capture)
    module.EXPERIMENTS[name](variant, **kw)
    return seen


def _spec_variant(path, tmp_path):
    (v,) = pvariant.build_variants(_load(ROOT / path))
    v.update(log_dir=str(tmp_path / Path(path).stem), print_to_console=False)
    return v


@pytest.mark.parametrize("name, path", [
    ("td3", "exp_specs/td3/td3_hopper.yaml"),
    ("td3", "exp_specs/td3/td3_humanoid.yaml"),
    ("dqn", "exp_specs/dqn/dqn_cartpole.yaml"),
    ("ddpg", "exp_specs/td3/td3_hopper.yaml"),
    ("sac_v", "exp_specs/td3/td3_hopper.yaml"),
])
def test_offpolicy_launchers_build_the_jax_configuration(
        name, path, tmp_path, monkeypatch):
    """Each launcher's trainer configuration, widths, env and schedule as
    the JAX launcher builds them from the same variant (ddpg and sac_v on
    td3_hopper.yaml's constants with their own parameter blocks)."""
    v = _spec_variant(path, tmp_path)
    if name == "ddpg":
        v["ddpg_params"] = {"policy_lr": 3e-4, "soft_target_tau": 0.005}
    if name == "sac_v":
        v["sac_params"] = {"alpha": 0.2, "reward_scale": 5.0}
    want = _captured(jexp, name, copy.deepcopy(v), monkeypatch)
    got = _captured(pexp, name, copy.deepcopy(v), monkeypatch,
                    device="cpu")
    ja, pa = want["algo"], got["algo"]
    assert dataclasses.asdict(pa.config) == {
        k: (float(x) if isinstance(x, float) else x)
        for k, x in dataclasses.asdict(ja.config).items()}
    assert pa.hidden == (int(v.get("net_size", 256)),) * int(
        v.get("num_hidden_layers", 2))
    jenv, penv = want["vec"].env, got["vec"].env
    assert (type(penv).__name__, penv.observation_size, penv.action_size,
            penv.discrete, penv.max_episode_steps, got["vec"].num_envs) == (
        type(jenv).__name__, jenv.observation_size, jenv.action_size,
        jenv.discrete, jenv.max_episode_steps, want["vec"].num_envs)
    assert got["rl"] == want["rl"]


def test_fault_discrete_sac_reads_its_spec_block(tmp_path, monkeypatch):
    """Reference fault: the JAX `run_discrete_sac` reads `sac_params`
    (experiments.py:628) while exp_specs/sac/sac_cartpole_d.yaml writes
    `discrete_sac_params`, so the JAX package trains it at the defaults.
    The port reads `discrete_sac_params`, and `sac_params` where only
    that is given."""
    path = "exp_specs/sac/sac_cartpole_d.yaml"
    v = _spec_variant(path, tmp_path)
    spec = dict(alpha=0.05, reward_scale=1.0, discount=0.95,
                soft_target_tau=0.005, policy_lr=1e-4, qf_lr=1e-3)
    assert v["discrete_sac_params"] == spec and "sac_params" not in v
    jcfg = _captured(jexp, "discrete_sac", copy.deepcopy(v),
                     monkeypatch)["algo"].config
    pcfg = _captured(pexp, "discrete_sac", copy.deepcopy(v), monkeypatch,
                     device="cpu")["algo"].config
    for k, x in spec.items():
        assert getattr(pcfg, k) == x, k
    assert (jcfg.alpha, jcfg.discount, jcfg.policy_lr,
            jcfg.soft_target_tau) == (1.0, 0.99, 1e-3, 1e-2)
    # the JAX layout, `sac_params`, is read where it is the only block
    v2 = copy.deepcopy(v)
    v2["sac_params"] = v2.pop("discrete_sac_params")
    pcfg2 = _captured(pexp, "discrete_sac", v2, monkeypatch,
                      device="cpu")["algo"].config
    jcfg2 = _captured(jexp, "discrete_sac", copy.deepcopy(v2),
                      monkeypatch)["algo"].config
    assert dataclasses.asdict(pcfg2) == dataclasses.asdict(jcfg2)
    assert pcfg2 == pcfg


def test_td3_reads_the_policy_noise_names_of_td3_humanoid(tmp_path,
                                                           monkeypatch):
    """exp_specs/td3/td3_humanoid.yaml writes `policy_noise` /
    `policy_noise_clip`, which the JAX `run_td3` does not read
    (experiments.py:550-552); the port reads them, and the `target_*`
    names win where both are given.  The spec's values are the defaults,
    so nothing differs there today."""
    v = _spec_variant("exp_specs/td3/td3_humanoid.yaml", tmp_path)
    v["env_specs"]["env_name"] = "pendulum"      # a cheap device env
    v["td3_params"].update(policy_noise=0.3, policy_noise_clip=0.4)
    cfg = _captured(pexp, "td3", copy.deepcopy(v), monkeypatch,
                    device="cpu")["algo"].config
    jcfg = _captured(jexp, "td3", copy.deepcopy(v), monkeypatch)[
        "algo"].config
    assert (cfg.target_policy_noise, cfg.target_policy_noise_clip) == (
        0.3, 0.4)
    assert (jcfg.target_policy_noise, jcfg.target_policy_noise_clip) == (
        0.2, 0.5)
    v["td3_params"].update(target_policy_noise=0.25,
                           target_policy_noise_clip=0.45)
    cfg = _captured(pexp, "td3", v, monkeypatch, device="cpu")[
        "algo"].config
    assert (cfg.target_policy_noise, cfg.target_policy_noise_clip) == (
        0.25, 0.45)


def _tiny_offpolicy(name, env, log_dir, num_epochs=2, **extra):
    """The tiny schedule of `_tiny` for another trainer (4 envs, 32 x 1
    nets, K = 4)."""
    v = _tiny(log_dir, num_epochs)
    v.pop("sac_params")
    v["env_specs"]["env_name"] = env
    v.update(extra)
    return v


@pytest.mark.parametrize("name, env, metric", [
    ("td3", "pendulum", "trainer/policy_loss"),
    ("dqn", "cartpole", "trainer/epsilon"),
])
def test_offpolicy_run_and_full_resume_bit_for_bit(name, env, metric,
                                                   tmp_path):
    """2 epochs straight through, and 1 epoch resumed in full to 2: the
    end states equal bit for bit (TD3's n_train_steps and three targets,
    DQN's two counters and its int32 ring among them), progress.csv rows
    equal but for the clocks, every value finite."""
    run = pexp.EXPERIMENTS[name]
    a = run(_tiny_offpolicy(name, env, tmp_path / "a"), device="cpu")
    run(_tiny_offpolicy(name, env, tmp_path / "b", 1), device="cpu")
    b = run(_tiny_offpolicy(name, env, tmp_path / "b",
                            load_params=str(tmp_path / "b")), device="cpu")
    assert tree_diff(to_tree(a), to_tree(b)) == []
    rows_a, rows_b = _rows(tmp_path / "a"), _rows(tmp_path / "b")
    assert len(rows_a) == len(rows_b) == 2 and metric in rows_a[0]
    for ra, rb in zip(rows_a, rows_b):
        assert all(math.isfinite(float(x)) for x in ra.values())
        assert {k: x for k, x in ra.items() if k not in CLOCKS} == {
            k: x for k, x in rb.items() if k not in CLOCKS}
    assert [float(r["TotalEnvSteps"]) for r in rows_a] == [96.0, 160.0]
    state = a.algo_state
    if name == "td3":
        assert state.n_train_steps == 2 * 16 * 4
        assert state.policy_opt.count == 2 * 16 * 4 // 2
    else:
        assert a.replay.data["action"].dtype == torch.int32
        assert state.n_train_steps == 2 * 16 * 4
        assert state.n_act_steps == 2 * 16 * 4      # env steps of training


@pytest.mark.parametrize("name, env", [
    ("td3", "pendulum"), ("ddpg", "pendulum"), ("sac_v", "pendulum"),
    ("dqn", "cartpole"), ("discrete_sac", "cartpole")])
def test_offpolicy_launchers_default_to_the_card(name, env, tmp_path):
    """Without `device` a launcher runs on cuda: on a machine without a
    card it raises, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pexp.EXPERIMENTS[name](_tiny_offpolicy(name, env, tmp_path / name))
    assert not (tmp_path / name).exists()
