"""The harness finds each configuration, traffic mix, limit file and
metric reader by the name in BENCHMARK.json, and nothing else."""

import json
import shutil

import pytest

from benchmark.harness.spec import ROOT, load_cell, reader

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = load_cell(workload)
    w = next(w for w in SPEC["workloads"] if w["name"] == workload)
    assert cell.config["name"] == w["config"]
    assert cell.traffic == json.loads(
        (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    assert {m["name"] for m in cell.end_to_end} >= {"env_steps_per_s",
                                                    "setup_s"}
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(reader(m["name"]))
    from benchmark.harness import algos
    assert set(cell.limits) - {"readings"} == set(
        algos.load(cell.config["algorithm"]).NUMBERS)


def test_a_new_cell_is_new_files_only(tmp_path):
    # a later PR adds a traffic mix, a cell and a metric as files and
    # entries; the harness needs no edit
    root = tmp_path
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (root / "benchmark" / "traffic" / "e64_k64.json").write_text(json.dumps(
        {"num_envs": 64, "grad_steps_per_iter": 64, "batch_size": 512,
         "warmup_steps": 5000}))
    shutil.copy(root / "benchmark" / "limits" / "sac_hopper.e8_k8.json",
                root / "benchmark" / "limits" / "sac_hopper.e64_k64.json")
    (root / "benchmark" / "metrics" / "loop.iterations.py").write_text(
        "def read(run):\n    return run.window.iterations\n")
    spec["workloads"].append({"name": "sac_hopper.e64_k64",
                              "config": "sac_hopper", "traffic": "e64_k64",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "loop.iterations", "unit": "iters",
                              "better": "higher", "source": "host_clock",
                              "layer": "loop", "moves": "env_steps_per_s",
                              "workloads": ["sac_hopper.e64_k64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("sac_hopper.e64_k64", root)
    assert cell.traffic["num_envs"] == 64
    names = [m["name"] for m in cell.per_layer]
    assert "loop.iterations" in names and "device.idle_pct" not in names
    assert reader("loop.iterations", root)(
        type("R", (), {"window": type("W", (), {"iterations": 7})})) == 7


def test_unknown_workload():
    with pytest.raises(KeyError):
        load_cell("no_such.cell")


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_every_config_finds_its_env_and_algorithm(config):
    from benchmark.harness import algos
    from benchmark.reference import envs
    data = json.loads((ROOT / config["file"]).read_text())
    env = envs.load(data["env"], "cpu")
    assert env.reset_obs and env.step and env.model.nq > 0
    algo = algos.load(data["algorithm"])
    for name in ("build", "set_up", "compare", "readings"):
        assert callable(getattr(algo, name))
    assert algo.NUMBERS


def test_a_new_env_and_algorithm_are_new_files_only(tmp_path):
    # a later configuration on another env or algorithm brings its own
    # files; the harness and the existing envs need no edit
    from benchmark.harness import algos
    from benchmark.reference import envs
    (tmp_path / "hopper_slow.py").write_text(
        "from benchmark.reference.envs.hopper import Env as Hopper\n\n\n"
        "class Env(Hopper):\n    slow = True\n")
    assert envs.load("hopper_slow", "cpu", folder=tmp_path).slow
    (tmp_path / "sac_slow.py").write_text(
        "from benchmark.harness.algos.sac import *  # noqa: F401,F403\n"
        "SLOW = True\n")
    algo = algos.load("sac_slow", folder=tmp_path)
    assert algo.SLOW and callable(algo.build)
    with pytest.raises(KeyError, match="no_such_env"):
        envs.load("no_such_env", "cpu")
    with pytest.raises(KeyError, match="no_such_algorithm"):
        algos.load("no_such_algorithm")
