"""run.py refuses, printing no result, where it cannot measure the port."""

import os
import shutil
import subprocess
import sys

from benchmark.harness.spec import ROOT

ARGS = ["--workload", "sac_hopper.e128_k128", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    # no fallback to the CPU: the card is hidden from the process
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    # a directory with only BENCHMARK.json and the benchmark's folder
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "ilswiss_tpu_torch" in out.stderr
