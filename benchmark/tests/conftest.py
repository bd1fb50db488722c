"""Tests of the benchmark harness.  They run on the CPU at tiny sizes:

    python -m pytest benchmark/tests -q

Nothing here imports JAX.  A test that needs a card carries the `gpu`
marker and decides inside a fixture whether there is one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def tiny_cell(workload: str = "sac_hopper.e128_k128"):
    """The cell at its widths and batch, with the envs, the gradient steps
    an iteration, the warmup and the ring cut to what the CPU runs in
    seconds (the reference and the program's plain versions).  Its window
    is too short for `iter_ms_p95`'s 200 iterations, so it reports the
    other end-to-end metrics."""
    from benchmark.harness.spec import load_cell
    cell = load_cell(workload, ROOT)
    cell.config = dict(cell.config, replay_capacity=4096)
    cell.traffic = dict(cell.traffic, num_envs=2, grad_steps_per_iter=4,
                        warmup_steps=4, ring_rows=1000)
    cell.end_to_end = [m for m in cell.end_to_end
                       if m["name"] != "iter_ms_p95"]
    return cell
