"""Tier marks for tests/ beyond those that tests/conftest.py sets.

Tier contract:
  per-commit  `-m 'not slow'`: everything but `slow`, with the five nightly
              cases that are not also `slow`: tests/test_pgs_pallas.py's
              engine step (about 140 s of one worker) and
              tests/test_locomotion.py's Ant and Humanoid parity and reset
              cases (about 210 s together)
  smoke       `-m "not slow and not nightly"`
  slow        `-m slow`, the three cases below among them
  nightly     `-m nightly`: all eight interpret-mode and parity cases
The full suite (no -m) runs everything.
"""

import pytest

# nightly and slow: the JAX package's frozen Pallas K1 run through the
# Pallas interpreter (ILSWISS_PLANAR_INTERPRET=1), 1,025 s of one worker
# together under `-m 'not slow' -n 6 --dist loadfile` (8-CPU host,
# 2026-10-19; the rollout case 738 s of it).  The port's K1 is held by
# tests/test_torch_planar.py (plain and host-threaded CUDA source against
# the JAX integrator and engine at the same pins) and, on the card, by
# tests/test_torch_gpu.py.  The cases keep their in-file `nightly` mark.
_INTERPRET = {
    "tests/test_planar_dynamics.py::test_kernel_control_step_matches_engine",
    "tests/test_planar_dynamics.py::test_env_rollout_through_kernel_stays_close",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.nodeid.split("[")[0] in _INTERPRET:
            item.add_marker(pytest.mark.slow)
