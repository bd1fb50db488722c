"""The algorithms the harness drives, one file each: `algos/<name>.py`,
found by the configuration's `algorithm`.  A new algorithm is a new file
here, and no edit of the others.  Each file defines:

  build(config, traffic, device)
      the system under test, with `step(runner) -> (runner, metrics)` (one
      of the window's iterations, through the program's own call),
      `spans` ([(object, method name, span name)] around the calls into
      each layer), `shapes` (what the metric readers count work from),
      `env_steps_per_iter`, and `planar` (the planar model, or None)
  set_up(system, config, traffic, seed, device) -> (runner, captured)
      everything before the window, from the seed, with what the
      comparison needs
  compare(captured, config, limits, device) -> (correct, checks)
      the comparison with the reference, after the window
  NUMBERS
      the names of the compared numbers, each with a limit in
      `limits/<workload>.json`
  readings(captured, config, device, controls) -> dict
      the program's compared numbers and, with `controls`, the control's
      and each planted fault's: what the limits are set from
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

ALGOS = Path(__file__).resolve().parent


def load(name: str, folder: Path = ALGOS):
    """The module of algorithm `name`; KeyError where there is no file."""
    path = Path(folder) / f"{name}.py"
    if name.startswith("_") or not path.is_file():
        raise KeyError(f"the harness has no algorithm '{name}' (no {path})")
    module_name = f"benchmark.harness.algos.{name}"
    if Path(folder) != ALGOS:
        module_name += f"@{Path(folder)}"
    if module_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        spec.loader.exec_module(module)
    return sys.modules[module_name]
