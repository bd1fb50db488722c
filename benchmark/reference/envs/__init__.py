"""The reference's envs, one file each: `envs/<name>.py` defines `Env`,
found by the configuration's `env`.  A new env is a new file here (and
its model table under `models/`), and no edit of the others."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch

ENVS = Path(__file__).resolve().parent


def load(name: str, device, dtype=torch.float32, folder: Path = ENVS):
    """The env `name` on `device` in `dtype`; KeyError where there is no
    file for it."""
    path = Path(folder) / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"the reference has no env '{name}' (no {path})")
    module_name = f"benchmark.reference.envs.{name}"
    if Path(folder) != ENVS:
        module_name += f"@{Path(folder)}"
    if module_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        spec.loader.exec_module(module)
    return sys.modules[module_name].Env(device, dtype)
