"""ctypes bindings for the native vectorized MuJoCo engine (counterpart:
ilswiss_tpu/envs/native_mujoco.py; `_ENV_TYPES`, `build_library`,
`NativeMjVectorEnv`).

`NativeMjVectorEnv` stands in for `GymVectorEnv` (envs/host_mujoco.py) on
the MuJoCo locomotion family, backed by the port's own copy of the engine,
ilswiss_tpu_torch/native/mjvec.cpp: one C call steps all B envs over
persistent worker threads.  `build_library` compiles it with g++ against
the `mujoco` wheel's headers and shared library into `build/native/` at
the root of the checkout (git-ignored), under a name that carries a hash
of the source, the command and the library it links, so an edited source
or another MuJoCo is rebuilt and an unchanged one reused; nothing is
written into a package directory.  The JAX package writes its library
beside its source instead.

Failures say what is missing: without `mujoco` or `gymnasium` (whose
assets hold the model XMLs) an ImportError names the package, without
g++ a FileNotFoundError; a source that g++ refuses raises RuntimeError
with the compiler's output, so a fault of the source is never mistaken
for a machine without the engine (launchers/experiments.py falls back to
gymnasium only on the first two).
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "mjvec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_ENV_TYPES = {
    "hopper": (0, "hopper.xml", 4),
    "walker": (1, "walker2d.xml", 4),
    "halfcheetah": (2, "half_cheetah.xml", 5),
    "ant": (3, "ant.xml", 5),
    "humanoid": (4, "humanoid.xml", 5),
    "swimmer": (5, "swimmer.xml", 4),
    "invertedpendulum": (6, "inverted_pendulum.xml", 2),
    "inverteddoublependulum": (7, "inverted_double_pendulum.xml", 5),
}

_LIB = None


def _package(name: str):
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(
            f"the native MuJoCo engine needs the '{name}' package, which "
            f"does not import here ({e})") from e


def _mujoco_paths() -> tuple[str, str, str]:
    """(the mujoco wheel's directory, its include directory, the name of
    its shared library)."""
    pkg = os.path.dirname(_package("mujoco").__file__)
    include = os.path.join(pkg, "include")
    libs = sorted(f for f in os.listdir(pkg) if f.startswith("libmujoco.so"))
    if not libs or not os.path.isdir(include):
        raise ImportError(f"the 'mujoco' package at {pkg} has no "
                          f"libmujoco or no include/ directory")
    return pkg, include, libs[-1]


def _assets_dir() -> str:
    _package("gymnasium")
    gm = _package("gymnasium.envs.mujoco")
    return os.path.join(os.path.dirname(gm.__file__), "assets")


def build_library() -> Path:
    """The shared library of `SOURCE`, compiled into `BUILD_DIR` unless a
    current one is there."""
    pkg, include, libname = _mujoco_paths()
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ was not found; the native MuJoCo "
                                "engine cannot be built")
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17", f"-I{include}",
             f"-L{pkg}", f"-l:{libname}", f"-Wl,-rpath,{pkg}", "-pthread"]
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libmjvec-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a temporary name per process, then one rename: concurrent builds
    # (test workers) never load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    done = subprocess.run([gxx, str(SOURCE), *flags, "-o", str(tmp)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{done.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()))
    lib.mjvec_create.restype = ctypes.c_void_p
    lib.mjvec_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint, ctypes.c_int,
    ]
    lib.mjvec_obs_dim.restype = ctypes.c_int
    lib.mjvec_obs_dim.argtypes = [ctypes.c_void_p]
    lib.mjvec_act_dim.restype = ctypes.c_int
    lib.mjvec_act_dim.argtypes = [ctypes.c_void_p]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.mjvec_reset_all.restype = None
    lib.mjvec_reset_all.argtypes = [ctypes.c_void_p, f32p]
    lib.mjvec_get_obs.restype = None
    lib.mjvec_get_obs.argtypes = [ctypes.c_void_p, f32p]
    lib.mjvec_set_state.restype = None
    lib.mjvec_set_state.argtypes = [ctypes.c_void_p, ctypes.c_int, f64p,
                                    f64p]
    lib.mjvec_step.restype = None
    lib.mjvec_step.argtypes = [
        ctypes.c_void_p, f32p, f32p, f32p, u8p, u8p, f32p]
    lib.mjvec_destroy.restype = None
    lib.mjvec_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


class NativeMjVectorEnv:
    """GymVectorEnv's numpy contract over the native engine; actions are
    normalized to [-1, 1] (the engine scales them to the ctrlrange)."""

    def __init__(self, env_name: str, num_envs: int, seed: int = 0,
                 max_episode_steps: int | None = None,
                 num_threads: int = 8, **_):
        if env_name not in _ENV_TYPES:
            raise ValueError(
                f"the native engine runs {sorted(_ENV_TYPES)}, not "
                f"{env_name!r} (GymVectorEnv runs the rest)")
        env_type, xml, frame_skip = _ENV_TYPES[env_name]
        self._lib = _load()
        self._handle = None
        xml_path = os.path.join(_assets_dir(), xml)
        self.max_episode_steps = max_episode_steps or 1000
        self._handle = self._lib.mjvec_create(
            xml_path.encode(), num_envs, env_type, frame_skip,
            self.max_episode_steps, seed, num_threads)
        if not self._handle:
            raise RuntimeError(f"mjvec_create failed for {xml_path}")
        self.name = env_name
        self.num_envs = num_envs
        self.observation_size = self._lib.mjvec_obs_dim(self._handle)
        self.action_size = self._lib.mjvec_act_dim(self._handle)
        self.discrete = False
        self.action_low = -np.ones(self.action_size, np.float32)
        self.action_high = np.ones(self.action_size, np.float32)
        self._obs = np.zeros((num_envs, self.observation_size), np.float32)

    def reset(self, seed: int | None = None) -> np.ndarray:
        # the per-env generators were seeded at create; a reset draws
        # fresh noise from them
        self._lib.mjvec_reset_all(self._handle, self._obs)
        return self._obs.copy()

    def set_state(self, i: int, qpos: np.ndarray, qvel: np.ndarray) -> None:
        self._lib.mjvec_set_state(
            self._handle, i, np.ascontiguousarray(qpos, np.float64),
            np.ascontiguousarray(qvel, np.float64))
        self._lib.mjvec_get_obs(self._handle, self._obs)

    def step(self, normalized_actions: np.ndarray) -> Tuple[np.ndarray, ...]:
        n, od = self.num_envs, self.observation_size
        actions = np.ascontiguousarray(normalized_actions, np.float32)
        if actions.shape != (n, self.action_size):
            raise ValueError(f"actions of shape {actions.shape}, expected "
                             f"{(n, self.action_size)}")
        obs_prev = self._obs.copy()
        true_next = np.zeros((n, od), np.float32)
        reward = np.zeros((n,), np.float32)
        terminal = np.zeros((n,), np.uint8)
        done = np.zeros((n,), np.uint8)
        obs_after = np.zeros((n, od), np.float32)
        self._lib.mjvec_step(self._handle, actions, true_next, reward,
                             terminal, done, obs_after)
        self._obs = obs_after
        return (obs_prev, true_next, reward, terminal.astype(bool),
                done.astype(bool), obs_after.copy())

    def close(self) -> None:
        if self._handle:
            self._lib.mjvec_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
