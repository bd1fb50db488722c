"""Build and load the port's CUDA kernels (no JAX counterpart: Pallas
kernels compile inside `jax.jit`).

Each `csrc/<name>.cu` has a plain C interface and becomes its own shared
library, built at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

into `build/kernels/` at the root of the checkout, and is loaded with
`ctypes`.  The library's name carries a hash of its source, so an edited
source is rebuilt and an unchanged one is reused.  `--use_fast_math` is
left out on purpose: the planar-dynamics kernel needs IEEE `sinf`, `cosf`,
`sqrtf` and `powf`.  The planar-dynamics kernel is also built with
`-fmad=false`: without contracted multiply-adds it rounds like its plain
PyTorch version, whose elementwise operations are unfused, so the two
stay comparable through the 15 Gauss-Seidel sweeps.  The fused SAC chain
keeps contraction on: its work is matrix products, which accumulate with
fused multiply-adds both here and in the library products of its plain
version, so `-fmad=false` would make the two differ more, not less.  The
Gauss-Seidel solve (`pgs`) keeps it on as well: its dot products are reduced
across a warp in another order than the plain version's sums whatever the
flag, and the tolerance it is held to covers both.
`build_all` starts one `nvcc` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("planar_forward", "fused_mlp", "fused_sac", "pgs")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
EXTRA_FLAGS = {"planar_forward": ("-fmad=false",)}


@dataclass
class Built:
    name: str
    path: Path
    seconds: float      # 0.0 when an earlier build was reused
    log: str            # nvcc's output, including -Xptxas -v


_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc was not found; the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    digest = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names=SOURCES) -> dict[str, Built]:
    """Build every named source that has no current library, one `nvcc`
    process per source, all running together.  Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, Built] = {}
    running = []
    for name in names:
        target = _target(name)
        log_path = target.with_suffix(".log")
        if target.exists():
            log = log_path.read_text() if log_path.exists() else ""
            out[name] = Built(name, target, 0.0, log)
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, target, tmp, log_path, proc, time.perf_counter()))
    for name, target, tmp, log_path, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, target)
        log_path.write_text(log)
        out[name] = Built(name, target, seconds, log)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        built = build_all((name,))[name]
        lib = ctypes.CDLL(str(built.path))
        _LIBS[name] = lib
    return lib
