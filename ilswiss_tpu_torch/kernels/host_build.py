"""Compile a kernel's CUDA source for the CPU, to rehearse its
logic where there is no GPU and no `nvcc` (no JAX counterpart: Pallas has
an interpret mode).

`build_host("fused_sac", "SacArgs")` copies `csrc/fused_sac.cu`, turns each
`__shared__ float name[n];` into a per-block buffer, appends a
`cudaLaunchCooperativeKernel` that runs the kernel on one `std::thread` per
CUDA thread (the shim's `cudaLaunchKernel` goes the same way, so
`build_host("pgs", "PgsArgs")` works alike), and compiles the result with `g++ -std=c++20` against the
headers in `host_shim/` into `build/host/`.  The library has the source's
own C interface, so `ctypes` loads it like the real one and the wrapper's
launch code can drive it with CPU tensors.  It is for small sizes (a few
blocks of 256 threads, barriers through the OS) and says nothing about
speed; the port never uses it at run time.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

from ilswiss_tpu_torch.kernels.build import BUILD_DIR, CSRC

SHIM = Path(__file__).resolve().parent / "host_shim"
HOST_DIR = BUILD_DIR.parent / "host"

_TRAILER = r"""
thread_local HostIdx threadIdx, blockIdx, gridDim;
thread_local HostBlock* host_block;
std::barrier<>* host_grid_bar;

cudaError_t cudaLaunchCooperativeKernel(void* f, dim3 grid, dim3 block,
                                        void** args, size_t, cudaStream_t) {
  auto kernel = reinterpret_cast<void (*)(ARGS)>(f);
  ARGS a = *static_cast<ARGS*>(args[0]);
  std::vector<HostBlock> blocks(grid.x);
  std::barrier<> grid_bar(grid.x * block.x);
  host_grid_bar = &grid_bar;
  for (auto& b : blocks) {
    b.bar.reset(new std::barrier<>(block.x));
    for (unsigned w = 0; w < block.x / 32; ++w) {
      b.warp_bar.emplace_back(new std::barrier<>(32));
      b.warp_buf.emplace_back(32);
    }
  }
  std::vector<std::thread> threads;
  for (unsigned bi = 0; bi < grid.x; ++bi)
    for (unsigned ti = 0; ti < block.x; ++ti)
      threads.emplace_back([&, bi, ti] {
        threadIdx = {ti, 0, 0};
        blockIdx = {bi, 0, 0};
        gridDim = {grid.x, 1, 1};
        host_block = &blocks[bi];
        kernel(a);
      });
  for (auto& t : threads) t.join();
  return cudaSuccess;
}
"""


def build_host(name: str, args_struct: str) -> Path:
    """The CPU library of `csrc/<name>.cu`, whose one kernel takes one
    `args_struct` by value.  Raises if `g++` is missing or fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ was not found")
    src = (CSRC / f"{name}.cu").read_text()
    src, n = re.subn(
        r"__shared__ (?:__align__\(16\) )?float (\w+)\[(.+?)\];",
        r'float* \1 = host_shared("\1", (\2));', src)
    if n == 0:
        raise RuntimeError(f"{name}.cu declares no shared float arrays")
    HOST_DIR.mkdir(parents=True, exist_ok=True)
    cpp = HOST_DIR / f"{name}_host.cpp"
    cpp.write_text(src + _TRAILER.replace("ARGS", args_struct))
    lib = HOST_DIR / f"lib{name}_host.so"
    cmd = [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
           f"-I{SHIM}", "-o", str(lib), str(cpp)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}.cu:\n{done.stderr}")
    return lib
