"""Batched projected Gauss-Seidel constraint solve, with kernel K4
(counterpart: ilswiss_tpu/ops/pgs_pallas.py).

The rigid-body engine (ops/rigid_body.py) solves the regularized pyramidal
contact and joint-limit problem

    (J M^-1 J^T + diag(Rreg)) f = -b,   f >= 0,   inactive rows pinned to 0

with `iters` Gauss-Seidel sweeps over the `nr` rows, warm-started at `f0`.
The sweep is in u-form: it carries u = W f with W = M^-1 J^T [nv, nr] and
never forms the [nr, nr] matrix,

    res_r = J_r . u + Rreg_r f_r + b_r
    f_r  <- active_r ? max(0, f_r - res_r / D_r) : 0
    u    += (f_r_new - f_r_old) W[:, r]

row after row in the engine's row order.  `pgs_solve_plain` is that sweep in
plain PyTorch over the batch; `pgs_solve` launches `csrc/pgs.cu` once per
solve for CUDA tensors.  All arguments carry a leading batch dimension:
J [B, nr, nv], W [B, nv, nr], Rreg, b, D, f0 [B, nr] and active [B, nr]
(bool).  The factor, W, Rreg, b and D are the engine's own PyTorch calls.
"""

from __future__ import annotations

import ctypes

import torch

# limits of kernel K4 (PGS_MAX_* in csrc/pgs.cu): up to 32 velocity
# coordinates in an env's lanes, and an env's rows in shared memory
MAX_NV, MAX_ROWS = 32, 256


def pgs_solve_plain(J, W, Rreg, b, D, active, f0, iters: int):
    """The plain version: the sweep and row order of the JAX package's
    `_sweep_fallback`, written over the batch.  Any float type, any
    device; returns f [B, nr]."""
    nr = f0.shape[1]
    f = torch.where(active, f0, torch.zeros_like(f0))
    u = torch.matmul(W, f.unsqueeze(-1)).squeeze(-1)          # [B, nv]
    zero = f.new_zeros(())
    for _ in range(iters):
        for r in range(nr):
            old = f[:, r]
            res = (J[:, r] * u).sum(-1) + Rreg[:, r] * old + b[:, r]
            new = torch.clamp_min(old - res / D[:, r], 0.0)
            new = torch.where(active[:, r], new, zero)
            u = u + (new - old).unsqueeze(-1) * W[:, :, r]
            f[:, r] = new
    return f


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    lib.pgs_solve.argtypes = [p, p, p, p]
    lib.pgs_solve.restype = ctypes.c_int
    lib.pgs_error_string.argtypes = [ctypes.c_int]
    lib.pgs_error_string.restype = ctypes.c_char_p
    return lib


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ilswiss_tpu_torch.kernels.build import load
        _LIB = _declare(load("pgs"))
    return _LIB


def _check_inputs(J, W, Rreg, b, D, active, f0, iters: int) -> None:
    """Raises ValueError for what kernel K4 does not take.  Runs before
    anything is built."""
    if J.dim() != 3:
        raise ValueError(f"J must be [B, nr, nv], got {tuple(J.shape)}")
    B, nr, nv = J.shape
    if not (1 <= nv <= MAX_NV and 1 <= nr <= MAX_ROWS) or iters < 0:
        raise ValueError(
            f"K4 takes 1..{MAX_NV} velocity coordinates, 1..{MAX_ROWS} rows "
            f"and iters >= 0; got nv {nv}, nr {nr}, iters {iters}")
    if tuple(W.shape) != (B, nv, nr):
        raise ValueError(f"W must be {(B, nv, nr)}, got {tuple(W.shape)}")
    for name, t in (("J", J), ("W", W)):
        if t.device != J.device or t.dtype != torch.float32:
            raise ValueError(f"K4 takes float32 tensors on {J.device}; {name} "
                             f"is {t.dtype} on {t.device}")
    for name, t, dtype in (("Rreg", Rreg, torch.float32),
                           ("b", b, torch.float32), ("D", D, torch.float32),
                           ("active", active, torch.bool),
                           ("f0", f0, torch.float32)):
        if (t.device != J.device or t.dtype != dtype
                or tuple(t.shape) != (B, nr) or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {(B, nr)} {dtype} tensor on "
                f"{J.device}; got {tuple(t.shape)} {t.dtype} on {t.device}")


def _launch(lib: ctypes.CDLL, J, W, Rreg, b, D, active, f0, iters: int,
            stream) -> torch.Tensor:
    """One call of the library's `pgs_solve` on checked inputs; returns f.
    `lib` is the CUDA library, or in a test the CPU build of the same
    source (kernels/host_build.py)."""
    B, nr, nv = J.shape
    f = torch.empty_like(f0)
    ptrs = [t.data_ptr() for t in (J, W, Rreg, b, D, active, f0, f)]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_dims = (ctypes.c_int * 4)(B, nr, nv, int(iters))
    c_strides = (ctypes.c_longlong * 6)(*J.stride(), *W.stride())
    err = lib.pgs_solve(c_ptrs, c_dims, c_strides, stream)
    if err != 0:
        raise RuntimeError("pgs_solve: " + lib.pgs_error_string(err).decode())
    return f


def pgs_solve(J, W, Rreg, b, D, active, f0, iters: int) -> torch.Tensor:
    """Row forces f [B, nr] after `iters` sweeps from the warm start f0.

    CPU tensors take `pgs_solve_plain`.  CUDA float32 tensors launch kernel
    K4 once on the current stream and add one to `pgs_solve.launches`; J and
    W are read through their strides, the row vectors must be contiguous.
    The call raises ValueError for what the kernel does not take (another
    type on the card, nv over 32, more than 256 rows, mismatched shapes or
    devices: a caller who wants float64 on the card calls the plain version
    by name) and RuntimeError with the CUDA error text when the launch
    fails."""
    if J.device.type == "cpu":
        return pgs_solve_plain(J, W, Rreg, b, D, active, f0, iters)
    if J.device.type != "cuda":
        raise ValueError(f"pgs_solve: unsupported device {J.device}")
    _check_inputs(J, W, Rreg, b, D, active, f0, iters)
    if J.shape[0] == 0:
        return torch.empty_like(f0)
    stream = torch.cuda.current_stream(J.device).cuda_stream
    f = _launch(_lib(), J, W, Rreg, b, D, active, f0, iters, stream)
    pgs_solve.launches += 1
    return f


pgs_solve.launches = 0
