"""Fused Gaussian-policy forward for acting, with kernel K3 (counterpart:
ilswiss_tpu/ops/fused_mlp.py).

The acting path runs the policy MLP (obs -> hidden -> hidden -> mean and
log-std heads) once per loop iteration.  `fused_gaussian_policy_forward`
computes the whole trunk, both heads and the log-std clamp in one launch
of `csrc/fused_mlp.cu` for a CUDA tensor, and the plain version (one
`addmm` per layer and a clamp) for a CPU tensor.  Acting runs under
`no_grad`; training keeps the `nn.Module` forward for autograd.
"""

from __future__ import annotations

import ctypes

import torch

from ilswiss_tpu_torch.models.distributions import LOG_SIG_MAX, LOG_SIG_MIN
from ilswiss_tpu_torch.models.policies import TanhGaussianPolicy

MAX_HIDDEN, MAX_WIDTH = 4, 1024   # MLP_MAX_* in csrc/fused_mlp.cu


def _layers(policy: TanhGaussianPolicy):
    """(weights, biases): trunk layers, then the mean and log-std heads;
    weights are nn.Linear's [out, in]."""
    layers = policy.hidden_layers() + [policy.mean, policy.log_std]
    return [l.weight for l in layers], [l.bias for l in layers]


def policy_forward_plain(weights, biases, obs: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ReLU(addmm) per trunk layer, two head addmms and
    the clamp of log-std to [-20, 2]."""
    h = obs
    for w, b in zip(weights[:-2], biases[:-2]):
        h = torch.relu(torch.addmm(b, h, w.t()))
    mean = torch.addmm(biases[-2], h, weights[-2].t())
    log_std = torch.clamp(torch.addmm(biases[-1], h, weights[-1].t()),
                          LOG_SIG_MIN, LOG_SIG_MAX)
    return mean, log_std


def _kernel_dims(weights, biases, obs: torch.Tensor) -> list[int]:
    """The widths (obs size, then each trunk layer) as K3 takes them;
    raises ValueError for what it does not take.  Runs before anything is
    built, so it runs without a card."""
    num_hidden = len(weights) - 2
    if obs.dim() != 2 or obs.dtype != torch.float32 or not obs.is_contiguous():
        raise ValueError("obs must be a contiguous [B, obs_size] float32 "
                         "tensor")
    dims = [obs.shape[1]] + [w.shape[0] for w in weights[:num_hidden]]
    if (not 1 <= num_hidden <= MAX_HIDDEN or max(dims) > MAX_WIDTH
            or weights[-1].shape[0] > MAX_WIDTH):
        raise ValueError(f"K3 takes 1..{MAX_HIDDEN} trunk layers and an "
                         f"action size of width <= {MAX_WIDTH}; got widths "
                         f"{dims}, action size {weights[-1].shape[0]}")
    for t in weights + biases:
        if (t.device != obs.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("policy parameters must be contiguous float32 "
                             f"tensors on {obs.device}")
    return dims


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_policy_forward.argtypes = [
        p, p, p, p, i, i, ctypes.c_float, ctypes.c_float, p, p, i, p]
    lib.fused_policy_forward.restype = ctypes.c_int
    lib.fused_mlp_error_string.argtypes = [ctypes.c_int]
    lib.fused_mlp_error_string.restype = ctypes.c_char_p
    return lib


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ilswiss_tpu_torch.kernels.build import load
        _LIB = _declare(load("fused_mlp"))
    return _LIB


def _launch(lib: ctypes.CDLL, weights, biases, obs: torch.Tensor,
            dims: list[int], stream) -> tuple[torch.Tensor, torch.Tensor]:
    """One call of the library's `fused_policy_forward` on checked inputs
    (B >= 1); returns (mean, log_std).  `lib` is the CUDA library, or in a
    test the CPU build of the same source (kernels/host_build.py)."""
    B, A = obs.shape[0], weights[-1].shape[0]
    mean = torch.empty((B, A), dtype=torch.float32, device=obs.device)
    log_std = torch.empty_like(mean)
    n = len(weights)
    w_ptrs = (ctypes.c_void_p * n)(*[w.data_ptr() for w in weights])
    b_ptrs = (ctypes.c_void_p * n)(*[b.data_ptr() for b in biases])
    c_dims = (ctypes.c_int * len(dims))(*dims)
    err = lib.fused_policy_forward(
        obs.data_ptr(), w_ptrs, b_ptrs, c_dims, n - 2, A, LOG_SIG_MIN,
        LOG_SIG_MAX, mean.data_ptr(), log_std.data_ptr(), B, stream)
    if err != 0:
        raise RuntimeError("fused_policy_forward: "
                           + lib.fused_mlp_error_string(err).decode())
    return mean, log_std


@torch.no_grad()
def fused_gaussian_policy_forward(policy: TanhGaussianPolicy,
                                  obs: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, clamped log_std) [B, A] of `policy` at `obs` [B, obs_size].

    A CPU tensor takes the plain version.  A CUDA tensor launches kernel
    K3 once on the current stream and adds one to
    `fused_gaussian_policy_forward.launches`; it raises if the kernel
    cannot take the shapes or cannot launch."""
    weights, biases = _layers(policy)
    if obs.device.type == "cpu":
        return policy_forward_plain(weights, biases, obs)
    if obs.device.type != "cuda":
        raise ValueError(f"unsupported device {obs.device}")
    dims = _kernel_dims(weights, biases, obs)
    if obs.shape[0] == 0:
        A = weights[-1].shape[0]
        empty = torch.empty((0, A), dtype=torch.float32, device=obs.device)
        return empty, empty.clone()
    stream = torch.cuda.current_stream(obs.device).cuda_stream
    out = _launch(_lib(), weights, biases, obs, dims, stream)
    fused_gaussian_policy_forward.launches += 1
    return out


fused_gaussian_policy_forward.launches = 0
