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

MAX_HIDDEN, MAX_WIDTH = 4, 256


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


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ilswiss_tpu_torch.kernels.build import load
        lib = load("fused_mlp")
        p = ctypes.c_void_p
        lib.fused_policy_forward.argtypes = [
            p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, p, p, ctypes.c_int, p]
        lib.fused_policy_forward.restype = ctypes.c_int
        lib.fused_mlp_error_string.argtypes = [ctypes.c_int]
        lib.fused_mlp_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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
    num_hidden = len(weights) - 2
    dims = [obs.shape[1]] + [w.shape[0] for w in weights[:num_hidden]]
    if obs.dim() != 2 or obs.dtype != torch.float32 or not obs.is_contiguous():
        raise ValueError("obs must be a contiguous [B, obs_size] float32 "
                         "tensor")
    if not 1 <= num_hidden <= MAX_HIDDEN or max(dims) > MAX_WIDTH:
        raise ValueError(f"K3 takes 1..{MAX_HIDDEN} trunk layers of width "
                         f"<= {MAX_WIDTH}; got widths {dims}")
    for t in weights + biases:
        if (t.device != obs.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("policy parameters must be contiguous float32 "
                             f"tensors on {obs.device}")
    B, A = obs.shape[0], weights[-1].shape[0]
    mean = torch.empty((B, A), dtype=torch.float32, device=obs.device)
    log_std = torch.empty_like(mean)
    if B > 0:
        lib = _lib()
        n = len(weights)
        w_ptrs = (ctypes.c_void_p * n)(*[w.data_ptr() for w in weights])
        b_ptrs = (ctypes.c_void_p * n)(*[b.data_ptr() for b in biases])
        c_dims = (ctypes.c_int * len(dims))(*dims)
        stream = torch.cuda.current_stream(obs.device).cuda_stream
        err = lib.fused_policy_forward(
            obs.data_ptr(), w_ptrs, b_ptrs, c_dims, num_hidden, A,
            LOG_SIG_MIN, LOG_SIG_MAX, mean.data_ptr(), log_std.data_ptr(),
            B, stream)
        if err != 0:
            raise RuntimeError("fused_policy_forward: "
                               + lib.fused_mlp_error_string(err).decode())
        fused_gaussian_policy_forward.launches += 1
    return mean, log_std


fused_gaussian_policy_forward.launches = 0
