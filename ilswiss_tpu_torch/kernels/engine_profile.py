"""Where one forward evaluation of the general engine spends its time on
the card (no JAX counterpart: `jax.profiler` does this for the JAX engine).

    python3 -m ilswiss_tpu_torch.kernels.engine_profile

For ant and humanoid at B = 128, float32, 15 sweeps, on one CUDA device it
prints: the device launches of one `forward` and their summed device time
(`torch.profiler`), the wall time of one `forward` and of one control step
(CUDA events around warm calls), the wall time of the engine's pieces
(kinematics, linearization, bias, rows, Cholesky, W), kernel K4's time
alone on that forward's own rows (and on the rows of B = 1024 and 4096
envs, where several warps share an SM), and the ten kernels with the most
device time.  It builds `csrc/pgs.cu` first and needs `nvcc`.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def grounded_state(m, name: str, B: int, seed: int, device,
                   dtype=torch.float32):
    """(q, qd, ctrl, f0) [B, .]: the model's rest pose lowered until feet
    touch the floor, with 0.1 pose noise, an un-normalized quaternion, 0.5
    velocity noise, clipped random controls and small warm-start forces."""
    rng = np.random.RandomState(seed)
    q = m.qpos0 + 0.1 * rng.randn(B, m.nq)
    if name in ("ant", "humanoid"):
        q[:, 2] = (0.45 if name == "ant" else 1.25) + 0.1 * rng.rand(B)
        q[:, 3:7] = (np.array([1.0, 0.0, 0.0, 0.0])
                     + 0.1 * rng.randn(B, 4)) * 1.1
    qd = 0.5 * rng.randn(B, m.nv)
    ctrl = np.clip(rng.randn(B, m.nu), -1.0, 1.0)
    f0 = 0.2 * np.abs(rng.randn(B, m.nrow))
    return tuple(torch.tensor(x, dtype=dtype, device=device)
                 for x in (q, qd, ctrl, f0))


def _k4_alone(m, name: str, envs: int, dev, iters: int):
    """Kernel K4's time on the rows that one forward of `envs` grounded
    envs sets up: (ms, active rows, rows, W's strides)."""
    from ilswiss_tpu_torch.ops import pgs
    from ilswiss_tpu_torch.ops import rigid_body as rb
    q, qd, _, f0 = grounded_state(m, name, envs, 0, dev)
    lin = rb._linearization(m, q)
    M, _ = rb._mass_from(m, lin, q.dtype)
    J, aref, d, active = rb._rows_from(m, lin, q, qd)
    W = rb._cho_solve(torch.linalg.cholesky(M), J.transpose(1, 2))
    dsafe = torch.clamp(d, 1e-4, 1.0 - 1e-6)
    Rreg = (1.0 - dsafe) / dsafe * m.consts(q.dtype, dev).row_diag
    D = torch.sum(J * W.transpose(1, 2), -1) + Rreg
    ms = _time_ms(lambda: pgs.pgs_solve(J, W, Rreg, aref, D, active, f0,
                                        iters), 50)
    return ms, int(active.sum()), active.numel(), tuple(W.stride())


def main() -> int:
    if not torch.cuda.is_available():
        print("engine_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from ilswiss_tpu_torch.envs.locomotion import _model
    from ilswiss_tpu_torch.kernels import build
    from ilswiss_tpu_torch.ops import rigid_body as rb

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(("pgs",))
    dev, B, iters = torch.device("cuda"), 128, 15

    for name in ("ant", "humanoid"):
        m = _model(name)
        q, qd, ctrl, f0 = grounded_state(m, name, B, 0, dev)
        fwd = lambda: rb.forward(m, q, qd, ctrl, iters, f0)
        fwd_ms = _time_ms(fwd, 20)
        step_ms = _time_ms(lambda: rb.physics_step(m, q, qd, ctrl, iters, f0),
                           3, 1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd()
            torch.cuda.synchronize()
        device_events = [e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.device_time for e in device_events)
        print(f"{name}, B = {B}, nv {m.nv}, {m.nrow} rows: one forward is "
              f"{len(device_events)} device launches, {device_us / 1e3:.3f} "
              f"ms of device time, {fwd_ms:.3f} ms of wall time; one control "
              f"step ({m.frame_skip} x {m.integrator}) {step_ms:.1f} ms")

        lin = rb._linearization(m, q)
        M, Iw = rb._mass_from(m, lin, q.dtype)
        L = torch.linalg.cholesky(M)
        J, aref, d, active = rb._rows_from(m, lin, q, qd)
        Jt = J.transpose(1, 2)
        pieces = {
            "kinematics": lambda: rb._kinematics(m, q),
            "linearization (with kinematics)": lambda: rb._linearization(m, q),
            "mass matrix": lambda: rb._mass_from(m, lin, q.dtype),
            "bias": lambda: rb._bias_from(m, lin, Iw, q, qd),
            "rows": lambda: rb._rows_from(m, lin, q, qd),
            "cholesky": lambda: torch.linalg.cholesky(M),
            "W, two triangular solves": lambda: rb._cho_solve(L, Jt),
            "W, cholesky_solve": lambda: torch.cholesky_solve(Jt, L),
        }
        for what, fn in pieces.items():
            print(f"  {what}: {_time_ms(fn, 20):.3f} ms")
        for envs in (B, 1024, 4096):
            k4_ms, n_active, n_rows, strides = _k4_alone(m, name, envs, dev,
                                                         iters)
            print(f"  K4 alone on the rows of {envs} envs ({n_active} of "
                  f"{n_rows} active; W strides {strides}): {k4_ms:.4f} ms")
        rows = sorted(((k.device_time_total, k.count, k.key)
                       for k in prof.key_averages()
                       if k.device_time_total > 0
                       and k.device_type == torch.autograd.DeviceType.CUDA),
                      reverse=True)[:10]
        for us, count, key in rows:
            print(f"    {us:9.1f} us  x{count:<4d} {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
