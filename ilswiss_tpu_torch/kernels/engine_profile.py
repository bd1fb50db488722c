"""Where one forward evaluation of the general engine spends its time on
the card (no JAX counterpart: `jax.profiler` does this for the JAX engine).

    python3 -m ilswiss_tpu_torch.kernels.engine_profile

For ant and humanoid at B = 128, float32, 15 sweeps, on one CUDA device it
prints: the device launches of one `forward` and their summed device time
(`torch.profiler`), the wall time of one `forward` and of one control step
(CUDA events around warm calls), the wall time of the engine's pieces
(kinematics, linearization, bias, rows, Cholesky, W), kernel K4's time
alone on that forward's own rows (and on the rows of B = 1024 and 4096
envs, where several envs share an SM), and the ten kernels with the most
device time.  It builds `csrc/pgs.cu` first and needs `nvcc`.

    python3 -m ilswiss_tpu_torch.kernels.engine_profile --active

prints only how many of the engine's rows are active (gap or limit
violated, the rows K4 has to walk) for ant and humanoid at B = 128: at
`grounded_state`, and at every control step of the main path's warmup
(`make_vec` with the loop's own draws from seed 0, uniform random
actions), as the mean over envs, the max over envs and the share of nr.
It builds nothing; with `--device cpu` it runs on the CPU (for a small
`--envs` and `--steps`).
"""

from __future__ import annotations

import argparse
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


def engine_rows(m, name: str, envs: int, device, iters: int = 15):
    """The arguments (J, W, Rreg, b, D, active, f0) that one `forward` of
    `envs` grounded envs hands its Gauss-Seidel solve: the engine's own rows
    (`_rows_from`) and `_solve_rows`' own W, Rreg, b and D."""
    from ilswiss_tpu_torch.ops import rigid_body as rb
    q, qd, ctrl, f0 = grounded_state(m, name, envs, 0, device)
    seen = []

    def record(J, W, Rreg, b, D, active, f0_, iters_):
        seen.append((J, W, Rreg, b, D, active, f0_))
        return torch.zeros_like(f0_)
    rb.forward(m, q, qd, ctrl, iters, f0, solve=record)
    return seen[0]


def _k4_alone(m, name: str, envs: int, dev, iters: int):
    """Kernel K4's time on the rows that one forward of `envs` grounded
    envs sets up: (ms, active rows, rows, W's strides)."""
    from ilswiss_tpu_torch.ops import pgs
    args = engine_rows(m, name, envs, dev, iters)
    ms = _time_ms(lambda: pgs.pgs_solve(*args, iters), 50)
    return ms, int(args[5].sum()), args[5].numel(), tuple(args[1].stride())


def active_rows(m, q, qd) -> torch.Tensor:
    """The engine's active-row mask [B, nr] at (q, qd): the rows of the
    first `forward` of a control step from that state."""
    from ilswiss_tpu_torch.ops import rigid_body as rb
    return rb._rows_from(m, rb._linearization(m, q), q, qd)[3]


def _census(active: torch.Tensor) -> tuple[float, int, int]:
    """(mean over envs, max over envs, nr) of an active mask [B, nr]."""
    per_env = active.sum(1)
    return float(per_env.float().mean()), int(per_env.max()), active.shape[1]


def active_census(name: str, envs: int, steps: int, device) -> dict:
    """Active-row counts of `name` at `grounded_state` and along `steps`
    warmup control steps of the main path (seed 0, the loop's draws):
    {"grounded": (mean, max, nr), "steps": [(mean, max, nr), ...]}, the
    k-th entry of "steps" taken at the state after k control steps."""
    from ilswiss_tpu_torch.envs import make_vec
    from ilswiss_tpu_torch.runtime.loop import Noise
    vec = make_vec(name, envs, device=device)
    m = vec.env.model
    q, qd, _, _ = grounded_state(m, name, envs, 0, device)
    out = {"grounded": _census(active_rows(m, q, qd)), "steps": []}
    noise = Noise(1, device)      # OffPolicyLoop.init(0)'s draws
    state = vec.reset(noise.reset(vec.env, envs))
    shape = (envs, vec.env.action_size)
    with torch.no_grad():
        for _ in range(steps + 1):
            q, qd, _ = state.internal
            out["steps"].append(_census(active_rows(m, q, qd)))
            state, _ = vec.step(state, noise.warmup_action(shape),
                                noise.reset(vec.env, envs))
    return out


def print_census(envs: int, steps: int, device) -> None:
    for name in ("ant", "humanoid"):
        c = active_census(name, envs, steps, device)
        mean, mx, nr = c["grounded"]
        print(f"{name}, B = {envs}, nr {nr}: grounded_state: mean "
              f"{mean:.2f} active rows an env, max {mx}, share "
              f"{mean / nr:.4f}")
        seq = c["steps"]
        for k in sorted({1, 8, min(39, steps), steps}):
            if k < len(seq):
                mean, mx, _ = seq[k]
                print(f"  after {k} warmup control steps: mean {mean:.2f}, "
                      f"max {mx}, share {mean / nr:.4f}")
        means = [s[0] for s in seq[1:]]
        if means:
            print(f"  over control steps 1..{steps}: mean {np.mean(means):.2f}"
                  f" (share {np.mean(means) / nr:.4f}), largest max "
                  f"{max(s[1] for s in seq[1:])}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--active", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--envs", type=int, default=128)
    ap.add_argument("--steps", type=int, default=39)
    opts = ap.parse_args()
    if opts.active and opts.device == "cpu":
        print_census(opts.envs, opts.steps, torch.device("cpu"))
        return 0
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
    if opts.active:
        print_census(opts.envs, opts.steps, torch.device(opts.device))
        return 0
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
