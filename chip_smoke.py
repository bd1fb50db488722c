#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ilswiss_tpu_torch) on one GPU.

    python3 chip_smoke.py

from the root of a checkout.  It needs one CUDA device and `nvcc`, and
exits non-zero on any failure; no phase catches its own error.

  1. probe: the card's name and power limit; TF32 off for matmuls and cuDNN;
  2. build kernels K1 (csrc/planar_forward.cu), K2 (csrc/fused_sac.cu),
     K3 (csrc/fused_mlp.cu) and K4 (csrc/pgs.cu) from the checkout's sources
     into build/kernels/, one nvcc each, in parallel, printing `-Xptxas -v`;
  3. K1 against its plain PyTorch version on the card: hopper, walker,
     halfcheetah (Euler, damped) and invertedpendulum (no contacts), at
     B = 128 and a ragged B = 100, one control step (one launch of the
     control-step mode against `_control_step` over `_forward_math`) and
     one forward evaluation (the one-evaluation mode against
     `_forward_math`) each at rtol 2e-4, atol 5e-3, and two launches
     bit-equal; times per control step at B = 128 and B = 1024, and per
     evaluation at B = 128;
  4. K3 against its plain version at hopper's (11 -> 256 -> 256 -> 3 + 3),
     ant's (105 -> ... -> 8 + 8) and humanoid's (348 -> ... -> 17 + 17)
     shapes at B = 1, 100, 128 and 1024, rtol = atol = 2e-5; times at
     B = 128 and 1024 (replays of a CUDA graph of 50 calls,
     `kernels/timing.py`: K3 runs shorter than the host takes to issue
     it), each beside a three-addmm PyTorch chain as the yardstick;
  4b. K2 against its plain version in the same mode (bf16 products, the
     default, and float32 products) from the same seeded state and inputs:
     hidden 32, B = 32, K = 3, and full width (256 x 2, B = 512, K = 4) at
     hopper's (11 / 3), ant's (105 / 8) and humanoid's (348 / 17) shapes;
     at the pins of `K2_PINS` in ilswiss_tpu_torch/testing.py (float32:
     those of tests/test_fused_sac.py, parameters and targets rtol 2e-4,
     atol 2e-5; log alpha 1e-5, 1e-6; mu 2e-4, 2e-6; nu 2e-3, 1e-8;
     metrics 5e-4, 5e-5; bf16: the same but mu 2e-2, 2e-5 and nu 1e-2,
     1e-8), counts equal; at full width in bf16 mode the parameters, mu
     and nu under `bf16_gate` instead (per group at most a third as many
     elements outside the pins as the plain float32 mode has against the
     plain bf16 mode, the control, on the same state and inputs), and the
     kernel's float32 mode, held to the plain bf16 mode the same way, must
     fail that gate; full width at K = 128 in each mode:
     every output finite and the drift from the plain version in the same
     mode printed, gated at K2_DRIFT (see there), with the plain version in
     float64 as the yardstick of the float32 mode; two launches bit-equal
     in each mode; times per mode at K = 128 at hopper's and ant's shapes,
     of the plain version and of 128 eager `train_step` calls;
  4c. K4 against its plain version on seeded random problems shaped like the
     engine's (nr / nv / B = 6/4/4, 38/6/9, 116/14/128, 150/23/128, 70% of
     the rows active, 15 sweeps) and on the engine's own rows (what one
     `forward` of grounded ant and humanoid envs hands its solve) at
     B = 128, 1024 and 4096, at rtol 2e-4, atol 1e-4; rows that are not
     active exactly zero, every force >= 0, two launches bit-equal (on
     engine rows where the plain version in float32 itself misses that pin
     against the plain version in float64, the kernel is held instead to
     at most twice the float32 plain version's distance from the float64
     solve, and the line says so); times (CUDA graph replays) at B = 128 on
     the random problems and at every B on the engine's rows, there with
     the active rows an env (mean, max) and the time per row update of the
     longest chain;
  4d. K4 inside the general engine: one `forward` and one control step of
     ant and of humanoid at B = 128 with the kernel, against the same with
     the plain solve named, at rtol 2e-4, atol 5e-3 on values divided by
     max(1, max |plain|) (the float32 pin of tests/test_torch_ant.py); times
     of one ant `forward` and one ant control step;
  5. the slice on a small input (4 envs, 32-wide nets): warmup and two
     training iterations on the card and on the CPU, from the same seed
     and the same draws, agree at rtol 2e-4, atol 5e-3; once with eager
     gradient steps and once with the fused chain in float32 mode (K2 on
     the card, its plain version on the CPU);
  6. SAC-Hopper through `make_vec`, `SAC` and `OffPolicyLoop` at 128 envs,
     batch 512, 256 x 2 nets, a 1M ring and 128 gradient steps per
     iteration, twice: the eager path (`use_fused_act=True`) for warmup and
     2 training iterations, then the main path (`use_fused_act=True,
     use_fused_chain=True`) for warmup and one epoch of 10 iterations.
     Before each, every launch counter is set to 0, and read just after;
     each kernel must have launched exactly as often as the path calls it
     (K1 once per control step), and every metric must be finite;
  7. SAC-Ant through the same entry points at full width (128 envs, batch
     512, 256 x 2 nets, a 1M ring, K = 128, `min_steps_before_training`
     5000 as exp_specs/sac/sac_ant.yaml), the main path only: warmup and 10
     training iterations, with K4 = 20 launches per control step, K2 = 10,
     K3 = 10 and K1 = 0;
  8. SAC-Humanoid through the same entry points on the main path (128
     envs, 256 x 2 nets, batch 512, a 1M ring, K = 128, as
     exp_specs/sac/sac_humanoid.yaml), cut in length to
     `min_steps_before_training` 1024: 8 warmup and 3 training iterations,
     with K4 = 20 launches per control step, K2 = 3, K3 = 3 and K1 = 0.

It prints a JSON line with every kernel's numbers, the card's name and
power limit, and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, dense bf16 on the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
    import torch
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


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS
             ) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_step_work(pm, B: int, iters: int) -> tuple[float, float]:
    """(bytes, flops) of one K1 control step of B envs: q, qd, ctrl and the
    warm-start forces read once, q, qd, qfrc_con, f, q_ev and qd_ev written
    once; the flops of its evaluations (4 per RK4 substep, 1 damped one
    per Euler substep) and of the integrator's combinations."""
    nv, nrow, nu = pm.nv, pm.nrow, len(pm.act_dof)
    euler = pm.integrator == "euler"
    evals = pm.frame_skip * (1 if euler else 4)
    flops = evals * k1_work(pm, B, iters, euler)[1] \
        + pm.frame_skip * B * nv * (4 if euler else 30)
    return 4 * B * ((2 * nv + nu + nrow) + (5 * nv + nrow)), flops


def k1_work(pm, B: int, iters: int, damped: bool) -> tuple[float, float]:
    """(bytes, flops) of one K1 evaluation of B envs, counted from the
    kernel's loops: each input read and each output written once; flops
    of the mass matrix, Cholesky, W solves, row set-up, the PGS sweeps
    and the constraint force."""
    nv, nrow, nu = pm.nv, pm.nrow, len(pm.act_dof)
    nbytes = 4 * B * ((2 * nv + nu + nrow) + (2 * nv + nrow)
                      + (nv if damped else 0))
    ncols = 2 * pm.ncon + len(pm.limit_dofs) + 1 + (1 if damped else 0)
    per_env = (
        6 * sum(len(d) ** 2 for d in pm.dofs_of) / 2     # mass matrix
        + nv ** 3 / 3 * (2 if damped else 1)             # Cholesky
        + ncols * 2 * nv * nv                            # triangular solves
        + nrow * (4 * nv + 20)                           # row set-up
        + nrow * 2 * nv                                  # warm-start u
        + iters * nrow * (4 * nv + 6)                    # PGS sweeps
        + nrow * 2 * nv)                                 # qfrc_con
    return nbytes, per_env * B


def k2_work(B: int, O: int, A: int, H: int, L: int, K: int
            ) -> tuple[float, float, float]:
    """(bytes, product flops, elementwise flops) of one K2 chain of K
    steps, counted from the products of one step (two flops per
    multiply-add): the policy forward on obs and on next_obs; three
    twin-critic forwards (targets, critics, updated critics); the critics'
    weight and input gradients; the input gradient of the updated critics
    down to the action columns; the policy's weight and input gradients;
    and, elementwise in float32, about 12 flops per parameter for Adam and
    Polyak.  Bytes: the state (parameters, targets, moments, alpha) read
    once and written once, the K streamed batches and noise read once, the
    metrics written once."""
    D = O + A
    trunk = (L - 1) * H * H
    policy_fwd = O * H + trunk + 2 * A * H
    critic_fwd = D * H + trunk + H
    macs = B * (2 * policy_fwd
                + 3 * 2 * critic_fwd
                + 2 * (critic_fwd + H + trunk)
                + 2 * (H + trunk + A * H)
                + policy_fwd + 2 * A * H + trunk)
    n_policy = O * H + H + (L - 1) * (H * H + H) + 2 * (A * H + A)
    n_critics = 2 * (D * H + H + (L - 1) * (H * H + H) + H + 1)
    state = 3 * n_policy + 4 * n_critics + 3
    nbytes = 4 * (2 * state + K * B * (2 * O + 3 * A + 2) + K * 8)
    return nbytes, K * 2 * macs, K * 12 * (n_policy + 2 * n_critics)


def k2_bound(B, O, A, H, L, K, bf16: bool) -> tuple[float, str]:
    """K2's bound in one mode: the products' operations over the peak of
    their type (bf16 tensor cores, or float32), plus the elementwise
    float32 operations over the float32 peak, against the bytes."""
    nbytes, prod, elem = k2_work(B, O, A, H, L, K)
    t_ops = (prod / (PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
             + elem / PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# (nv, nrow) of the models whose K4 times are taken, as
# `ilswiss_tpu_torch.envs.locomotion._model(name)` builds them, and the
# sweeps of their env classes
K4_SHAPES = {"ant": (14, 116), "humanoid": (23, 150)}
K4_SWEEPS = 15


def k4_work(nv: int, nrow: int, iters: int, active) -> tuple[float, float]:
    """(bytes, flops) of one K4 solve, counted on this call's data: the
    kernel walks the active rows only, so it must read J and W [nv] and
    four float row vectors of each active row, and the mask of every row
    (one byte), and write f for every row; it computes the warm start u =
    W f0 and, per sweep and active row, a dot J_r . u, the row update and
    u += df W_r.  `active` is the [B, nrow] mask."""
    B = active.shape[0]
    n_act = int(active.sum())
    nbytes = n_act * (4 * 2 * nv + 4 * 4) + B * nrow * (1 + 4)
    flops = 2 * n_act * nv + iters * n_act * (4 * nv + 6)
    return nbytes, flops


# Gate on K2 against its plain version after 128 steps at full width.  At
# K = 4 the two agree at the pins (the bf16 mode at full width under
# `bf16_gate`, ilswiss_tpu_torch/testing.py).  Over 128 steps they drift
# apart by rounding alone: Adam divides each gradient by its own running size, so a
# last-bit difference in a small gradient becomes a difference of up to
# lr in one step of one parameter, and ReLU and min() turn such differences
# into different branches later.  A parameter can move at most K * lr =
# 0.0384 in 128 steps; the gate allows two parameters to drift apart by a
# quarter of that, and the per-step metrics by 2% + 0.02.  That it is
# rounding is shown by a third run, the plain version in float64: the
# kernel must not end farther from it than `f64_factor` times the float32
# plain version does.
K2_DRIFT = {"params": 0.25 * 128 * 3e-4, "metrics_rtol": 2e-2,
            "metrics_atol": 2e-2, "f64_factor": 4.0}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "ilswiss_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(ilswiss_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    # ---- 1. probe ------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 2. build ------------------------------------------------------
    from ilswiss_tpu_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(built)}")
    for b in built.values():
        print(f"--- nvcc {b.name}.cu ({b.seconds:.2f} s) ---")
        print(b.log.strip())

    from ilswiss_tpu_torch.envs.locomotion import _model
    from ilswiss_tpu_torch.kernels.engine_profile import (
        engine_rows, grounded_state,
    )
    from ilswiss_tpu_torch.kernels.redesign_sweep import (
        pin_share, random_rows)
    from ilswiss_tpu_torch.kernels.timing import graph_ms
    from ilswiss_tpu_torch.ops import fused_mlp, fused_sac, pgs
    from ilswiss_tpu_torch.ops import planar_dynamics as pd
    from ilswiss_tpu_torch.ops import rigid_body as rb
    from ilswiss_tpu_torch.testing import (
        GATED, K2_PINS, bf16_gate, float32_chain, k2_groups,
    )
    k1 = pd.planar_forward
    k2 = fused_sac.fused_sac_chain
    k3 = fused_mlp.fused_gaussian_policy_forward
    k4 = pgs.pgs_solve
    gen = torch.Generator().manual_seed(0)

    # ---- 3. K1 vs its plain version --------------------------------------
    import numpy as np

    def k1_inputs(m, B):
        q = torch.tensor(m.qpos0, dtype=torch.float32)[:, None] \
            + 0.1 * torch.randn(m.nq, B, generator=gen)
        qd = 0.3 * torch.randn(m.nv, B, generator=gen)
        ctrl = torch.randn(m.nu, B, generator=gen).clamp(-1.0, 1.0)
        f0 = 0.2 * torch.randn(m.nrow, B, generator=gen).abs()
        return [x.to(dev).contiguous() for x in (q, qd, ctrl, f0)]

    def plain_fwd(pm, iters):
        def fwd(q, qd, c, f, damped):
            return pd._forward_math(pm, q, qd, c, f, iters,
                                    pm.timestep if damped else None)
        return fwd

    def kernel_fwd(pm, iters):
        def fwd(q, qd, c, f, damped):
            return k1(pm, q, qd, c, f, iters, damped)
        return fwd

    def max_err(got, want):
        return max((float((g - w).abs().max()) for g, w in zip(got, want)
                    if g.numel()), default=0.0)

    def check(what, got, want, rtol, atol):
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.isfinite(g).all():
                fail(f"{what}: output {i} is not finite")
            if not torch.allclose(g, w, rtol=rtol, atol=atol):
                err = float((g - w).abs().max())
                fail(f"{what}: output {i} differs by {err:.3g} "
                     f"(max |plain| {float(w.abs().max()):.3g})")

    iters = 15
    k1s = pd.planar_control_step
    flat = lambda s: [s[0], s[1], s[2], s[3], s[4][0], s[4][1]]
    hopper_err = None
    for name in ("hopper", "walker", "halfcheetah", "invertedpendulum"):
        m = _model(name)
        pm = pd.planar_model(m)
        damped = pm.integrator == "euler"
        for B in (128, 100):
            q, qd, ctrl, f0 = k1_inputs(m, B)
            got = k1(pm, q, qd, ctrl, f0, iters, damped)
            torch.cuda.synchronize()
            want = plain_fwd(pm, iters)(q, qd, ctrl, f0, damped)
            check(f"K1 {name} B={B} forward", got, want, 2e-4, 5e-3)
            err_f = max_err(got, want)
            got_s = k1s(pm, q, qd, ctrl, f0, iters)
            torch.cuda.synchronize()
            want_s = pd._control_step(pm, plain_fwd(pm, iters),
                                      q, qd, ctrl, f0)
            check(f"K1 {name} B={B} control step", flat(got_s),
                  flat(want_s), 2e-4, 5e-3)
            if not all(torch.equal(a, b) for a, b in zip(
                    flat(got_s), flat(k1s(pm, q, qd, ctrl, f0, iters)))):
                fail(f"K1 {name} B={B}: two launches differ")
            err_s = max_err(flat(got_s), flat(want_s))
            print(f"K1 {name:16s} B={B:4d}: forward max |err| {err_f:.3g}, "
                  f"control step ({pm.frame_skip} x {pm.integrator}, one "
                  f"launch) max |err| {err_s:.3g}; two launches bit-equal")
            if name == "hopper" and B == 128:
                hopper_err = err_s

    hop = pd.planar_model(_model("hopper"))
    k1_times = {}
    for B in (128, 1024):
        q, qd, ctrl, f0 = k1_inputs(_model("hopper"), B)
        k1_times[B] = time_ms(lambda: k1s(hop, q, qd, ctrl, f0, iters), 50)
    q, qd, ctrl, f0 = k1_inputs(_model("hopper"), 128)
    k1_eval_ms = time_ms(lambda: k1(hop, q, qd, ctrl, f0, iters, False), 200)
    k1_plain_ms = time_ms(lambda: pd._control_step(
        hop, plain_fwd(hop, iters), q, qd, ctrl, f0), 2, 1)
    k1_bound = bound_ms(*k1_step_work(hop, 128, iters))
    # the PGS sweep's share, and the other layout it could have had: K1
    # keeps one thread per env with u in registers; K4 4 lanes per env at
    # B = 128 (every row active here), on hopper's row shape (38 rows, nv 6)
    k1_no_pgs_ms = time_ms(lambda: k1s(hop, q, qd, ctrl, f0, 0), 50)
    rng_l = np.random.RandomState(38)
    J = torch.tensor(rng_l.randn(128, 38, 6), dtype=torch.float32, device=dev)
    W = torch.tensor(rng_l.randn(128, 6, 38), dtype=torch.float32,
                     device=dev) * 0.1
    row = lambda: torch.tensor(rng_l.uniform(0.1, 1.0, (128, 38)),
                               dtype=torch.float32, device=dev)
    pgs_args = (J, W, row(), row(), row() + 1.0,
                torch.ones(128, 38, dtype=torch.bool, device=dev), row())
    k4_hopper_rows_ms = time_ms(lambda: k4(*pgs_args, 15 * 16), 20)
    print(f"K1 hopper control step (16 evaluations, one launch): "
          f"{k1_times[128]:.4f} ms at B=128, {k1_times[1024]:.4f} ms at "
          f"B=1024; one evaluation {k1_eval_ms:.4f} ms at B=128; plain "
          f"control step {k1_plain_ms:.2f} ms at B=128; bound "
          f"{k1_bound[0]:.6f} ms ({k1_bound[1]}) per control step at B=128")
    print(f"K1 PGS layouts, hopper rows (38 x nv 6), B=128, the 16 x 15 "
          f"sweeps of one control step: one thread per env (K1 with 15 "
          f"sweeps less K1 with none) {k1_times[128] - k1_no_pgs_ms:.4f} ms; "
          f"4 lanes per env (K4, 240 sweeps in one launch) "
          f"{k4_hopper_rows_ms:.4f} ms")

    # ---- 4. K3 vs its plain version ----------------------------------------
    from ilswiss_tpu_torch.models.policies import TanhGaussianPolicy

    def three_addmm(weights, biases, obs):
        """The yardstick: three addmm (both heads in one), ReLUs, the
        clamp; the port never calls it."""
        A = weights[-1].shape[0]
        w_heads = torch.cat(weights[2:]).t().contiguous()
        b_heads = torch.cat(biases[2:])
        w0, w1 = weights[0].t(), weights[1].t()

        def run():
            h = torch.relu(torch.addmm(biases[0], obs, w0))
            h = torch.relu(torch.addmm(biases[1], h, w1))
            out = torch.addmm(b_heads, h, w_heads)
            return out[:, :A], out[:, A:].clamp(-20.0, 2.0)
        return run

    k3_times = {}
    k3_err = {}
    for shape, (n_obs, n_act) in {"hopper": (11, 3), "ant": (105, 8),
                                  "humanoid": (348, 17)}.items():
        policy = TanhGaussianPolicy(n_obs, n_act, (256, 256), gen).to(dev)
        weights, biases = fused_mlp._layers(policy)
        weights = [w.detach() for w in weights]
        biases = [b.detach() for b in biases]
        errs = []
        for B in (1, 100, 128, 1024):
            obs = torch.randn(B, n_obs, generator=gen).to(dev)
            got = k3(policy, obs)
            torch.cuda.synchronize()
            with torch.no_grad():
                want = fused_mlp.policy_forward_plain(weights, biases, obs)
            check(f"K3 {shape} B={B}", got, want, 2e-5, 2e-5)
            errs.append(f"B={B} {max_err(got, want):.3g}")
            if B == 128:
                k3_err[shape] = max_err(got, want)
            if B in (128, 1024):
                with torch.no_grad():
                    k3_times[shape, B] = (
                        graph_ms(lambda: k3(policy, obs)),
                        graph_ms(lambda: fused_mlp.policy_forward_plain(
                            weights, biases, obs)),
                        graph_ms(three_addmm(weights, biases, obs)),
                        time_ms(lambda: k3(policy, obs), 200))
        n_w = sum(w.numel() + b.numel() for w, b in zip(weights, biases))
        bound = bound_ms(4 * (n_w + 128 * n_obs + 2 * 128 * n_act),
                         2 * 128 * sum(w.numel() for w in weights))
        k3_times[shape, "bound"] = bound
        t128, t1024 = k3_times[shape, 128], k3_times[shape, 1024]
        print(f"K3 {shape} ({n_obs} -> 256 -> 256 -> {n_act} + {n_act}): max "
              f"|err| {', '.join(errs)} (2e-5); at B=128 (CUDA graph): "
              f"{t128[0]:.4f} ms, plain version {t128[1]:.4f} ms, "
              f"three-addmm chain {t128[2]:.4f} ms, bound {bound[0]:.6f} ms "
              f"({bound[1]}), wall time of a call {t128[3]:.4f} ms; at "
              f"B=1024: {t1024[0]:.4f} ms, three-addmm chain {t1024[2]:.4f} "
              f"ms; on {card}")
    k3_ms, k3_plain_ms, k3_library_ms, k3_wall_ms = k3_times["hopper", 128]
    k3_bound = k3_times["hopper", "bound"]

    # ---- 4b. K2 vs its plain version --------------------------------------
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig

    def k2_case(n_obs, n_act, width, B, K):
        """A trainer, two identical seeded states and one set of [K, B, ...]
        inputs on the card."""
        sac_ = SAC(n_obs, n_act, SACConfig(), net_size=width,
                   num_hidden_layers=2)
        g = torch.Generator().manual_seed(K * 1000 + B)
        draw = lambda *shape: torch.randn(*shape, generator=g).to(dev)
        batches = {"obs": draw(K, B, n_obs),
                   "action": torch.tanh(draw(K, B, n_act)),
                   "reward": draw(K, B),
                   "terminal": (draw(K, B) > 1.0).float(),
                   "next_obs": draw(K, B, n_obs)}
        return (sac_, sac_.init(1), sac_.init(1), batches,
                draw(K, B, n_act), draw(K, B, n_act))

    bf16, f32 = torch.bfloat16, torch.float32
    mode_name = {bf16: "bf16", f32: "float32"}
    plain_chain = fused_sac.fused_sac_chain_plain

    def k2_modes(what, n_obs, n_act, width, B, K):
        """K2 against its plain version in each mode, from one seeded state
        and one set of inputs: every group at the mode's pins, but in bf16
        mode at widths over 32 the parameters, mu and nu under
        `bf16_gate`, with the plain float32 mode as its control; and the
        float32 mode held against the plain bf16 mode the same way must
        fail that gate.  Returns max |kernel - plain| per mode and group."""
        sac_, _, _, batches, e_next, e_new = k2_case(n_obs, n_act, width,
                                                     B, K)
        runs = {}
        for who, chain in (("kernel", k2), ("plain", plain_chain)):
            for dt in (bf16, f32):
                st, m = chain(sac_, sac_.init(1), batches, e_next, e_new, dt)
                torch.cuda.synchronize()
                if any(o.count != K for o in (st.policy_opt, st.qf_opt,
                                              st.alpha_opt)):
                    fail(f"K2 {what}: Adam counts are not {K}")
                runs[who, dt] = k2_groups(st, m)
        gated = width > 32
        errs = {}
        for dt in (bf16, f32):
            got, want = runs["kernel", dt], runs["plain", dt]
            for name in got:
                label = f"K2 {mode_name[dt]} {what} {name}"
                if dt == bf16 and gated and name in GATED:
                    if not all(bool(torch.isfinite(g).all())
                               for g in got[name]):
                        fail(f"{label}: not finite")
                else:
                    check(label, got[name], want[name], *K2_PINS[dt][name])
            errs[dt] = {n: max_err(got[n], want[n]) for n in got}
            print(f"K2 {mode_name[dt]} {what}: max |kernel - plain| "
                  + ", ".join(f"{n} {e:.3g}" for n, e in errs[dt].items()))
        if gated:
            control = runs["plain", f32]
            for dt, must_pass in ((bf16, True), (f32, False)):
                gate = bf16_gate(runs["kernel", dt], runs["plain", bf16],
                                 control)
                passed = all(ok for _, _, ok in gate.values())
                print(f"K2 {what}: bf16 gate on the kernel's "
                      f"{mode_name[dt]} mode against the plain bf16 mode: "
                      + ", ".join(f"{g} {n} outside (control {c})"
                                  for g, (n, c, _) in gate.items())
                      + f"; {'passes' if passed else 'fails'}")
                if passed != must_pass:
                    fail(f"K2 {what}: the bf16 gate "
                         f"{'fails' if must_pass else 'passes'} the "
                         f"{mode_name[dt]} mode")
        return errs

    def k2_drift(dt):
        """The kernel and the plain version in mode `dt` after K = 128
        steps at the hopper shape: every output finite, the drift gated at
        K2_DRIFT.  Returns the two runs' `k2_groups`."""
        sac_, st_k, st_p, batches, e_next, e_new = k2_case(11, 3, 256, 512,
                                                           128)
        got = k2_groups(*k2(sac_, st_k, batches, e_next, e_new, dt))
        torch.cuda.synchronize()
        want = k2_groups(*plain_chain(sac_, st_p, batches, e_next, e_new,
                                      dt))
        for name in got:
            if not all(bool(torch.isfinite(g).all()) for g in got[name]):
                fail(f"K2 {mode_name[dt]} K=128: {name} is not finite")
        drift = {n: max_err(got[n], want[n]) for n in got}
        print(f"K2 {mode_name[dt]} hopper shape, 256x2, B=512, K=128 "
              f"(drift): max |kernel - plain| "
              + ", ".join(f"{n} {e:.3g}" for n, e in drift.items()))
        if max(drift["params"], drift["log_alpha"]) > K2_DRIFT["params"]:
            fail(f"K2 {mode_name[dt]} drifts from its plain version by "
                 f"{drift['params']:.3g} in 128 steps, over "
                 f"{K2_DRIFT['params']:.3g}")
        check(f"K2 {mode_name[dt]} K=128 metrics", got["metrics"],
              want["metrics"], K2_DRIFT["metrics_rtol"],
              K2_DRIFT["metrics_atol"])
        return got, want

    k2_modes("hidden 32, B=32, K=3", 5, 2, 32, 32, 3)
    shapes = {"hopper": (11, 3), "ant": (105, 8), "humanoid": (348, 17)}
    for shape, (n_obs, n_act) in shapes.items():
        errs = k2_modes(f"{shape} shape {n_obs}/{n_act}, 256x2, B=512, K=4",
                        n_obs, n_act, 256, 512, 4)
        if shape == "hopper":
            k2_err = {dt: max(errs[dt][n] for n in ("params", "log_alpha",
                                                    "mu", "nu"))
                      for dt in (bf16, f32)}
    k2_drift(bf16)
    f32_got, f32_want = k2_drift(f32)

    # the float32 mode's 128 steps by the plain version in float64
    sac_d, st_d, _, batches_d, e_next_d, e_new_d = k2_case(11, 3, 256, 512,
                                                           128)
    for module in (st_d.policy, st_d.qf, st_d.target_qf):
        module.double()
    st_d.log_alpha.data = st_d.log_alpha.data.double()
    for opt in (st_d.policy_opt, st_d.qf_opt, st_d.alpha_opt):
        opt.mu = [m.double() for m in opt.mu]
        opt.nu = [v.double() for v in opt.nu]
    st_d, _ = plain_chain(
        sac_d, st_d, {n: v.double() for n, v in batches_d.items()},
        e_next_d.double(), e_new_d.double(), torch.float32)
    truth = k2_groups(st_d)["params"]
    kernel_off = max_err([g.double() for g in f32_got["params"]], truth)
    plain_off = max_err([w.double() for w in f32_want["params"]], truth)
    print(f"K2 float32 256x2, B=512, K=128: parameters against the float64 "
          f"plain version: kernel {kernel_off:.3g}, float32 plain version "
          f"{plain_off:.3g}")
    if kernel_off > K2_DRIFT["f64_factor"] * plain_off + 1e-6:
        fail(f"K2 ends {kernel_off:.3g} from the float64 result, the "
             f"float32 plain version {plain_off:.3g}")

    # two launches bit-equal, and times per mode at K = 128
    k2_ms = {}
    for shape in ("hopper", "ant"):
        n_obs, n_act = shapes[shape]
        sac2, st2, st3, batches2, e_next2, e_new2 = k2_case(n_obs, n_act, 256,
                                                            512, 128)
        for dt in (bf16, f32):
            if shape == "hopper":
                a_, b_ = sac2.init(1), sac2.init(1)
                m_a = k2(sac2, a_, batches2, e_next2, e_new2, dt)[1]
                m_b = k2(sac2, b_, batches2, e_next2, e_new2, dt)[1]
                same = all(torch.equal(x, y) for x, y in zip(
                    k2_groups(a_)["params"], k2_groups(b_)["params"]))
                same = same and all(torch.equal(m_a[n], m_b[n])
                                    for n in m_a)
                if not same:
                    fail(f"K2 {mode_name[dt]}: two launches differ")
                del a_, b_
            k2_ms[shape, dt] = time_ms(
                lambda: k2(sac2, st2, batches2, e_next2, e_new2, dt), 5, 1)
        if shape == "hopper":
            k2_plain_ms = time_ms(lambda: fused_sac.fused_sac_chain_plain(
                sac2, st3, batches2, e_next2, e_new2), 2, 1)

            def eager_128():
                for k in range(128):
                    sac2.train_step(st3, {n: v[k] for n, v in batches2.items()},
                                    e_next2[k], e_new2[k])
            k2_eager_ms = time_ms(eager_128, 2, 1)
        del sac2, st2, st3, batches2, e_next2, e_new2
    k2_bounds = {(shape, dt): k2_bound(512, *shapes[shape], 256, 2, 128,
                                       dt == bf16)
                 for shape in ("hopper", "ant") for dt in (bf16, f32)}
    print("K2 two launches bit-equal in each mode (hopper shape, K=128)")
    for (shape, dt), ms in k2_ms.items():
        b = k2_bounds[shape, dt]
        print(f"K2 {mode_name[dt]} {shape} shape, 256x2, B=512, K=128: "
              f"{ms:.3f} ms per chain ({ms / 128 * 1e3:.1f} us per step); "
              f"bound {b[0]:.4f} ms ({b[1]}); on {card}")
    print(f"K2 plain version (bf16 mode, hopper shape, K=128) "
          f"{k2_plain_ms:.1f} ms; 128 eager train_step calls on the same "
          f"batches {k2_eager_ms:.1f} ms ({k2_eager_ms / 128:.3f} ms per "
          f"step)")

    # ---- 4c. K4 vs its plain version --------------------------------------
    def k4_case(what, args, time_it, f64_yardstick=False):
        """K4 against its plain version on `args` at 15 sweeps: rtol 2e-4,
        atol 1e-4, inactive rows exactly zero, forces >= 0, two launches
        bit-equal.  With `f64_yardstick`, rows on which the plain version
        in float32 itself misses that pin against the plain version in
        float64 (the engine's rows of thousands of envs, where forces reach
        1e3 and a float32 solve drifts by 1e-3) hold the kernel to the
        float64 solve instead, element by element: its pin share there
        (the largest |got - want| / (1e-4 + 2e-4 |want|)) no more than
        twice the float32 plain version's, so a small force is held to its
        own scale.  Returns (max |err|, ms, plain ms, bound, rule) with the
        times when `time_it`."""
        got = k4(*args, K4_SWEEPS)
        torch.cuda.synchronize()
        want = pgs.pgs_solve_plain(*args, K4_SWEEPS)
        rule = "pin"
        if f64_yardstick:
            want64 = pgs.pgs_solve_plain(
                *(x.double() if x.is_floating_point() else x for x in args),
                K4_SWEEPS)
            plain_share = pin_share(want, want64)
            if plain_share > 1.0:
                kernel_share = pin_share(got, want64)
                plain_off = float((want.double() - want64).abs().max())
                kernel_off = float((got.double() - want64).abs().max())
                rule = (f"float64 yardstick, element-wise (pin share against "
                        f"it: the float32 plain version {plain_share:.3g}, "
                        f"outside the pin, the kernel {kernel_share:.3g}; "
                        f"max |err| {plain_off:.3g} and {kernel_off:.3g})")
                if not torch.isfinite(got).all() or \
                        kernel_share > 2.0 * plain_share:
                    fail(f"{what}: pin share {kernel_share:.3g} against the "
                         f"float64 solve, over twice the float32 plain "
                         f"version's {plain_share:.3g}")
        if rule == "pin":
            check(what, [got], [want], 2e-4, 1e-4)
        if not bool((got[~args[5]] == 0.0).all()) or not bool(
                (got >= 0.0).all()):
            fail(f"{what}: an inactive row is not zero, or a force is "
                 f"negative")
        if not torch.equal(got, k4(*args, K4_SWEEPS)):
            fail(f"{what}: two launches differ")
        err = max_err([got], [want])
        if not time_it:
            return err, None, None, None, rule
        B, nr, nv = args[0].shape
        ms = graph_ms(lambda: k4(*args, K4_SWEEPS))
        plain_ms = time_ms(lambda: pgs.pgs_solve_plain(*args, K4_SWEEPS), 2, 1)
        return err, ms, plain_ms, bound_ms(*k4_work(nv, nr, K4_SWEEPS,
                                                    args[5])), rule

    k4_stats = {}
    for nr, nv, B in ((6, 4, 4), (38, 6, 9), (116, 14, 128), (150, 23, 128)):
        args = random_rows(nr, nv, B, dev)
        err, ms, plain_ms, bound, _ = k4_case(f"K4 {nr}/{nv}/{B}", args,
                                              B == 128)
        line = f"K4 nr={nr:3d} nv={nv:2d} B={B:3d}: max |err| {err:.3g}"
        if B == 128:
            k4_stats[(nv, nr)] = (err, ms, plain_ms, bound)
            line += (f" (70% of rows active); {ms:.4f} ms per launch, plain "
                     f"version {plain_ms:.1f} ms, bound {bound[0]:.6f} ms "
                     f"({bound[1]})")
        print(line)

    # K4 on the engine's own rows: what one `forward` of grounded envs hands
    # its solve (`_rows_from`, `_solve_rows`' own W, Rreg, b and D)
    k4_engine = {}
    for name in K4_SHAPES:
        m = _model(name)
        for B in (128, 1024, 4096):
            args = engine_rows(m, name, B, dev, K4_SWEEPS)
            err, ms, plain_ms, bound, rule = k4_case(
                f"K4 {name} engine rows B={B}", args, True, True)
            per_env = args[5].sum(1)
            mean_act, max_act = float(per_env.float().mean()), int(
                per_env.max())
            ns = ms * 1e6 / (K4_SWEEPS * max(1, max_act))
            k4_engine[name, B] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "active_mean": mean_act, "active_max": max_act,
                "ns_per_row_update": ns}
            print(f"K4 {name} engine rows (nr {m.nrow}, nv {m.nv}), B={B}: "
                  f"max |err| {err:.3g}; active rows an env mean "
                  f"{mean_act:.2f}, max {max_act}; {ms:.4f} ms per launch "
                  f"({ns:.1f} ns per row update of the longest chain, "
                  f"{K4_SWEEPS} x {max_act}), plain version {plain_ms:.1f} "
                  f"ms, bound {bound[0]:.6f} ms ({bound[1]}); held at the "
                  f"{rule}; on {card}")

    del args  # the engine's rows of 4096 envs

    # ---- 4d. K4 inside the general engine ----------------------------------
    def scaled_check(what, got, want):
        """rtol 2e-4, atol 5e-3 on values divided by max(1, max |plain|)."""
        worst = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.isfinite(g).all():
                fail(f"{what}: output {i} is not finite")
            scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
            if not torch.allclose(g / scale, w / scale, rtol=2e-4, atol=5e-3):
                fail(f"{what}: output {i} differs by "
                     f"{float((g - w).abs().max()):.3g} (max |plain| "
                     f"{float(w.abs().max()):.3g})")
            if w.numel():
                worst = max(worst, float((g - w).abs().max()) / scale)
        return worst

    flat = lambda s: [s[0], s[1], s[2], s[3], s[4][0], s[4][1]]
    engine_ms = {}
    for name in K4_SHAPES:
        m = _model(name)
        q, qd, ctrl, f0 = grounded_state(m, name, 128, 0, dev)
        got = rb.forward(m, q, qd, ctrl, K4_SWEEPS, f0)
        torch.cuda.synchronize()
        want = rb.forward(m, q, qd, ctrl, K4_SWEEPS, f0,
                          solve=pgs.pgs_solve_plain)
        err_f = scaled_check(f"engine {name} forward", got, want)
        got_s = rb.physics_step(m, q, qd, ctrl, K4_SWEEPS, f0)
        torch.cuda.synchronize()
        want_s = rb.physics_step(m, q, qd, ctrl, K4_SWEEPS, f0,
                                 solve=pgs.pgs_solve_plain)
        err_s = scaled_check(f"engine {name} control step", flat(got_s),
                             flat(want_s))
        active = int((want[4] > 0).sum())
        engine_ms[name] = (
            time_ms(lambda: rb.forward(m, q, qd, ctrl, K4_SWEEPS, f0), 20),
            time_ms(lambda: rb.physics_step(m, q, qd, ctrl, K4_SWEEPS, f0),
                    3, 1))
        print(f"engine {name} B=128, kernel vs plain solve ({active} rows "
              f"carry force): forward max scaled |err| {err_f:.3g}, control "
              f"step ({m.frame_skip} x {m.integrator}) {err_s:.3g}; one "
              f"forward {engine_ms[name][0]:.3f} ms, one control step "
              f"{engine_ms[name][1]:.1f} ms (wall, by CUDA events)")

    # ---- 5. the slice on a small input: card vs CPU -----------------------
    from ilswiss_tpu_torch.envs import make_vec
    from ilswiss_tpu_torch.runtime.loop import (
        Noise, OffPolicyConfig, OffPolicyLoop,
    )

    class CopiedNoise:
        """Draws on a CPU generator and hands copies to `device`, so a
        loop on the card and one on the CPU get the same draws."""

        def __init__(self, seed, cpu_env, device):
            self.noise, self.cpu_env, self.device = (
                Noise(seed, "cpu"), cpu_env, device)

        def warmup_action(self, shape):
            return self.noise.warmup_action(shape).to(self.device)

        def act(self, shape):
            return self.noise.act(shape).to(self.device)

        def reset(self, env, n):
            return tuple(x.to(self.device)
                         for x in self.noise.reset(self.cpu_env, n))

        def replay(self, batch_size):
            return self.noise.replay(batch_size).to(self.device)

        def train(self, shape):
            return tuple(x.to(self.device) for x in self.noise.train(shape))

    small = OffPolicyConfig(batch_size=16, replay_capacity=256,
                            min_steps_before_training=8,
                            grad_steps_per_iter=4)

    def small_slice(where, fused):
        v = make_vec("hopper", 4, device=where)
        a = SAC(11, 3, SACConfig(), net_size=32, num_hidden_layers=2,
                use_fused_act=True, use_fused_chain=fused, device=where)
        lp = OffPolicyLoop(v, a, small)
        cpu_env = make_vec("hopper", 4, device="cpu").env
        r = lp.warmup(lp.init(0, noise=CopiedNoise(1, cpu_env, where)))
        return lp.train_epoch(r, steps_per_epoch=8)

    # the fused chain in float32 mode: the CPU's float32 plain version and
    # the card's kernel are compared at float32's pins
    with float32_chain():
        for fused in (False, True):
            k2.launches = 0
            rg, mg = small_slice("cuda", fused)
            rc, mc = small_slice("cpu", fused)
            if k2.launches != (2 if fused else 0):
                fail(f"small slice, fused={fused}: K2 launched "
                     f"{k2.launches} times")
            pairs = [(rg.env_state.obs, rc.env_state.obs)]
            pairs += list(zip(rg.env_state.internal, rc.env_state.internal))
            pairs += [(rg.replay.data[k], rc.replay.data[k])
                      for k in rc.replay.data]
            pairs += list(zip(k2_groups(rg.algo_state)["params"],
                              k2_groups(rc.algo_state)["params"]))
            slice_err = 0.0
            for x, y in pairs:
                x = x.detach().cpu()
                y = y.detach()
                if not torch.allclose(x, y, rtol=2e-4, atol=5e-3):
                    fail(f"slice on the card differs from the CPU run by "
                         f"{float((x - y).abs().max()):.3g}")
                slice_err = max(slice_err, float((x - y).abs().max()))
            for k in mc:
                if not math.isclose(mg[k], mc[k], rel_tol=2e-4,
                                    abs_tol=5e-3):
                    fail(f"metric {k}: {mg[k]} on the card, {mc[k]} on "
                         f"the CPU")
            if (rg.replay.ptr, rg.replay.size) != (rc.replay.ptr,
                                                   rc.replay.size):
                fail("replay cursors differ")
            print(f"slice, 4 envs, 2 warmup + 2 training iterations, "
                  f"{'fused chain, float32' if fused else 'eager steps'}: "
                  f"card vs CPU max |err| {slice_err:.3g} (rtol 2e-4, atol "
                  f"5e-3)")

    # ---- 6. SAC-Hopper at full width: the eager path, then the main path --
    num_envs = 128

    def drive(env_name, fused, train_iters, min_steps=5_000):
        """Warmup and `train_iters` training iterations from seed 0, with
        every launch count set to 0 just before and read just after."""
        config = OffPolicyConfig(batch_size=512, replay_capacity=1_000_000,
                                 min_steps_before_training=min_steps,
                                 grad_steps_per_iter=128)
        warmup_iters = max(1, min_steps // num_envs)
        held = torch.cuda.memory_allocated()  # what earlier phases left
        vec = make_vec(env_name, num_envs)
        model = vec.env.model
        sac = SAC(vec.env.observation_size, vec.env.action_size, SACConfig(),
                  net_size=256, num_hidden_layers=2, use_fused_act=True,
                  use_fused_chain=fused)
        loop = OffPolicyLoop(vec, sac, config)
        runner = loop.init(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.launches = k1s.launches = k2.launches = k3.launches = 0
        k4.launches = 0
        t0 = time.perf_counter()
        runner = loop.warmup(runner)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runner, metrics = loop.train_epoch(runner, train_iters * num_envs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {"planar_control_step": k1s.launches,
                    "planar_forward": k1.launches,
                    "fused_sac_chain": k2.launches,
                    "fused_policy_forward": k3.launches,
                    "pgs_solve": k4.launches}

        what = f"{env_name} {'main path' if fused else 'eager path'}"
        control_steps = warmup_iters + train_iters
        # K1 once per control step on a planar model; K4 once per forward
        # evaluation (4 RK4 evaluations per substep) on any other
        evaluations = 4 * model.frame_skip * control_steps
        planar = pd.planar_model(model) is not None
        want = {"planar_control_step": control_steps if planar else 0,
                "planar_forward": 0,
                "fused_sac_chain": train_iters if fused else 0,
                "fused_policy_forward": train_iters,
                "pgs_solve": 0 if planar else evaluations}
        if launches != want:
            fail(f"{what}: launches {launches}, expected {want} (K1 one per "
                 f"control step, K4 {4 * model.frame_skip} per control step, "
                 f"K3 one per acting call, K2 one per fused training "
                 f"iteration)")
        bad = [k for k, v in metrics.items() if not math.isfinite(v)]
        if bad or set(metrics) != set(fused_sac.METRIC_NAMES):
            fail(f"{what}: metrics {sorted(metrics)}, non-finite {bad}")
        obs = runner.env_state.obs
        if tuple(obs.shape) != (num_envs, vec.env.observation_size) \
                or not torch.isfinite(obs).all():
            fail(f"{what}: env observations are not finite "
                 f"[{num_envs}, {vec.env.observation_size}]")
        if runner.total_env_steps != control_steps * num_envs \
                or runner.replay.size != control_steps * num_envs:
            fail(f"{what}: env-step or replay counts are wrong")
        if runner.algo_state.policy_opt.count != 128 * train_iters:
            fail(f"{what}: the policy took "
                 f"{runner.algo_state.policy_opt.count} gradient steps")
        rate = train_iters * num_envs / (t2 - t1)
        print(f"{what}: warmup {warmup_iters} iterations in {t1 - t0:.2f} s "
              f"({warmup_iters * num_envs / (t1 - t0):.1f} env-steps/s), "
              f"training {train_iters} iterations of 128 grad steps in "
              f"{t2 - t1:.3f} s ({(t2 - t1) / train_iters * 1e3:.1f} ms per "
              f"iteration, {rate:.1f} env-steps/s), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
              f"({(torch.cuda.max_memory_allocated() - held) / 2**20:.1f} "
              f"MiB above the {held / 2**20:.1f} MiB that earlier phases "
              f"left allocated), on {card}")
        print(f"{what} metrics: "
              + json.dumps({k: round(v, 6) for k, v in metrics.items()}))
        print(f"launches on the {what}: {json.dumps(launches)}")
        return launches

    drive("hopper", fused=False, train_iters=2)
    hopper_launches = drive("hopper", fused=True, train_iters=10)

    # ---- 7. SAC-Ant at full width ------------------------------------------
    ant_launches = drive("ant", fused=True, train_iters=10)

    # ---- 8. SAC-Humanoid at full width, cut in length ----------------------
    humanoid_launches = drive("humanoid", fused=True, train_iters=3,
                              min_steps=1024)

    ant_k4 = k4_engine["ant", 128]
    kernels = [
        {"name": "planar_forward", "route": "cuda",
         "source": "ilswiss_tpu_torch/csrc/planar_forward.cu",
         "replaces": "ilswiss_tpu/ops/planar_dynamics.py:694",
         "launches": hopper_launches["planar_control_step"],
         "max_abs_err": hopper_err, "ms": k1_times[128],
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None,
         "ms_per_evaluation": k1_eval_ms, "ms_b1024": k1_times[1024]},
        {"name": "fused_sac_chain", "route": "cuda",
         "source": "ilswiss_tpu_torch/csrc/fused_sac.cu",
         "replaces": "ilswiss_tpu/ops/fused_sac.py:158",
         "launches": ant_launches["fused_sac_chain"],
         "max_abs_err": k2_err[bf16], "ms": k2_ms["hopper", bf16],
         "plain_ms": k2_plain_ms, "bound_ms": k2_bounds["hopper", bf16][0],
         "bound_by": k2_bounds["hopper", bf16][1], "library_ms": None,
         "float32": {"ms": k2_ms["hopper", f32],
                     "bound_ms": k2_bounds["hopper", f32][0],
                     "max_abs_err": k2_err[f32]},
         "ant_shape_ms": {"bf16": k2_ms["ant", bf16],
                          "float32": k2_ms["ant", f32]}},
        {"name": "fused_policy_forward", "route": "cuda",
         "source": "ilswiss_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "ilswiss_tpu/ops/fused_mlp.py:34",
         "launches": ant_launches["fused_policy_forward"],
         "max_abs_err": k3_err["hopper"], "ms": k3_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": k3_library_ms,
         "wall_ms": k3_wall_ms,
         "by_shape_b128": {
             shape: {"ms": k3_times[shape, 128][0],
                     "library_ms": k3_times[shape, 128][2],
                     "bound_ms": k3_times[shape, "bound"][0],
                     "max_abs_err": k3_err[shape]}
             for shape in ("hopper", "ant", "humanoid")}},
        {"name": "pgs_solve", "route": "cuda",
         "source": "ilswiss_tpu_torch/csrc/pgs.cu",
         "replaces": "ilswiss_tpu/ops/pgs_pallas.py:80",
         "launches": ant_launches["pgs_solve"],
         "max_abs_err": ant_k4["max_abs_err"], "ms": ant_k4["ms"],
         "plain_ms": ant_k4["plain_ms"], "bound_ms": ant_k4["bound_ms"],
         "bound_by": ant_k4["bound_by"], "library_ms": None,
         "ns_per_row_update": ant_k4["ns_per_row_update"],
         "active_mean": ant_k4["active_mean"],
         "active_max": ant_k4["active_max"],
         "engine_rows": {f"{name} B={B}": {
             k: v for k, v in st.items() if k in (
                 "ms", "bound_ms", "ns_per_row_update", "active_mean",
                 "active_max")} for (name, B), st in k4_engine.items()},
         "ms_70pct_active": {"ant": k4_stats[K4_SHAPES["ant"]][1],
                             "humanoid": k4_stats[K4_SHAPES["humanoid"]][1]}},
    ]
    # K1's count is the hopper main path's (its control-step mode), K4's
    # the ant main path's; K2 and K3 run on all three, and the line carries
    # the ant path's
    paths = {"hopper": hopper_launches, "ant": ant_launches,
             "humanoid": humanoid_launches}
    for entry, name in zip(kernels, ("planar_control_step", "fused_sac_chain",
                                     "fused_policy_forward", "pgs_solve")):
        entry["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        if sum(c[name] for c in paths.values()) == 0:
            fail(f"{name} was launched on no main path")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
