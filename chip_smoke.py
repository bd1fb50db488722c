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
     B = 128 and a ragged B = 100, one forward evaluation and one control
     step each at rtol 2e-4, atol 5e-3; times at B = 128 and B = 1024;
  4. K3 against its plain version at B = 128, 11 -> 256 -> 256 -> 3 + 3,
     rtol = atol = 2e-5; times, and a three-addmm PyTorch chain as the
     yardstick; the same check at ant's shape (105 -> 256 -> 256 -> 8 + 8);
  4b. K2 against its plain version from the same seeded state and inputs:
     hidden 32, B = 32, K = 3 and full width (11 / 3, 256 x 2, B = 512) at
     K = 4, at the pins of tests/test_fused_sac.py (parameters and targets
     rtol 2e-4, atol 2e-5; log alpha 1e-5, 1e-6; mu 2e-4, 2e-6; nu 2e-3,
     1e-8; metrics 5e-4, 5e-5; counts equal); full width at K = 128: every
     output finite and the drift printed, gated at K2_DRIFT (see there),
     with the plain version in float64 as the yardstick;
     times at K = 128 of the kernel, the plain version and 128 eager
     `train_step` calls; the pins again at ant's shape (105 / 8, 256 x 2,
     B = 512, K = 4) and the kernel's time there at K = 128;
  4c. K4 against its plain version on seeded random problems shaped like the
     engine's (nr / nv / B = 6/4/4, 38/6/9, 116/14/128, 150/23/128, 15
     sweeps) at rtol 2e-4, atol 1e-4; rows that are not active exactly zero,
     every force >= 0, two launches bit-equal; times at ant's and humanoid's
     shapes, B = 128;
  4d. K4 inside the general engine: one `forward` and one control step of
     ant and of humanoid at B = 128 with the kernel, against the same with
     the plain solve named, at rtol 2e-4, atol 5e-3 on values divided by
     max(1, max |plain|) (the float32 pin of tests/test_torch_ant.py); times
     of one ant `forward` and one ant control step;
  5. the slice on a small input (4 envs, 32-wide nets): warmup and two
     training iterations on the card and on the CPU, from the same seed
     and the same draws, agree at rtol 2e-4, atol 5e-3; once with eager
     gradient steps and once with the fused chain (K2 on the card, its
     plain version on the CPU);
  6. SAC-Hopper through `make_vec`, `SAC` and `OffPolicyLoop` at 128 envs,
     batch 512, 256 x 2 nets, a 1M ring and 128 gradient steps per
     iteration, twice: the eager path (`use_fused_act=True`) for warmup and
     2 training iterations, then the main path (`use_fused_act=True,
     use_fused_chain=True`) for warmup and one epoch of 10 iterations.
     Before each, every launch counter is set to 0, and read just after;
     each kernel must have launched exactly as often as the path calls it,
     and every metric must be finite;
  7. SAC-Ant through the same entry points at full width (128 envs, batch
     512, 256 x 2 nets, a 1M ring, K = 128, `min_steps_before_training`
     5000 as exp_specs/sac/sac_ant.yaml), the main path only: warmup and 10
     training iterations, with K4 = 20 launches per control step, K2 = 10,
     K3 = 10 and K1 = 0;
  8. humanoid, whose widths K2 and K3 do not take: `make_vec("humanoid",
     128)` stepped 5 control steps with random actions, K4 = 100 launches,
     finite observations [128, 348].

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
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
            ) -> tuple[float, float]:
    """(bytes, flops) of one K2 chain of K steps, counted from the products
    of one step (two flops per multiply-add): the policy forward on obs and
    on next_obs; three twin-critic forwards (targets, critics, updated
    critics); the critics' weight and input gradients; the input gradient
    of the updated critics down to the action columns; the policy's weight
    and input gradients; and about 12 flops per parameter for Adam and
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
    flops = K * (2 * macs + 12 * (n_policy + 2 * n_critics))
    state = 3 * n_policy + 4 * n_critics + 3
    nbytes = 4 * (2 * state + K * B * (2 * O + 3 * A + 2) + K * 8)
    return nbytes, flops


# (nv, nrow) of the models whose K4 times are taken, as
# `ilswiss_tpu_torch.envs.locomotion._model(name)` builds them, and the
# sweeps of their env classes
K4_SHAPES = {"ant": (14, 116), "humanoid": (23, 150)}
K4_SWEEPS = 15


def k4_work(B: int, nv: int, nrow: int, iters: int) -> tuple[float, float]:
    """(bytes, flops) of one K4 solve of B envs, from the u-form sweep: J
    and W [nrow, nv] and four float row vectors read, the mask read at one
    byte a row, f written; the warm start u = W f0, then per sweep and row
    a dot J_r . u, the row update, and u += df W_r.  Every row is swept
    whether it is active or not, so the count does not depend on the data."""
    nbytes = B * (4 * 2 * nrow * nv + 4 * 4 * nrow + nrow + 4 * nrow)
    flops = B * (2 * nrow * nv + iters * nrow * (4 * nv + 6))
    return nbytes, flops


# Gate on K2 against its plain version after 128 steps at full width.  At
# K = 4 the two agree at the pins.  Over 128 steps they drift apart by
# rounding alone: Adam divides each gradient by its own running size, so a
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
    from ilswiss_tpu_torch.kernels.engine_profile import grounded_state
    from ilswiss_tpu_torch.ops import fused_mlp, fused_sac, pgs
    from ilswiss_tpu_torch.ops import planar_dynamics as pd
    from ilswiss_tpu_torch.ops import rigid_body as rb
    k1 = pd.planar_forward
    k2 = fused_sac.fused_sac_chain
    k3 = fused_mlp.fused_gaussian_policy_forward
    k4 = pgs.pgs_solve
    gen = torch.Generator().manual_seed(0)

    # ---- 3. K1 vs its plain version --------------------------------------
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
            got_s = pd._control_step(pm, kernel_fwd(pm, iters),
                                     q, qd, ctrl, f0)
            torch.cuda.synchronize()
            want_s = pd._control_step(pm, plain_fwd(pm, iters),
                                      q, qd, ctrl, f0)
            flat = lambda s: [s[0], s[1], s[2], s[3], s[4][0], s[4][1]]
            check(f"K1 {name} B={B} control step", flat(got_s),
                  flat(want_s), 2e-4, 5e-3)
            err_s = max_err(flat(got_s), flat(want_s))
            print(f"K1 {name:16s} B={B:4d}: forward max |err| {err_f:.3g}, "
                  f"control step ({pm.frame_skip} x {pm.integrator}) "
                  f"max |err| {err_s:.3g}")
            if name == "hopper" and B == 128:
                hopper_err = err_f

    hop = pd.planar_model(_model("hopper"))
    k1_times = {}
    for B in (128, 1024):
        q, qd, ctrl, f0 = k1_inputs(_model("hopper"), B)
        k1_times[B] = time_ms(
            lambda: k1(hop, q, qd, ctrl, f0, iters, False), 200)
    q, qd, ctrl, f0 = k1_inputs(_model("hopper"), 128)
    k1_plain_ms = time_ms(
        lambda: pd._forward_math(hop, q, qd, ctrl, f0, iters, None), 5, 1)
    k1_bound = bound_ms(*k1_work(hop, 128, iters, False))
    print(f"K1 hopper: {k1_times[128]:.4f} ms per launch at B=128, "
          f"{k1_times[1024]:.4f} ms at B=1024; plain version "
          f"{k1_plain_ms:.2f} ms at B=128; bound {k1_bound[0]:.6f} ms "
          f"({k1_bound[1]}) at B=128")

    # ---- 4. K3 vs its plain version --------------------------------------
    from ilswiss_tpu_torch.models.policies import TanhGaussianPolicy
    policy = TanhGaussianPolicy(11, 3, (256, 256), gen).to(dev)
    weights, biases = fused_mlp._layers(policy)
    weights = [w.detach() for w in weights]
    biases = [b.detach() for b in biases]
    k3_err = 0.0
    for B in (128, 100):
        obs = torch.randn(B, 11, generator=gen).to(dev)
        got = k3(policy, obs)
        torch.cuda.synchronize()
        want = fused_mlp.policy_forward_plain(weights, biases, obs)
        check(f"K3 B={B}", got, want, 2e-5, 2e-5)
        if B == 128:
            k3_err = max_err(got, want)
    obs = torch.randn(128, 11, generator=gen).to(dev)
    k3_ms = time_ms(lambda: k3(policy, obs), 200)
    with torch.no_grad():
        k3_plain_ms = time_ms(
            lambda: fused_mlp.policy_forward_plain(weights, biases, obs), 200)
        # the yardstick: three addmm (both heads in one), ReLUs, the clamp
        w_heads = torch.cat(weights[2:]).t().contiguous()
        b_heads = torch.cat(biases[2:])
        w0, w1 = weights[0].t(), weights[1].t()

        def library():
            h = torch.relu(torch.addmm(biases[0], obs, w0))
            h = torch.relu(torch.addmm(biases[1], h, w1))
            out = torch.addmm(b_heads, h, w_heads)
            return out[:, :3], out[:, 3:].clamp(-20.0, 2.0)
        k3_library_ms = time_ms(library, 200)
    n_w = sum(w.numel() + b.numel() for w, b in zip(weights, biases))
    k3_flops = 2 * 128 * sum(w.numel() for w in weights)
    k3_bound = bound_ms(4 * (n_w + 128 * 11 + 2 * 128 * 3), k3_flops)
    print(f"K3 B=128: {k3_ms:.4f} ms; plain version {k3_plain_ms:.4f} ms; "
          f"three-addmm chain {k3_library_ms:.4f} ms; bound "
          f"{k3_bound[0]:.6f} ms ({k3_bound[1]})")
    ant_policy = TanhGaussianPolicy(105, 8, (256, 256), gen).to(dev)
    ant_obs = torch.randn(128, 105, generator=gen).to(dev)
    got = k3(ant_policy, ant_obs)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = fused_mlp.policy_forward_plain(*fused_mlp._layers(ant_policy),
                                              ant_obs)
    check("K3 ant shape", got, want, 2e-5, 2e-5)
    k3_ant_ms = time_ms(lambda: k3(ant_policy, ant_obs), 200)
    print(f"K3 at ant's shape (105 -> 256 -> 256 -> 8 + 8, B=128): max |err| "
          f"{max_err(got, want):.3g}, {k3_ant_ms:.4f} ms")

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

    def k2_groups(st):
        opts = (st.policy_opt, st.qf_opt, st.alpha_opt)
        return {
            "params": [p.detach() for m in (st.policy, st.qf, st.target_qf)
                       for p in m.parameters()],
            "log_alpha": [st.log_alpha.detach()],
            "mu": [m for o in opts for m in o.mu],
            "nu": [v for o in opts for v in o.nu]}

    k2_pins = {"params": (2e-4, 2e-5), "log_alpha": (1e-5, 1e-6),
               "mu": (2e-4, 2e-6), "nu": (2e-3, 1e-8),
               "metrics": (5e-4, 5e-5)}

    def k2_against_plain(what, n_obs, n_act, width, B, K, pins):
        """Max |kernel - plain| per group; held to `pins` where given, and
        every kernel output finite either way."""
        sac_, st_k, st_p, batches, e_next, e_new = k2_case(n_obs, n_act,
                                                           width, B, K)
        st_k, m_k = k2(sac_, st_k, batches, e_next, e_new)
        torch.cuda.synchronize()
        st_p, m_p = fused_sac.fused_sac_chain_plain(sac_, st_p, batches,
                                                    e_next, e_new)
        got, want = k2_groups(st_k), k2_groups(st_p)
        got["metrics"] = [m_k[n] for n in fused_sac.METRIC_NAMES]
        want["metrics"] = [m_p[n] for n in fused_sac.METRIC_NAMES]
        errs = {}
        for name in got:
            if pins is not None:
                check(f"K2 {what} {name}", got[name], want[name], *pins[name])
            elif not all(bool(torch.isfinite(g).all()) for g in got[name]):
                fail(f"K2 {what}: {name} is not finite")
            errs[name] = max_err(got[name], want[name])
        counts = [(o.count, w.count) for o, w in zip(
            (st_k.policy_opt, st_k.qf_opt, st_k.alpha_opt),
            (st_p.policy_opt, st_p.qf_opt, st_p.alpha_opt))]
        if any(a != b or a != K for a, b in counts):
            fail(f"K2 {what}: Adam counts {counts}, expected {K}")
        print(f"K2 {what}: max |kernel - plain| "
              + ", ".join(f"{n} {e:.3g}" for n, e in errs.items()))
        return errs, got, want

    k2_against_plain("hidden 32, B=32, K=3", 5, 2, 32, 32, 3, k2_pins)
    k2_errs, _, _ = k2_against_plain("256x2, B=512, K=4", 11, 3, 256, 512, 4,
                                     k2_pins)
    k2_err = max(k2_errs[n] for n in ("params", "log_alpha", "mu", "nu"))
    drift, got, want = k2_against_plain("256x2, B=512, K=128 (drift)", 11, 3,
                                        256, 512, 128, None)
    if max(drift["params"], drift["log_alpha"]) > K2_DRIFT["params"]:
        fail(f"K2 drifts from its plain version by {drift['params']:.3g} "
             f"in 128 steps, over {K2_DRIFT['params']:.3g}")
    check("K2 K=128 metrics", got["metrics"], want["metrics"],
          K2_DRIFT["metrics_rtol"], K2_DRIFT["metrics_atol"])

    # the same 128 steps by the plain version in float64
    sac_d, st_d, _, batches_d, e_next_d, e_new_d = k2_case(11, 3, 256, 512,
                                                           128)
    for module in (st_d.policy, st_d.qf, st_d.target_qf):
        module.double()
    st_d.log_alpha.data = st_d.log_alpha.data.double()
    for opt in (st_d.policy_opt, st_d.qf_opt, st_d.alpha_opt):
        opt.mu = [m.double() for m in opt.mu]
        opt.nu = [v.double() for v in opt.nu]
    st_d, _ = fused_sac.fused_sac_chain_plain(
        sac_d, st_d, {n: v.double() for n, v in batches_d.items()},
        e_next_d.double(), e_new_d.double())
    truth = k2_groups(st_d)["params"]
    kernel_off = max_err([g.double() for g in got["params"]], truth)
    plain_off = max_err([w.double() for w in want["params"]], truth)
    print(f"K2 256x2, B=512, K=128: parameters against the float64 plain "
          f"version: kernel {kernel_off:.3g}, float32 plain version "
          f"{plain_off:.3g}")
    if kernel_off > K2_DRIFT["f64_factor"] * plain_off + 1e-6:
        fail(f"K2 ends {kernel_off:.3g} from the float64 result, the "
             f"float32 plain version {plain_off:.3g}")

    sac2, st2, _, batches2, e_next2, e_new2 = k2_case(11, 3, 256, 512, 128)
    k2_ms = time_ms(lambda: k2(sac2, st2, batches2, e_next2, e_new2), 5, 1)
    k2_plain_ms = time_ms(lambda: fused_sac.fused_sac_chain_plain(
        sac2, st2, batches2, e_next2, e_new2), 2, 1)

    def eager_128():
        for k in range(128):
            sac2.train_step(st2, {n: v[k] for n, v in batches2.items()},
                            e_next2[k], e_new2[k])
    k2_eager_ms = time_ms(eager_128, 2, 1)
    k2_bound = bound_ms(*k2_work(512, 11, 3, 256, 2, 128))
    print(f"K2 256x2, B=512, K=128: {k2_ms:.3f} ms per chain "
          f"({k2_ms / 128 * 1e3:.1f} us per step); plain version "
          f"{k2_plain_ms:.1f} ms; bound {k2_bound[0]:.4f} ms "
          f"({k2_bound[1]}); on {card}")
    print(f"K2 replaces 128 eager train_step calls on the same batches: "
          f"{k2_eager_ms:.1f} ms ({k2_eager_ms / 128:.3f} ms per step)")

    k2_ant_errs, _, _ = k2_against_plain("ant shape: 256x2, B=512, K=4", 105,
                                         8, 256, 512, 4, k2_pins)
    sac_a, st_a, _, batches_a, e_next_a, e_new_a = k2_case(105, 8, 256, 512,
                                                           128)
    k2_ant_ms = time_ms(lambda: k2(sac_a, st_a, batches_a, e_next_a, e_new_a),
                        3, 1)
    k2_ant_bound = bound_ms(*k2_work(512, 105, 8, 256, 2, 128))
    print(f"K2 at ant's shape (105 / 8, 256x2, B=512, K=128): {k2_ant_ms:.3f} "
          f"ms per chain; bound {k2_ant_bound[0]:.4f} ms "
          f"({k2_ant_bound[1]})")
    del sac_a, st_a, batches_a, e_next_a, e_new_a

    # ---- 4c. K4 vs its plain version --------------------------------------
    import numpy as np

    def k4_problem(nr, nv, B):
        """A seeded instance shaped like the engine's: J random, M = I +
        small SPD, W = M^-1 J^T, 70% of the rows active."""
        rng = np.random.RandomState(nr)
        J = rng.randn(B, nr, nv)
        S = 0.2 * rng.randn(B, nv, nv)
        W = np.linalg.solve(np.eye(nv)[None] + S @ S.transpose(0, 2, 1),
                            J.transpose(0, 2, 1))
        Rreg = rng.uniform(0.05, 0.5, (B, nr))
        b = rng.randn(B, nr)
        D = np.einsum("brv,bvr->br", J, W) + Rreg
        active = torch.tensor(rng.rand(B, nr) < 0.7, device=dev)
        f0 = np.abs(rng.randn(B, nr))
        J, W, Rreg, b, D, f0 = (
            torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (J, W, Rreg, b, D, f0))
        return J, W, Rreg, b, D, active, f0

    k4_stats = {}
    for nr, nv, B in ((6, 4, 4), (38, 6, 9), (116, 14, 128), (150, 23, 128)):
        args = k4_problem(nr, nv, B)
        got = k4(*args, K4_SWEEPS)
        torch.cuda.synchronize()
        want = pgs.pgs_solve_plain(*args, K4_SWEEPS)
        check(f"K4 {nr}/{nv}/{B}", [got], [want], 2e-4, 1e-4)
        if not bool((got[~args[5]] == 0.0).all()) or not bool(
                (got >= 0.0).all()):
            fail(f"K4 {nr}/{nv}/{B}: an inactive row is not zero, or a "
                 f"force is negative")
        if not torch.equal(got, k4(*args, K4_SWEEPS)):
            fail(f"K4 {nr}/{nv}/{B}: two launches differ")
        err = max_err([got], [want])
        line = f"K4 nr={nr:3d} nv={nv:2d} B={B:3d}: max |err| {err:.3g}"
        if B == 128:
            ms = time_ms(lambda: k4(*args, K4_SWEEPS), 100)
            plain_ms = time_ms(
                lambda: pgs.pgs_solve_plain(*args, K4_SWEEPS), 2, 1)
            bound = bound_ms(*k4_work(B, nv, nr, K4_SWEEPS))
            k4_stats[(nv, nr)] = (err, ms, plain_ms, bound)
            line += (f"; {ms:.4f} ms per launch, plain version "
                     f"{plain_ms:.1f} ms, bound {bound[0]:.6f} ms "
                     f"({bound[1]})")
        print(line)

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

    for fused in (False, True):
        k2.launches = 0
        (rg, mg), (rc, mc) = small_slice("cuda", fused), small_slice("cpu",
                                                                     fused)
        if k2.launches != (2 if fused else 0):
            fail(f"small slice, fused={fused}: K2 launched {k2.launches} "
                 f"times")
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
            if not math.isclose(mg[k], mc[k], rel_tol=2e-4, abs_tol=5e-3):
                fail(f"metric {k}: {mg[k]} on the card, {mc[k]} on the CPU")
        if (rg.replay.ptr, rg.replay.size) != (rc.replay.ptr,
                                               rc.replay.size):
            fail("replay cursors differ")
        print(f"slice, 4 envs, 2 warmup + 2 training iterations, "
              f"{'fused chain' if fused else 'eager steps'}: card vs CPU "
              f"max |err| {slice_err:.3g} (rtol 2e-4, atol 5e-3)")

    # ---- 6. SAC-Hopper at full width: the eager path, then the main path --
    num_envs = 128
    config = OffPolicyConfig(batch_size=512, replay_capacity=1_000_000,
                             min_steps_before_training=5_000,
                             grad_steps_per_iter=128)
    warmup_iters = max(1, config.min_steps_before_training // num_envs)

    def drive(env_name, fused, train_iters):
        """Warmup and `train_iters` training iterations from seed 0, with
        every launch count set to 0 just before and read just after."""
        vec = make_vec(env_name, num_envs)
        model = vec.env.model
        sac = SAC(vec.env.observation_size, vec.env.action_size, SACConfig(),
                  net_size=256, num_hidden_layers=2, use_fused_act=True,
                  use_fused_chain=fused)
        loop = OffPolicyLoop(vec, sac, config)
        runner = loop.init(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.launches = k2.launches = k3.launches = k4.launches = 0
        t0 = time.perf_counter()
        runner = loop.warmup(runner)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runner, metrics = loop.train_epoch(runner, train_iters * num_envs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {"planar_forward": k1.launches,
                    "fused_sac_chain": k2.launches,
                    "fused_policy_forward": k3.launches,
                    "pgs_solve": k4.launches}

        what = f"{env_name} {'main path' if fused else 'eager path'}"
        control_steps = warmup_iters + train_iters
        # 4 RK4 evaluations per substep, each one K1 launch on a planar
        # model and one K4 launch on any other
        evaluations = 4 * model.frame_skip * control_steps
        planar = pd.planar_model(model) is not None
        want = {"planar_forward": evaluations if planar else 0,
                "fused_sac_chain": train_iters if fused else 0,
                "fused_policy_forward": train_iters,
                "pgs_solve": 0 if planar else evaluations}
        if launches != want:
            fail(f"{what}: launches {launches}, expected {want} (K1 or K4 "
                 f"{4 * model.frame_skip} per control step, K3 one per "
                 f"acting call, K2 one per fused training iteration)")
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
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, on "
              f"{card}")
        print(f"{what} metrics: "
              + json.dumps({k: round(v, 6) for k, v in metrics.items()}))
        print(f"launches on the {what}: {json.dumps(launches)}")
        return launches

    drive("hopper", fused=False, train_iters=2)
    hopper_launches = drive("hopper", fused=True, train_iters=10)

    # ---- 7. SAC-Ant at full width: this slice's main path -----------------
    ant_launches = drive("ant", fused=True, train_iters=10)

    # ---- 8. humanoid: the engine and K4 at the widest model ----------------
    vec = make_vec("humanoid", num_envs)
    noise = Noise(0, dev)
    state = vec.reset(noise.reset(vec.env, num_envs))
    torch.cuda.synchronize()
    k4.launches = 0
    t0 = time.perf_counter()
    for _ in range(5):
        state, tr = vec.step(
            state, noise.warmup_action((num_envs, vec.env.action_size)),
            noise.reset(vec.env, num_envs))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if k4.launches != 4 * vec.env.model.frame_skip * 5:
        fail(f"humanoid: K4 launched {k4.launches} times in 5 control steps")
    for what, x in (("next_obs", tr.next_obs), ("obs", state.obs),
                    ("reward", tr.reward)):
        if not torch.isfinite(x).all():
            fail(f"humanoid: {what} is not finite")
    if tuple(state.obs.shape) != (num_envs, 348):
        fail(f"humanoid: observations are {tuple(state.obs.shape)}")
    print(f"humanoid, {num_envs} envs, 5 control steps of random actions: "
          f"K4 launched {k4.launches} times, {seconds / 5 * 1e3:.1f} ms per "
          f"control step ({5 * num_envs / seconds:.1f} env-steps/s), "
          f"observations finite {list(state.obs.shape)}, mean reward "
          f"{float(tr.reward.mean()):.3f}")

    ant_k4 = k4_stats[K4_SHAPES["ant"]]
    kernels = [
        {"name": "planar_forward", "route": "cuda",
         "source": "ilswiss_tpu_torch/csrc/planar_forward.cu",
         "replaces": "ilswiss_tpu/ops/planar_dynamics.py:694",
         "launches": hopper_launches["planar_forward"],
         "max_abs_err": hopper_err, "ms": k1_times[128],
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "fused_sac_chain", "route": "cuda",
         "source": "ilswiss_tpu_torch/csrc/fused_sac.cu",
         "replaces": "ilswiss_tpu/ops/fused_sac.py:158",
         "launches": ant_launches["fused_sac_chain"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None},
        {"name": "fused_policy_forward", "route": "cuda",
         "source": "ilswiss_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "ilswiss_tpu/ops/fused_mlp.py:34",
         "launches": ant_launches["fused_policy_forward"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": k3_library_ms},
        {"name": "pgs_solve", "route": "cuda",
         "source": "ilswiss_tpu_torch/csrc/pgs.cu",
         "replaces": "ilswiss_tpu/ops/pgs_pallas.py:80",
         "launches": ant_launches["pgs_solve"],
         "max_abs_err": ant_k4[0], "ms": ant_k4[1], "plain_ms": ant_k4[2],
         "bound_ms": ant_k4[3][0], "bound_by": ant_k4[3][1],
         "library_ms": None},
    ]
    # K1's count is the hopper main path's, K4's the ant main path's; K2 and
    # K3 run on both, 10 launches each, and the line carries the ant path's
    for entry, name in zip(kernels, ("planar_forward", "fused_sac_chain",
                                     "fused_policy_forward", "pgs_solve")):
        entry["launches_by_path"] = {"hopper": hopper_launches[name],
                                     "ant": ant_launches[name]}
        if hopper_launches[name] + ant_launches[name] == 0:
            fail(f"{name} was launched on no main path")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
