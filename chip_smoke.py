#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ilswiss_tpu_torch) on one GPU.

    python3 chip_smoke.py

from the root of a checkout.  It needs one CUDA device and `nvcc`, and
exits non-zero on any failure; no phase catches its own error.

  1. probe: the card's name and power limit; TF32 off for matmuls and cuDNN;
  2. build kernels K1 (csrc/planar_forward.cu) and K3 (csrc/fused_mlp.cu)
     from the checkout's sources into build/kernels/, one nvcc each, in
     parallel, printing `-Xptxas -v`;
  3. K1 against its plain PyTorch version on the card: hopper, walker,
     halfcheetah (Euler, damped) and invertedpendulum (no contacts), at
     B = 128 and a ragged B = 100, one forward evaluation and one control
     step each at rtol 2e-4, atol 5e-3; times at B = 128 and B = 1024;
  4. K3 against its plain version at B = 128, 11 -> 256 -> 256 -> 3 + 3,
     rtol = atol = 2e-5; times, and a three-addmm PyTorch chain as the
     yardstick;
  5. the slice on a small input (4 envs, 32-wide nets): warmup and two
     training iterations on the card and on the CPU, from the same seed
     and the same draws, agree at rtol 2e-4, atol 5e-3;
  6. the main path: SAC-Hopper through `make_vec`, `SAC(use_fused_act=
     True)` and `OffPolicyLoop` at 128 envs, batch 512, 256 x 2 nets, a 1M
     ring and 128 gradient steps per iteration: warmup, then one epoch of
     10 iterations.  Every launch counter is set to 0 just before and read
     just after; each kernel must have launched exactly as often as the
     path calls it, and every metric must be finite.

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
    from ilswiss_tpu_torch.ops import fused_mlp
    from ilswiss_tpu_torch.ops import planar_dynamics as pd
    k1 = pd.planar_forward
    k3 = fused_mlp.fused_gaussian_policy_forward
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

    # ---- 5. the slice on a small input: card vs CPU -----------------------
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
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
    runs = {}
    for where in ("cuda", "cpu"):
        v = make_vec("hopper", 4, device=where)
        a = SAC(11, 3, SACConfig(), net_size=32, num_hidden_layers=2,
                use_fused_act=True, device=where)
        lp = OffPolicyLoop(v, a, small)
        cpu_env = make_vec("hopper", 4, device="cpu").env
        r = lp.warmup(lp.init(0, noise=CopiedNoise(1, cpu_env, where)))
        r, m_small = lp.train_epoch(r, steps_per_epoch=8)
        runs[where] = (r, m_small)
    (rg, mg), (rc, mc) = runs["cuda"], runs["cpu"]
    pairs = [(rg.env_state.obs, rc.env_state.obs)]
    pairs += list(zip(rg.env_state.internal, rc.env_state.internal))
    pairs += [(rg.replay.data[k], rc.replay.data[k]) for k in rc.replay.data]
    pairs += [(x, y) for x, y in zip(rg.algo_state.policy.parameters(),
                                     rc.algo_state.policy.parameters())]
    pairs += [(x, y) for x, y in zip(rg.algo_state.qf.parameters(),
                                     rc.algo_state.qf.parameters())]
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
    if (rg.replay.ptr, rg.replay.size) != (rc.replay.ptr, rc.replay.size):
        fail("replay cursors differ")
    print(f"slice, 4 envs, 2 warmup + 2 training iterations: card vs CPU "
          f"max |err| {slice_err:.3g} (rtol 2e-4, atol 5e-3)")

    # ---- 6. the main path: SAC-Hopper ------------------------------------
    num_envs, steps_per_epoch = 128, 1_280
    vec = make_vec("hopper", num_envs)
    sac = SAC(vec.env.observation_size, vec.env.action_size, SACConfig(),
              net_size=256, num_hidden_layers=2, use_fused_act=True)
    config = OffPolicyConfig(batch_size=512, replay_capacity=1_000_000,
                             min_steps_before_training=5_000,
                             grad_steps_per_iter=128)
    loop = OffPolicyLoop(vec, sac, config)
    runner = loop.init(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warmup_iters = max(1, config.min_steps_before_training // num_envs)
    train_iters = max(1, steps_per_epoch // num_envs)

    k1.launches = 0
    k3.launches = 0
    t0 = time.perf_counter()
    runner = loop.warmup(runner)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    runner, metrics = loop.train_epoch(runner, steps_per_epoch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"planar_forward": k1.launches,
                "fused_policy_forward": k3.launches}

    control_steps = warmup_iters + train_iters
    want_k1 = 4 * hop.frame_skip * control_steps
    if launches["planar_forward"] != want_k1:
        fail(f"K1 launched {launches['planar_forward']} times on the main "
             f"path, expected {want_k1} (16 x {control_steps} control steps)")
    if launches["fused_policy_forward"] != train_iters:
        fail(f"K3 launched {launches['fused_policy_forward']} times on the "
             f"main path, expected {train_iters} acting calls")
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad:
        fail(f"non-finite metrics: {bad}")
    obs = runner.env_state.obs
    if tuple(obs.shape) != (num_envs, 11) or not torch.isfinite(obs).all():
        fail("env observations are not finite [128, 11]")
    if runner.total_env_steps != control_steps * num_envs \
            or runner.replay.size != control_steps * num_envs:
        fail("env-step or replay counts are wrong")
    train_rate = steps_per_epoch / (t2 - t1)
    print(f"main path: warmup {warmup_iters} iterations in {t1 - t0:.2f} s "
          f"({warmup_iters * num_envs / (t1 - t0):.1f} env-steps/s), "
          f"training {train_iters} iterations of 128 grad steps in "
          f"{t2 - t1:.2f} s ({train_rate:.1f} env-steps/s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, on {card}")
    print("main path metrics: "
          + json.dumps({k: round(v, 6) for k, v in metrics.items()}))
    print(f"launches on the main path: {json.dumps(launches)}")

    kernels = [
        {"name": "planar_forward", "route": "cuda",
         "source": "ilswiss_tpu_torch/csrc/planar_forward.cu",
         "replaces": "ilswiss_tpu/ops/planar_dynamics.py:694",
         "launches": launches["planar_forward"],
         "max_abs_err": hopper_err, "ms": k1_times[128],
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "fused_policy_forward", "route": "cuda",
         "source": "ilswiss_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "ilswiss_tpu/ops/fused_mlp.py:34",
         "launches": launches["fused_policy_forward"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": k3_library_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
