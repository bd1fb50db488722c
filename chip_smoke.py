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
     B = 128, a ragged B = 100, and the launcher's B = 8 (its envs) and
     B = 32 (its evaluator), one control step (one launch of the
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
     hidden 32, B = 32, K = 3, full width (256 x 2, B = 512, K = 4) at
     hopper's (11 / 3), ant's (105 / 8) and humanoid's (348 / 17) shapes,
     and hopper's at the launcher's K = 8;
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
     with K4 = 20 launches per control step, K2 = 3, K3 = 3 and K1 = 0;
  9. the YAML launcher: exp_specs/sac/sac_hopper_optable.yaml through
     `build_variants` and `EXPERIMENTS["sac"]` of the port, at the spec's
     width (8 envs, 256 x 2, batch 512, a 1M ring, the fused chain with K =
     8), cut in length only, logs under build/chip_smoke/, no trace.  Run
     A: 2 epochs straight through (warmup, training, a 32-episode
     evaluation an epoch).  Run B: 1 epoch, then a full resume from
     its checkpoints/last to 2 epochs.  Launch counts exact (A: K1 = 625
     warmup + 2 x 1250 training + 2 x 1000 evaluation = 5125, K2 = 2500;
     B: 2875 and 1250; B's resume: 2250 and 1250; K3 = K4 = 0); B's end
     state equal to A's bit for bit, and its progress.csv rows but for the
     wall clocks; TotalEnvSteps 15000 and 25000, every value finite; the
     snapshot's size, save and load time; a CPU restore of the card's
     snapshot acting within rtol = atol = 2e-5 of the card's policy; on
     the path's own data, K1 at B = 8 and 32 from run A's end states
     (phase 3's check) and K2 at K = 8, B = 512 on batches of run A's ring
     (phase 4b's, both modes) against their plain versions, and timed;
 10. adversarial IL through the launcher: exp_specs/gail/gail_hopper.yaml
     copied under build/chip_smoke_gail/ with only num_epochs (162 -> 2)
     and num_steps_per_epoch (10000 -> 400, 50 iterations an epoch) cut,
     through `build_variants` and `EXPERIMENTS["adv_irl"]`: GAIL (gail2)
     on hopper from demos/hopper_expert.npz at the spec's widths (SAC 256
     x 2, discriminator 2 x 128 tanh, batch 256, 8 envs, a 20k ring,
     demo-stats scaling, no_terminal, 8 discriminator and 8 SAC steps an
     iteration).  Run A: 2 epochs; run B: 1 epoch, then a full resume.
     Launch counts exact (A: K1 = 625 warmup + 2 x (50 training + 1000
     evaluation) = 2725; B: 1675; B's resume: 1050; K2 = K3 = K4 = 0);
     B's end state equal to A's bit for bit and its progress.csv rows but
     for the wall clocks; every metric finite, the discriminator's among
     them, gail2 rewards <= 0; K1 at B = 8 and 32 on run A's end states
     against its plain version (phase 3's check); the iteration's split
     (K1, a discriminator step, a policy step), the snapshot's size, save
     and load time;
 11. TD3 through the launcher: exp_specs/td3/td3_hopper.yaml copied under
     build/chip_smoke_td3/ with only num_epochs (102 -> 2) and
     num_steps_per_epoch (10000 -> 400) cut, through
     `EXPERIMENTS["td3"]`: 8 envs, 256 x 2, batch 256, K = 8, a 1M ring,
     5000 warmup steps, the 32-env evaluator.  Run A: 2 epochs; run B: 1
     epoch, then a full resume.  Launch counts exact (K1 2725 / 1675 /
     1050; K2 = K3 = K4 = 0), B's end state equal to A's bit for bit (the
     three targets, both critics' and the policy's Adams, n_train_steps,
     the ring, the noise generator) and its progress.csv rows but for the
     wall clocks, every metric finite; K1 at B = 8 and 32 on run A's end
     states against its plain version; one TD3 step's wall ms (host clock,
     synchronized, 20 steps), device operations and device ms
     (torch.profiler), the iteration's split (K1, 8 steps, the rest), the
     snapshot's size, save and load time, the spec's estimated wall time;
 12. the other four trainers through the launcher, cut in num_epochs
     only: exp_specs/dqn/dqn_cartpole.yaml (2 epochs, and 1 plus a full
     resume, bit-equal with epsilon's counters),
     exp_specs/sac/sac_cartpole_d.yaml (1 epoch; the trainer and debug.log
     must hold the spec's alpha 0.05 and discount 0.95), and DDPG and
     SAC-V on phase 11's copy with td3_params' values under ddpg_params /
     sac_params (1 epoch; K1 exactly 1675 each); cartpole launches no
     kernel; for each, a step's wall ms, device operations and device ms;
 13. PPO through the launcher: exp_specs/ppo/ppo_hopper.yaml copied under
     build/chip_smoke_ppo/ with only num_epochs (200 -> 2) and
     num_steps_per_epoch (10000 -> 2048, one iteration of T = 128 steps of
     16 envs) cut, through `EXPERIMENTS["ppo"]`: 256 x 2 policy and value
     nets, minibatch 64, 10 passes, obs_norm, the 1000-step evaluation.
     Launch counts exact (K1 2 x (128 + 1000) = 2256; K2 = K3 = K4 = 0),
     every metric finite, TotalEnvSteps 2048 / 4096, the moments' count
     1e-4 + 4096 (float32), the run's 'last' snapshot restored into a fresh
     runner bit for bit; K1 at B = 16 on the end states against its plain
     version; the rollout's and the update's ms, one minibatch step's wall
     ms, device operations and device ms, the snapshot's size, save and
     load time, the spec's estimated wall time at 200 epochs;
 14. the rnn discriminator through the launcher: exp_specs/gail/
     gail_hopper.yaml copied under build/chip_smoke_gail_rnn/ with
     `disc_type: rnn` (T = 16, a 2-layer bidirectional GRU of width 128)
     and num_epochs 2, num_steps_per_epoch 24 (3 iterations an epoch).
     Run A: 2 epochs; run B: 1 epoch, then a full resume.  Launch counts
     exact (K1 2631 / 1628 / 1003; K2 = K3 = K4 = 0), B's end state equal
     to A's bit for bit, every metric finite (gail2 rewards <= 0); K1 at
     B = 8 and 32 on run A's end states against its plain version; one rnn
     discriminator step on the card against the same step on a CPU copy,
     same state and draws, at rtol 2e-4, atol 2e-5; a discriminator step's
     and a policy step's wall ms, device operations and device ms, and the
     share of masked steps in the policy batches;
 15. MBPO through the launcher: exp_specs/mbpo/mbpo_hopper.yaml copied
     under build/chip_smoke_mbpo/ with only num_epochs (301 -> 1) and
     num_steps_per_epoch (1000 -> 248, one segment of 31 iterations) cut,
     through `EXPERIMENTS["mbpo"]`: SAC 256 x 2 (160 steps an iteration
     on mixed batches, real_ratio 0.05), the 7-net ensemble of 200 x 4,
     rollouts of 100,000 branches, a 1M-row real and a 6,000,000-row
     model ring.  Launch counts exact (K1 1656; K2 = K3 = K4 = 0), every
     value finite, the model ring's size the sum of the rows the rollouts
     wrote, the 'last' snapshot restored bit for bit, K1 at B = 8 on the
     end states against its plain version; an ensemble minibatch step and
     a model rollout of 3 steps at R = 1024 on the card against a CPU copy
     from the same state and draws (rtol 2e-4, atol 2e-5; the rows each
     step wrote, ptr and size exactly); the ensemble fits' seconds and
     epochs, a minibatch step's and a mixed-batch SAC step's wall ms,
     device operations and device ms, rollouts of 1 and 15 steps at R =
     100,000 with the branches alive per step, an iteration, the peak
     device memory, the snapshot's size, save and load time, and the
     spec's estimated wall time at 301 epochs;
 16. imitation without an adversary on hopper, from phase 9's run A
     'last' policy, under build/chip_smoke_il/ with its own demos
     listing: exp_specs/gen_expert/hopper.yaml (num_rollouts 4 -> 2),
     exp_specs/bc/bc_hopper.yaml on those demos (2 epochs),
     exp_specs/dagger/dagger_hopper.yaml seeded from them (1 epoch of
     1000 steps, the 1000 pretraining steps kept; n % 8 of the seeded
     rows printed) and exp_specs/eval_policy.yaml on hopper with
     save_samples.  Launch counts exact (K1 500 / 2000 / 1125 / 1250; K2 =
     K3 = K4 = 0), every value finite, DAgger's added rows holding the
     expert's actions, K1 on each run's end state against its plain
     version; a BC step's and a DAgger iteration's wall ms, device
     operations and device ms;
 17. goal-conditioned learning on reach2d: her_sac_reach2d.yaml,
     gcsl_reach2d.yaml and gcsl_reach_dis.yaml, 1 epoch of 1000 steps
     each, under build/chip_smoke_goal/: no kernel launch, every value
     finite, TotalEnvSteps 16 x 162, a batch sampled from each run's hindsight
     ring equal to the same draws on a CPU copy of it, exactly; an
     iteration's and an inner step's wall ms, device operations and
     device ms;
 18. the visual path: exp_specs/sac_ae/, sac_rad/ and sac_curl/
     *_pendulum_pixels.yaml through `EXPERIMENTS` cut in length only (1
     epoch of 400 steps after the spec's 1000-step warmup; 16 envs of 64
     px, K = 8 at batch 128, the 100,000-row ring, bf16 convs, crop 56 for
     RAD and CURL), under build/chip_smoke_visual/ (each run's logs deleted
     once read): no kernel launch, every value finite, TotalEnvSteps 1392,
     one SAC-AE step on the card against a CPU copy (16 rows of a batch,
     float32 convs, rtol 2e-4, atol 1e-4); an even and an odd SAC-AE
     step's and an iteration's wall ms, device operations and device ms,
     TrainTime, EvalTime, the ring's bytes, the peak memory, the
     snapshots' sizes, save and load seconds, and the bf16-vs-float32
     feature gap (the disk's free space and the host bridges' packages
     printed first); then GAIL with the cnn discriminator on
     pendulum_pixels through `OffPolicyLoop` (2 envs, batch 16, an 8-step
     epoch): finite metrics, no launch;
 19. the host loops' device half (ROADMAP.md item 2.8), `host_phase`:
     the GPU machine it is written for has no MuJoCo, gymnasium or Box2D
     (printed, with the native engine's ImportError), so the gymnasium env
     that the launcher builds is replaced by
     `ilswiss_tpu_torch.testing.DeviceEnvAsHost` on pendulum (reach2d for
     HER).  exp_specs/sac/sac_hopper_native.yaml
     (force_host) at its widths (16 envs, 256 x 2, batch 512, a 1M ring,
     1000 eager steps a train call) cut to 2 epochs of 1000 steps after a
     1000-step warmup: straight, 1 epoch plus a full resume (TotalEnvSteps
     1984 / 2976 both), and 1 epoch with the collection not overlapped;
     gail_pendulum.yaml and ppo_pendulum.yaml with force_host, 1 epoch;
     `HostHERLoop` and `HostMBPOLoop` on the her_sac_reach2d.yaml and
     mbpo_pendulum.yaml constants, one segment each.  No kernel launch on
     any run, every value finite; a segment's collection and a train
     call's wall ms, a 20-step call's device operations and device ms,
     TrainTime overlapped and serial, and a 4-step train call on the card
     against a CPU copy at phase 18's pins;
 20. data parallelism over torch.distributed (`data_parallel_phase`), one
     process a rank, spawned and joined with a deadline (a rank that
     fails or hangs fails the script): (a) nccl with one rank per card
     (a world of one under one card): `DistributedOffPolicyRunner` with
     SAC on hopper at sac_hopper_optable.yaml's widths, its 5000-step
     warmup and 2 epochs of 25 iterations a rank: K1 once a control step
     on every rank, K2 (refused under a group), K3 and K4 never, every
     metric finite, the parameters equal across ranks (rtol = atol =
     1e-6), K1 on each rank's end states against its plain version; (b) 2
     ranks on the one card over gloo with CUDA tensors: the same SAC
     runner and `DistributedOnPolicyRunner` with PPO at ppo_hopper.yaml's
     widths (cut in length), from identical data equal to the one-rank
     run (rtol 1e-5, atol 1e-6), from distinct data the replicas equal and
     away from it; the world size and backend, an iteration's wall ms, the
     collectives' ms per SAC step (CUDA events) and a step's device
     operations.  `python3 chip_smoke.py --phase20 [nccl]` runs phases 1,
     2 and 20 alone (with "nccl", (a) only), for a call on four cards.

It prints a JSON line with every kernel's numbers, the card's name and
power limit, and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
import types
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


# Phase 9: the spec run through the port's launcher, cut in length only
LAUNCHER_SPEC = "exp_specs/sac/sac_hopper_optable.yaml"
# wall clocks: the only progress.csv columns in which a resumed run may
# differ from the uninterrupted one (WallTime is the logger's own)
CLOCK_COLUMNS = {"TrainTime", "EvalTime", "EnvStepsPerSec", "WallTime"}


def run_spec(experiment: str, variant: dict, log_dir, counters: dict,
             num_epochs: int, **extra):
    """One run of `variant` through the port's `EXPERIMENTS[experiment]` on
    the card, with num_epochs, log_dir and `extra` set and no console
    output; every launch counter is set to 0 just before the run and read
    just after.  Returns (runner, launches, wall seconds)."""
    import copy

    import torch

    from ilswiss_tpu_torch.launchers.experiments import EXPERIMENTS

    v = copy.deepcopy(variant)
    if num_epochs is not None:     # None: the variant's own schedule
        v["rl_alg_params"]["num_epochs"] = num_epochs
    v["log_dir"] = str(log_dir)
    v["print_to_console"] = False
    v.update(extra)
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    runner = EXPERIMENTS[experiment](v)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return runner, {n: k.launches for n, k in counters.items()}, seconds


def check_launches(what: str, runs) -> None:
    """`runs`: (run name, launches read, launches expected)."""
    for name, got, exp in runs:
        if got != exp:
            fail(f"{what} run {name}: launches {got}, expected {exp}")
        print(f"{what} run {name}: launches {json.dumps(got)}")


@contextlib.contextmanager
def kept_algos():
    """Inside: every trainer a launcher hands its `_run_off_policy` is
    appended to the yielded list (for timings after the run)."""
    from ilswiss_tpu_torch.launchers import experiments as pexp

    algos = []
    run_off_policy = pexp._run_off_policy

    def keep(algo, *args, **kwargs):
        algos.append(algo)
        return run_off_policy(algo, *args, **kwargs)

    pexp._run_off_policy = keep
    try:
        yield algos
    finally:
        pexp._run_off_policy = run_off_policy


def step_costs(fn, reps: int = 20, warmup: int = 3, traced: int = 3
               ) -> tuple:
    """One call of `fn` (an update step): its wall ms on the host clock,
    synchronized, over `reps` calls after `warmup` unmeasured; then its
    device operations (kernels, copies) and their summed device ms, from a
    torch.profiler trace of `traced` calls.  Returns (wall ms, operations,
    device ms) per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return (wall, len(ops) / traced,
            sum(e.device_time for e in ops) / traced / 1e3)


def cut_spec(spec_path: str, out: Path, cut: dict,
             constants: dict | None = None) -> tuple:
    """A copy of `spec_path` under `out` with `cut` set in its
    rl_alg_params (and `constants` among its constants), and its one
    variant.  Returns (variant, the spec's own rl_alg_params)."""
    import yaml

    from ilswiss_tpu_torch.launchers.variant import build_variants

    with open(ROOT / spec_path) as f:
        spec = yaml.safe_load(f)
    full = dict(spec["constants"]["rl_alg_params"])
    spec["constants"]["rl_alg_params"].update(cut)
    spec["constants"].update(constants or {})
    path = out / Path(spec_path).name
    with open(path, "w") as f:
        yaml.safe_dump(spec, f)
    with open(path) as f:
        (variant,) = build_variants(yaml.safe_load(f))
    return variant, full


def progress_rows(log_dir) -> list:
    import csv
    with open(Path(log_dir) / "progress.csv") as f:
        return list(csv.DictReader(f))


def check_progress(what: str, a_rows, b_rows, need, steps) -> None:
    """Both runs' progress.csv: 2 rows with the `need` columns,
    TotalEnvSteps `steps`, every value finite, and B's rows equal to A's
    but for the wall clocks."""
    for name, rs in (("A", a_rows), ("B", b_rows)):
        if len(rs) != 2 or not set(need) <= set(rs[0]):
            fail(f"{what} run {name}: progress.csv has {len(rs)} rows, "
                 f"columns {list(rs[0]) if rs else []}")
        if [float(r["TotalEnvSteps"]) for r in rs] != steps:
            fail(f"{what} run {name}: TotalEnvSteps "
                 f"{[r['TotalEnvSteps'] for r in rs]}, expected {steps}")
        for r in rs:
            if not all(math.isfinite(float(v)) for v in r.values()):
                fail(f"{what} run {name}: a value of progress.csv is not "
                     f"finite")
    for ra, rb in zip(a_rows, b_rows):
        da = {k: v for k, v in ra.items() if k not in CLOCK_COLUMNS}
        db = {k: v for k, v in rb.items() if k not in CLOCK_COLUMNS}
        if da != db:
            fail(f"{what} progress.csv epoch {ra['Epoch']}: B differs from "
                 f"A in {sorted(k for k in da if da[k] != db.get(k))}")


def snapshot_times(what: str, path, runner, into, tree) -> tuple:
    """Save `runner` as a full snapshot at `path` and restore it into the
    runner `into`, which must then equal `tree` (`runner`'s) bit for bit.
    Returns (MiB on disk, save seconds, load seconds)."""
    import os

    import torch

    from ilswiss_tpu_torch.runtime.checkpoint import (
        restore_checkpoint, save_checkpoint, to_tree,
    )
    from ilswiss_tpu_torch.testing import tree_diff

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(str(path), runner)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(Path(path) / "state.pt")
    t0 = time.perf_counter()
    restore_checkpoint(str(path), into)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    bad = tree_diff(tree, to_tree(into))
    if bad:
        fail(f"a {what} snapshot restored into another runner differs in "
             f"{bad[:10]}")
    return size / 2**20, save_s, load_s


def k1_on_end_states(what: str, runner, n: int, k1_step, k1_check,
                     seed: int, sizes: tuple | None = None) -> tuple:
    """K1 at the path's batches, `n` envs (warmup and training) and 4n (the
    32-env evaluator) unless `sizes` names them, from the runner's end
    states and actions in [-1, 1]: held against its plain version
    (`k1_check`, phase 3's check) and timed.  Returns ({B: ms},
    {B: max |err|})."""
    import torch

    from ilswiss_tpu_torch.envs.locomotion import HopperDevice, _model
    from ilswiss_tpu_torch.ops import planar_dynamics as pd

    pm = pd.planar_model(_model("hopper"))
    dev = runner.env_state.obs.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    k1_ms, k1_err = {}, {}
    for nb in sizes or (n, 4 * n):
        q, qd, f0 = (x.repeat(nb // n, 1).t().contiguous()
                     for x in runner.env_state.internal)
        ctrl = 2 * torch.rand((len(pm.act_dof), nb), device=dev,
                              generator=gen) - 1
        k1_err[nb] = k1_check(f"K1 hopper B={nb}, {what} run A's end "
                              f"states", pm, q, qd, ctrl, f0,
                              HopperDevice.solver_iters)
        print(f"K1 hopper B={nb} on {what} run A's end states: control "
              f"step max |kernel - plain| {k1_err[nb]:.3g}; two launches "
              f"bit-equal")
        k1_ms[nb] = time_ms(lambda: k1_step(
            pm, q, qd, ctrl, f0, HopperDevice.solver_iters), 50)
    return k1_ms, k1_err


def launcher_phase(card: str, counters: dict, k2_fns, k1_check,
                   k2_check) -> dict:
    """Phase 9: LAUNCHER_SPEC through `build_variants` and
    `EXPERIMENTS["sac"]` on the card, with only num_epochs, log_dir,
    profile_dir (none: no trace) and print_to_console changed.  Run A: 2
    epochs straight through.  Run B: 1 epoch, then a full resume from its
    log_dir to 2 epochs.  Fails unless every launch count is the one derived from the
    spec, B's end state equals A's bit for bit, progress.csv holds
    TotalEnvSteps 15000 / 25000 and finite values (B's rows equal to A's
    but for the wall clocks), a CPU restore of the card's snapshot acts
    as the card's policy does, and K1 and K2 agree with their plain
    versions at the path's shapes on its data (`k1_check`, `k2_check`:
    phase 3's and 4b's checks).  Returns what the kernels line needs."""
    import shutil

    import torch
    import yaml

    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.data.replay import replay_sample
    from ilswiss_tpu_torch.launchers.variant import build_variants
    from ilswiss_tpu_torch.ops.fused_sac import METRIC_NAMES
    from ilswiss_tpu_torch.runtime.checkpoint import restore_subtree, to_tree
    from ilswiss_tpu_torch.testing import tree_diff

    out = ROOT / "build" / "chip_smoke"
    shutil.rmtree(out, ignore_errors=True)
    with open(ROOT / LAUNCHER_SPEC) as f:
        (variant,) = build_variants(yaml.safe_load(f))

    def run(name, num_epochs, **extra):
        # no trace: one traced epoch took 36.3 s against 5.2 to 5.5 s and
        # wrote 526.4 MiB on the card (PERF.md); the tests cover `trace`
        return run_spec("sac", variant, out / name, counters, num_epochs,
                        profile_dir=None, **extra)

    # the launch counts, derived from the spec: K1 once per control step of
    # warmup (min_steps_before_training // env_num iterations), training
    # (num_steps_per_epoch // env_num iterations an epoch) and evaluation
    # (max_path_length steps of the 32-env evaluator an epoch); K2 once per
    # training iteration (use_fused_chain, K = 8 steps); K3 and K4 never
    # (run_sac sets no fused acting, and hopper is planar)
    rl = variant["rl_alg_params"]
    n = variant["env_specs"]["env_num"]
    warm = rl["min_steps_before_training"] // n
    iters = rl["num_steps_per_epoch"] // n
    evals = rl["max_path_length"]

    def want(epochs, warmup):
        return {"planar_control_step": (warm if warmup else 0)
                + epochs * (iters + evals), "planar_forward": 0,
                "fused_sac_chain": epochs * iters,
                "fused_policy_forward": 0, "pgs_solve": 0}

    a, a_launches, a_s = run("a", 2)
    b1, b1_launches, b1_s = run("b", 1)
    b, b_launches, b_s = run("b", 2, load_params=str(out / "b"))
    runs = (("A (2 epochs)", a_launches, want(2, True)),
            ("B (1 epoch)", b1_launches, want(1, True)),
            ("B resumed to 2 epochs", b_launches, want(1, False)))
    if [(e["planar_control_step"], e["fused_sac_chain"])
            for _, _, e in runs] != [(5125, 2500), (2875, 1250),
                                     (2250, 1250)]:
        fail(f"launcher: the spec's launch counts are not phase 9's: "
             f"{[e for _, _, e in runs]}")
    check_launches("launcher", runs)
    print(f"launcher runs: A {a_s:.1f} s, B {b1_s:.1f} s + resume "
          f"{b_s:.1f} s (wall time of each call), on {card}")

    a_tree = to_tree(a)
    bad = tree_diff(a_tree, to_tree(b))
    if bad:
        fail(f"the resumed run B differs from run A in {bad[:10]}")
    print("resume: B's end state equals A's bit for bit (parameters, "
          "targets, Adam moments and counts, log alpha, ring with cursor, "
          "size and episode counters, env state, env steps, noise "
          "generator)")

    a_rows, b_rows = progress_rows(out / "a"), progress_rows(out / "b")
    need = ([f"trainer/{k}" for k in METRIC_NAMES]
            + ["AverageReturn", "MaxReturn", "MinReturn", "StdReturn",
               "AvgPathLength", "TotalEnvSteps", "TrainTime", "EvalTime",
               "EnvStepsPerSec"])
    check_progress("launcher", a_rows, b_rows, need, [15000.0, 25000.0])
    epochs = [{k: float(r[k]) for k in ("TrainTime", "EvalTime",
                                        "EnvStepsPerSec", "AverageReturn")}
              for r in a_rows + b_rows]
    for (run_name, ep), e in zip((("A", 0), ("A", 1), ("B", 0), ("B", 1)),
                                 epochs):
        print(f"launcher run {run_name} epoch {ep}: TrainTime "
              f"{e['TrainTime']:.3f} s, EvalTime {e['EvalTime']:.3f} s, "
              f"EnvStepsPerSec {e['EnvStepsPerSec']:.1f}, AverageReturn "
              f"{e['AverageReturn']:.3f}"
              + f", on {card}")

    # a full snapshot: size, save and load time
    size, save_s, load_s = snapshot_times("launcher", out / "snapshot", a,
                                          b1, a_tree)
    print(f"full snapshot: {size:.1f} MiB on disk, save "
          f"{save_s:.3f} s, load {load_s:.3f} s (into a runner on the card), "
          f"on {card}")

    # the card-written snapshot restored into a CPU template
    cpu_sac = SAC(11, 3, SACConfig(), net_size=256, num_hidden_layers=2,
                  device="cpu")
    cpu_state = restore_subtree(str(out / "a" / "checkpoints" / "last"),
                                cpu_sac.init(1), key="algo_state")
    card_sac = SAC(11, 3, SACConfig(), net_size=256, num_hidden_layers=2,
                   use_fused_chain=True)
    obs = torch.randn(64, 11, generator=torch.Generator().manual_seed(3))
    got = cpu_sac.act(cpu_state, obs, deterministic=True)
    ref = card_sac.act(a.algo_state, obs.cuda(), deterministic=True).cpu()
    cross_err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, rtol=2e-5, atol=2e-5):
        fail(f"the CPU restore of the card's snapshot acts {cross_err:.3g} "
             f"away from the card's policy")
    print(f"cross-device restore: CPU policy vs the card's on 64 "
          f"observations, max |err| {cross_err:.3g} (rtol = atol = 2e-5)")

    # K2 at the launcher path's shape: K = 8, hopper, batch 512, from a
    # fresh state on batches of run A's ring, held against its plain
    # version in both modes and timed
    k2, k2_plain = k2_fns
    state = card_sac.init(0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    K = round(n * rl["num_train_steps_per_train_call"]
              / rl["num_steps_between_train_calls"])
    B = rl["batch_size"]
    u = torch.rand((K, B), device="cuda", generator=gen)
    batches = replay_sample(a.replay, u)
    eps = [torch.randn((K, B, 3), device="cuda", generator=gen)
           for _ in range(2)]
    k2_errs = k2_check(f"hopper 256x2, B={B}, K={K}, run A's ring", 11, 3,
                       256, B, K, case=(card_sac, batches, *eps))
    k2_err = {mode: max(k2_errs[dt][g]
                        for g in ("params", "log_alpha", "mu", "nu"))
              for mode, dt in (("bf16", torch.bfloat16),
                               ("float32", torch.float32))}
    ms = time_ms(lambda: k2(card_sac, state, batches, *eps), 50)
    plain_ms = time_ms(lambda: k2_plain(card_sac, state, batches, *eps), 5, 1)

    # K1 at the launcher path's batches, 8 envs (warmup and training) and
    # 32 (the evaluator), from run A's end states
    k1_ms, k1_err = k1_on_end_states("the launcher's", a, n,
                                     counters["planar_control_step"],
                                     k1_check, 5)
    it_ms = 1e3 * sum(e["TrainTime"] for e in epochs) / (len(epochs) * iters)
    print(f"launcher iteration: {it_ms:.3f} ms (mean over the 4 epochs); "
          f"K1 at B = {n}: {k1_ms[n]:.4f} ms, K2 at K = {K}: {ms:.4f} ms, "
          f"{(k1_ms[n] + ms) / it_ms:.1%} of it; K1 at B = {4 * n} (the "
          f"evaluator): {k1_ms[4 * n]:.4f} ms of a "
          f"{1e3 * sum(e['EvalTime'] for e in epochs) / (4 * evals):.3f} ms "
          f"control step; on {card}")
    return {"launches": a_launches, "resumed_launches": b_launches,
            "k2_k8_ms": ms, "k2_k8_plain_ms": plain_ms,
            "k2_k8_err": k2_err, "k1_ms": k1_ms, "k1_err": k1_err,
            "iteration_ms": it_ms,
            "snapshot_mib": size, "save_s": save_s, "load_s": load_s,
            "cross_device_err": cross_err, "epochs": epochs}


# Phase 10: adversarial IL through the port's launcher, cut in length only
GAIL_SPEC = "exp_specs/gail/gail_hopper.yaml"
GAIL_CUT = {"num_epochs": 2, "num_steps_per_epoch": 400}
GAIL_METRICS = ["disc_ce_loss", "disc_acc", "disc_grad_pen", "disc_rew_mean"]


def gail_phase(card: str, counters: dict, k1_check) -> dict:
    """Phase 10: a copy of GAIL_SPEC under build/chip_smoke_gail/ with
    only GAIL_CUT changed (num_epochs 162 -> 2, num_steps_per_epoch 10000
    -> 400: 50 iterations an epoch), its logs and print_to_console, through
    `build_variants` and `EXPERIMENTS["adv_irl"]` on the card: GAIL (gail2
    mode) on hopper from demos/hopper_expert.npz (4 trajectories,
    demo-stats scaling), SAC 256 x 2, discriminator 2 x 128 tanh, batch
    256, 8 envs, a 20k ring, no_terminal, 8 update loops an iteration.
    Run A: 2 epochs straight through.  Run B: 1 epoch, then a full resume
    to 2 epochs.  Fails unless the launch counts are the spec's (K1 once
    per control step of warmup, training and the 32-env evaluation; K2, K3
    and K4 never: the inner SAC steps run eagerly between discriminator
    steps, acting goes through the nn.Module, hopper is planar), B's end
    state equals A's bit for bit, progress.csv holds every metric finite
    (gail2 rewards <= 0) and B's rows equal A's but for the wall clocks,
    and K1 agrees with its plain version on run A's end states at B = 8
    and 32 (`k1_check`, phase 3's check).  Times the iteration's parts:
    K1 at B = 8, one discriminator step and one policy step (host clock,
    synchronized, on run B's end state; their device operations and
    device time from a torch.profiler trace), and a full snapshot's save
    and load."""
    import os
    import shutil

    from ilswiss_tpu_torch.ops.fused_sac import METRIC_NAMES
    from ilswiss_tpu_torch.runtime.checkpoint import to_tree
    from ilswiss_tpu_torch.runtime.loop import Noise
    from ilswiss_tpu_torch.testing import tree_diff

    # the spec names its demos relative to the checkout's root
    os.chdir(ROOT)
    out = ROOT / "build" / "chip_smoke_gail"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    variant, full = cut_spec(GAIL_SPEC, out, GAIL_CUT)

    # the trainer the launcher builds, kept for the timings below
    algos = []

    def run(name, num_epochs, **extra):
        with kept_algos() as kept:
            result = run_spec("adv_irl", variant, out / name, counters,
                              num_epochs, **extra)
        algos.extend(kept)
        return result

    rl = variant["rl_alg_params"]
    n = variant["env_specs"]["env_num"]
    warm = rl["min_steps_before_training"] // n
    iters = rl["num_steps_per_epoch"] // n
    evals = rl["max_path_length"]

    def want(epochs, warmup):
        return {"planar_control_step": (warm if warmup else 0)
                + epochs * (iters + evals), "planar_forward": 0,
                "fused_sac_chain": 0, "fused_policy_forward": 0,
                "pgs_solve": 0}

    a, a_launches, a_s = run("a", 2)
    b1, b1_launches, b1_s = run("b", 1)
    b, b_launches, b_s = run("b", 2, load_params=str(out / "b"))
    check_launches("GAIL", (("A (2 epochs)", a_launches, want(2, True)),
                            ("B (1 epoch)", b1_launches, want(1, True)),
                            ("B resumed to 2 epochs", b_launches,
                             want(1, False))))
    print(f"GAIL runs: A {a_s:.1f} s, B {b1_s:.1f} s + resume {b_s:.1f} s "
          f"(wall time of each call), on {card}")

    a_tree = to_tree(a)
    bad = tree_diff(a_tree, to_tree(b))
    if bad:
        fail(f"the resumed GAIL run B differs from run A in {bad[:10]}")
    print("GAIL resume: B's end state equals A's bit for bit (the "
          "discriminator and its Adam, the SAC state, the expert buffer, "
          "the ring, the env state, the noise generator)")

    a_rows, b_rows = progress_rows(out / "a"), progress_rows(out / "b")
    need = ([f"trainer/{k}" for k in GAIL_METRICS]
            + [f"trainer/policy_{k}" for k in METRIC_NAMES]
            + ["AverageReturn", "StdReturn", "AvgPathLength",
               "TotalEnvSteps", "TrainTime", "EvalTime", "EnvStepsPerSec"])
    check_progress("GAIL", a_rows, b_rows, need,
                   [float(rl["min_steps_before_training"] + (e + 1)
                          * rl["num_steps_per_epoch"]) for e in range(2)])
    for r in a_rows + b_rows:
        if float(r["trainer/disc_rew_mean"]) > 0:
            fail(f"GAIL: gail2 rewards are log D <= 0, a mean reads "
                 f"{r['trainer/disc_rew_mean']}")
    keys = ["TrainTime", "EvalTime", "EnvStepsPerSec", "AverageReturn"] \
        + [f"trainer/{k}" for k in GAIL_METRICS]
    epochs = [{k: float(r[k]) for k in keys} for r in a_rows + b_rows]
    for (run_name, ep), e in zip((("A", 0), ("A", 1), ("B", 0), ("B", 1)),
                                 epochs):
        print(f"GAIL run {run_name} epoch {ep}: TrainTime "
              f"{e['TrainTime']:.3f} s, EvalTime {e['EvalTime']:.3f} s, "
              f"EnvStepsPerSec {e['EnvStepsPerSec']:.1f}, AverageReturn "
              f"{e['AverageReturn']:.3f}, "
              + ", ".join(f"{k} {e[f'trainer/{k}']:.4g}"
                          for k in GAIL_METRICS) + f", on {card}")

    size, save_s, load_s = snapshot_times("GAIL", out / "snapshot", a, b1,
                                          a_tree)
    print(f"GAIL full snapshot: {size:.1f} MiB on disk, save "
          f"{save_s:.3f} s, load {load_s:.3f} s, on {card}")
    k1_ms, k1_err = k1_on_end_states("GAIL", a, n,
                                     counters["planar_control_step"],
                                     k1_check, 11)

    # the iteration's update steps, on run B's end state (B is not read
    # again): one discriminator step and one policy step, host clock over
    # 20 of each after 3 unmeasured; then what one step asks of the
    # device, its device operations (kernels, copies) and their summed
    # device time, from a torch.profiler trace of 3 steps
    algo = algos[-1]
    noise = Noise(123, a.env_state.obs.device)
    disc_ms, disc_ops, disc_dev_ms = step_costs(
        lambda: algo._disc_update(b.algo_state, b.replay, noise))
    policy_ms, policy_ops, policy_dev_ms = step_costs(
        lambda: algo._policy_update(b.algo_state, b.replay, noise))
    print(f"GAIL update steps: a discriminator step {disc_ops:.0f} device "
          f"operations, {disc_dev_ms:.3f} ms of device time in "
          f"{disc_ms:.3f} ms of wall time; a policy step {policy_ops:.0f}, "
          f"{policy_dev_ms:.3f} ms in {policy_ms:.3f} ms; on {card}")
    cfg = algo.config
    loops = cfg.num_update_loops_per_train_call
    n_disc = loops * cfg.num_disc_updates_per_loop_iter
    n_pol = loops * cfg.num_policy_updates_per_loop_iter
    it_ms = 1e3 * sum(e["TrainTime"] for e in epochs) / (len(epochs) * iters)
    parts = k1_ms[n] + n_disc * disc_ms + n_pol * policy_ms
    busy = k1_ms[n] + n_disc * disc_dev_ms + n_pol * policy_dev_ms
    print(f"GAIL iteration: {it_ms:.3f} ms (mean over the 4 epochs); K1 at "
          f"B = {n}: {k1_ms[n]:.4f} ms, {n_disc} discriminator steps x "
          f"{disc_ms:.3f} ms, {n_pol} policy (SAC) steps x "
          f"{policy_ms:.3f} ms: {parts / it_ms:.1%} of it; the device "
          f"busy for about {busy / it_ms:.1%} of it (K1 and the steps' "
          f"device time; acting and the ring not counted); K1 at "
          f"B = {4 * n} (the evaluator): {k1_ms[4 * n]:.4f} ms of a "
          f"{1e3 * sum(e['EvalTime'] for e in epochs) / (4 * evals):.3f} ms "
          f"control step; on {card}")
    full_iters = full["num_steps_per_epoch"] // n
    full_h = (it_ms * 1e-3 * full_iters + sum(
        e["EvalTime"] for e in epochs) / len(epochs)) \
        * full["num_epochs"] / 3600
    print(f"GAIL spec at full length ({full['num_epochs']} epochs of "
          f"{full_iters} iterations and an evaluation each), at these "
          f"rates: {full_h:.2f} h, on {card}")
    return {"launches": a_launches, "resumed_launches": b_launches,
            "k1_ms": k1_ms, "k1_err": k1_err, "iteration_ms": it_ms,
            "disc_step_ms": disc_ms, "policy_step_ms": policy_ms,
            "disc_device_ms": disc_dev_ms, "policy_device_ms": policy_dev_ms,
            "disc_ops": disc_ops, "policy_ops": policy_ops,
            "device_busy_share": busy / it_ms,
            "snapshot_mib": size, "save_s": save_s, "load_s": load_s,
            "full_spec_hours": full_h, "epochs": epochs}


# Phase 11: TD3 through the port's launcher, cut in length only
TD3_SPEC = "exp_specs/td3/td3_hopper.yaml"
TD3_CUT = {"num_epochs": 2, "num_steps_per_epoch": 400}
TD3_METRICS = ["qf1_loss", "qf2_loss", "policy_loss", "q_target_mean"]
EVAL_COLUMNS = ["AverageReturn", "MaxReturn", "MinReturn", "StdReturn",
                "AvgPathLength", "TotalEnvSteps", "TrainTime", "EvalTime",
                "EnvStepsPerSec"]


def k1_want(variant: dict, epochs: int, warmup: bool, planar: bool) -> dict:
    """The launch counts of `epochs` epochs of a launcher run of `variant`
    on an eager learner: K1 once per control step of warmup
    (min_steps_before_training // env_num iterations), training
    (num_steps_per_epoch // env_num iterations an epoch) and evaluation
    (max_path_length steps an epoch) on a planar env, never on an analytic
    one; K2, K3 and K4 never (only SAC sets the fused chain and fused
    acting, and hopper is planar)."""
    rl = variant["rl_alg_params"]
    n = variant["env_specs"]["env_num"]
    steps = ((rl["min_steps_before_training"] // n if warmup else 0)
             + epochs * (rl["num_steps_per_epoch"] // n
                         + rl["max_path_length"]))
    return {"planar_control_step": steps if planar else 0,
            "planar_forward": 0, "fused_sac_chain": 0,
            "fused_policy_forward": 0, "pgs_solve": 0}


def env_steps(variant: dict, epochs: int) -> int:
    """TotalEnvSteps after warmup and `epochs` epochs: whole iterations of
    env_num steps each."""
    rl = variant["rl_alg_params"]
    n = variant["env_specs"]["env_num"]
    return n * (rl["min_steps_before_training"] // n
                + epochs * (rl["num_steps_per_epoch"] // n))


def straight_and_resumed(what: str, name: str, variant: dict, out: Path,
                         counters: dict, card: str, planar: bool,
                         metrics: list) -> dict:
    """Run A: 2 epochs of `variant` through `EXPERIMENTS[name]`; run B: 1
    epoch, then a full resume to 2.  Fails unless the launch counts are
    `k1_want`'s, B's end state equals A's bit for bit, and progress.csv
    holds the `metrics` and every value finite, TotalEnvSteps as the
    schedule gives them, and B's rows equal to A's but for the wall
    clocks.  Returns the runners, launches, the trainer, the epochs' rows
    and the calls' wall seconds."""
    from ilswiss_tpu_torch.runtime.checkpoint import to_tree
    from ilswiss_tpu_torch.testing import tree_diff

    with kept_algos() as algos:
        a, a_launches, a_s = run_spec(name, variant, out / "a", counters, 2)
        b1, b1_launches, b1_s = run_spec(name, variant, out / "b",
                                         counters, 1)
        b, b_launches, b_s = run_spec(name, variant, out / "b", counters, 2,
                                      load_params=str(out / "b"))
    check_launches(what, (
        ("A (2 epochs)", a_launches, k1_want(variant, 2, True, planar)),
        ("B (1 epoch)", b1_launches, k1_want(variant, 1, True, planar)),
        ("B resumed to 2 epochs", b_launches,
         k1_want(variant, 1, False, planar))))
    print(f"{what} runs: A {a_s:.1f} s, B {b1_s:.1f} s + resume {b_s:.1f} s "
          f"(wall time of each call), on {card}")
    a_tree = to_tree(a)
    bad = tree_diff(a_tree, to_tree(b))
    if bad:
        fail(f"the resumed {what} run B differs from run A in {bad[:10]}")
    print(f"{what} resume: B's end state equals A's bit for bit (every "
          f"network, target, Adam's moments and count, the step counters, "
          f"the ring, the env state, the noise generator)")
    a_rows, b_rows = progress_rows(out / "a"), progress_rows(out / "b")
    check_progress(what, a_rows, b_rows,
                   [f"trainer/{k}" for k in metrics] + EVAL_COLUMNS,
                   [float(env_steps(variant, e)) for e in (1, 2)])
    rows = [{k: float(r[k]) for k in ["TrainTime", "EvalTime",
                                      "EnvStepsPerSec", "AverageReturn"]
             + [f"trainer/{m}" for m in metrics]}
            for r in a_rows + b_rows]
    for (run_name, ep), e in zip((("A", 0), ("A", 1), ("B", 0), ("B", 1)),
                                 rows):
        print(f"{what} run {run_name} epoch {ep}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in e.items()) + f", on {card}")
    return {"a": a, "b": b, "b1": b1, "a_tree": a_tree,
            "launches": a_launches, "resumed_launches": b_launches,
            "algo": algos[-1], "rows": rows, "seconds": [a_s, b1_s, b_s]}


def train_step_costs(algo, runner, batch_size: int, seed: int) -> tuple:
    """`step_costs` of one gradient step as the loop takes it: a replay
    sample and `train_step` with the trainer's own draws, on `runner`'s
    end state and ring (the runner is not read again)."""
    from ilswiss_tpu_torch.data.replay import replay_sample
    from ilswiss_tpu_torch.runtime.loop import Noise

    noise = Noise(seed, runner.env_state.obs.device)

    def step():
        batch = replay_sample(runner.replay, noise.replay(batch_size))
        algo.train_step(runner.algo_state, batch,
                        *algo.train_noise(noise, batch_size))
    return step_costs(step)


def td3_phase(card: str, counters: dict, k1_check) -> dict:
    """Phase 11: a copy of TD3_SPEC under build/chip_smoke_td3/ with only
    TD3_CUT changed (num_epochs 102 -> 2, num_steps_per_epoch 10000 ->
    400: 50 iterations of 8 envs an epoch, K = 8), through
    `build_variants` and `EXPERIMENTS["td3"]` on the card: TD3 256 x 2 on
    hopper, batch 256, a 1M ring, 5000 warmup steps, the 32-env evaluator.
    Run A: 2 epochs; run B: 1 epoch, then a full resume
    (`straight_and_resumed`: K1 2725 / 1675 / 1050, K2 = K3 = K4 = 0, B
    bit-equal to A).  K1 at B = 8 and 32 on run A's end states against its
    plain version (phase 3's check).  Times one TD3 step (wall, device
    operations and device time), splits the iteration into K1, 8 steps
    and the rest, times a full snapshot's save and load, and estimates the
    spec's wall time at full length."""
    import shutil

    out = ROOT / "build" / "chip_smoke_td3"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    variant, full = cut_spec(TD3_SPEC, out, TD3_CUT)
    want = [k1_want(variant, e, w, True)["planar_control_step"]
            for e, w in ((2, True), (1, True), (1, False))]
    if want != [2725, 1675, 1050]:
        fail(f"TD3: the spec's launch counts are not phase 11's: {want}")
    r = straight_and_resumed("TD3", "td3", variant, out, counters, card,
                             True, TD3_METRICS)
    a, algo = r["a"], r["algo"]
    rl = variant["rl_alg_params"]
    n = variant["env_specs"]["env_num"]
    size, save_s, load_s = snapshot_times("TD3", out / "snapshot", a,
                                          r["b1"], r["a_tree"])
    print(f"TD3 full snapshot: {size:.1f} MiB on disk, save {save_s:.3f} s, "
          f"load {load_s:.3f} s, on {card}")
    k1_ms, k1_err = k1_on_end_states("TD3", a, n,
                                     counters["planar_control_step"],
                                     k1_check, 13)
    step_ms, step_ops, step_dev_ms = train_step_costs(
        algo, r["b"], rl["batch_size"], 17)
    iters = rl["num_steps_per_epoch"] // n
    k = round(n * rl["num_train_steps_per_train_call"]
              / rl["num_steps_between_train_calls"])
    it_ms = 1e3 * sum(e["TrainTime"] for e in r["rows"]) / (
        len(r["rows"]) * iters)
    rest = it_ms - k1_ms[n] - k * step_ms
    eval_s = sum(e["EvalTime"] for e in r["rows"]) / len(r["rows"])
    print(f"TD3 step (batch {rl['batch_size']}, 256 x 2): {step_ms:.3f} ms "
          f"of wall time, {step_ops:.0f} device operations, "
          f"{step_dev_ms:.3f} ms of device time; on {card}")
    print(f"TD3 iteration: {it_ms:.3f} ms (mean over the 4 epochs) = K1 at "
          f"B = {n} {k1_ms[n]:.4f} ms + {k} TD3 steps x {step_ms:.3f} ms + "
          f"the rest {rest:.3f} ms (acting, the env's other work, the ring, "
          f"the host); the device busy for about "
          f"{(k1_ms[n] + k * step_dev_ms) / it_ms:.1%} of it (K1 and the "
          f"steps' device time); K1 at B = {4 * n} (the evaluator): "
          f"{k1_ms[4 * n]:.4f} ms of a "
          f"{1e3 * eval_s / rl['max_path_length']:.3f} ms control step; "
          f"on {card}")
    full_iters = full["num_steps_per_epoch"] // n
    full_h = (it_ms * 1e-3 * full_iters + eval_s) * full["num_epochs"] / 3600
    print(f"TD3 spec at full length ({full['num_epochs']} epochs of "
          f"{full_iters} iterations and an evaluation each), at these "
          f"rates: {full_h:.2f} h, on {card}")
    return {"launches": r["launches"], "resumed_launches":
            r["resumed_launches"], "k1_ms": k1_ms, "k1_err": k1_err,
            "step_ms": step_ms, "step_ops": step_ops,
            "step_device_ms": step_dev_ms, "iteration_ms": it_ms,
            "rest_ms": rest, "snapshot_mib": size, "save_s": save_s,
            "load_s": load_s, "full_spec_hours": full_h,
            "epochs": r["rows"], "seconds": r["seconds"]}


# Phase 12: the other four trainers through the launcher, at their specs'
# widths, cut in num_epochs only (DDPG and SAC-V on TD3_SPEC's cut copy)
DQN_SPEC = "exp_specs/dqn/dqn_cartpole.yaml"
DISCRETE_SAC_SPEC = "exp_specs/sac/sac_cartpole_d.yaml"
OTHER_METRICS = {
    "dqn": ["qf_loss", "q_pred_mean", "epsilon"],
    "discrete_sac": ["qf1_loss", "qf2_loss", "policy_loss"],
    "ddpg": ["qf_loss", "policy_loss", "q_target_mean"],
    "sac_v": ["qf1_loss", "qf2_loss", "vf_loss", "policy_loss",
              "log_pi_mean"],
}


def one_epoch(what: str, name: str, variant: dict, out: Path,
              counters: dict, card: str, planar: bool) -> dict:
    """One epoch of `variant` through `EXPERIMENTS[name]`: launch counts
    exact (`k1_want`), progress.csv's row finite with the trainer's
    metrics and TotalEnvSteps as the schedule gives it."""
    with kept_algos() as algos:
        runner, launches, seconds = run_spec(name, variant, out, counters, 1)
    check_launches(what, (("(1 epoch)", launches,
                           k1_want(variant, 1, True, planar)),))
    (row,) = progress_rows(out)
    need = [f"trainer/{k}" for k in OTHER_METRICS[name]] + EVAL_COLUMNS
    if not set(need) <= set(row) or not all(
            math.isfinite(float(v)) for v in row.values()):
        fail(f"{what}: progress.csv row {row}")
    if float(row["TotalEnvSteps"]) != env_steps(variant, 1):
        fail(f"{what}: TotalEnvSteps {row['TotalEnvSteps']}, expected "
             f"{env_steps(variant, 1)}")
    e = {k: float(row[k]) for k in need if k != "TotalEnvSteps"}
    print(f"{what} epoch 0 ({seconds:.1f} s for the call): " + ", ".join(
        f"{k} {v:.6g}" for k, v in e.items()) + f", on {card}")
    return {"runner": runner, "launches": launches, "algo": algos[-1],
            "row": e, "seconds": seconds}


def other_trainers_phase(card: str, counters: dict) -> dict:
    """Phase 12: DQN_SPEC (16 cartpole envs, 128 x 2, batch 128, K = 8,
    250 iterations an epoch) run 2 epochs straight and 1 epoch plus a full
    resume, bit-equal, carrying epsilon's counters; DISCRETE_SAC_SPEC (128
    envs, 128 x 2, batch 128, K = 13, 78 iterations an epoch) for 1 epoch,
    whose trainer must hold the spec's alpha 0.05 and discount 0.95 (the
    block the JAX launcher does not read) and whose debug.log must say
    so; DDPG and SAC-V through `EXPERIMENTS["ddpg"]` and
    `EXPERIMENTS["sac_v"]` on TD3_SPEC's cut copy (phase 11's, 1 epoch of
    400 steps) with td3_params' values that each trainer reads moved under
    `ddpg_params` / `sac_params`: K1 exactly 1675 each.  CartPole paths
    launch no kernel.  For each: one gradient step's wall ms, device
    operations and device ms, TrainTime and EvalTime."""
    import copy
    import shutil

    out = ROOT / "build" / "chip_smoke_offpolicy"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    result = {}

    def costs(name, algo, runner, batch_size, seed):
        ms, ops, dev_ms = train_step_costs(algo, runner, batch_size, seed)
        print(f"{name} step (batch {batch_size}): {ms:.3f} ms of wall time, "
              f"{ops:.0f} device operations, {dev_ms:.3f} ms of device "
              f"time; on {card}")
        return {"step_ms": ms, "step_ops": ops, "step_device_ms": dev_ms}

    # DQN on cartpole: straight and resumed
    dqn = spec_variant(DQN_SPEC)
    r = straight_and_resumed("DQN", "dqn", dqn, out / "dqn", counters, card,
                             False, OTHER_METRICS["dqn"])
    rl = dqn["rl_alg_params"]
    steps = 2 * rl["num_steps_per_epoch"]
    state = r["a"].algo_state
    if state.n_act_steps != steps or r["algo"].epsilon(state) != \
            r["algo"].epsilon(r["b"].algo_state):
        fail(f"DQN: epsilon counted {state.n_act_steps} env steps, "
             f"expected {steps}")
    print(f"DQN epsilon after 2 epochs: {r['algo'].epsilon(state):.6f} at "
          f"{state.n_act_steps} env steps of training, "
          f"{state.n_train_steps} gradient steps")
    result["dqn"] = dict(costs("DQN", r["algo"], r["b"], rl["batch_size"],
                               21), launches=r["launches"],
                         resumed_launches=r["resumed_launches"],
                         epochs=r["rows"], seconds=r["seconds"])

    # discrete SAC on cartpole: 1 epoch, the spec's own parameters
    dsac = spec_variant(DISCRETE_SAC_SPEC)
    e = one_epoch("discrete SAC", "discrete_sac", dsac, out / "dsac",
                  counters, card, False)
    cfg = e["algo"].config
    log = (out / "dsac" / "debug.log").read_text()
    if (cfg.alpha, cfg.discount) != (0.05, 0.95) or \
            "alpha=0.05" not in log or "discount=0.95" not in log:
        fail(f"discrete SAC trains at alpha {cfg.alpha}, discount "
             f"{cfg.discount}, not the spec's 0.05 and 0.95")
    print(f"discrete SAC trainer (debug.log): alpha {cfg.alpha}, discount "
          f"{cfg.discount}, policy_lr {cfg.policy_lr}, soft_target_tau "
          f"{cfg.soft_target_tau} (the spec's discrete_sac_params)")
    result["discrete_sac"] = dict(
        costs("discrete SAC", e["algo"], e["runner"],
              dsac["rl_alg_params"]["batch_size"], 22),
        launches=e["launches"], epoch=e["row"], seconds=e["seconds"])

    # DDPG and SAC-V on hopper: phase 11's cut copy of TD3_SPEC
    td3 = spec_variant(Path("build") / "chip_smoke_td3" / Path(TD3_SPEC).name)
    reads = {"ddpg": ("ddpg_params", ("discount", "reward_scale",
                                      "policy_lr", "qf_lr",
                                      "soft_target_tau")),
             "sac_v": ("sac_params", ("discount", "reward_scale",
                                      "soft_target_tau", "policy_lr",
                                      "qf_lr"))}
    for name, (block, keys) in reads.items():
        v = copy.deepcopy(td3)
        p = v.pop("td3_params")
        v[block] = {k: p[k] for k in keys if k in p}
        what = {"ddpg": "DDPG", "sac_v": "SAC-V"}[name]
        e = one_epoch(what, name, v, out / name, counters, card, True)
        if e["launches"]["planar_control_step"] != 1675:
            fail(f"{what}: K1 launched {e['launches']} times, not 1675")
        result[name] = dict(costs(what, e["algo"], e["runner"],
                                  v["rl_alg_params"]["batch_size"], 23),
                            launches=e["launches"], epoch=e["row"],
                            seconds=e["seconds"])
    return result


# Phase 13: PPO through the port's launcher, cut in length only
PPO_SPEC = "exp_specs/ppo/ppo_hopper.yaml"
PPO_CUT = {"num_epochs": 2, "num_steps_per_epoch": 2048}
PPO_K1 = 2256            # K1 launches of the cut spec: 2 x (128 + 1000)
PPO_METRICS = ["vf_loss", "pg_loss", "adv_mean_abs", "value_mean",
               "rollout_reward_mean"]


@contextlib.contextmanager
def kept_loops():
    """Inside: every on-policy loop a launcher initializes is appended to
    the yielded list (for timings after the run)."""
    from ilswiss_tpu_torch.runtime import onpolicy

    loops = []
    init = onpolicy.OnPolicyLoop.init

    def keep(self, *args, **kwargs):
        loops.append(self)
        return init(self, *args, **kwargs)

    onpolicy.OnPolicyLoop.init = keep
    try:
        yield loops
    finally:
        onpolicy.OnPolicyLoop.init = init


def ppo_phase(card: str, counters: dict, k1_check) -> dict:
    """Phase 13: a copy of PPO_SPEC under build/chip_smoke_ppo/ with only
    PPO_CUT changed (num_epochs 200 -> 2, num_steps_per_epoch 10000 ->
    2048: one iteration of T = 128 steps of 16 envs an epoch), through
    `build_variants` and `EXPERIMENTS["ppo"]` on the card: PPO 256 x 2 on
    hopper, minibatch 64, 10 passes, obs_norm, the 1000-step evaluation on
    the 16 training envs.  Fails unless K1 launched once per control step
    of the rollouts and evaluations (K2, K3 and K4 never), progress.csv
    holds the trainer's metrics and every value finite with TotalEnvSteps
    2048 / 4096, the moments' count is 1e-4 + 2 x 2048 (in float32), the
    run's 'last' snapshot restores into a fresh runner bit for bit, and K1
    agrees with its plain version on the end states at B = 16
    (`k1_check`, phase 3's check).  Times the iteration's rollout and
    update, one minibatch step (wall, device operations and device time),
    a full snapshot's save and load, and estimates the spec's wall time
    at full length."""
    import shutil

    import torch

    from ilswiss_tpu_torch.models.distributions import normal_log_prob
    from ilswiss_tpu_torch.runtime.checkpoint import (
        restore_checkpoint, to_tree,
    )
    from ilswiss_tpu_torch.testing import tree_diff

    out = ROOT / "build" / "chip_smoke_ppo"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    variant, full = cut_spec(PPO_SPEC, out, PPO_CUT)
    rl, p = variant["rl_alg_params"], variant["ppo_params"]
    n, T = variant["env_specs"]["env_num"], p["rollout_length"]
    iters = rl["num_steps_per_epoch"] // (T * n)
    evals = rl["max_path_length"]
    want = {"planar_control_step": 2 * (iters * T + evals),
            "planar_forward": 0, "fused_sac_chain": 0,
            "fused_policy_forward": 0, "pgs_solve": 0}
    if want["planar_control_step"] != PPO_K1:
        fail(f"PPO: the spec's schedule is not phase 13's: {iters} "
             f"iterations an epoch, {want}")
    with kept_loops() as loops:
        runner, launches, seconds = run_spec("ppo", variant, out / "a",
                                             counters, 2)
    check_launches("PPO", (("A (2 epochs)", launches, want),))
    loop = loops[-1]
    ppo = loop.algo
    rows = progress_rows(out / "a")
    need = [f"trainer/{k}" for k in PPO_METRICS] + EVAL_COLUMNS
    if len(rows) != 2 or not set(need) <= set(rows[0]):
        fail(f"PPO: progress.csv has {len(rows)} rows, columns "
             f"{list(rows[0]) if rows else []}")
    steps = [float((e + 1) * iters * T * n) for e in range(2)]
    if [float(r["TotalEnvSteps"]) for r in rows] != steps:
        fail(f"PPO: TotalEnvSteps {[r['TotalEnvSteps'] for r in rows]}, "
             f"expected {steps}")
    if not all(math.isfinite(float(v)) for r in rows for v in r.values()):
        fail("PPO: a value of progress.csv is not finite")
    epochs = [{k: float(r[k]) for k in need if k != "TotalEnvSteps"}
              for r in rows]
    for ep, e in enumerate(epochs):
        print(f"PPO epoch {ep}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in e.items()) + f", on {card}")
    print(f"PPO run: {seconds:.1f} s for the call (2 epochs), on {card}")

    # the moments merged 2 x 2048 rollout rows, counted in float32
    count = torch.tensor(1e-4, dtype=torch.float32)
    for _ in range(2 * iters):
        count = count + float(T * n)
    if float(runner.obs_rms.count) != float(count):
        fail(f"PPO: the moments count {float(runner.obs_rms.count)} "
             f"rows, expected {float(count)}")
    print(f"PPO moments: count {float(runner.obs_rms.count)} (1e-4 + "
          f"{2 * iters * T * n} rows in float32), mean |mean| "
          f"{float(runner.obs_rms.mean.abs().mean()):.4g}, mean var "
          f"{float(runner.obs_rms.var.mean()):.4g}")

    # the run's own 'last' snapshot, restored into a fresh runner
    tree = to_tree(runner)
    fresh = loop.init(variant.get("seed", 0) + 7)
    restore_checkpoint(str(out / "a" / "checkpoints" / "last"), fresh)
    bad = tree_diff(tree, to_tree(fresh))
    if bad:
        fail(f"PPO: the 'last' snapshot restored into a fresh runner "
             f"differs in {bad[:10]}")
    print("PPO 'last' snapshot: restored into a fresh runner, bit for bit "
          "(both networks, both Adams' moments and counts, the moments, "
          "the env state, the noise generator)")
    size, save_s, load_s = snapshot_times("PPO", out / "snapshot", runner,
                                          loop.init(11), tree)
    print(f"PPO full snapshot: {size:.2f} MiB on disk, save {save_s:.3f} s, "
          f"load {load_s:.3f} s, on {card}")
    k1_ms, k1_err = k1_on_end_states("PPO", runner, n,
                                     counters["planar_control_step"],
                                     k1_check, 19, sizes=(n,))

    # an iteration's two halves, on the end state (read no more after
    # this): the rollout (T acting steps and the moments) and the update
    # (GAE, 10 passes of 32 minibatches), host clock, synchronized
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), result

    rollout_ms, (_, rollout, _) = timed(lambda: loop.rollout(runner))
    perms = ppo.train_noise(runner.noise, T * n)[0]
    update_ms, _ = timed(lambda: ppo.train_step(runner.algo_state, rollout,
                                                perms))
    # one minibatch step (the value step, then the policy step) on 64
    # rows of the rollout
    pick = perms[0][:p["mini_batch_size"]]
    flat = lambda x: x.reshape((T * n,) + x.shape[2:])[pick]  # noqa: E731
    with torch.no_grad():
        mean, log_std = runner.algo_state.policy(flat(rollout["obs"]))
        batch = {"obs": flat(rollout["obs"]),
                 "action": flat(rollout["action"]),
                 "return": flat(rollout["reward"]),
                 "adv": torch.randn_like(flat(rollout["reward"])),
                 "fixed_logp": normal_log_prob(
                     mean, log_std, flat(rollout["action"]))[..., 0],
                 "fixed_v": runner.algo_state.vf(
                     flat(rollout["obs"]))[..., 0]}
    mb_ms, mb_ops, mb_dev_ms = step_costs(
        lambda: ppo.minibatch_step(runner.algo_state, batch))
    n_mb = (T * n) // p["mini_batch_size"] * p["update_epoch"]
    it_s = sum(e["TrainTime"] for e in epochs) / (len(epochs) * iters)
    eval_s = sum(e["EvalTime"] for e in epochs) / len(epochs)
    print(f"PPO iteration: TrainTime {1e3 * it_s:.1f} ms (mean of the 2 "
          f"epochs); measured apart: rollout {rollout_ms:.1f} ms ({T} "
          f"control steps, K1 at B = {n} {k1_ms[n]:.4f} ms each), update "
          f"{update_ms:.1f} ms ({n_mb} minibatch steps); one minibatch "
          f"step {mb_ms:.3f} ms of wall time, {mb_ops:.0f} device "
          f"operations, {mb_dev_ms:.3f} ms of device time; the device "
          f"busy for about {(T * k1_ms[n] + n_mb * mb_dev_ms) / (rollout_ms + update_ms):.1%} "
          f"of the two (K1 and the minibatch steps' device time); on {card}")
    full_iters = max(1, full["num_steps_per_epoch"] // (T * n))
    full_h = (it_s * full_iters + eval_s) * full["num_epochs"] / 3600
    print(f"PPO spec at full length ({full['num_epochs']} epochs of "
          f"{full_iters} iterations and a {evals}-step evaluation each), at "
          f"these rates: {full_h:.2f} h, on {card}")
    return {"launches": launches, "k1_ms": k1_ms, "k1_err": k1_err,
            "rollout_ms": rollout_ms, "update_ms": update_ms,
            "minibatch_ms": mb_ms, "minibatch_ops": mb_ops,
            "minibatch_device_ms": mb_dev_ms, "iteration_s": it_s,
            "eval_s": eval_s, "snapshot_mib": size, "save_s": save_s,
            "load_s": load_s, "full_spec_hours": full_h, "epochs": epochs,
            "seconds": seconds}


# Phase 14: the rnn discriminator through the launcher: GAIL_SPEC with
# disc_type rnn (the JAX defaults: T = 16, gru, 2 layers, bidirectional),
# cut in length further than phase 10 (see rnn_gail_phase)
RNN_GAIL_CUT = {"num_epochs": 2, "num_steps_per_epoch": 24}
RNN_GAIL_K1 = [2631, 1628, 1003]     # runs A, B, B's resume


class ReplayedDraws:
    """`Noise`'s replay, interpolation and model-rollout draws, answered
    from a list of (kind, CPU tensor) in order, on `device`: the same
    draws for a step on the card and on the CPU."""

    def __init__(self, draws, device):
        self.draws, self.device = list(draws), device

    def _next(self, kind):
        got, value = self.draws.pop(0)
        if got != kind:
            fail(f"drew {kind} where the replayed draws hold {got}")
        return value.to(self.device)

    def replay(self, n):
        return self._next("replay")

    def interpolation(self, n):
        return self._next("interpolation")

    def act(self, shape):
        return self._next("act")

    def elite(self, n, num_elites):
        return self._next("elite")

    def model(self, shape):
        return self._next("model")

    def train(self, shape):
        return self._next("eps_next"), self._next("eps_new")


def compare_trees(what: str, got, want, rtol: float, atol: float) -> float:
    """`got` against `want` (trees as `to_tree` makes them) leaf by leaf
    at rtol / atol, scalars exactly; fails naming the first leaf outside.
    Returns the largest |got - want|."""
    import torch

    worst = 0.0

    def walk(g, w, path):
        nonlocal worst
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, list):
            for i, (gi, wi) in enumerate(zip(g, w)):
                walk(gi, wi, f"{path}[{i}]")
        elif isinstance(w, torch.Tensor):
            if not torch.allclose(g, w, rtol=rtol, atol=atol):
                fail(f"{what}: the card's {path} differs from the CPU's by "
                     f"{float((g - w).abs().max()):.3g}")
            if w.numel():
                worst = max(worst, float((g - w).abs().max()))
        elif g != w:
            fail(f"{what}: {path} is {g} on the card, {w} on the CPU")

    walk(got, want, "")
    return worst


def rnn_gail_phase(card: str, counters: dict, k1_check) -> dict:
    """Phase 14: a copy of GAIL_SPEC under build/chip_smoke_gail_rnn/ with
    `disc_type: rnn` and RNN_GAIL_CUT (num_epochs 162 -> 2,
    num_steps_per_epoch 10000 -> 24: 3 iterations of 8 discriminator and
    8 SAC steps an epoch, shorter than phase 10's 50: an rnn iteration
    takes about 2 s, and the phase stays under a minute), through
    `EXPERIMENTS["adv_irl"]` on the card:
    the spec's widths (SAC 256 x 2, batch 256, 8 envs, a 20k ring) with
    a 2-layer bidirectional GRU discriminator of width 128 over windows of
    16 steps (16 windows a step).  Run A: 2 epochs; run B: 1 epoch, then
    a full resume (`straight_and_resumed`: K1 2631 / 1628 / 1003, K2 =
    K3 = K4 = 0, B bit-equal to A, every metric finite, gail2 rewards
    <= 0).  K1 at B = 8 and 32 on run A's end states against its plain
    version (phase 3's check).  One rnn `_disc_update` from run B's
    1-epoch state on the card and on a CPU copy, with the same draws,
    must agree at rtol 2e-4, atol 2e-5 (parameters, Adam moments,
    metrics).  Times a discriminator step and a policy step (wall, device
    operations and device time) and reads the share of masked steps in
    the policy batches of run A's ring."""
    import os
    import shutil

    import torch

    from ilswiss_tpu_torch.algorithms.adv_irl import AdvIRL
    from ilswiss_tpu_torch.algorithms.sac import SAC
    from ilswiss_tpu_torch.data.replay import (
        ReplayState, replay_sample_window,
    )
    from ilswiss_tpu_torch.models.rnn_discriminators import RNNDisc
    from ilswiss_tpu_torch.runtime.checkpoint import restore_into, to_tree
    from ilswiss_tpu_torch.runtime.loop import Noise

    os.chdir(ROOT)
    out = ROOT / "build" / "chip_smoke_gail_rnn"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    variant, full = cut_spec(GAIL_SPEC, out, RNN_GAIL_CUT,
                             {"disc_type": "rnn"})
    want = [k1_want(variant, e, w, True)["planar_control_step"]
            for e, w in ((2, True), (1, True), (1, False))]
    if want != RNN_GAIL_K1:
        fail(f"rnn GAIL: the spec's launch counts are not phase 14's: "
             f"{want}")
    r = straight_and_resumed("rnn GAIL", "adv_irl", variant, out, counters,
                             card, True, GAIL_METRICS)
    a, algo = r["a"], r["algo"]
    cfg = algo.config
    disc = a.algo_state.disc
    if not (isinstance(disc, RNNDisc) and disc.cell_f0.features == 128
            and (cfg.disc_traj_len, cfg.disc_rnn_cell, disc.num_layers,
                 disc.bidirectional) == (16, "gru", 2, True)):
        fail(f"rnn GAIL: the discriminator is {type(disc).__name__} with "
             f"{cfg}")
    for e in r["rows"]:
        if e["trainer/disc_rew_mean"] > 0:
            fail(f"rnn GAIL: gail2 rewards are log D <= 0, a mean reads "
                 f"{e['trainer/disc_rew_mean']}")
    n = variant["env_specs"]["env_num"]
    k1_ms, k1_err = k1_on_end_states("rnn GAIL", a, n,
                                     counters["planar_control_step"],
                                     k1_check, 23)

    # one discriminator step on the card and on a CPU copy of run B's
    # 1-epoch state and ring, from the same draws
    T = cfg.disc_traj_len
    n_w = max(1, cfg.disc_optim_batch_size // T)
    gen = torch.Generator().manual_seed(29)
    draws = [("replay", torch.rand(n_w, generator=gen)),
             ("replay", torch.rand(n_w, generator=gen)),
             ("interpolation", torch.rand((n_w, 1), generator=gen))]
    card_state = r["b1"].algo_state
    sac = algo.policy_trainer
    cpu_algo = AdvIRL(algo.obs_size, algo.action_size,
                      SAC(sac.obs_size, sac.action_size, sac.config,
                          net_size=sac.hidden[0],
                          num_hidden_layers=len(sac.hidden), device="cpu"),
                      algo.expert_replay, cfg)
    cpu_state = restore_into(cpu_algo.init(0), to_tree(card_state))
    ring = r["b1"].replay
    cpu_ring = ReplayState(data={k: v.cpu() for k, v in ring.data.items()},
                           ep_id=ring.ep_id.cpu(), ptr=ring.ptr,
                           size=ring.size, env_ep=ring.env_ep.cpu())
    _, m_card = algo._disc_update(card_state, ring,
                                  ReplayedDraws(draws, algo.device))
    _, m_cpu = cpu_algo._disc_update(cpu_state, cpu_ring,
                                     ReplayedDraws(draws, "cpu"))
    worst = compare_trees(
        "rnn GAIL discriminator step",
        to_tree({"disc": card_state.disc, "opt": card_state.disc_opt,
                 "metrics": m_card}),
        to_tree({"disc": cpu_state.disc, "opt": cpu_state.disc_opt,
                 "metrics": m_cpu}), 2e-4, 2e-5)
    print(f"rnn GAIL discriminator step, card vs CPU from the same state "
          f"and draws: parameters, Adam moments and metrics within rtol "
          f"2e-4, atol 2e-5, max |err| {worst:.3g}")

    # the update steps' costs, on run B's end state (not read again)
    b = r["b"]
    noise = Noise(123, a.env_state.obs.device)
    disc_ms, disc_ops, disc_dev_ms = step_costs(
        lambda: algo._disc_update(b.algo_state, b.replay, noise), reps=10)
    policy_ms, policy_ops, policy_dev_ms = step_costs(
        lambda: algo._policy_update(b.algo_state, b.replay, noise), reps=10)
    print(f"rnn GAIL update steps: a discriminator step {disc_ops:.0f} "
          f"device operations, {disc_dev_ms:.3f} ms of device time in "
          f"{disc_ms:.3f} ms of wall time; a policy step {policy_ops:.0f}, "
          f"{policy_dev_ms:.3f} ms in {policy_ms:.3f} ms; on {card}")

    # the masked steps of the policy batches (rewards zeroed, SAC trains
    # on them): run A's ring, 64 batches of the policy step's windows
    n_pw = max(1, cfg.policy_optim_batch_size // T)
    shares = [1.0 - float(replay_sample_window(
        a.replay, noise.replay(n_pw), T)["valid"].float().mean())
        for _ in range(64)]
    masked = sum(shares) / len(shares)
    print(f"rnn GAIL policy batches: {masked:.2%} of the {n_pw * T} steps "
          f"are masked (min {min(shares):.2%}, max {max(shares):.2%}, 64 "
          f"batches of run A's ring, {a.replay.size} rows)")

    loops = cfg.num_update_loops_per_train_call
    iters = variant["rl_alg_params"]["num_steps_per_epoch"] // n
    it_ms = 1e3 * sum(e["TrainTime"] for e in r["rows"]) / (
        len(r["rows"]) * iters)
    parts = k1_ms[n] + loops * (disc_ms + policy_ms)
    busy = k1_ms[n] + loops * (disc_dev_ms + policy_dev_ms)
    eval_s = sum(e["EvalTime"] for e in r["rows"]) / len(r["rows"])
    print(f"rnn GAIL iteration: {it_ms:.3f} ms (mean over the 4 epochs); "
          f"K1 at B = {n}: {k1_ms[n]:.4f} ms, {loops} discriminator steps "
          f"x {disc_ms:.3f} ms, {loops} policy steps x {policy_ms:.3f} ms: "
          f"{parts / it_ms:.1%} of it; the device busy for about "
          f"{busy / it_ms:.1%} of it; on {card}")
    full_iters = full["num_steps_per_epoch"] // n
    full_h = (it_ms * 1e-3 * full_iters + eval_s) * full["num_epochs"] / 3600
    print(f"rnn GAIL spec at full length ({full['num_epochs']} epochs of "
          f"{full_iters} iterations and an evaluation each), at these "
          f"rates: {full_h:.2f} h, on {card}")
    return {"launches": r["launches"],
            "resumed_launches": r["resumed_launches"], "k1_ms": k1_ms,
            "k1_err": k1_err, "card_vs_cpu_err": worst,
            "disc_step_ms": disc_ms, "disc_ops": disc_ops,
            "disc_device_ms": disc_dev_ms, "policy_step_ms": policy_ms,
            "policy_ops": policy_ops, "policy_device_ms": policy_dev_ms,
            "masked_share": masked, "iteration_ms": it_ms,
            "device_busy_share": busy / it_ms, "full_spec_hours": full_h,
            "epochs": r["rows"], "seconds": r["seconds"]}


# Phase 15: MBPO through the launcher, cut in length only (see mbpo_phase)
MBPO_SPEC = "exp_specs/mbpo/mbpo_hopper.yaml"
# one segment of the spec's epoch of four
MBPO_CUT = {"num_epochs": 1, "num_steps_per_epoch": 248}
MBPO_K1 = 1656           # 625 warmup + 1 segment x 31 + 1000 evaluation
MBPO_CHECK_R = 1024      # branches of the card-vs-CPU rollout
MBPO_METRICS = ["qf1_loss", "qf2_loss", "policy_loss", "alpha_loss",
                "alpha", "log_pi_mean", "bnn_epochs", "bnn_train_loss",
                "bnn_holdout_mse", "mean_rollout_length"]


@contextlib.contextmanager
def kept_mbpo():
    """Inside: every MBPO a launcher initializes ("mbpo"), each ensemble
    fit's wall seconds and stats ("fits") and each model rollout's wall
    seconds, length and rows written per step ("rollouts"), host clock,
    synchronized."""
    import torch

    from ilswiss_tpu_torch.algorithms import bnn_trainer, mbpo

    seen = {"mbpo": [], "fits": [], "rollouts": []}
    init = mbpo.MBPO.init
    train = bnn_trainer.BNNTrainer.train
    rollout = mbpo.MBPO._rollout_model

    def keep(self, *args, **kwargs):
        seen["mbpo"].append(self)
        return init(self, *args, **kwargs)

    def timed_train(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stats = train(self, *args, **kwargs)
        torch.cuda.synchronize()
        seen["fits"].append((time.perf_counter() - t0, stats))
        return state, stats

    def timed_rollout(self, runner, length):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = rollout(self, runner, length)
        torch.cuda.synchronize()
        seen["rollouts"].append((time.perf_counter() - t0, length, written))
        return written

    mbpo.MBPO.init = keep
    bnn_trainer.BNNTrainer.train = timed_train
    mbpo.MBPO._rollout_model = timed_rollout
    try:
        yield seen
    finally:
        mbpo.MBPO.init = init
        bnn_trainer.BNNTrainer.train = train
        mbpo.MBPO._rollout_model = rollout


def mbpo_phase(card: str, counters: dict, k1_check) -> dict:
    """Phase 15: a copy of MBPO_SPEC under build/chip_smoke_mbpo/ with only
    MBPO_CUT changed (num_epochs 301 -> 1, num_steps_per_epoch 1000 ->
    248: one segment of 31 iterations), through `build_variants` and
    `EXPERIMENTS["mbpo"]` on the card, at the spec's widths: 8 envs, SAC
    256 x 2 at batch 256 with 160 steps an iteration, the 7-net ensemble
    (5 elites) of 200 x 4, rollouts of 100,000 branches, real_ratio 0.05,
    a 1M-row real ring and a 6,000,000-row model ring, the 5000-step
    warmup and the 1000-step evaluation.  Fails unless K1 launched once
    per control step (MBPO_K1; K2, K3 and K4 never), every progress.csv
    value is finite with TotalEnvSteps 5248, the model ring holds the sum
    of the rows the rollouts wrote, the run's 'last' snapshot restores
    into a fresh runner bit for bit, K1 agrees with its plain version on
    the end states at B = 8 (`k1_check`), and one ensemble minibatch step
    and one model rollout of 3 steps at R = MBPO_CHECK_R on the card agree
    with the same on a CPU copy, from the same state, rows and draws, at
    rtol 2e-4, atol 2e-5 (the ring's cursor and size, and the rows each
    step wrote, exactly).  Then times the ensemble fits, a minibatch step
    and a mixed-batch SAC step (wall, device operations and device time),
    model rollouts of 1 and 15 steps at R = 100,000 from the end state
    (with the branches alive at each step), an iteration, a full snapshot,
    and estimates the spec's wall time at 301 epochs."""
    import dataclasses
    import os
    import shutil

    import torch

    from ilswiss_tpu_torch.algorithms.bnn_trainer import BNNTrainer
    from ilswiss_tpu_torch.algorithms.mbpo import MBPO, MBPORunnerState
    from ilswiss_tpu_torch.algorithms.sac import SAC
    from ilswiss_tpu_torch.data.replay import ReplayState, replay_init
    from ilswiss_tpu_torch.envs import make_vec
    from ilswiss_tpu_torch.runtime.checkpoint import (
        restore_checkpoint, restore_into, to_tree,
    )
    from ilswiss_tpu_torch.runtime.loop import Noise
    from ilswiss_tpu_torch.testing import tree_diff

    out = ROOT / "build" / "chip_smoke_mbpo"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    variant, full = cut_spec(MBPO_SPEC, out, MBPO_CUT)
    rl, mp = variant["rl_alg_params"], variant["mbpo_params"]
    n = variant["env_specs"]["env_num"]
    seg_iters = max(1, mp["model_train_freq"] // n)
    segments = max(1, rl["num_steps_per_epoch"] // (seg_iters * n))
    want = {"planar_control_step": rl["min_steps_before_training"] // n
            + segments * seg_iters + rl["max_path_length"],
            "planar_forward": 0, "fused_sac_chain": 0,
            "fused_policy_forward": 0, "pgs_solve": 0}
    if want["planar_control_step"] != MBPO_K1 or segments != 1:
        fail(f"MBPO: the spec's schedule is not phase 15's: {segments} "
             f"segments of {seg_iters} iterations, {want}")
    torch.cuda.reset_peak_memory_stats()
    with kept_mbpo() as seen:
        runner, launches, seconds = run_spec("mbpo", variant, out / "a",
                                             counters, 1)
    peak = torch.cuda.max_memory_allocated()
    check_launches("MBPO", (("A (1 epoch)", launches, want),))
    mbpo = seen["mbpo"][-1]
    sac, cfg = mbpo.algo, mbpo.config
    R = cfg.rollout_batch_size
    widths = (R, mbpo.bnn.config.num_nets, mbpo.bnn.config.num_elites,
              mbpo.bnn.config.hidden_sizes, sac.hidden,
              mbpo.grad_steps_per_iter, cfg.batch_size, cfg.real_ratio,
              runner.replay.data["reward"].shape[0],
              runner.model_replay.data["reward"].shape[0],
              sac.target_entropy)
    if widths != (100_000, 7, 5, (200,) * 4, (256, 256), 160, 256, 0.05,
                  1_000_000, 6_000_000, -1.0):
        fail(f"MBPO: the run is not at the spec's widths: {widths}")
    rows = progress_rows(out / "a")
    need = [f"trainer/{k}" for k in MBPO_METRICS] + EVAL_COLUMNS
    if len(rows) != 1 or not set(need) <= set(rows[0]):
        fail(f"MBPO: progress.csv has {len(rows)} rows, columns "
             f"{list(rows[0]) if rows else []}")
    row = {k: float(v) for k, v in rows[0].items()}
    if not all(math.isfinite(v) for v in row.values()):
        fail("MBPO: a value of progress.csv is not finite")
    steps = rl["min_steps_before_training"] + segments * seg_iters * n
    if row["TotalEnvSteps"] != steps or runner.total_env_steps != steps:
        fail(f"MBPO: TotalEnvSteps {row['TotalEnvSteps']}, expected {steps}")
    print("MBPO epoch 0: " + ", ".join(
        f"{k} {row[k]:.6g}" for k in need) + f", on {card}")
    print(f"MBPO run: {seconds:.1f} s for the call (warmup, 1 epoch, its "
          f"evaluation and snapshots), peak device memory "
          f"{peak / 2**20:.1f} MiB, on {card}")

    written = [w for _, _, w in seen["rollouts"]]
    capacity = runner.model_replay.data["reward"].shape[0]
    if len(seen["fits"]) != segments or len(written) != segments \
            or runner.model_replay.size != min(capacity,
                                               sum(map(sum, written))):
        fail(f"MBPO: the model ring holds {runner.model_replay.size} rows, "
             f"the {len(written)} rollouts wrote {written}")
    for seg, ((fit_s, stats), (roll_s, length, w)) in enumerate(
            zip(seen["fits"], seen["rollouts"])):
        print(f"MBPO segment {seg}: ensemble fit {fit_s:.3f} s, "
              f"{stats['bnn_epochs']} epochs, holdout MSE of the elites "
              f"{stats['bnn_holdout_mse']:.5g}; model rollout of {length} "
              f"step(s) {1e3 * roll_s:.2f} ms, rows written per step {w}; "
              f"on {card}")

    # the run's own 'last' snapshot, restored into a fresh runner; then a
    # full snapshot's save and load
    tree = to_tree(runner)
    fresh = mbpo.init(variant.get("seed", 0) + 7)
    restore_checkpoint(str(out / "a" / "checkpoints" / "last"), fresh)
    bad = tree_diff(tree, to_tree(fresh))
    if bad:
        fail(f"MBPO: the 'last' snapshot restored into a fresh runner "
             f"differs in {bad[:10]}")
    print("MBPO 'last' snapshot: restored into a fresh runner, bit for bit "
          "(SAC and the ensemble with their Adams, the normaliser, elites "
          "and holdout MSEs, both rings, the env state, the noise "
          "generator)")
    size, save_s, load_s = snapshot_times("MBPO", out / "snapshot", runner,
                                          fresh, tree)
    del fresh, tree
    print(f"MBPO full snapshot: {size:.2f} MiB on disk, save {save_s:.3f} "
          f"s, load {load_s:.3f} s, on {card}")
    k1_ms, k1_err = k1_on_end_states("MBPO", runner, n,
                                     counters["planar_control_step"],
                                     k1_check, 31, sizes=(n,))

    # card vs CPU: one ensemble minibatch step from a copy of the end
    # state, on the same rows of the real ring
    dev = runner.env_state.obs.device
    gen = torch.Generator().manual_seed(37)
    cpu_trainer = BNNTrainer(mbpo.obs_size, mbpo.action_size,
                             mbpo.bnn.config, device="cpu")
    real = runner.replay
    cpu_real = ReplayState(data={k: v.cpu() for k, v in real.data.items()},
                           ep_id=real.ep_id.cpu(), ptr=real.ptr,
                           size=real.size, env_ep=real.env_ep.cpu())
    d = cpu_real.data
    idx = torch.randint(0, real.size, (mbpo.bnn.config.num_nets,
                                       mbpo.bnn.config.batch_size),
                        generator=gen)
    inp = torch.cat([d["obs"], d["action"]], -1)[idx]
    tgt = torch.cat([d["reward"][:, None], d["next_obs"] - d["obs"]],
                    -1)[idx]
    state_tree = to_tree(runner.bnn_state)
    card_bnn = restore_into(mbpo.bnn.init(0), state_tree)
    cpu_bnn = restore_into(cpu_trainer.init(0), state_tree)
    loss_card = mbpo.bnn.minibatch_step(card_bnn, inp.to(dev), tgt.to(dev))
    loss_cpu = cpu_trainer.minibatch_step(cpu_bnn, inp, tgt)
    bnn_err = compare_trees(
        "MBPO ensemble minibatch step",
        to_tree({"loss": loss_card, "params": card_bnn.params,
                 "adam": card_bnn.opt_state}),
        to_tree({"loss": loss_cpu, "params": cpu_bnn.params,
                 "adam": cpu_bnn.opt_state}), 2e-4, 2e-5)
    print(f"MBPO ensemble minibatch step, card vs CPU from the same state "
          f"and rows: loss, parameters and Adam moments within rtol 2e-4, "
          f"atol 2e-5, max |err| {bnn_err:.3g}")

    # card vs CPU: a model rollout of 3 steps at R = MBPO_CHECK_R from the
    # end state and the same draws, into model rings of 4 R rows whose
    # cursor sits 1.5 R before the wrap
    small = dataclasses.replace(cfg, rollout_batch_size=MBPO_CHECK_R)
    cpu_sac = SAC(sac.obs_size, sac.action_size, sac.config,
                  net_size=sac.hidden[0], num_hidden_layers=len(sac.hidden),
                  device="cpu")
    env_name = variant["env_specs"]["env_name"]
    draws = [("replay", torch.rand(MBPO_CHECK_R, generator=gen))]
    for _ in range(3):
        draws += [("act", torch.randn((MBPO_CHECK_R, sac.action_size),
                                      generator=gen)),
                  ("elite", torch.randint(0, mbpo.bnn.config.num_elites,
                                          (MBPO_CHECK_R,), generator=gen)),
                  ("model", torch.randn((MBPO_CHECK_R, 1 + mbpo.obs_size),
                                        generator=gen))]
    rollouts = {}
    for where, m, algo_state, bnn_state, ring in (
            ("card", MBPO(mbpo.vec_env, sac, mbpo.terminal_fn, small,
                          mbpo.bnn.config), runner.algo_state,
             runner.bnn_state, real),
            ("cpu", MBPO(make_vec(env_name, n, device="cpu"), cpu_sac,
                         mbpo.terminal_fn, small, mbpo.bnn.config),
             restore_into(cpu_sac.init(0), to_tree(runner.algo_state)),
             restore_into(cpu_trainer.init(0), state_tree), cpu_real)):
        model_ring = replay_init(4 * MBPO_CHECK_R, m.obs_size, m.action_size,
                                 write_batch=MBPO_CHECK_R, device=m.device)
        cap = model_ring.data["reward"].shape[0]
        model_ring.ptr = model_ring.size = cap - 3 * MBPO_CHECK_R // 2
        r = MBPORunnerState(noise=ReplayedDraws(draws, m.device),
                            env_state=None, replay=ring,
                            model_replay=model_ring, algo_state=algo_state,
                            bnn_state=bnn_state, total_env_steps=0)
        rollouts[where] = (m._rollout_model(r, 3), model_ring)
    (w_card, ring_card), (w_cpu, ring_cpu) = rollouts["card"], rollouts["cpu"]
    if w_card != w_cpu:
        step = next(i for i, (a, b) in enumerate(zip(w_card, w_cpu))
                    if a != b)
        fail(f"MBPO rollout, card vs CPU: a branch's terminal flipped at a "
             f"threshold before step {step + 1}: rows written {w_card} on "
             f"the card, {w_cpu} on the CPU")
    if (ring_card.ptr, ring_card.size) != (ring_cpu.ptr, ring_cpu.size):
        fail(f"MBPO rollout, card vs CPU: ptr / size "
             f"{ring_card.ptr} / {ring_card.size} against "
             f"{ring_cpu.ptr} / {ring_cpu.size}")
    roll_err = compare_trees("MBPO model rollout", to_tree(ring_card.data),
                             to_tree(ring_cpu.data), 2e-4, 2e-5)
    print(f"MBPO model rollout of 3 steps at R = {MBPO_CHECK_R}, card vs "
          f"CPU from the same state and draws: rows written per step "
          f"{w_card} on both, the same ptr / size ({ring_card.ptr} / "
          f"{ring_card.size}, across the wrap), rows within rtol 2e-4, "
          f"atol 2e-5, max |err| {roll_err:.3g}")

    # costs, on the end state (the runner's rings and SAC state are not
    # read for a check after this)
    noise = Noise(41, dev)
    bnn_ms, bnn_ops, bnn_dev_ms = step_costs(
        lambda: mbpo.bnn.minibatch_step(card_bnn, inp.to(dev), tgt.to(dev)))

    def sac_step():
        batch = mbpo._mixed_batch(runner, noise)
        sac.train_step(runner.algo_state, batch,
                       *sac.train_noise(noise, cfg.batch_size))

    sac_ms, sac_ops, sac_dev_ms = step_costs(sac_step)
    print(f"MBPO update steps: an ensemble minibatch step (7 nets, 256 "
          f"rows each) {bnn_ops:.0f} device operations, {bnn_dev_ms:.3f} "
          f"ms of device time in {bnn_ms:.3f} ms of wall time; a "
          f"mixed-batch SAC step {sac_ops:.0f}, {sac_dev_ms:.3f} ms in "
          f"{sac_ms:.3f} ms; on {card}")
    roll_ms = {}
    for length in (1, 15):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alive = mbpo._rollout_model(runner, length)
        torch.cuda.synchronize()
        roll_ms[length] = 1e3 * (time.perf_counter() - t0)
        print(f"MBPO model rollout of {length} step(s) at R = {R} from the "
              f"end state: {roll_ms[length]:.2f} ms, branches alive per "
              f"step {alive}, on {card}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        mbpo._train_iter(runner)
    torch.cuda.synchronize()
    it_ms = 1e3 * (time.perf_counter() - t0) / 3
    busy = (k1_ms[n] + mbpo.grad_steps_per_iter * sac_dev_ms) / it_ms
    fit_s = sum(f for f, _ in seen["fits"])
    fit_epochs = [st["bnn_epochs"] for _, st in seen["fits"]]
    print(f"MBPO iteration: {it_ms:.1f} ms (3 iterations timed apart: one "
          f"act, K1 at B = {n} {k1_ms[n]:.4f} ms, {mbpo.grad_steps_per_iter} "
          f"mixed-batch SAC steps); the device busy for about {busy:.1%} of "
          f"it; the epoch: TrainTime {row['TrainTime']:.2f} s ({fit_s:.2f} s "
          f"of it the {segments} ensemble fits of {fit_epochs} epochs), "
          f"EvalTime {row['EvalTime']:.2f} s; on {card}")

    # the spec at full length: 4 segments an epoch, each an ensemble fit
    # on the real ring (as many epochs as the last fit here, which, like
    # every later fit, starts from a fitted ensemble; n_train // 256
    # minibatch steps an epoch at the measured wall time), a rollout at
    # the schedule's length (the measured time per step at R = 100,000),
    # 31 iterations at the measured time; the evaluation and a full
    # 'last' snapshot every epoch, another every freq_saving epochs
    full_segments = max(1, full["num_steps_per_epoch"] // (seg_iters * n))
    epochs_per_fit = fit_epochs[-1]
    step_s = roll_ms[15] / 15 / 1e3
    ring_rows = rl["min_steps_before_training"]
    total_s = 0.0
    for epoch in range(full["num_epochs"]):
        for _ in range(full_segments):
            holdout = min(int(ring_rows * 0.2), 5000)
            total_s += epochs_per_fit * ((ring_rows - holdout) // 256) \
                * bnn_ms / 1e3
            total_s += mbpo.rollout_length(epoch) * step_s
            total_s += seg_iters * it_ms / 1e3
            ring_rows += seg_iters * n
        total_s += row["EvalTime"] + save_s * (
            2 if epoch % int(full.get("freq_saving", 10)) == 0 else 1)
    full_h = total_s / 3600
    print(f"MBPO spec at full length ({full['num_epochs']} epochs of "
          f"{full_segments} segments), at these rates: {full_h:.1f} h; "
          f"assumed: each ensemble fit takes {epochs_per_fit} epochs (the "
          f"last fit's here) at any ring size, each epoch n_train // 256 "
          f"minibatch steps of {bnn_ms:.2f} ms; a model step "
          f"{1e3 * step_s:.2f} ms at "
          f"the schedule's length; an iteration {it_ms:.1f} ms; evaluation "
          f"{row['EvalTime']:.2f} s; a {size:.0f} MiB snapshot in "
          f"{save_s:.2f} s once an epoch and twice every "
          f"{full.get('freq_saving', 10)}; on {card}")
    return {"launches": launches, "k1_ms": k1_ms, "k1_err": k1_err,
            "bnn_card_vs_cpu_err": bnn_err,
            "rollout_card_vs_cpu_err": roll_err,
            "fits": [(f, st) for f, st in seen["fits"]],
            "rollouts": seen["rollouts"], "bnn_step_ms": bnn_ms,
            "bnn_ops": bnn_ops, "bnn_device_ms": bnn_dev_ms,
            "sac_step_ms": sac_ms, "sac_ops": sac_ops,
            "sac_device_ms": sac_dev_ms, "rollout_ms": roll_ms,
            "iteration_ms": it_ms, "device_busy_share": busy,
            "train_s": row["TrainTime"], "eval_s": row["EvalTime"],
            "peak_mib": peak / 2**20, "snapshot_mib": size,
            "save_s": save_s, "load_s": load_s, "full_spec_hours": full_h,
            "seconds": seconds}


# Phase 16: imitation without an adversary (hopper), from phase 9's run A
IL_DIR = "build/chip_smoke_il"
IL_ROLLOUTS = 2           # gen_expert's num_rollouts (the spec's 4, cut)
BC_EPOCHS = 2
DAGGER_CUT = {"num_epochs": 1, "num_steps_per_epoch": 1000}
EVAL_PATH = 1000          # eval_policy's horizon on hopper (pendulum's 200)
NO_LAUNCHES = {"planar_control_step": 0, "planar_forward": 0,
               "fused_sac_chain": 0, "fused_policy_forward": 0,
               "pgs_solve": 0}


@contextlib.contextmanager
def kept(*methods):
    """Inside: for each (class, method name), every object the method was
    called on, in order (`seen[name]`), and `seen["env_state"]`, the
    state of the last `VectorEnv.step` (a run's end state, for K1)."""
    from ilswiss_tpu_torch.envs.vector import VectorEnv

    seen = {"env_state": None}
    saved = [(VectorEnv, "step", VectorEnv.step)]
    saved += [(cls, name, getattr(cls, name)) for cls, name in methods]

    def wrap(name, fn):
        def call(self, *args, **kwargs):
            out = fn(self, *args, **kwargs)
            if name == "step":
                seen["env_state"] = out[0]
            else:
                seen.setdefault(name, []).append(self)
            return out
        return call

    for cls, name, fn in saved:
        setattr(cls, name, wrap(name, fn))
    try:
        yield seen
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def spec_variant(path: str) -> dict:
    import yaml

    from ilswiss_tpu_torch.launchers.variant import build_variants

    with open(ROOT / path) as f:
        (variant,) = build_variants(yaml.safe_load(f))
    return variant


def finite_row(what: str, log_dir, need) -> dict:
    """progress.csv's one row: the `need` columns present, every value
    finite; returns it as floats."""
    rows = progress_rows(log_dir)
    if not rows or not set(need) <= set(rows[-1]) or not all(
            math.isfinite(float(v)) for r in rows for v in r.values()):
        fail(f"{what}: progress.csv {rows}")
    return {k: float(v) for k, v in rows[-1].items()}


def imitation_phase(card: str, counters: dict, k1_check) -> dict:
    """Phase 16: imitation without an adversary on hopper, at the specs'
    widths, cut in length only, logs and demos under build/chip_smoke_il/
    (its own demos listing; the committed one is not touched), the expert
    the policy of phase 9's run A ('last', 256 x 2, 2 epochs of SAC):
      - exp_specs/gen_expert/hopper.yaml with num_rollouts 4 -> 2 (4 envs,
        500 steps each): K1 500, the demos finite, their episodes counted;
      - exp_specs/bc/bc_hopper.yaml on those demos (traj_num 4, MLE),
        num_epochs 201 -> 2 (100 steps an epoch, the 8-env evaluation of
        1000 steps): K1 2000;
      - exp_specs/dagger/dagger_hopper.yaml with num_epochs 201 -> 1 and
        num_steps_per_epoch 8000 -> 1000 (125 iterations of 8 envs, K = 8
        BC steps each), num_initial_train_steps 1000 kept, the same
        expert, seeded from those demos: K1 125 + 1000; the ring holds the
        seeded n rows (n % 8 recorded) and the 1000 added ones, whose
        actions are the expert's on their pre-step observations;
      - exp_specs/eval_policy.yaml on hopper from the same snapshot, with
        save_samples (2000 steps of 8 envs): K1 1000 + 250, the samples
        finite.
    Every run: exact launch counts (K2 = K3 = K4 = 0), finite metrics, and
    K1 on its end state against its plain version (phase 3's check).
    Times a BC step and a DAgger iteration (wall, device operations and
    device ms) and reports the epochs' TrainTime."""
    import shutil

    import numpy as np
    import torch

    from ilswiss_tpu_torch.algorithms.dagger import DAggerLoop
    from ilswiss_tpu_torch.data.demo import load_demos_npz
    from ilswiss_tpu_torch.data.replay import replay_sample
    from ilswiss_tpu_torch.runtime.loop import Noise
    from ilswiss_tpu_torch.runtime.offline import OfflineLoop

    expert = ROOT / "build" / "chip_smoke" / "a" / "checkpoints" / "last"
    if not (expert / "state.pt").exists():
        fail(f"imitation: phase 9's snapshot {expert} is missing")
    out = ROOT / IL_DIR
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    listing = out / "demos_listing.yaml"
    common = dict(demos_listing=str(listing), print_to_console=False)
    result = {"k1_ms": {}, "k1_err": {}, "launches": {}, "seconds": {}}

    def run(name, what, variant, want, end_state=None):
        with kept((OfflineLoop, "init"), (DAggerLoop, "init")) as seen:
            runner, launches, seconds = run_spec(
                name, variant, out / what, counters, None, **common)
        want = dict(NO_LAUNCHES, planar_control_step=want)
        check_launches(f"imitation {what}", (("(as cut)", launches, want),))
        state = end_state(runner) if end_state else seen["env_state"]
        n = state.obs.shape[0]
        ms, err = k1_on_end_states(
            f"imitation {what}", types.SimpleNamespace(env_state=state), n,
            counters["planar_control_step"], k1_check, 43, sizes=(n,))
        result["k1_ms"][f"{what}_b{n}"] = ms[n]
        result["k1_err"][f"{what}_b{n}"] = err[n]
        result["launches"][what] = launches
        result["seconds"][what] = seconds
        print(f"imitation {what}: {seconds:.1f} s for the call, on {card}")
        return runner, seen

    # gen_expert: the snapshot's deterministic policy on 4 envs
    gen = spec_variant("exp_specs/gen_expert/hopper.yaml")
    gen.update(expert_path=str(expert), num_rollouts=IL_ROLLOUTS,
               save_path=str(out / "hopper_expert.npz"))
    steps = -(-IL_ROLLOUTS * gen["max_path_length"]
              // gen["env_specs"]["env_num"])
    path, _ = run("gen_expert", "gen_expert", gen, steps)
    demos = load_demos_npz(path)
    episodes = int(torch.unique(demos.ep_id).numel())
    mean_rew = float(demos.data["reward"].mean())
    if demos.size != steps * gen["env_specs"]["env_num"] or not all(
            bool(torch.isfinite(v).all()) for v in demos.data.values()):
        fail(f"imitation gen_expert: {demos.size} rows, or not finite")
    print(f"imitation gen_expert: {demos.size} transitions in {episodes} "
          f"episodes, mean step reward {mean_rew:.4f}")

    # BC on those demos
    bc = spec_variant("exp_specs/bc/bc_hopper.yaml")
    bc["rl_alg_params"]["num_epochs"] = BC_EPOCHS
    rl = bc["rl_alg_params"]
    bc_runner, seen = run("bc", "bc", bc, BC_EPOCHS * rl["max_path_length"])
    bc_rows = progress_rows(out / "bc")
    row = finite_row("imitation bc", out / "bc",
                     ["trainer/bc_loss", "TrainTime"] + EVAL_COLUMNS[:5])
    if len(bc_rows) != BC_EPOCHS:
        fail(f"imitation bc: {len(bc_rows)} epochs")
    algo = seen["init"][-1].algo
    noise = Noise(47, bc_runner.expert.ep_id.device)
    bs = rl["batch_size"]

    def bc_step():
        batch = replay_sample(bc_runner.expert, noise.replay(bs))
        algo.train_step(bc_runner.algo_state, batch,
                        *algo.train_noise(noise, bs))

    bc_ms, bc_ops, bc_dev = step_costs(bc_step)
    print("imitation bc epochs: " + "; ".join(
        f"bc_loss {float(r['trainer/bc_loss']):.5g}, AverageReturn "
        f"{float(r['AverageReturn']):.5g}, TrainTime "
        f"{float(r['TrainTime']):.3f} s ({rl['num_train_steps_per_train_call']}"
        f" steps), EvalTime {float(r['EvalTime']):.3f} s" for r in bc_rows)
        + f"; a BC step (batch {bs}, 256 x 2, MLE): {bc_ms:.3f} ms of wall "
        f"time, {bc_ops:.0f} device operations, {bc_dev:.3f} ms of device "
        f"time; on {card}")

    # DAgger seeded from those demos, querying the same expert
    dag = spec_variant("exp_specs/dagger/dagger_hopper.yaml")
    dag["expert_policy_path"] = str(expert)
    dag["dagger_params"].update(DAGGER_CUT)
    dp = dag["dagger_params"]
    n_env = max(dag["env_specs"]["env_num"], 8)
    iters = dp["num_steps_per_epoch"] // n_env
    runner, seen = run("dagger", "dagger", dag,
                       iters + dp["max_path_length"],
                       end_state=lambda r: r.env_state)
    row = finite_row("imitation dagger", out / "dagger",
                     ["trainer/bc_loss", "TrainTime"] + EVAL_COLUMNS[:6])
    agg = runner.aggregate
    added = iters * n_env
    n = agg.size - added
    cap = agg.data["reward"].shape[0]
    if agg.ptr != (n + added) % cap or n <= 0:
        fail(f"imitation dagger: ring ptr {agg.ptr}, size {agg.size}")
    loop = seen["init"][-1]
    rows = slice(n, n + added)
    want = torch.cat([loop.expert_fn(o) for o in
                      agg.data["obs"][rows].split(n_env)])
    relabel_err = float((agg.data["action"][rows] - want).abs().max())
    if not torch.allclose(agg.data["action"][rows], want, rtol=1e-5,
                          atol=1e-6):
        fail(f"imitation dagger: stored actions are {relabel_err:.3g} from "
             f"the expert's")
    dag_ms, dag_ops, dag_dev = step_costs(lambda: loop._iter(runner), 5, 1)
    print(f"imitation dagger: seeded with n = {n} demo rows (n % {n_env} = "
          f"{n % n_env}), cursor now {agg.ptr} of {cap}; the {added} added "
          f"rows hold the expert's actions (max |err| {relabel_err:.3g}); "
          f"epoch: bc_loss {row['trainer/bc_loss']:.5g}, AverageReturn "
          f"{row['AverageReturn']:.5g}, TrainTime {row['TrainTime']:.3f} s "
          f"({iters} iterations), EvalTime {row['EvalTime']:.3f} s; a DAgger "
          f"iteration (K1, the expert's relabeling, "
          f"{loop.grad_steps_per_iter} BC steps): {dag_ms:.3f} ms of wall "
          f"time, {dag_ops:.0f} device operations, {dag_dev:.3f} ms of "
          f"device time; on {card}")

    # eval_policy with save_samples, from the same snapshot
    ev = spec_variant("exp_specs/eval_policy.yaml")
    ev.update(policy_checkpoint=str(expert), max_path_length=EVAL_PATH,
              env_specs={"env_name": "hopper", "env_kwargs": {},
                         "env_num": 8})
    stats, _ = run("eval_policy", "eval_policy", ev,
                   EVAL_PATH + ev["num_eval_steps"] // 8)
    samples = np.load(out / "eval_policy" / "eval_samples.npz")
    if samples["obs"].shape != (ev["num_eval_steps"], 11) or not all(
            np.isfinite(samples[k]).all() for k in samples.files) or not all(
            math.isfinite(v) for v in stats.values()):
        fail(f"imitation eval_policy: samples {samples['obs'].shape}, stats "
             f"{stats}")
    print(f"imitation eval_policy: {json.dumps(stats)}; "
          f"{samples['obs'].shape[0]} samples saved, on {card}")
    result.update(demos=demos.size, demo_episodes=episodes,
                  seeded_rows=n, seeded_rows_mod_b=n % n_env,
                  relabel_err=relabel_err, bc_step_ms=bc_ms, bc_ops=bc_ops,
                  bc_device_ms=bc_dev, dagger_iter_ms=dag_ms,
                  dagger_ops=dag_ops, dagger_device_ms=dag_dev,
                  bc_train_s=[float(r["TrainTime"]) for r in bc_rows],
                  dagger_train_s=row["TrainTime"])
    return result


# Phase 17: goal-conditioned learning on reach2d, 1 epoch of each spec
# 2000 of the specs' 4000 steps an epoch
GOAL_STEPS = 1000
GOAL_SPECS = {"her_sac": ("her", "exp_specs/her/her_sac_reach2d.yaml"),
              "gcsl": ("gcsl", "exp_specs/gcsl/gcsl_reach2d.yaml"),
              "gcsl_dis": ("gcsl", "exp_specs/gcsl/gcsl_reach_dis.yaml")}


def goal_phase(card: str, counters: dict) -> dict:
    """Phase 17: her_sac_reach2d.yaml, gcsl_reach2d.yaml and
    gcsl_reach_dis.yaml through `EXPERIMENTS["her"]` / `["gcsl"]` on the
    card, 1 epoch each (the specs' 20, cut) of GOAL_STEPS steps, logs
    under build/chip_smoke_goal/: 16 envs, 512 episode slots, batch 128,
    K = 8, a warmup of 2 x 50 iterations and 62 training iterations.
    reach2d is analytic: no kernel may launch.  Fails unless every
    progress.csv value is finite with TotalEnvSteps 16 x 162, and a batch
    sampled from the run's hindsight ring on the card holds the same rows
    as the same draws give on a CPU copy of the ring, exactly.  Times an HER iteration
    (one env step, 8 SAC steps), an HER SAC step and a GCSL step (wall,
    device operations and device ms)."""
    import shutil

    import torch

    from ilswiss_tpu_torch.algorithms.her import HERLoop
    from ilswiss_tpu_torch.data.her import (
        HindsightReplayBuffer, HindsightReplayState,
    )
    from ilswiss_tpu_torch.envs import make
    from ilswiss_tpu_torch.envs.wrappers import DiscretEnv
    from ilswiss_tpu_torch.runtime.loop import Noise

    out = ROOT / "build" / "chip_smoke_goal"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    result = {"launches": {}, "seconds": {}, "rows": {}}
    for what, (name, path) in GOAL_SPECS.items():
        variant = spec_variant(path)
        variant["rl_alg_params"]["num_steps_per_epoch"] = GOAL_STEPS
        with kept((HERLoop, "init")) as seen:
            runner, launches, seconds = run_spec(
                name, variant, out / what, counters, 1)
        check_launches(f"goal {what}", (("(1 epoch)", launches,
                                         NO_LAUNCHES),))
        loop = seen["init"][-1]
        rl = variant["rl_alg_params"]
        n = loop.vec_env.num_envs
        steps = n * (loop.config.min_episodes_before_training
                     * loop.vec_env.env.max_episode_steps
                     + rl["num_steps_per_epoch"] // n)
        metric = "trainer/qf1_loss" if name == "her" else "trainer/gcsl_loss"
        row = finite_row(f"goal {what}", out / what,
                         [metric] + EVAL_COLUMNS[:6])
        if row["TotalEnvSteps"] != steps or runner.total_env_steps != steps:
            fail(f"goal {what}: TotalEnvSteps {row['TotalEnvSteps']}, "
                 f"expected {steps}")

        # a batch from the card's ring against the same on a CPU copy
        bs = loop.config.batch_size
        draws = Noise(53, "cpu").hindsight(bs, n)
        env = loop.vec_env.env
        cpu_env = make("reach2d", device="cpu",
                       max_episode_steps=env.max_episode_steps)
        if isinstance(env, DiscretEnv):
            cpu_env = DiscretEnv(
                cpu_env, possible_actions=env.base_actions.cpu().numpy())
        buf = loop.buffer
        cpu_buf = HindsightReplayBuffer(cpu_env, n, buf.S, buf.T,
                                        buf.relabel_type, buf.her_ratio)
        r = runner.replay
        cpu_ring = HindsightReplayState(
            data={k: v.cpu() for k, v in r.data.items()},
            ep_len=r.ep_len.cpu(), cur_slot=r.cur_slot.cpu(),
            cur_t=r.cur_t.cpu(), completed=r.completed.cpu())
        dev = r.ep_len.device
        got = buf.sample(r, tuple(d.to(dev) for d in draws), bs,
                         return_horizon=loop.return_horizon)
        want = cpu_buf.sample(cpu_ring, draws, bs,
                              return_horizon=loop.return_horizon)
        bad = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
        if bad or set(got) != set(want):
            fail(f"goal {what}: a batch from the card's ring differs from "
                 f"the CPU copy's in {bad}")
        episodes = int(r.completed.sum())

        # costs on the end state
        noise = Noise(59, dev)
        algo = loop.algo

        def step():
            batch = buf.sample(r, noise.hindsight(bs, n), bs,
                               return_horizon=loop.return_horizon)
            algo.train_step(runner.algo_state, batch,
                            *algo.train_noise(noise, bs))

        step_ms, step_ops, step_dev = step_costs(step)
        it_ms, it_ops, it_dev = step_costs(lambda: loop._train_iter(runner),
                                           5, 1)
        print(f"goal {what} epoch 0 ({seconds:.1f} s for the call): "
              + ", ".join(f"{k} {row[k]:.6g}" for k in [metric]
                          + EVAL_COLUMNS[:5] + ["TrainTime", "EvalTime"])
              + f"; {episodes} episodes completed; a sampled batch of {bs} "
              f"equals the CPU copy's exactly; a {name} step: "
              f"{step_ms:.3f} ms of wall time, {step_ops:.0f} device "
              f"operations, {step_dev:.3f} ms of device time; an iteration "
              f"(one env step, {loop.grad_steps_per_iter} steps): "
              f"{it_ms:.3f} ms, {it_ops:.0f} operations, {it_dev:.3f} ms of "
              f"device time; on {card}")
        result["launches"][what] = launches
        result["seconds"][what] = seconds
        result["rows"][what] = {k: row[k] for k in (
            metric, "AverageReturn", "TrainTime", "EvalTime")}
        result[what] = {"step_ms": step_ms, "step_ops": step_ops,
                        "step_device_ms": step_dev, "iteration_ms": it_ms,
                        "iteration_ops": it_ops,
                        "iteration_device_ms": it_dev}
    return result


VISUAL_DIR = "build/chip_smoke_visual"
VISUAL_SPECS = {
    "sac_ae": ("sac_ae", "exp_specs/sac_ae/sac_ae_pendulum_pixels.yaml"),
    "sac_rad": ("sac_rad", "exp_specs/sac_rad/sac_rad_pendulum_pixels.yaml"),
    "sac_curl": ("sac_curl",
                 "exp_specs/sac_curl/sac_curl_pendulum_pixels.yaml")}
# 800 of the specs' 4000 steps an epoch
VISUAL_CUT = {"num_epochs": 1, "num_steps_per_epoch": 400}
VISUAL_METRICS = {
    "sac_ae": ["qf1_loss", "qf2_loss", "policy_loss", "alpha_loss", "alpha",
               "rec_loss", "latent_loss"],
    "sac_curl": ["qf1_loss", "qf2_loss", "policy_loss", "alpha_loss",
                 "alpha", "curl_loss"]}
VISUAL_METRICS["sac_rad"] = VISUAL_METRICS["sac_ae"]
# the GAIL epoch at tests/test_il.py::test_visual_gail_cnn_disc_epoch's
# shapes: 2 envs of 64 px, 60 demo steps an env, batch 16, an 8-step epoch
CNN_GAIL = {"envs": 2, "demo_steps": 60, "batch": 16, "epoch_steps": 8}
# one SAC-AE step on the card against a CPU copy (float32 convs on both)
# on the first VISUAL_CHECK_ROWS rows of a batch: the pins of
# tests/test_torch_visual.py's updates
VISUAL_PIN = {"rtol": 2e-4, "atol": 1e-4}
VISUAL_CHECK_ROWS = 16


@contextlib.contextmanager
def timed_snapshots():
    """Inside: the seconds of every `SnapshotManager.on_epoch` call (the
    epoch's 'epoch_N', 'last' and 'best' saves) in the yielded list."""
    from ilswiss_tpu_torch.runtime.checkpoint import SnapshotManager

    seconds = []
    on_epoch = SnapshotManager.on_epoch

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = on_epoch(self, *args, **kwargs)
        seconds.append(time.perf_counter() - t0)
        return out

    SnapshotManager.on_epoch = timed
    try:
        yield seconds
    finally:
        SnapshotManager.on_epoch = on_epoch


def visual_phase(card: str, counters: dict) -> dict:
    """Phase 18: the visual path.  sac_ae_pendulum_pixels.yaml,
    sac_rad_pendulum_pixels.yaml and sac_curl_pendulum_pixels.yaml through
    `EXPERIMENTS[...]` on the card, cut in length only (1 epoch of 400
    steps after the spec's 1000-step warmup), logs under
    build/chip_smoke_visual/: 16 envs of 64 px frames, K = 8 SAC-AE steps
    an iteration at batch 128, the spec's 100,000-row float32 ring, a 4 x
    32 conv encoder of 50 features in bf16, a 256 x 2 SAC, crop 56 for RAD
    and CURL.  The path is analytic and eager: no kernel may launch.
    Fails unless every progress.csv value is finite, TotalEnvSteps is 62
    x 16 + 400 and the state took 200 steps, and one SAC-AE step (both
    phases of an even step, on 16 rows of a batch) on the card agrees with
    the same step on a CPU copy of the end state, float32 convs on both,
    at rtol 2e-4, atol 1e-4.
    Prints per spec: a SAC-AE step's wall ms, device operations and
    device ms (an even and an odd step), an iteration's, TrainTime and
    EvalTime, the ring's bytes and the peak device memory, the snapshots'
    sizes, the epoch's save seconds and the 'last' snapshot's load
    seconds, and the largest gap between the bf16 and the float32
    encoder's features on one batch.  Each run's log directory is deleted
    once read.  The disk's free space and which of the host bridges'
    packages import are printed first.  Then GAIL with the cnn
    discriminator on pendulum_pixels through `OffPolicyLoop` (`CNN_GAIL`):
    finite metrics, no launch, a discriminator step's costs."""
    import importlib.util
    import shutil

    import torch

    from ilswiss_tpu_torch.algorithms.adv_irl import AdvIRL, AdvIRLConfig
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.algorithms.sac_ae import SACAE
    from ilswiss_tpu_torch.data.augmentations import center_crop
    from ilswiss_tpu_torch.envs import make_vec
    from ilswiss_tpu_torch.runtime.checkpoint import (
        restore_checkpoint, restore_into, to_tree,
    )
    from ilswiss_tpu_torch.runtime.collector import collect_transitions
    from ilswiss_tpu_torch.runtime.loop import (
        Noise, OffPolicyConfig, OffPolicyLoop,
    )

    out = ROOT / VISUAL_DIR
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    usage = shutil.disk_usage(out)
    print(f"visual: disk at {out}: {usage.free / 2**30:.1f} GiB free of "
          f"{usage.total / 2**30:.1f} GiB")
    # the packages the host bridges (ROADMAP.md item 2.8) would need
    found = {m: importlib.util.find_spec(m) is not None for m in (
        "mujoco", "gymnasium", "gymnasium_robotics", "dm_control", "Box2D")}
    print(f"visual: host-bridge packages importable here: "
          f"{json.dumps(found)}")
    result = {"launches": {}}
    for what, (name, path) in VISUAL_SPECS.items():
        variant, full = cut_spec(path, out, VISUAL_CUT)
        log_dir = out / what
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with kept((OffPolicyLoop, "init")) as seen, \
                timed_snapshots() as save_s:
            runner, launches, seconds = run_spec(
                name, variant, log_dir, counters, None)
        peak = torch.cuda.max_memory_allocated()
        check_launches(f"visual {what}", (("(1 epoch)", launches,
                                           NO_LAUNCHES),))
        loop = seen["init"][-1]
        algo, state = loop.algo.algo, runner.algo_state
        rl = variant["rl_alg_params"]
        n, K = loop.vec_env.num_envs, loop.grad_steps_per_iter
        warm = max(1, rl["min_steps_before_training"] // n)
        iters = rl["num_steps_per_epoch"] // n
        steps = n * (warm + iters)
        metrics = ["trainer/" + m for m in VISUAL_METRICS[what]]
        row = finite_row(f"visual {what}", log_dir,
                         metrics + EVAL_COLUMNS[:6])
        if (row["TotalEnvSteps"] != steps or runner.total_env_steps != steps
                or state.step != iters * K):
            fail(f"visual {what}: TotalEnvSteps {row['TotalEnvSteps']} "
                 f"(expected {steps}), {state.step} SAC-AE steps (expected "
                 f"{iters * K})")
        ring_bytes = sum(t.numel() * t.element_size()
                         for t in runner.replay.data.values())
        sizes = {d: sum(f.stat().st_size for f in (log_dir / "checkpoints"
                                                    / d).iterdir())
                 for d in ("epoch_0", "last", "best")}
        t0 = time.perf_counter()
        restore_checkpoint(str(log_dir / "checkpoints" / "last"), runner)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        shutil.rmtree(log_dir)

        # costs of one SAC-AE step on the end state: an even step (every
        # phase of the spec) and an odd one (the autoencoder's or CURL's)
        noise = Noise(61, loop.device)
        batch = loop.sample_fn(runner.replay, noise, loop.config.batch_size)
        draws = algo.train_noise(noise, loop.config.batch_size)

        def step(parity):
            def call():
                state.step = parity
                algo.train_step(state, batch, *draws)
            return call

        even = step_costs(step(0))
        odd = step_costs(step(1))
        it = step_costs(lambda: loop._train_iter(runner), 5, 1)

        # the bf16 convs against float32 ones on the same batch
        view = batch["obs"]
        with torch.no_grad():
            f_bf16 = state.encoder(view)
            state.encoder.compute_dtype = torch.float32
            f_f32 = state.encoder(view)
        gap = float((f_bf16 - f_f32).abs().max())

        # one step, float32 convs, on the card and on a CPU copy, on a
        # small batch (the CPU's convs at batch 128 take tens of seconds)
        rows = VISUAL_CHECK_ROWS
        batch = {k: v[:rows] for k, v in batch.items()}
        draws = tuple(d[:rows] for d in draws)
        cpu_algo = SACAE(algo.action_size, algo.config,
                         net_size=algo.hidden[0],
                         num_hidden_layers=len(algo.hidden), device="cpu")
        cpu_state = restore_into(cpu_algo.init(0), to_tree(state))
        for s in (state, cpu_state):
            for m in (s.encoder, s.target_encoder, s.decoder):
                m.compute_dtype = torch.float32
            s.step = 0
        algo.train_step(state, batch, *draws)
        cpu_algo.train_step(cpu_state, {k: v.cpu() for k, v in
                                        batch.items()},
                            *(d.cpu() for d in draws))
        err = compare_trees(f"visual {what} SAC-AE step", to_tree(state),
                            to_tree(cpu_state), **VISUAL_PIN)
        spec_h = full["num_epochs"] * (full["num_steps_per_epoch"] // n) \
            * it[0] / 3.6e6
        print(f"visual {what} epoch 0 ({seconds:.1f} s for the call): "
              + ", ".join(f"{k} {row[k]:.6g}" for k in metrics
                          + EVAL_COLUMNS[:2] + ["TrainTime", "EvalTime"])
              + f"; {iters} iterations of K = {K} at batch "
              f"{loop.config.batch_size}, image {algo.config.image_size} px; "
              f"an even SAC-AE step {even[0]:.3f} ms of wall time, "
              f"{even[1]:.0f} device operations, {even[2]:.3f} ms of device "
              f"time; an odd step {odd[0]:.3f} ms, {odd[1]:.0f} operations, "
              f"{odd[2]:.3f} ms; an iteration {it[0]:.3f} ms, {it[1]:.0f} "
              f"operations, {it[2]:.3f} ms of device time; ring "
              f"{ring_bytes / 1e9:.4f} GB, peak device memory "
              f"{peak / 2**30:.3f} GiB; snapshots epoch_0 "
              f"{sizes['epoch_0'] / 2**20:.1f} MiB, last "
              f"{sizes['last'] / 2**20:.1f} MiB, best "
              f"{sizes['best'] / 2**20:.2f} MiB, saved in "
              f"{sum(save_s):.2f} s, 'last' loaded in {load_s:.2f} s; bf16 "
              f"vs float32 features max |gap| {gap:.4g}; a float32 step "
              f"({rows} rows) on the card vs the CPU max |err| {err:.3g}; "
              f"the spec's {full['num_epochs']} epochs at this iteration "
              f"time: {spec_h:.3f} h of training; on {card}")
        result["launches"][f"visual_{what}"] = launches
        result[what] = {
            "seconds": seconds, "train_time": row["TrainTime"],
            "eval_time": row["EvalTime"],
            "average_return": row["AverageReturn"],
            "even_step": even, "odd_step": odd, "iteration": it,
            "ring_bytes": ring_bytes, "peak_bytes": peak,
            "snapshot_bytes": sizes, "save_s": sum(save_s),
            "load_s": load_s, "bf16_gap": gap, "card_vs_cpu": err,
            "spec_hours": spec_h}
        del runner, state, batch, loop, seen
        torch.cuda.empty_cache()

    # GAIL with the cnn discriminator on pendulum_pixels
    g = CNN_GAIL
    vec = make_vec("pendulum_pixels", g["envs"])
    demos = collect_transitions(
        vec, lambda obs, nz: nz.warmup_action((g["envs"], 1)),
        g["demo_steps"], Noise(3, vec.env.device))
    obs_dim = int(math.prod(vec.env.observation_size))

    class FlatSAC:
        """The inner SAC on flattened frames / 255 (the adapter of
        tests/test_il.py::test_visual_gail_cnn_disc_epoch)."""

        def __init__(self, sac):
            self.sac, self.device = sac, sac.device
            self.init, self.act_noise = sac.init, sac.act_noise

        def _flat(self, obs):
            return obs.reshape(obs.shape[0], -1) / 255.0

        def act(self, state, obs, eps=None, deterministic=False):
            return self.sac.act(state, self._flat(obs), eps,
                                deterministic=deterministic)

        def train_step(self, state, batch, eps_next, eps_new):
            b = dict(batch, obs=self._flat(batch["obs"]),
                     next_obs=self._flat(batch["next_obs"]))
            return self.sac.train_step(state, b, eps_next, eps_new)

    sac = SAC(obs_dim, 1, SACConfig(), net_size=32, num_hidden_layers=1)
    gail = AdvIRL(obs_dim, 1, FlatSAC(sac), demos, AdvIRLConfig(
        mode="gail", disc_type="cnn", disc_hid_dim=32, disc_num_blocks=2,
        disc_num_filters=8, disc_optim_batch_size=g["batch"],
        policy_optim_batch_size=g["batch"], grad_pen_weight=1.0))
    loop = OffPolicyLoop(vec, gail, OffPolicyConfig(
        batch_size=g["batch"], replay_capacity=512,
        min_steps_before_training=g["batch"]))
    for k in counters.values():
        k.launches = 0
    runner = loop.warmup(loop.init(0))
    runner, m = loop.train_epoch(runner, g["epoch_steps"])
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}
    check_launches("visual cnn GAIL", (("(1 epoch)", launches,
                                        NO_LAUNCHES),))
    bad = [k for k, v in m.items() if not math.isfinite(v)]
    if bad or not {"disc_ce_loss", "disc_acc", "disc_rew_mean"} <= set(m) \
            or m["disc_rew_mean"] < 0:
        fail(f"visual cnn GAIL: metrics {m}")
    noise = Noise(67, vec.env.device)
    disc = step_costs(lambda: gail._disc_update(runner.algo_state,
                                                runner.replay, noise))
    print(f"visual cnn GAIL epoch ({g['envs']} envs of 64 px, batch "
          f"{g['batch']}): " + ", ".join(f"{k} {m[k]:.6g}" for k in (
              "disc_ce_loss", "disc_acc", "disc_grad_pen", "disc_rew_mean"))
          + f"; a discriminator step {disc[0]:.3f} ms of wall time, "
          f"{disc[1]:.0f} device operations, {disc[2]:.3f} ms of device "
          f"time; on {card}")
    result["launches"]["visual_cnn_gail"] = launches
    result["cnn_gail"] = {"metrics": m, "disc_step": disc}
    return result


HOST_DIR = "build/chip_smoke_host"
HOST_STANDIN = "pendulum"
# sac_hopper_native.yaml at its widths (16 envs, 256 x 2, batch 512, a 1M
# ring, 1000 steps between train calls, 1000 steps a call), cut in length:
# 2 epochs of 1000 steps after a 1000-step warmup (the spec's 5000)
HOST_SAC_CUT = {"num_epochs": 2, "num_steps_per_epoch": 1000,
                "min_steps_before_training": 1000}
HOST_GAIL_CUT = {"num_epochs": 1, "num_steps_per_epoch": 1000}
HOST_PPO_CUT = {"num_epochs": 1, "num_steps_per_epoch": 2048}
# the card-vs-CPU train call: sac_hopper_native's, cut to 4 SAC steps;
# the profiled one cut to 20 (torch.profiler takes minutes over a whole
# call's device operations, some 460 a SAC step)
HOST_CHECK_STEPS = 4
HOST_PROFILE_STEPS = 20
HOST_PACKAGES = ("mujoco", "gymnasium", "gymnasium_robotics", "Box2D",
                 "dm_control")


@contextlib.contextmanager
def host_standin():
    """Inside: the gymnasium env that the launcher's `_make_host_env` and
    `_host_env_sizes` build is `DeviceEnvAsHost` on HOST_STANDIN, whatever
    env the spec names (the GPU machine has no gymnasium and no MuJoCo), and
    every `HostOffPolicyLoop` made is kept in the yielded list.  The
    native engine is tried first as on any machine, and gives way."""
    from ilswiss_tpu_torch.envs import host_mujoco
    from ilswiss_tpu_torch.runtime.host_loop import HostOffPolicyLoop
    from ilswiss_tpu_torch.testing import DeviceEnvAsHost

    loops = []
    gym_env, init = host_mujoco.GymVectorEnv, HostOffPolicyLoop.__init__

    def standin(env_name, **kwargs):
        return DeviceEnvAsHost(HOST_STANDIN, **kwargs)

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        loops.append(self)

    host_mujoco.GymVectorEnv, HostOffPolicyLoop.__init__ = standin, keep
    try:
        yield loops
    finally:
        host_mujoco.GymVectorEnv, HostOffPolicyLoop.__init__ = gym_env, init


@contextlib.contextmanager
def serial_collection():
    """Inside: every `HostOffPolicyLoop` alternates collection and
    training (`overlap_collection` off)."""
    import dataclasses

    from ilswiss_tpu_torch.runtime.host_loop import HostOffPolicyLoop

    init = HostOffPolicyLoop.__init__

    def serial(self, env, algo, config, *args, **kwargs):
        init(self, env, algo, dataclasses.replace(
            config, overlap_collection=False), *args, **kwargs)

    HostOffPolicyLoop.__init__ = serial
    try:
        yield
    finally:
        HostOffPolicyLoop.__init__ = init


@contextlib.contextmanager
def timed_calls():
    """Inside: the wall ms (host clock, synchronized) of every
    `HostOffPolicyLoop.ingest_and_train` call, in the yielded list."""
    import torch

    from ilswiss_tpu_torch.runtime.host_loop import HostOffPolicyLoop

    calls = []
    train = HostOffPolicyLoop.ingest_and_train

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train(self, *args, **kwargs)
        torch.cuda.synchronize()
        calls.append(1e3 * (time.perf_counter() - t0))
        return out

    HostOffPolicyLoop.ingest_and_train = timed
    try:
        yield calls
    finally:
        HostOffPolicyLoop.ingest_and_train = train


def host_phase(card: str, counters: dict) -> dict:
    """Phase 19: the host loops' device half on the card.  The GPU machine
    has none of the host envs' packages (printed first, with the native
    engine's ImportError), so for this phase's runs only the gymnasium env
    that the launcher's `_make_host_env` and `_host_env_sizes` build is
    replaced by `ilswiss_tpu_torch.testing.DeviceEnvAsHost` on pendulum
    (the port's device env stepped by its plain version on the CPU, behind
    the host envs' numpy contract): the collector, the acting copy, the
    segment's transfer, the learner on the card, the evaluation and the
    snapshots run as on a machine with MuJoCo.  Logs under
    build/chip_smoke_host/.
      (a) exp_specs/sac/sac_hopper_native.yaml (force_host) through
          `EXPERIMENTS["sac"]` at its widths, cut to HOST_SAC_CUT: run A
          2 epochs; run B 1 epoch, then a full resume; run C 1 epoch
          with `overlap_collection` off;
      (b) exp_specs/gail/gail_pendulum.yaml with force_host, 1 epoch of
          1000 steps (one train call);
      (c) exp_specs/ppo/ppo_pendulum.yaml with force_host, 1 iteration;
      (d) `HostHERLoop` on her_sac_reach2d.yaml's constants (the stand-in
          on reach2d) and `HostMBPOLoop` on mbpo_pendulum.yaml's, a
          warmup and one segment each.
    No kernel may launch on any run; every progress.csv value and metric
    must be finite; TotalEnvSteps after the full resume continues the
    saved count.  Prints a segment's collection ms, the wall ms of run C's
    train call (not overlapped), a call cut to HOST_PROFILE_STEPS steps'
    wall ms, device operations and device ms, TrainTime overlapped and
    serial,
    and holds a train call cut to HOST_CHECK_STEPS steps on the card
    against the same call on a CPU copy (one state, one segment, one set
    of draws) at phase 18's pins."""
    import dataclasses
    import importlib.util
    import shutil

    import torch

    from ilswiss_tpu_torch.algorithms.bnn_trainer import BNNTrainerConfig
    from ilswiss_tpu_torch.algorithms.her import (
        HER, HERLoopConfig, HostHERLoop,
    )
    from ilswiss_tpu_torch.algorithms.mbpo import (
        MBPO, HostMBPOLoop, MBPOConfig,
    )
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.data.replay import ReplayState
    from ilswiss_tpu_torch.envs.native_mujoco import NativeMjVectorEnv
    from ilswiss_tpu_torch.envs.terminals import get_terminal_func
    from ilswiss_tpu_torch.runtime.checkpoint import restore_into, to_tree
    from ilswiss_tpu_torch.runtime.host_loop import (
        HostOffPolicyLoop, HostRunnerState, collector_noise,
    )
    from ilswiss_tpu_torch.runtime.loop import Noise
    from ilswiss_tpu_torch.testing import DeviceEnvAsHost

    found = {m: importlib.util.find_spec(m) is not None
             for m in HOST_PACKAGES}
    print(f"host: packages importable here: {json.dumps(found)}")
    try:
        NativeMjVectorEnv("hopper", 1).close()
        native = "built and ran"
    except ImportError as e:
        native = f"ImportError: {e}"
    print(f"host: NativeMjVectorEnv('hopper'): {native}")
    if not found["mujoco"] and not native.startswith("ImportError"):
        fail("host: the native engine did not raise its ImportError")

    out = ROOT / HOST_DIR
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    result = {"launches": {}}
    runs = []

    def zero(what, launches):
        check_launches(f"host {what}", (("(its run)", launches,
                                        NO_LAUNCHES),))
        result["launches"][f"host_{what}"] = launches

    # (a) SAC: straight, resumed, serial
    variant, full = cut_spec("exp_specs/sac/sac_hopper_native.yaml", out,
                             HOST_SAC_CUT)
    with host_standin() as loops:
        runner, launches, sec_a = run_spec("sac", variant, out / "a",
                                           counters, None)
        zero("sac_a", launches)
        loop = loops[-1]
        _, launches, sec_b1 = run_spec("sac", variant, out / "b", counters,
                                       1)
        zero("sac_b", launches)
        _, launches, sec_b2 = run_spec("sac", variant, out / "b", counters,
                                       None, load_params=str(out / "b"))
        zero("sac_b_resume", launches)
        with serial_collection(), timed_calls() as calls_ms:
            _, launches, sec_c = run_spec("sac", variant, out / "c",
                                          counters, 1)
        zero("sac_c_serial", launches)
    n, rl = loop.env.num_envs, variant["rl_alg_params"]
    seg_steps = n * max(1, rl["num_steps_between_train_calls"] // n) * max(
        1, rl["num_steps_per_epoch"] // rl["num_steps_between_train_calls"])
    warm = n * max(1, rl["min_steps_before_training"] // n)
    want = [warm + seg_steps, warm + 2 * seg_steps]
    need = ["trainer/qf1_loss", "trainer/alpha", "Time/sample",
            "Time/train", "TotalEnvSteps", "TrainTime"] + EVAL_COLUMNS[:5]
    rows = {}
    for name in ("a", "b", "c"):
        rs = progress_rows(out / name)
        if not rs or not set(need) <= set(rs[0]) or not all(
                math.isfinite(float(v)) for r in rs for v in r.values()):
            fail(f"host sac run {name}: progress.csv {rs}")
        rows[name] = [{k: float(v) for k, v in r.items()} for r in rs]
    steps = {k: [r["TotalEnvSteps"] for r in rs] for k, rs in rows.items()}
    if steps["a"] != want or steps["b"] != want or steps["c"] != want[:1]:
        fail(f"host sac: TotalEnvSteps {steps}, expected {want} (A and B "
             f"after its full resume) and {want[:1]} (C)")
    if "native engine unavailable" not in (out / "a" / "debug.log"
                                           ).read_text() and not found[
                                               "mujoco"]:
        fail("host sac: the launcher did not log the native engine's "
             "fallback")
    train_overlap = [r["TrainTime"] for r in rows["a"]]
    train_serial = rows["c"][0]["TrainTime"]

    # costs on run A's end state: a segment's collection, one train call
    algo = loop.algo
    t0 = time.perf_counter()
    seg = loop._collect_segment(
        loop.config.steps_between_train_calls,
        collector_noise(runner.seed, runner.total_env_steps),
        loop.acting_snapshot(runner.algo_state))
    collect_ms = 1e3 * (time.perf_counter() - t0)
    call_ms = calls_ms[-1]
    short = HostOffPolicyLoop(loop.env, loop.algo, dataclasses.replace(
        loop.config, train_steps_per_call=HOST_PROFILE_STEPS))
    call = step_costs(lambda: short.ingest_and_train(runner, seg), 1, 0, 1)

    # one train call on the card against the same call on a CPU copy
    cfg = dataclasses.replace(loop.config,
                              train_steps_per_call=HOST_CHECK_STEPS)
    draws, noise = [], Noise(79, "cpu")
    bs = cfg.batch_size
    for _ in range(HOST_CHECK_STEPS):
        draws.append(("replay", noise.replay(bs)))
        e_next, e_new = noise.train((bs, algo.action_size))
        draws += [("eps_next", e_next), ("eps_new", e_new)]
    cpu_algo = SAC(algo.obs_size, algo.action_size, algo.config,
                   net_size=algo.hidden[0],
                   num_hidden_layers=len(algo.hidden), device="cpu")
    r = runner.replay
    copies = (("card", algo, r, runner.algo_state),
              ("cpu", cpu_algo, ReplayState(
                  data={k: v.cpu() for k, v in r.data.items()},
                  ep_id=r.ep_id.cpu(), ptr=r.ptr, size=r.size,
                  env_ep=r.env_ep.cpu()),
               restore_into(cpu_algo.init(0), to_tree(runner.algo_state))))
    states = {}
    for where, a, ring, state in copies:
        st = HostRunnerState(
            noise=ReplayedDraws(draws, a.device), replay=ring,
            algo_state=state, total_env_steps=0, seed=0)
        states[where] = HostOffPolicyLoop(loop.env, a, cfg).ingest_and_train(
            st, seg)[0]
    err = compare_trees(
        "host train call",
        *(to_tree({"algo_state": states[w].algo_state,
                   "replay": states[w].replay}) for w in ("card", "cpu")),
        **VISUAL_PIN)
    print(f"host sac (sac_hopper_native.yaml, {n} envs of the stand-in "
          f"{HOST_STANDIN}, K = {loop.config.train_steps_per_call} at batch "
          f"{bs}, a {loop.config.replay_capacity}-row ring): runs "
          f"{sec_a:.1f} s (A, 2 epochs), {sec_b1:.1f} + {sec_b2:.1f} s (B, "
          f"1 epoch + a full resume), {sec_c:.1f} s (C, serial, 1 epoch); "
          f"TotalEnvSteps A {steps['a']}, B {steps['b']}; TrainTime a "
          f"{seg_steps}-step epoch overlapped {train_overlap} s, serial "
          f"{train_serial:.3f} s; a segment's collection {collect_ms:.1f} "
          f"ms; run C's train call ({loop.config.train_steps_per_call} "
          f"steps) {call_ms:.1f} ms of wall time; a call cut to "
          f"{HOST_PROFILE_STEPS} steps {call[0]:.1f} ms, {call[1]:.0f} "
          f"device operations, {call[2]:.2f} ms of device time; a "
          f"{HOST_CHECK_STEPS}-step float32 train call on the card vs the "
          f"CPU max |err| {err:.3g}; on {card}")
    result["sac"] = {
        "seconds": [sec_a, sec_b1, sec_b2, sec_c],
        "total_env_steps": steps, "train_time_overlap": train_overlap,
        "train_time_serial": train_serial, "collect_ms": collect_ms,
        "train_call_ms": call_ms, "profiled_call": call,
        "card_vs_cpu": err}
    runs.append(("sac", sec_a + sec_b1 + sec_b2 + sec_c))
    del runner, loop, loops, states

    # (b) GAIL and (c) PPO through the launcher
    for what, name, path, cut, metric in (
            ("gail", "adv_irl", "exp_specs/gail/gail_pendulum.yaml",
             HOST_GAIL_CUT, "trainer/disc_rew_mean"),
            ("ppo", "ppo", "exp_specs/ppo/ppo_pendulum.yaml", HOST_PPO_CUT,
             "trainer/pg_loss")):
        constants = {"env_specs": dict(spec_variant(path)["env_specs"],
                                       force_host=True)}
        if what == "gail":
            constants["demo_path"] = str(ROOT / "demos" /
                                         "pendulum_expert.npz")
        variant, _ = cut_spec(path, out, cut, constants=constants)
        with host_standin():
            runner, launches, sec = run_spec(name, variant, out / what,
                                             counters, None)
        zero(what, launches)
        row = finite_row(f"host {what}", out / what,
                         [metric, "TotalEnvSteps"] + EVAL_COLUMNS[:5])
        if row["TotalEnvSteps"] != runner.total_env_steps:
            fail(f"host {what}: TotalEnvSteps {row['TotalEnvSteps']}")
        print(f"host {what} ({path}, force_host, the stand-in "
              f"{HOST_STANDIN}) epoch 0 ({sec:.1f} s for the call): "
              + ", ".join(f"{k} {row[k]:.6g}" for k in (
                  metric, "AverageReturn", "TotalEnvSteps", "TrainTime"))
              + f"; on {card}")
        result[what] = {"seconds": sec, "row": row}
        runs.append((what, sec))

    # (d) HER and MBPO, one segment each
    her_spec = spec_variant("exp_specs/her/her_sac_reach2d.yaml")
    rl, en = her_spec["rl_alg_params"], her_spec["env_specs"]
    env = DeviceEnvAsHost("reach2d", en["env_num"], seed=0,
                          max_episode_steps=rl["max_path_length"])
    seg_len = max(env.max_episode_steps * env.num_envs,
                  rl["num_steps_between_train_calls"])
    sac = SAC(env.observation_size + env.goal_size, env.action_size,
              SACConfig(discount=her_spec["sac_params"]["discount"]),
              net_size=her_spec["net_size"],
              num_hidden_layers=her_spec["num_hidden_layers"])
    her_loop = HostHERLoop(
        env, HER(sac), HERLoopConfig(
            batch_size=rl["batch_size"],
            num_episode_slots=her_spec["her_params"]["num_episode_slots"]),
        relabel_type=her_spec["her_params"]["relabel_type"],
        her_ratio=her_spec["her_params"]["her_ratio"],
        grad_steps_per_segment=int(
            seg_len * rl["num_train_steps_per_train_call"]
            / rl["num_steps_between_train_calls"]),
        segment_steps=seg_len)
    mb_spec = spec_variant("exp_specs/mbpo/mbpo_pendulum.yaml")
    mrl, mp, bp = (mb_spec["rl_alg_params"], mb_spec["mbpo_params"],
                   mb_spec["bnn_params"])
    menv = DeviceEnvAsHost("pendulum", mb_spec["env_specs"]["env_num"],
                           seed=0, max_episode_steps=mrl["max_path_length"])
    msac = SAC(3, 1, SACConfig(
        reward_scale=mb_spec["sac_params"]["reward_scale"]),
        net_size=mb_spec["net_size"],
        num_hidden_layers=mb_spec["num_hidden_layers"])
    mbpo = MBPO(None, msac, get_terminal_func("pendulum"), MBPOConfig(
        model_train_freq=mp["model_train_freq"],
        rollout_batch_size=mp["rollout_batch_size"],
        real_ratio=mp["real_ratio"],
        rollout_schedule=tuple(mp["rollout_schedule"]),
        batch_size=mrl["batch_size"],
        replay_capacity=mrl["replay_buffer_size"],
        min_steps_before_training=mrl["min_steps_before_training"],
        max_path_length=mrl["max_path_length"]), BNNTrainerConfig(
        num_nets=bp["num_nets"], num_elites=bp["num_elites"],
        hidden_sizes=tuple(bp["hidden_sizes"]), batch_size=bp["batch_size"],
        max_epochs=bp["max_epochs"], holdout_ratio=bp["holdout_ratio"]),
        obs_size=3, action_size=1, num_envs=menv.num_envs)
    mbpo_loop = HostMBPOLoop(
        menv, mbpo, grad_steps_per_env_step=(
            mrl["num_train_steps_per_train_call"]
            / mrl["num_steps_between_train_calls"]))
    for what, lp, epoch in (
            ("her", her_loop, lambda r: her_loop.train_epoch(r, seg_len)),
            ("mbpo", mbpo_loop, lambda r: mbpo_loop.train_epoch(
                r, 0, mp["model_train_freq"]))):
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        r = lp.warmup(lp.init(0))
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r, m = epoch(r)
        torch.cuda.synchronize()
        seg_s = time.perf_counter() - t0
        zero(what, {name: k.launches for name, k in counters.items()})
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad or not m:
            fail(f"host {what}: metrics {m}")
        print(f"host {what} segment: warmup {warm_s:.2f} s, one segment "
              f"{seg_s:.2f} s ({r.total_env_steps} env steps in all); "
              + ", ".join(f"{k} {v:.6g}" for k, v in sorted(m.items()))
              + f"; on {card}")
        result[what] = {"warmup_s": warm_s, "segment_s": seg_s,
                        "metrics": m}
        runs.append((what, warm_s + seg_s))
    shutil.rmtree(out)
    print(f"host: seconds by run {json.dumps(dict(runs))}")
    return result


DP_DIR = "build/chip_smoke_dp"
DP_JOIN_S = 400.0         # a rank that outlives it fails the phase
# (a): the spec's warmup (5000 steps, 625 iterations of 8 envs), then 2
# epochs of DP_EPOCH_ITERS iterations a rank
DP_EPOCH_ITERS = 25
# (b): each run cut in length to a warmup of DP_CHECK_WARMUP steps and
# one epoch of DP_CHECK_ITERS iterations a rank; PPO's rollout and passes
DP_CHECK_WARMUP = 512
DP_CHECK_ITERS = 16
DP_PPO_CUT = {"rollout_length": 32, "update_epoch": 2}
DP_PPO_SPEC = "exp_specs/ppo/ppo_hopper.yaml"
DP_PROFILE_STEPS = 20     # steps timed for an all-reduce's ms and a step


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_counters() -> dict:
    from ilswiss_tpu_torch.ops import fused_mlp, fused_sac, pgs
    from ilswiss_tpu_torch.ops import planar_dynamics as pd
    return {"planar_control_step": pd.planar_control_step,
            "planar_forward": pd.planar_forward,
            "fused_sac_chain": fused_sac.fused_sac_chain,
            "fused_policy_forward": fused_mlp.fused_gaussian_policy_forward,
            "pgs_solve": pgs.pgs_solve}


def dp_sac_loop(device, min_steps: int, group=None):
    """SAC on hopper at sac_hopper_optable.yaml's widths (the launcher's
    reading of its sac_params and rl_alg_params: 8 envs a rank, 256 x 2,
    batch 512, K = 8, a 1M ring a rank, the fused chain asked for), the
    trainer averaging over `group` when one is given; `min_steps` the
    warmup."""
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.envs import make_vec
    from ilswiss_tpu_torch.launchers.experiments import _grad_steps_per_iter
    from ilswiss_tpu_torch.runtime.loop import OffPolicyConfig, OffPolicyLoop

    v = spec_variant(LAUNCHER_SPEC)
    rl, p = v["rl_alg_params"], v["sac_params"]
    vec = make_vec(v["env_specs"]["env_name"], v["env_specs"]["env_num"],
                   device=device)
    sac = SAC(vec.env.observation_size, vec.env.action_size, SACConfig(
        discount=p["discount"], reward_scale=p["reward_scale"],
        soft_target_tau=p["soft_target_tau"], policy_lr=p["policy_lr"],
        qf_lr=p["qf_lr"]), net_size=v["net_size"],
        num_hidden_layers=v["num_hidden_layers"],
        use_fused_chain=p["use_fused_chain"], device=device, group=group)
    return OffPolicyLoop(vec, sac, OffPolicyConfig(
        batch_size=rl["batch_size"],
        replay_capacity=rl["replay_buffer_size"],
        min_steps_before_training=min_steps,
        grad_steps_per_iter=_grad_steps_per_iter(rl, vec.num_envs)))


def dp_ppo_loop(device, group=None, normalize_obs: bool | None = None):
    """PPO on hopper at ppo_hopper.yaml's widths (16 envs a rank, 256 x 2,
    minibatch 64, the spec's obs_norm unless `normalize_obs` names it), cut
    in length by DP_PPO_CUT."""
    from ilswiss_tpu_torch.algorithms.ppo import PPO, PPOConfig
    from ilswiss_tpu_torch.envs import make_vec
    from ilswiss_tpu_torch.runtime.onpolicy import (
        OnPolicyConfig, OnPolicyLoop,
    )

    v = spec_variant(DP_PPO_SPEC)
    p = {**v["ppo_params"], **DP_PPO_CUT}
    vec = make_vec(v["env_specs"]["env_name"], v["env_specs"]["env_num"],
                   device=device)
    ppo = PPO(vec.env.observation_size, vec.env.action_size, PPOConfig(
        discount=p["discount"], reward_scale=p["reward_scale"],
        gae_tau=p["gae_tau"], clip_eps=p["clip_eps"],
        policy_lr=p["policy_lr"], value_lr=p["value_lr"],
        value_l2_reg=p["value_l2_reg"], update_epoch=p["update_epoch"],
        mini_batch_size=p["mini_batch_size"]), net_size=v["net_size"],
        num_hidden_layers=v["num_hidden_layers"], device=device,
        group=group)
    if normalize_obs is None:
        normalize_obs = bool(v["env_specs"]["obs_norm"])
    return OnPolicyLoop(vec, ppo, OnPolicyConfig(
        rollout_length=p["rollout_length"], normalize_obs=normalize_obs))


def flat_params(state, obs_rms=None) -> "torch.Tensor":
    """The policy's and the critics' (PPO: the value net's) parameters,
    and the observation moments where there are some, in one vector."""
    import torch
    nets = [state.policy, getattr(state, "qf", None) or state.vf]
    moments = [] if obs_rms is None else [obs_rms.mean, obs_rms.var]
    return torch.cat([p.detach().reshape(-1) for n in nets
                      for p in n.parameters()] + moments)


def replica_spread(flat, group) -> tuple:
    """This rank's vector against every rank's (an all-gather: on the card
    over nccl, on the host over gloo): the largest |difference| and
    whether all are within rtol = atol = 1e-6 of this one."""
    import torch
    import torch.distributed as dist
    x = flat.cpu() if group.backend == "gloo" else flat
    parts = [torch.empty_like(x) for _ in range(group.world_size)]
    dist.all_gather(parts, x, group=group.process_group)
    return (max(float((p - x).abs().max()) for p in parts),
            all(torch.allclose(p, x, rtol=1e-6, atol=1e-6) for p in parts))


def dp_allreduce_ms(state, group) -> tuple:
    """CUDA events around the collectives of one SAC step, as
    `train_step` issues them (`all_reduce_mean` of the critics', the
    policy's and log alpha's gradients, one buffer each), over
    DP_PROFILE_STEPS steps: ms per step.  In a world of one
    `all_reduce_mean` issues nothing, so the raw `all_reduce` of the same
    three buffers is timed beside it."""
    import torch
    import torch.distributed as dist
    from ilswiss_tpu_torch.parallel.distributed import all_reduce_mean

    groups = [list(state.qf.parameters()), list(state.policy.parameters()),
              [state.log_alpha]]
    grads = [[torch.randn_like(p) for p in g] for g in groups]
    bufs = [torch.cat([g.reshape(-1) for g in gs]) for gs in grads]

    def timed(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(DP_PROFILE_STEPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / DP_PROFILE_STEPS

    mean_ms = timed(lambda: [all_reduce_mean(g, group) for g in grads])
    raw_ms = timed(lambda: [dist.all_reduce(b, group=group.process_group)
                            for b in bufs])
    return mean_ms, raw_ms, [b.numel() for b in bufs]


def dp_sac_nccl(group, out: dict) -> None:
    """Phase 20 (a) on one rank: warmup and 2 epochs of
    `DistributedOffPolicyRunner`, launches counted, metrics finite, the
    replicas equal; then K1 on the end states against its plain version,
    the iteration's wall ms, the collectives' ms and a step's device
    operations."""
    import torch
    from ilswiss_tpu_torch.envs.locomotion import HopperDevice, _model
    from ilswiss_tpu_torch.ops import planar_dynamics as pd
    from ilswiss_tpu_torch.parallel import distributed as dd

    v = spec_variant(LAUNCHER_SPEC)
    loop = dp_sac_loop(group.device,
                       v["rl_alg_params"]["min_steps_before_training"], group)
    b = loop.vec_env.num_envs
    factory = dd.DistributedOffPolicyRunner(loop, group)
    warmup, epoch = factory.build(group.world_size * b * DP_EPOCH_ITERS)
    runner = factory.init(0)
    counters = dp_counters()
    torch.cuda.synchronize()
    for k in counters.values():
        k.launches = 0
    calls = dd.all_reduce_mean.calls
    t0 = time.perf_counter()
    runner = warmup(runner)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    metrics = []
    for _ in range(2):
        runner, m = epoch(runner)
        metrics.append(m)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out["launches"] = {n: k.launches for n, k in counters.items()}
    out["collectives"] = dd.all_reduce_mean.calls - calls
    warm_iters = max(1, loop.config.min_steps_before_training // b)
    out["want"] = {"planar_control_step": warm_iters + 2 * DP_EPOCH_ITERS,
                   "planar_forward": 0, "fused_sac_chain": 0,
                   "fused_policy_forward": 0, "pgs_solve": 0}
    out["metrics"] = metrics
    out["iteration_ms"] = 1e3 * (t2 - t1) / (2 * DP_EPOCH_ITERS)
    out["warmup_s"] = t1 - t0
    out["total_env_steps"] = runner.total_env_steps
    out["policy_steps"] = runner.algo_state.policy_opt.count
    out["spread"], out["replicas_close"] = replica_spread(
        flat_params(runner.algo_state), group)
    out["bit_equal"] = out["spread"] == 0.0
    out["obs_finite"] = bool(torch.isfinite(runner.env_state.obs).all())

    # K1 on this rank's end states against its plain version
    pm = pd.planar_model(_model("hopper"))
    q, qd, f0 = (x.t().contiguous() for x in runner.env_state.internal)
    gen = torch.Generator(device=group.device).manual_seed(20 + group.rank)
    ctrl = 2 * torch.rand((len(pm.act_dof), b), device=group.device,
                          generator=gen) - 1
    iters = HopperDevice.solver_iters
    got = pd.planar_control_step(pm, q, qd, ctrl, f0, iters)
    want = pd._control_step(pm, lambda q, qd, c, f, damped: pd._forward_math(
        pm, q, qd, c, f, iters, pm.timestep if damped else None),
        q, qd, ctrl, f0)
    flat = lambda s: [s[0], s[1], s[2], s[3], s[4][0], s[4][1]]  # noqa
    err = 0.0
    for g, w in zip(flat(got), flat(want)):
        if not torch.allclose(g, w, rtol=2e-4, atol=5e-3):
            fail(f"data parallel rank {group.rank}: K1 on the end states "
                 f"differs from its plain version by "
                 f"{float((g - w).abs().max()):.3g}")
        err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
    out["k1_err"] = err

    out["allreduce_ms"], out["raw_allreduce_ms"], out["grad_numels"] = \
        dp_allreduce_ms(runner.algo_state, group)
    wall, ops, dev_ms = train_step_costs(loop.algo, runner,
                                         loop.config.batch_size, 7)
    out["step"] = {"wall_ms": wall, "operations": ops, "device_ms": dev_ms}


def dp_checks(group, out: dict) -> None:
    """Phase 20 (b) on one rank of 2 on one card over gloo: SAC and PPO
    each (1) from the one-rank runner's envs and draws on every rank
    against the one-rank run, (2) from this rank's own envs: the replicas
    equal and away from the one-rank run; SAC's launches counted on (2);
    then the collectives' ms and a step's device operations."""
    import torch
    from ilswiss_tpu_torch.parallel import distributed as dd

    counters = dp_counters()
    dev = group.device
    for kind in ("sac", "ppo"):
        if kind == "sac":
            plain_loop = dp_sac_loop(dev, DP_CHECK_WARMUP)
            plain_loop.algo.use_fused_chain = False   # the eager steps
            loop = same_loop = dp_sac_loop(dev, DP_CHECK_WARMUP, group)
            runner_cls = dd.DistributedOffPolicyRunner
            steps = loop.vec_env.num_envs * DP_CHECK_ITERS
        else:
            # identical data without the moments: their merge counts a
            # batch once per rank (JAX's rule), which moves the first
            # update away from the one-rank run's where the moments' prior
            # (count 1e-4, variance 1) outweighs a dimension's small batch
            # variance; distinct data with the spec's obs_norm
            plain_loop = dp_ppo_loop(dev, normalize_obs=False)
            same_loop = dp_ppo_loop(dev, group, normalize_obs=False)
            loop = dp_ppo_loop(dev, group)
            runner_cls = dd.DistributedOnPolicyRunner
            steps = loop.vec_env.num_envs * loop.config.rollout_length
        factory = runner_cls(loop, group)
        warmup, epoch = factory.build(group.world_size * steps)
        same_warmup, same_epoch = runner_cls(same_loop, group).build(
            group.world_size * steps)
        plain = plain_loop.warmup(plain_loop.init(0))
        plain, plain_m = plain_loop.train_epoch(plain, steps)
        same, same_m = same_epoch(same_warmup(same_loop.init(0)))
        torch.cuda.synchronize()
        for k in counters.values():
            k.launches = 0
        calls = dd.all_reduce_mean.calls
        distinct, distinct_m = epoch(warmup(factory.init(0)))
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in counters.items()}
        want = flat_params(plain.algo_state)
        got = flat_params(same.algo_state)
        away = flat_params(distinct.algo_state)
        replicas = flat_params(distinct.algo_state,
                               getattr(distinct, "obs_rms", None))
        spread, close = replica_spread(replicas, group)
        out[kind] = {
            "launches": launches,
            "collectives": dd.all_reduce_mean.calls - calls,
            "same_err": float((got - want).abs().max()),
            "same_close": bool(torch.allclose(got, want, rtol=1e-5,
                                              atol=1e-6)),
            "same_bit_equal": bool(torch.equal(got, want)),
            "metrics_err": max(abs(same_m[k] - plain_m[k]) for k in plain_m),
            "spread": spread, "replicas_close": close,
            "away": float((away - want).abs().max()),
            "metrics": distinct_m,
            "warmup_iters": (max(1, DP_CHECK_WARMUP // loop.vec_env.num_envs)
                             if kind == "sac" else 0),
            "iters": DP_CHECK_ITERS if kind == "sac" else 1,
        }
        if kind == "sac":
            sac_runner, sac_loop = distinct, loop
    out["allreduce_ms"], out["raw_allreduce_ms"], out["grad_numels"] = \
        dp_allreduce_ms(sac_runner.algo_state, group)
    wall, ops, dev_ms = train_step_costs(sac_loop.algo, sac_runner,
                                         sac_loop.config.batch_size, 7)
    out["step"] = {"wall_ms": wall, "operations": ops, "device_ms": dev_ms}


def dp_rank(rank: int, world_size: int, job: dict) -> None:
    """One rank of phase 20, in a process of its own (spawned by
    `spawn_ranks`): it joins the group the job names, runs its part and
    writes what it measured to <out>/<what>_rank<r>.json.  A failed check
    exits non-zero (`fail`), which fails the phase."""
    import torch

    from ilswiss_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = mesh.init_group(rank, world_size, backend=job["backend"],
                            init_method=job["init"], device=job["device"],
                            timeout=DP_JOIN_S)
    out = {"rank": rank, "world_size": world_size, "backend": group.backend,
           "device": str(group.device)}
    if job["what"] == "nccl":
        dp_sac_nccl(group, out)
    else:
        dp_checks(group, out)
    with open(Path(job["out"]) / f"{job['what']}_rank{rank}.json",
              "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def data_parallel_phase(card: str, only_nccl: bool = False) -> dict:
    """Phase 20: data parallelism over torch.distributed, one process a
    rank (`spawn_ranks`, joined within DP_JOIN_S; a rank that fails or
    hangs fails the phase):
      (a) nccl, one rank per card (world = torch.cuda.device_count()):
          `DistributedOffPolicyRunner` with SAC on hopper at
          sac_hopper_optable.yaml's widths (8 envs a rank, 256 x 2, batch
          512, K = 8, a 1M ring a rank), the spec's 5000-step warmup and 2
          epochs of DP_EPOCH_ITERS iterations a rank: K1 once a control
          step on every rank, K2 (the fused chain the spec asks for is
          refused under a group), K3 and K4 never; every metric finite;
          the policy and critics equal across ranks (rtol = atol = 1e-6,
          JAX's test_params_stay_replicated; bit-equal reported); K1 on
          each rank's end states against its plain version;
      (b) 2 ranks on the one card over gloo with CUDA tensors (named):
          the same SAC runner (cut to DP_CHECK_WARMUP steps of warmup and
          DP_CHECK_ITERS iterations) and `DistributedOnPolicyRunner` with
          PPO at ppo_hopper.yaml's widths (cut by DP_PPO_CUT), each run
          from the one-rank runner's envs and draws on both ranks (equal
          to the one-rank run at JAX's identical-data pins, rtol 1e-5,
          atol 1e-6) and from each rank's own envs (replicas equal, away
          from the one-rank run).
    Prints the world size and backend, an iteration's wall ms, the
    collectives' ms per SAC step (CUDA events), a step's device
    operations.  Returns the launches per rank."""
    import torch

    from ilswiss_tpu_torch.parallel.mesh import spawn_ranks

    out = ROOT / DP_DIR
    out.mkdir(parents=True, exist_ok=True)
    for f in out.glob("*.json"):
        f.unlink()
    world = torch.cuda.device_count()
    jobs = [("nccl", world, {"backend": None, "device": None})]
    if not only_nccl:
        jobs.append(("gloo", 2, {"backend": "gloo", "device": "cuda:0"}))
    result = {"launches": {}}
    for what, n, kw in jobs:
        t0 = time.perf_counter()
        spawn_ranks(dp_rank, n, ({
            "what": what, "out": str(out),
            "init": f"tcp://localhost:{free_port()}", **kw},),
            timeout=DP_JOIN_S)
        ranks = []
        for r in range(n):
            with open(out / f"{what}_rank{r}.json") as f:
                ranks.append(json.load(f))
        print(f"data parallel ({what}): world {n}, backend "
              f"{ranks[0]['backend']}, devices "
              f"{[x['device'] for x in ranks]}; {time.perf_counter() - t0:.1f}"
              f" s with the ranks' start")
        if what == "nccl":
            dp_check_nccl(ranks, card)
            for x in ranks:
                result["launches"][f"dp_nccl_rank{x['rank']}"] = \
                    x["launches"]
            result["nccl"] = ranks
        else:
            dp_check_gloo(ranks, card)
            for x in ranks:
                result["launches"][f"dp_gloo_rank{x['rank']}"] = \
                    x["sac"]["launches"]
            result["gloo"] = ranks
    return result


def dp_check_nccl(ranks: list, card: str) -> None:
    for x in ranks:
        what = f"data parallel (nccl) rank {x['rank']}"
        if x["launches"] != x["want"]:
            fail(f"{what}: launches {x['launches']}, expected {x['want']} "
                 f"(K1 once a control step; K2, K3, K4 never)")
        bad = [(i, k) for i, m in enumerate(x["metrics"])
               for k, v in m.items() if not math.isfinite(v)]
        if bad or not x["obs_finite"]:
            fail(f"{what}: not finite: {bad}")
        if not x["replicas_close"]:
            fail(f"{what}: replicas differ by {x['spread']:.3g} (rtol = "
                 f"atol = 1e-6)")
        if x["metrics"] != ranks[0]["metrics"]:
            fail(f"{what}: the epoch's metrics differ across ranks")
    x = ranks[0]
    equal = ("bit-equal" if all(r["bit_equal"] for r in ranks)
             else "within rtol = atol = 1e-6")
    print(f"data parallel (nccl): launches per rank "
          f"{[r['launches']['planar_control_step'] for r in ranks]} K1 "
          f"(expected {x['want']['planar_control_step']}), K2 = K3 = K4 = 0; "
          f"collectives per rank {x['collectives']}; replicas' largest "
          f"difference {max(r['spread'] for r in ranks):.3g} "
          f"({equal}); "
          f"K1 on the end states max |kernel - plain| "
          f"{max(r['k1_err'] for r in ranks):.3g}")
    print(f"data parallel (nccl): warmup {x['warmup_s']:.2f} s, an "
          f"iteration {x['iteration_ms']:.3f} ms (8 envs, K = 8 eager "
          f"steps a rank), {x['total_env_steps']} env steps and "
          f"{x['policy_steps']} gradient steps a rank; collectives of one "
          f"SAC step (CUDA events): all_reduce_mean "
          f"{x['allreduce_ms']:.4f} ms, raw nccl all_reduce of the three "
          f"buffers ({x['grad_numels']} floats) {x['raw_allreduce_ms']:.4f} "
          f"ms; one step {x['step']['wall_ms']:.3f} ms wall, "
          f"{x['step']['operations']:.0f} device operations, "
          f"{x['step']['device_ms']:.3f} ms device; on {card}")
    print("data parallel (nccl) metrics, epoch 2: " + json.dumps(
        {k: round(v, 6) for k, v in x["metrics"][1].items()}))


def dp_check_gloo(ranks: list, card: str) -> None:
    for x in ranks:
        for kind in ("sac", "ppo"):
            c = x[kind]
            what = f"data parallel (gloo) rank {x['rank']} {kind}"
            if not c["same_close"]:
                fail(f"{what}: from the one-rank runner's data the "
                     f"parameters differ from the one-rank run by "
                     f"{c['same_err']:.3g} (rtol 1e-5, atol 1e-6)")
            if not c["replicas_close"]:
                fail(f"{what}: replicas differ by {c['spread']:.3g} (rtol "
                     f"= atol = 1e-6)")
            if not c["away"] > 1e-4:
                fail(f"{what}: on distinct data the parameters stay at the "
                     f"one-rank run's ({c['away']:.3g})")
            bad = [k for k, v in c["metrics"].items()
                   if not math.isfinite(v)]
            if bad:
                fail(f"{what}: not finite: {bad}")
        sac = x["sac"]
        want = {"planar_control_step": sac["warmup_iters"] + sac["iters"],
                "planar_forward": 0, "fused_sac_chain": 0,
                "fused_policy_forward": 0, "pgs_solve": 0}
        if sac["launches"] != want:
            fail(f"data parallel (gloo) rank {x['rank']}: launches "
                 f"{sac['launches']}, expected {want}")
        ppo_k1 = x["ppo"]["launches"]["planar_control_step"]
        if ppo_k1 != DP_PPO_CUT["rollout_length"]:
            fail(f"data parallel (gloo) rank {x['rank']} ppo: K1 "
                 f"{ppo_k1}, expected {DP_PPO_CUT['rollout_length']}")
    for kind in ("sac", "ppo"):
        c = [x[kind] for x in ranks]
        equal = ("bit-equal" if all(r["same_bit_equal"] for r in c)
                 else "within rtol 1e-5, atol 1e-6")
        print(f"data parallel (gloo, cuda tensors) {kind}: identical data "
              f"against the one-rank run max |diff| "
              f"{max(r['same_err'] for r in c):.3g} "
              f"({equal}, metrics {max(r['metrics_err'] for r in c):.3g}); distinct "
              f"data: replicas' largest difference "
              f"{max(r['spread'] for r in c):.3g}, away from the one-rank "
              f"run by {min(r['away'] for r in c):.3g}; launches "
              f"{c[0]['launches']}, collectives {c[0]['collectives']}")
    x = ranks[0]
    print(f"data parallel (gloo, cuda tensors): collectives of one SAC step "
          f"(CUDA events) all_reduce_mean {x['allreduce_ms']:.4f} ms, raw "
          f"all_reduce {x['raw_allreduce_ms']:.4f} ms; one step "
          f"{x['step']['wall_ms']:.3f} ms wall, "
          f"{x['step']['operations']:.0f} device operations, "
          f"{x['step']['device_ms']:.3f} ms device; on {card}")


def main() -> int:
    import torch
    only = sys.argv[1:]
    if only not in ([], ["--phase20"], ["--phase20", "nccl"]):
        print("usage: chip_smoke.py [--phase20 [nccl]]", file=sys.stderr)
        return 2
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

    if only:
        # phase 20 alone (the kernels built above): world = the cards
        # over nccl, then, without "nccl", 2 ranks over gloo on one card
        t0 = time.perf_counter()
        dp = data_parallel_phase(card, only_nccl=only[1:] == ["nccl"])
        print(f"phase 20: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"data_parallel_launches": dp["launches"]}))
        print(f"card: {card}")
        print(json.dumps({"ok": True, "phase": 20, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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

    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        """Print the seconds since the last lap (the phase just ended)."""
        now = time.perf_counter()
        print(f"phase {name}: {now - clock[0]:.1f} s")
        clock[0] = now

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

    def k1_step_check(what, pm, q, qd, ctrl, f0, iters):
        """K1's control step against its plain version at the pins
        (rtol 2e-4, atol 5e-3), and two launches bit-equal.  Returns max
        |kernel - plain|."""
        got_s = k1s(pm, q, qd, ctrl, f0, iters)
        torch.cuda.synchronize()
        want_s = pd._control_step(pm, plain_fwd(pm, iters), q, qd, ctrl, f0)
        check(f"{what} control step", flat(got_s), flat(want_s), 2e-4, 5e-3)
        if not all(torch.equal(a, b) for a, b in zip(
                flat(got_s), flat(k1s(pm, q, qd, ctrl, f0, iters)))):
            fail(f"{what}: two launches differ")
        return max_err(flat(got_s), flat(want_s))

    hopper_err = None
    for name in ("hopper", "walker", "halfcheetah", "invertedpendulum"):
        m = _model(name)
        pm = pd.planar_model(m)
        damped = pm.integrator == "euler"
        # 128 and 100 as the main paths, 8 and 32 as the launcher's
        # training envs and its 32-episode evaluator
        for B in (128, 100, 8, 32):
            q, qd, ctrl, f0 = k1_inputs(m, B)
            got = k1(pm, q, qd, ctrl, f0, iters, damped)
            torch.cuda.synchronize()
            want = plain_fwd(pm, iters)(q, qd, ctrl, f0, damped)
            check(f"K1 {name} B={B} forward", got, want, 2e-4, 5e-3)
            err_f = max_err(got, want)
            err_s = k1_step_check(f"K1 {name} B={B}", pm, q, qd, ctrl, f0,
                                  iters)
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

    lap("3")
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

    lap("4")
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

    def k2_modes(what, n_obs, n_act, width, B, K, case=None):
        """K2 against its plain version in each mode, from one seeded state
        and one set of inputs (`case`: a trainer, its [K, B] batches and
        the two noise draws; by default `k2_case`'s): every group at the
        mode's pins, but in bf16 mode at widths over 32 the parameters, mu
        and nu under `bf16_gate`, with the plain float32 mode as its
        control; and the
        float32 mode held against the plain bf16 mode the same way must
        fail that gate.  Returns max |kernel - plain| per mode and group."""
        if case is None:
            sac_, _, _, batches, e_next, e_new = k2_case(n_obs, n_act,
                                                         width, B, K)
        else:
            sac_, batches, e_next, e_new = case
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
    # the launcher's K: round(8 envs x 1000 / 1000) steps a launch
    k2_modes("hopper shape 11/3, 256x2, B=512, K=8", 11, 3, 256, 512, 8)
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

    lap("4b")
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

    lap("4c")
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

    lap("4d")
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

    lap("5")
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

    lap("6")
    # ---- 7. SAC-Ant at full width ------------------------------------------
    ant_launches = drive("ant", fused=True, train_iters=10)

    lap("7")
    # ---- 8. SAC-Humanoid at full width, cut in length ----------------------
    humanoid_launches = drive("humanoid", fused=True, train_iters=3,
                              min_steps=1024)

    lap("8")
    # ---- 9. the YAML launcher: sac_hopper_optable.yaml, save and resume ----
    counters = {"planar_control_step": k1s, "planar_forward": k1,
                "fused_sac_chain": k2, "fused_policy_forward": k3,
                "pgs_solve": k4}
    launcher = launcher_phase(
        card, counters, (k2, fused_sac.fused_sac_chain_plain),
        k1_step_check, k2_modes)
    lap("9")
    # ---- 10. adversarial IL: gail_hopper.yaml, save and resume ------------
    gail = gail_phase(card, counters, k1_step_check)
    lap("10")
    # ---- 11. TD3: td3_hopper.yaml, save and resume -----------------------
    td3 = td3_phase(card, counters, k1_step_check)
    lap("11")
    # ---- 12. DQN, discrete SAC, DDPG, SAC-V through the launcher ----------
    others = other_trainers_phase(card, counters)
    lap("12")
    # ---- 13. PPO: ppo_hopper.yaml through the launcher --------------------
    ppo = ppo_phase(card, counters, k1_step_check)
    lap("13")
    # ---- 14. the rnn discriminator: gail_hopper.yaml, save and resume -----
    gail_rnn = rnn_gail_phase(card, counters, k1_step_check)
    lap("14")
    # ---- 15. MBPO: mbpo_hopper.yaml through the launcher ------------------
    mbpo = mbpo_phase(card, counters, k1_step_check)
    lap("15")
    # ---- 16. gen_expert, BC, DAgger and eval_policy on hopper -------------
    imitation = imitation_phase(card, counters, k1_step_check)
    lap("16")
    # ---- 17. HER and GCSL on reach2d --------------------------------------
    goal = goal_phase(card, counters)
    lap("17")
    # ---- 18. SAC-AE, RAD, CURL on pendulum_pixels; the cnn discriminator --
    visual = visual_phase(card, counters)
    lap("18")
    # ---- 19. the host loops' device half over a stand-in host env --------
    host = host_phase(card, counters)
    lap("19")
    # ---- 20. data parallelism over torch.distributed ----------------------
    dp = data_parallel_phase(card)
    lap("20")

    k2_k8_bound = k2_bound(512, 11, 3, 256, 2, 8, bf16=True)
    print(f"K2 at the launcher's shape (hopper, B = 512, 256 x 2, K = 8, "
          f"bf16): {launcher['k2_k8_ms']:.4f} ms per launch, plain version "
          f"{launcher['k2_k8_plain_ms']:.3f} ms, bound "
          f"{k2_k8_bound[0]:.6f} ms ({k2_k8_bound[1]}), on {card}")

    ant_k4 = k4_engine["ant", 128]
    kernels = [
        {"name": "planar_forward", "route": "cuda",
         "source": "ilswiss_tpu_torch/csrc/planar_forward.cu",
         "replaces": "ilswiss_tpu/ops/planar_dynamics.py:694",
         "launches": hopper_launches["planar_control_step"],
         "max_abs_err": hopper_err, "ms": k1_times[128],
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None,
         "ms_per_evaluation": k1_eval_ms, "ms_b1024": k1_times[1024],
         "launcher": {f"b{b}": {"ms": v,
                                "max_abs_err": launcher["k1_err"][b]}
                      for b, v in launcher["k1_ms"].items()},
         "gail": {f"b{b}": {"ms": v, "max_abs_err": gail["k1_err"][b]}
                  for b, v in gail["k1_ms"].items()},
         "td3": {f"b{b}": {"ms": v, "max_abs_err": td3["k1_err"][b]}
                 for b, v in td3["k1_ms"].items()},
         "ppo": {f"b{b}": {"ms": v, "max_abs_err": ppo["k1_err"][b]}
                 for b, v in ppo["k1_ms"].items()},
         "gail_rnn": {f"b{b}": {"ms": v,
                                "max_abs_err": gail_rnn["k1_err"][b]}
                      for b, v in gail_rnn["k1_ms"].items()},
         "mbpo": {f"b{b}": {"ms": v, "max_abs_err": mbpo["k1_err"][b]}
                  for b, v in mbpo["k1_ms"].items()},
         "imitation": {run: {"ms": v,
                             "max_abs_err": imitation["k1_err"][run]}
                       for run, v in imitation["k1_ms"].items()}},
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
                          "float32": k2_ms["ant", f32]},
         "launcher_k8": {"ms": launcher["k2_k8_ms"],
                         "plain_ms": launcher["k2_k8_plain_ms"],
                         "max_abs_err": launcher["k2_k8_err"]["bf16"],
                         "float32_max_abs_err":
                             launcher["k2_k8_err"]["float32"],
                         "bound_ms": k2_k8_bound[0],
                         "bound_by": k2_k8_bound[1]}},
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
    # the ant path's; `launches_by_path` adds the launcher's run A, the
    # GAIL launcher's run A, TD3's and DQN's run A, the 1-epoch runs of
    # DDPG, SAC-V and discrete SAC, PPO's run, the rnn GAIL's run A,
    # MBPO's run, phase 16's four runs, phase 17's three, phase 18's
    # four and phase 19's nine (no kernel launches on the visual path or
    # on the host loops), and phase 20's ranks (K1 on each: the nccl
    # ranks' runs, the gloo ranks' distinct-data SAC runs)
    paths = {"hopper": hopper_launches, "ant": ant_launches,
             "humanoid": humanoid_launches, "launcher": launcher["launches"],
             "gail": gail["launches"], "td3": td3["launches"],
             **{name: others[name]["launches"]
                for name in ("ddpg", "sac_v", "dqn", "discrete_sac")},
             "ppo": ppo["launches"], "gail_rnn": gail_rnn["launches"],
             "mbpo": mbpo["launches"], **imitation["launches"],
             **goal["launches"], **visual["launches"], **host["launches"],
             **dp["launches"]}
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
