#!/usr/bin/env python3
"""How far kernel K2 and its plain version part, in each mode of the
products, on one GPU: the readings behind `bf16_gate`
(ilswiss_tpu_torch/testing.py).

    python3 -m ilswiss_tpu_torch.kernels.k2_mode_diff

from the root of a checkout.  For the hopper, ant and humanoid shapes
(obs / action 11 / 3, 105 / 8, 348 / 17; 256 x 2 nets, batch 512) and
chains of K = 1, 2 and 4 steps from one seeded state and seeded inputs
(those of chip_smoke.py), it prints per group (parameters and targets,
mu, nu) how many elements lie outside the bf16 pins of the plain bf16
mode for: the kernel's bf16 mode, the control (the plain float32 mode)
and the kernel's float32 mode; whether `bf16_gate` passes the kernel's
bf16 mode and refuses its float32 mode; and the largest parameter
difference of kernel and plain version in each mode.  The card's name and
power limit come first.
"""

from __future__ import annotations

import subprocess
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_mode_diff: no CUDA device", file=sys.stderr)
        return 2
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.ops import fused_sac
    from ilswiss_tpu_torch.testing import bf16_gate, k2_groups

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    chains = {"kernel": fused_sac.fused_sac_chain,
              "plain": fused_sac.fused_sac_chain_plain}
    for n_obs, n_act in ((11, 3), (105, 8), (348, 17)):
        for K in (1, 2, 4):
            sac = SAC(n_obs, n_act, SACConfig(), net_size=256,
                      num_hidden_layers=2)
            g = torch.Generator().manual_seed(K * 1000 + 512)
            draw = lambda *shape: torch.randn(*shape, generator=g).to(dev)
            batches = {"obs": draw(K, 512, n_obs),
                       "action": torch.tanh(draw(K, 512, n_act)),
                       "reward": draw(K, 512),
                       "terminal": (draw(K, 512) > 1.0).float(),
                       "next_obs": draw(K, 512, n_obs)}
            eps_next, eps_new = draw(K, 512, n_act), draw(K, 512, n_act)
            runs = {}
            for who, chain in chains.items():
                for dt in (bf16, f32):
                    state, _ = chain(sac, sac.init(1), batches, eps_next,
                                     eps_new, dt)
                    torch.cuda.synchronize()
                    runs[who, dt] = k2_groups(state)
            ok = bf16_gate(runs["kernel", bf16], runs["plain", bf16],
                           runs["plain", f32])
            wrong = bf16_gate(runs["kernel", f32], runs["plain", bf16],
                              runs["plain", f32])
            worst = {dt: max(float((x - y).abs().max()) for x, y in zip(
                runs["kernel", dt]["params"], runs["plain", dt]["params"]))
                for dt in (bf16, f32)}
            n_all = {grp: sum(x.numel() for x in runs["plain", bf16][grp])
                     for grp in ok}
            print(f"{n_obs}/{n_act} K={K}: outside the bf16 pins of the "
                  f"plain bf16 mode, kernel bf16 / control / kernel "
                  f"float32: "
                  + "; ".join(f"{grp} {ok[grp][0]} / {ok[grp][1]} / "
                              f"{wrong[grp][0]} of {n_all[grp]}"
                              for grp in ok)
                  + f"; gate passes the bf16 mode: "
                  f"{all(v[2] for v in ok.values())}, refuses the float32 "
                  f"mode: {not all(v[2] for v in wrong.values())}; max "
                  f"|kernel - plain| in a parameter: bf16 {worst[bf16]:.3g},"
                  f" float32 {worst[f32]:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
