#!/usr/bin/env python3
"""Where one step of kernel K2 (ilswiss_tpu_torch/csrc/fused_sac.cu) spends
its time, phase by phase, on one GPU.

    python3 -m ilswiss_tpu_torch.kernels.k2_phase_profile

from the root of a checkout.  The kernel is one persistent launch, so no profiler sees inside it.  This
script builds a patched copy of the source (into the git-ignored
build/prof/) in which thread 0 of block 0 reads `clock64()` after every
`grid.sync()` of the chain's last step, and hands the differences back
through the metrics table.  It prints the cycles between successive
barriers at the main path's shapes (11 / 3, 256 x 2, batch 512), the
card's name and power limit, and the time of a whole chain by CUDA events
with the unpatched arithmetic (the patch adds one clock read per phase),
once for each mode of the products (bf16, the default, and float32).
A phase's count includes the barrier that ends it.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]

# one name per grid.sync() of a step, in order, for two hidden layers
PHASES = ("trunks layer 0 (policy x2, critics)", "trunks layer 1",
          "rows: heads, samples, Q(s, a)", "target trunk layer 0",
          "target trunk layer 1", "rows: target, dq, d_top",
          "critic backward layer 1 (+ output)", "critic backward layer 0",
          "critic Adam + Polyak", "new-critic trunk layer 0",
          "new-critic trunk layer 1", "rows: Q(s, a_new), d_top",
          "back through critics layer 1", "rows: da, dmean, dls, d_top",
          "policy backward layer 1 (+ heads)", "policy backward layer 0",
          "policy Adam, metrics, alpha")


def patched_source() -> str:
    src = (ROOT / "ilswiss_tpu_torch" / "csrc" / "fused_sac.cu").read_text()
    src, n = re.subn(
        r"  for \(int step = 0; step < a\.K; \+\+step\) \{\n",
        "  long long prof[64]; int pi = 0; long long t_prev = 0;\n"
        "  for (int step = 0; step < a.K; ++step) {\n"
        "    if (step == a.K - 1) t_prev = clock64();\n", src)
    if n != 1:
        raise RuntimeError("the step loop was not found")
    src = src.replace(
        "grid.sync();",
        "grid.sync(); if (step == a.K - 1 && pi < 64) { long long now = "
        "clock64(); prof[pi++] = now - t_prev; t_prev = now; }")
    src, n = re.subn(
        r"\n  \}\n\}\n\nextern \"C\" \{",
        "\n  }\n  if (gtid == 0) { for (int i = 0; i < pi; ++i) "
        "a.metrics[i] = (float)prof[i]; a.metrics[pi] = -1.f; }\n}\n\n"
        "extern \"C\" {", src)
    if n != 1:
        raise RuntimeError("the end of the kernel was not found")
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_phase_profile: no CUDA device", file=sys.stderr)
        return 2
    from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
    from ilswiss_tpu_torch.kernels import build
    from ilswiss_tpu_torch.ops import fused_sac

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    out = ROOT / "build" / "prof"
    out.mkdir(parents=True, exist_ok=True)
    (out / "fused_sac.cu").write_text(patched_source())
    build.CSRC = out            # the wrapper now loads the patched copy
    built = build.build_all(("fused_sac",))["fused_sac"]
    print("\n".join(l for l in built.log.splitlines()
                    if "registers" in l or "spill" in l))

    K, B, n_obs, n_act = 16, 512, 11, 3
    sac = SAC(n_obs, n_act, SACConfig(), net_size=256, num_hidden_layers=2)
    state = sac.init(0)
    g = torch.Generator().manual_seed(0)
    draw = lambda *shape: torch.randn(*shape, generator=g).to("cuda")
    batches = {"obs": draw(K, B, n_obs),
               "action": torch.tanh(draw(K, B, n_act)),
               "reward": draw(K, B),
               "terminal": (draw(K, B) > 1.0).float(),
               "next_obs": draw(K, B, n_obs)}
    eps_next, eps_new = draw(K, B, n_act), draw(K, B, n_act)
    for name, dt in (("bf16", torch.bfloat16), ("float32", torch.float32)):
        for _ in range(3):
            state, metrics = fused_sac.fused_sac_chain(
                sac, state, batches, eps_next, eps_new, dt)
        torch.cuda.synchronize()
        table = torch.stack([metrics[n] for n in fused_sac.METRIC_NAMES], 1)
        cycles = []
        for v in table.flatten().tolist():
            if v < 0:
                break
            cycles.append(v)
        total = sum(cycles)
        print(f"--- {name} products")
        for i, c in enumerate(cycles):
            phase = PHASES[i] if len(cycles) == len(PHASES) else f"phase {i}"
            print(f"{phase:36s} {c:9.0f} cycles {100 * c / total:5.1f}%")
        print(f"one step: {total:.0f} cycles over {len(cycles)} barriers")

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fused_sac.fused_sac_chain(sac, state, batches, eps_next, eps_new, dt)
        end.record()
        end.synchronize()
        print(f"chain of {K} steps: {start.elapsed_time(end) / K * 1e3:.1f} "
              f"us per step, {name} products, on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
