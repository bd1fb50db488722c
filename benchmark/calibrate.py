"""The readings that the comparison's limits are set from, for one cell.

    python3 benchmark/calibrate.py --workload <name> --seeds <a>,<b>,... \
        [--controls <n>]

For each seed it runs the cell's set-up (the warmup and the first training
iteration through the loop's own call) and prints one JSON line: the
compared numbers of the program against the reference (the lower
readings), and for the first `--controls` seeds those of the control (the
reference one precision below the configuration's, in the program's
place) and of each fault a training cell can have, planted in the
reference put in the program's place (the upper readings).  The runs of
`run.py` do not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, controls: bool, device) -> dict:
    import torch
    from benchmark.harness import algos

    algo = algos.load(cell.config["algorithm"])
    t0 = time.perf_counter()
    system = algo.build(cell.config, cell.traffic, device)
    _, cap = algo.set_up(system, cell.config, cell.traffic, seed, device)
    system = None
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out = {"seed": seed}
    out.update(algo.readings(cap, cell.config, device, controls))
    out["seconds"] = {"set_up": t1 - t0,
                      "comparison": time.perf_counter() - t1}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from benchmark.harness.spec import load_cell
    from ilswiss_tpu_torch.kernels import build
    build.build_all()
    cell = load_cell(args.workload, ROOT)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, i < args.controls, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
