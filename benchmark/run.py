"""One run of one benchmark cell of `ilswiss_tpu_torch` on the card(s) of
this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result as one JSON object; the
compared numbers and their limits are the last lines of standard error.
It exits with 2, printing no result, where the cell's cards are missing,
where the port is not beside this folder, or where JAX was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
JAX_NAMES = {"jax", "jaxlib", "flax", "optax", "ilswiss_tpu"}


def process_start() -> float:
    """The wall-clock time this process started, from /proc, or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def jax_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in sys.modules} & JAX_NAMES)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run inside the checkout, at fixed paths; no JAX
    # through a library that would load it by itself
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if not (ROOT / "ilswiss_tpu_torch").is_dir():
        return fail(f"the port (ilswiss_tpu_torch/) is not in {ROOT}")
    sys.path.insert(0, str(ROOT))

    from benchmark.harness.spec import load_cell, reader
    cell = load_cell(args.workload, ROOT)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"this machine has {cards}")
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from benchmark.harness import cell as cell_run
    from benchmark.harness.trace import top
    out = cell_run.run(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", started, lambda name: reader(name, ROOT))
    found = jax_modules()
    if found:
        return fail(f"JAX was loaded during the run: {', '.join(found)}")

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    tr = out["trace"]
    if tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": top(tr.ops),
                               "idle_gaps": top(tr.gaps)}
    print(f"window: {out['attempted']} iterations, {out['samples']} "
          f"iteration intervals", file=sys.stderr)
    result["checks"] = out["checks"]
    print(json.dumps(result))
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
