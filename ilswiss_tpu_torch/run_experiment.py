"""Experiment scheduler: YAML spec -> variant grid -> runs (counterpart:
the root run_experiment.py of the JAX package).

    python -m ilswiss_tpu_torch.run_experiment -e spec.yaml [--workers N] \\
        [--device cpu]

Same CLI and spec schema as the reference's top-level scheduler
(run_experiment.py:11-78).  Variants run sequentially in-process by
default (one GPU is one device; `--workers N` runs them in N
subprocesses).  `--device` picks the torch device and defaults to the GPU
(`cuda`); there is no fallback to the CPU.  `-g/--gpu` is accepted for
the reference's CLI and ignored.

The algorithm is chosen by `meta_data.algorithm` (or inferred from the
reference's `script_path` naming).  Logs and snapshots go to the variant's
`log_dir`, by default logs/<exp_name>/seed_<seed>_id<exp_id>/
(progress.csv, debug.log, variant.json, checkpoints/).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import yaml

from ilswiss_tpu_torch.launchers.experiments import EXPERIMENTS
from ilswiss_tpu_torch.launchers.variant import build_variants


def infer_algorithm(meta: dict) -> str:
    if "algorithm" in meta:
        return meta["algorithm"]
    script = meta.get("script_path", "")
    for name in ("sac_alpha", "discrete_sac", "sac", "td3", "ddpg", "dqn",
                 "ppo", "bc", "adv_irl", "gail"):
        if name in script:
            return {"sac_alpha": "sac", "gail": "adv_irl"}.get(name, name)
    raise ValueError(
        f"cannot infer algorithm from meta_data: {meta}; "
        "set meta_data.algorithm"
    )


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-e", "--experiment", required=True,
                        help="experiment spec yaml")
    parser.add_argument("-g", "--gpu", default="0",
                        help="accepted for reference-CLI parity; ignored")
    parser.add_argument("--workers", type=int, default=0,
                        help="run variants in N subprocesses (0 = inline)")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)

    with open(args.experiment) as f:
        spec = yaml.safe_load(f)
    meta = spec.get("meta_data", {})
    algorithm = infer_algorithm(meta)
    if algorithm not in EXPERIMENTS:
        raise ValueError(
            f"unknown algorithm '{algorithm}'; known: {sorted(EXPERIMENTS)}"
        )
    variants = build_variants(spec)
    exp_name = meta.get("exp_name", algorithm)
    for v in variants:
        v.setdefault("exp_name", exp_name)

    print(f"[run_experiment] {len(variants)} variant(s) of '{algorithm}'")

    if args.workers <= 0:
        for i, variant in enumerate(variants):
            print(f"[run_experiment] variant {i}: "
                  f"seed={variant.get('seed')} id={variant['exp_id']}")
            EXPERIMENTS[algorithm](variant, device=args.device)
        return

    # subprocess pool (reference run_experiment.py:57-78)
    tmpdir = tempfile.mkdtemp(prefix="variants-")
    queue = []
    for i, variant in enumerate(variants):
        path = os.path.join(tmpdir, f"{i}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(variant, f)
        queue.append(path)

    def launch(path):
        cmd = [sys.executable, "-m", "ilswiss_tpu_torch.launchers.run_variant",
               "--algorithm", algorithm, "--variant", path]
        if args.device:
            cmd += ["--device", args.device]
        return subprocess.Popen(cmd)

    running: dict[str, subprocess.Popen] = {}
    failed = []
    while queue or running:
        for path, proc in list(running.items()):
            if proc.poll() is not None:
                del running[path]
                if proc.returncode:
                    failed.append(path)
        while queue and len(running) < args.workers:
            path = queue.pop(0)
            running[path] = launch(path)
        time.sleep(1)
    if failed:
        sys.exit(f"[run_experiment] variant(s) failed: {failed}")

if __name__ == "__main__":
    main()
