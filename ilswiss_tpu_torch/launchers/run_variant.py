"""Subprocess entry: run one variant yaml (counterpart:
ilswiss_tpu/launchers/run_variant.py; used by run_experiment.py's worker
pool, mirroring the reference's per-variant script invocation)."""

from __future__ import annotations

import argparse

import yaml

from ilswiss_tpu_torch.launchers.experiments import EXPERIMENTS


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--algorithm", required=True)
    parser.add_argument("--variant", required=True)
    parser.add_argument("--device", default=None)
    args = parser.parse_args()
    with open(args.variant) as f:
        variant = yaml.safe_load(f)
    EXPERIMENTS[args.algorithm](variant, device=args.device)


if __name__ == "__main__":
    main()
