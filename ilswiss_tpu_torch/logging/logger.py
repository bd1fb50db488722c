"""Metric sinks: console table, progress.csv, TensorBoard, wandb
(counterpart: ilswiss_tpu/logging/logger.py, of which this is a copy).

Rebuild of the reference logger (rlkit/core/logger.py): tabular
accumulation (`record_tabular` :226), epoch dumps to console +
`progress.csv` (:300-343), optional TensorBoard (:128-131,201-202) and
wandb (:134-140,205-206) scalar mirroring keyed on the epoch step, plus
variant json (launcher_util.py:260-264).  Differences by design:
metrics arrive once per epoch as one small dict of floats read from the
device (the loop never calls back mid-epoch), and the csv writer handles
late-appearing keys by rewriting the header instead of the reference's
fixed-key-set assumption (logger.py:309-317 — the constraint that forced
its `_can_evaluate` gating).
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Dict, Mapping


class Logger:
    def __init__(self, log_dir: str, use_tensorboard: bool = False,
                 use_wandb: bool = False, wandb_kwargs: dict | None = None,
                 print_to_console: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._tabular: Dict[str, Any] = {}
        self._csv_path = os.path.join(log_dir, "progress.csv")
        self._csv_keys: list[str] = []
        self._text_path = os.path.join(log_dir, "debug.log")
        self.print_to_console = print_to_console
        self._t0 = time.time()

        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))
            except ImportError:
                self.log("tensorboard unavailable; disabled")

        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(dir=log_dir, **(wandb_kwargs or {}))
            except ImportError:
                self.log("wandb unavailable; disabled")

    # --- text -----------------------------------------------------------
    def log(self, msg: str) -> None:
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        line = f"{stamp} | {msg}"
        if self.print_to_console:
            print(line, flush=True)
        with open(self._text_path, "a") as f:
            f.write(line + "\n")

    # --- tabular --------------------------------------------------------
    def record_tabular(self, key: str, value: Any) -> None:
        self._tabular[key] = (
            float(value) if hasattr(value, "__float__") else value
        )

    def record_dict(self, d: Mapping[str, Any], prefix: str = "") -> None:
        for k, v in d.items():
            self.record_tabular(prefix + k, v)

    def dump_tabular(self, step: int) -> None:
        """Write the accumulated row (console + csv + tb + wandb)."""
        self._tabular.setdefault("Epoch", step)
        self._tabular.setdefault("WallTime", time.time() - self._t0)
        row = dict(self._tabular)
        self._tabular = {}

        if self.print_to_console:
            width = max(len(k) for k in row)
            print("-" * (width + 17))
            for k in sorted(row):
                v = row[k]
                vs = f"{v:.6g}" if isinstance(v, float) else str(v)
                print(f"| {k:<{width}} | {vs:>10} |")
            print("-" * (width + 17), flush=True)

        self._write_csv(row)
        if self._tb is not None:
            for k, v in row.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log(row, step=step)

    def _write_csv(self, row: Dict[str, Any]) -> None:
        new_keys = [k for k in row if k not in self._csv_keys]
        if new_keys and os.path.exists(self._csv_path):
            # rewrite with widened header (reference assumed a fixed key
            # set; we tolerate keys appearing after epoch 0)
            with open(self._csv_path) as f:
                old_rows = list(csv.DictReader(f))
            self._csv_keys += new_keys
            with open(self._csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._csv_keys)
                w.writeheader()
                for r in old_rows:
                    w.writerow(r)
        elif new_keys:
            self._csv_keys += new_keys
            with open(self._csv_path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self._csv_keys).writeheader()
        with open(self._csv_path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._csv_keys).writerow(row)

    # --- artifacts ------------------------------------------------------
    def save_variant(self, variant: Mapping[str, Any]) -> None:
        with open(os.path.join(self.log_dir, "variant.json"), "w") as f:
            json.dump(variant, f, indent=2, default=str)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
