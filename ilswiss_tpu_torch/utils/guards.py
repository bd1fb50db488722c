"""Fault guards: NaN detection and preemption-signal checkpoint flush
(counterpart: ilswiss_tpu/utils/guards.py).

  * `enable_debug_nans()` turns on autograd's anomaly mode (variant key
    `debug_nans: true`).
  * `check_finite_metrics()` is the cheap per-epoch host-side guard:
    every epoch's metrics are scanned once; a non-finite entry logs
    loudly and (with `abort_on_nan`) raises before the run burns more
    device time on a diverged state.
  * `PreemptionGuard` converts SIGTERM/SIGUSR1 (the cluster's
    preemption notice) into an end-of-epoch checkpoint flush + clean
    exit, so `load_params`-style resume continues the run.
"""

from __future__ import annotations

import signal
from typing import Callable, Dict

import numpy as np
import torch


class NonFiniteMetricError(RuntimeError):
    pass


def enable_debug_nans() -> None:
    """`torch.autograd.set_detect_anomaly(True)`, the counterpart of
    `jax_debug_nans`.

    Unlike `jax_debug_nans`, which re-runs every jitted operation that
    produced a NaN, anomaly mode checks only the BACKWARD pass of autograd:
    it raises where a backward function returns a NaN and names the
    forward operation that recorded it.  It does not see forward
    operations (a NaN made in a forward pass or under `no_grad`, such as
    acting, the env step and the Q target, goes by), nor the kernels: the
    fused chain (kernel K2, and its plain version, which runs under
    `no_grad`), the planar step (K1), the policy forward (K3) and the
    contact solve (K4) never reach autograd.  `check_finite_metrics`
    still sees what they make, once an epoch."""
    torch.autograd.set_detect_anomaly(True)


def check_finite_metrics(metrics: Dict[str, float], epoch: int,
                         log_fn: Callable[[str], None] | None = None,
                         abort: bool = False) -> bool:
    """Returns True if all metric values are finite; logs offenders."""
    bad = {k: v for k, v in metrics.items()
           if not np.all(np.isfinite(v))}
    if not bad:
        return True
    msg = (f"NON-FINITE metrics at epoch {epoch}: "
           + ", ".join(f"{k}={v}" for k, v in bad.items()))
    (log_fn or print)(msg)
    if abort:
        raise NonFiniteMetricError(msg)
    return False


class PreemptionGuard:
    """SIGTERM/SIGUSR1 -> flush a checkpoint at the next epoch boundary.

    Usage:
        guard = PreemptionGuard()
        for epoch in ...:
            ... train ...
            if guard.should_stop:
                snap.save_last(runner, epoch); break
    The handler only sets a flag — the actual write happens on the main
    thread between epochs, where the runner state is consistent.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGUSR1)):
        self.should_stop = False
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except (ValueError, OSError):
                pass  # non-main thread / unsupported platform

    def _handle(self, signum, frame):
        self.should_stop = True

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
