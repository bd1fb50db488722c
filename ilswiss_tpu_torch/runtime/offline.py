"""Offline training loop: BC-style, no env interaction while training
(counterpart: ilswiss_tpu/runtime/offline.py; `OfflineRunnerState`,
`OfflineLoop`).

An epoch is `steps_per_epoch` gradient steps, each on a batch gathered
uniformly from the expert ring.  The JAX package scans them in one jitted
program; here they are eager calls, with the metrics kept on the device
until the epoch ends.  Draws per step: noise.replay (the batch's rows),
then the algorithm's `train_noise`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from ilswiss_tpu_torch.data.replay import ReplayState, replay_sample
from ilswiss_tpu_torch.runtime.loop import Noise


@dataclass
class OfflineRunnerState:
    noise: Any
    algo_state: Any
    expert: ReplayState
    total_train_steps: int


def _copy_ring(ring: ReplayState) -> ReplayState:
    return ReplayState(data={k: v.clone() for k, v in ring.data.items()},
                       ep_id=ring.ep_id.clone(), ptr=ring.ptr,
                       size=ring.size, env_ep=ring.env_ep.clone())


class OfflineLoop:
    """For an algorithm with `init(seed)` and `train_step(state, batch,
    *draws)` with `train_noise(noise, batch_size)` (BC)."""

    def __init__(self, algo, expert_replay: ReplayState,
                 batch_size: int = 256):
        self.algo = algo
        self.expert_replay = expert_replay
        self.batch_size = batch_size

    def init(self, seed: int, noise=None) -> OfflineRunnerState:
        """Fresh runner: algorithm state from `seed`, every later draw from
        `noise` (default `Noise(seed + 1, device)`), and a private copy of
        the expert ring, as the JAX runner holds one."""
        device = self.expert_replay.ep_id.device
        return OfflineRunnerState(
            noise=Noise(seed + 1, device) if noise is None else noise,
            algo_state=self.algo.init(seed),
            expert=_copy_ring(self.expert_replay),
            total_train_steps=0,
        )

    def train_epoch(self, runner: OfflineRunnerState, steps_per_epoch: int
                    ) -> tuple[OfflineRunnerState, Dict[str, float]]:
        """`steps_per_epoch` gradient steps; returns the per-epoch means of
        the metrics as floats."""
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(steps_per_epoch):
            batch = replay_sample(runner.expert,
                                  runner.noise.replay(self.batch_size))
            runner.algo_state, metrics = self.algo.train_step(
                runner.algo_state, batch,
                *self.algo.train_noise(runner.noise, self.batch_size))
            for k, v in metrics.items():
                sums[k] = v if k not in sums else sums[k] + v
        runner.total_train_steps += steps_per_epoch
        return runner, {k: float(v / steps_per_epoch)
                        for k, v in sums.items()}
