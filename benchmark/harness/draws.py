"""The run's random draws, made from `--seed` by the benchmark and handed
to the program as its `noise` object (runtime/loop.py's `Noise`
interface: the methods an off-policy SAC iteration calls).  While
`record` is a list, every draw is appended to it as (method, value), so
the reference gets the same inputs."""

from __future__ import annotations

import torch


class Draws:
    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.record: list | None = None

    def _keep(self, kind: str, value):
        if self.record is not None:
            self.record.append((kind, value))
        return value

    def _uniform(self, shape, low: float, high: float) -> torch.Tensor:
        return torch.empty(shape, device=self.device).uniform_(
            low, high, generator=self.generator)

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, device=self.device,
                           generator=self.generator)

    def warmup_action(self, shape) -> torch.Tensor:
        return self._keep("warmup_action", self._uniform(shape, -1.0, 1.0))

    def act(self, shape) -> torch.Tensor:
        return self._keep("act", self._normal(shape))

    def reset(self, env, n: int):
        return self._keep("reset",
                          env.sample_reset_noise(n, self.generator))

    def replay(self, batch_size: int) -> torch.Tensor:
        return self._keep("replay", self._uniform((batch_size,), 0.0, 1.0))

    def train(self, shape) -> tuple[torch.Tensor, torch.Tensor]:
        return self._keep("train", (self._normal(shape),
                                    self._normal(shape)))


def take(record: list, kind: str) -> list:
    """The values of one kind of draw, in the order they were made."""
    return [v for k, v in record if k == kind]
