"""Pixel-observation pendulum, rendered analytically on the device
(counterpart: ilswiss_tpu/envs/classic/pendulum_pixels.py).

The pendulum's dynamics, reward and reset are `Pendulum`'s.  Each frame
is the rod drawn as a distance-to-segment field on a [-1.2, 1.2] pixel
grid (angle 0 up), and the last `frame_stack` frames are stacked along
the trailing axis, as the reference's FrameStackEnv stacks dm-control
renders.  The internal state is ([B, 2] theta and theta dot, [B, H, W, k]
frames); observations are the frames, NHWC float32 in [0, 1].
"""

from __future__ import annotations

import numpy as np
import torch

from ilswiss_tpu_torch.envs.base import Environment
from ilswiss_tpu_torch.envs.classic.pendulum import Pendulum


class PendulumPixels(Environment):
    """obs: [B, image_size, image_size, frame_stack] float32 in [0, 1]."""

    action_size = 1
    discrete = False
    max_episode_steps = 200
    action_low = np.array([-2.0], np.float32)
    action_high = np.array([2.0], np.float32)

    image_size = 64
    frame_stack = 3

    def __init__(self, device=None, **overrides):
        super().__init__(device=device, **overrides)
        self._pend = Pendulum(device=self.device)
        self.observation_size = (
            self.image_size, self.image_size, self.frame_stack)
        # the pixel grid in world coordinates, y up (jnp.meshgrid(coords,
        # -coords)); float32 as jnp.linspace computes it
        coords = torch.as_tensor(
            np.linspace(-1.2, 1.2, self.image_size, dtype=np.float32),
            device=self.device)
        self._xx = coords[None, None, :]
        self._yy = -coords[None, :, None]

    def _render(self, th: torch.Tensor) -> torch.Tensor:
        """[B, size, size] rod images of the angles `th` [B]."""
        ex = torch.sin(th)[:, None, None]
        ey = torch.cos(th)[:, None, None]
        t = torch.clamp(self._xx * ex + self._yy * ey, 0.0, 1.0)
        dx, dy = self._xx - t * ex, self._yy - t * ey
        dist = torch.sqrt(dx ** 2 + dy ** 2)
        return torch.clamp(1.0 - dist / 0.12, 0.0, 1.0)

    def sample_reset_noise(self, n: int, generator: torch.Generator):
        return self._pend.sample_reset_noise(n, generator)

    def _reset(self, noise):
        (state,), _ = self._pend._reset(noise)
        frame = self._render(state[:, 0])
        frames = frame[..., None].expand(
            -1, -1, -1, self.frame_stack).contiguous()
        return (state, frames), frames

    def _step(self, internal, action):
        state, frames = internal
        (state,), _, reward, terminal = self._pend._step((state,), action)
        frame = self._render(state[:, 0])
        frames = torch.cat([frames[..., 1:], frame[..., None]], dim=-1)
        return (state, frames), frames, reward, terminal
