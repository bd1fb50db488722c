"""Adversarial-IL discriminators (counterpart:
ilswiss_tpu/models/discriminators.py; `resolve_act`, `MLPDisc`,
`CNNDisc`, `ResNetAIRLDisc`).

`MLPDisc` is the reference architecture (simple_disc_models.py:8-48):
Linear -> [BatchNorm] -> act blocks, then a scalar logit clamped to
+-clamp_magnitude.  Layers keep the flax names (`dense_i`, `bn_i`,
`logit`) so utils/convert.py maps them one to one.  Its BatchNorm is the
port's own `BatchNorm` with flax's semantics, not `torch.nn.BatchNorm1d`,
which updates its running variance with the unbiased batch variance and
momentum 0.1 and so drifts from the JAX discriminator after one update.
`CNNDisc` is the visual discriminator of (image, action) pairs
(reference cnn_disc_models.py:7-77), NHWC as in the JAX package.
`ResNetAIRLDisc` is the residual MLP of the reference's
simple_disc_models.py:51+; nothing in the JAX package calls it, and
nothing in the port does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ilswiss_tpu_torch.models.encoders import lecun_normal_

# flax's `lecun_normal`: a normal truncated at +-2 standard deviations,
# rescaled by this constant (the truncated unit normal's std) so the
# kernel's variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def resolve_act(hid_act: str):
    """relu or tanh, as the reference (simple_disc_models.py:14-19);
    another name raises."""
    if hid_act == "relu":
        return torch.relu
    if hid_act == "tanh":
        return torch.tanh
    raise NotImplementedError(f"unknown disc activation: {hid_act!r}")


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the batch axis of [B, F]: momentum 0.99,
    epsilon 1e-5, learned `scale` (ones) and `bias` (zeros), running
    `mean` (zeros) and `var` (ones).

    In train mode it normalizes by the batch's own statistics, the mean
    and the BIASED variance max(0, E[x^2] - E[x]^2) (flax's fast variance),
    and the gradient flows through them; in eval mode by the running
    averages.  The forward never updates the running averages itself:
    `update(mean, var)` does, momentum * running + (1 - momentum) * batch,
    so the caller decides which forward's statistics count (the JAX
    `_disc_update` keeps those of its main forward only)."""

    momentum = 0.99
    epsilon = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool,
                stats: List[Tuple[torch.Tensor, torch.Tensor]] | None = None
                ) -> torch.Tensor:
        if train:
            mean = torch.mean(x, dim=0)
            var = torch.clamp_min(torch.mean(x * x, dim=0) - mean * mean,
                                  0.0)
            if stats is not None:
                stats.append((mean.detach(), var.detach()))
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean) * mul + self.bias

    @torch.no_grad()
    def update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.mean.copy_(m * self.mean + (1 - m) * mean)
        self.var.copy_(m * self.var + (1 - m) * var)


def _lecun_normal_(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax Dense's default init: kernel lecun_normal, bias zeros."""
    std = (1.0 / layer.in_features) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        layer.bias.zero_()


class MLPDisc(nn.Module):
    """`num_layer_blocks` x (Linear -> [BatchNorm] -> act), then a logit
    clamped to +-clamp_magnitude; [B, input_size] -> [B, 1]."""

    def __init__(self, input_size: int, generator: torch.Generator,
                 num_layer_blocks: int = 2, hid_dim: int = 100,
                 hid_act: str = "relu", use_bn: bool = True,
                 clamp_magnitude: float = 10.0):
        super().__init__()
        self.act = resolve_act(hid_act)
        self.num_layer_blocks = num_layer_blocks
        self.use_bn = use_bn
        self.clamp_magnitude = clamp_magnitude
        width = input_size
        for i in range(num_layer_blocks):
            layer = nn.Linear(width, hid_dim)
            _lecun_normal_(layer, generator)
            self.add_module(f"dense_{i}", layer)
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(hid_dim))
            width = hid_dim
        self.logit = nn.Linear(width, 1)
        _lecun_normal_(self.logit, generator)

    def batch_norms(self) -> List[BatchNorm]:
        if not self.use_bn:
            return []
        return [getattr(self, f"bn_{i}") for i in range(self.num_layer_blocks)]

    def forward(self, x: torch.Tensor, train: bool = True,
                stats: List[Tuple[torch.Tensor, torch.Tensor]] | None = None
                ) -> torch.Tensor:
        """Logits [B, 1].  `train` selects the BatchNorm statistics (the
        batch's, or the running averages); where `stats` is a list, each
        BatchNorm appends its batch (mean, var) to it, for
        `update_batch_stats`."""
        for i in range(self.num_layer_blocks):
            x = getattr(self, f"dense_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, train, stats)
            x = self.act(x)
        x = self.logit(x)
        return torch.clamp(x, -self.clamp_magnitude, self.clamp_magnitude)

    def update_batch_stats(
            self, stats: List[Tuple[torch.Tensor, torch.Tensor]]) -> None:
        """Move each BatchNorm's running averages toward the statistics a
        train-mode forward collected."""
        for bn, (mean, var) in zip(self.batch_norms(), stats):
            bn.update(mean, var)


class CNNDisc(nn.Module):
    """The visual discriminator (JAX `CNNDisc`, discriminators.py:54-94):
    a 3x3 VALID conv of stride 2 (`conv_0`), num_layer_blocks - 1 of
    stride 1 (`conv_{i}`), each followed by the activation; the features
    flattened in (h, w, c) order (the JAX layout) and concatenated with
    the action; num_layer_blocks x (Dense `dense_i` -> LayerNorm `ln_i`,
    flax's epsilon 1e-6 -> act); a logit clamped to +-clamp_magnitude.
    Float32 throughout; flax's default inits (lecun_normal kernels, zero
    biases).  AdvIRL builds it without BatchNorm, as the JAX AdvIRL does,
    so the port has none.  obs [B, H, W, C], action [B, A] -> [B, 1]."""

    def __init__(self, obs_shape, action_size: int,
                 generator: torch.Generator, num_filters: int = 32,
                 num_layer_blocks: int = 2, hid_dim: int = 100,
                 hid_act: str = "relu", clamp_magnitude: float = 10.0):
        super().__init__()
        self.act = resolve_act(hid_act)
        self.num_layer_blocks = num_layer_blocks
        self.clamp_magnitude = clamp_magnitude
        h, _, c = obs_shape
        width = c
        for i in range(num_layer_blocks):
            conv = nn.Conv2d(width, num_filters, 3)
            lecun_normal_(conv.weight, width * 9, generator)
            with torch.no_grad():
                conv.bias.zero_()
            self.add_module(f"conv_{i}", conv)
            width = num_filters
        hw = (h - 3) // 2 + 1 - 2 * (num_layer_blocks - 1)
        width = num_filters * hw * hw + action_size
        for i in range(num_layer_blocks):
            dense = nn.Linear(width, hid_dim)
            _lecun_normal_(dense, generator)
            self.add_module(f"dense_{i}", dense)
            self.add_module(f"ln_{i}", nn.LayerNorm(hid_dim, eps=1e-6))
            width = hid_dim
        self.logit = nn.Linear(width, 1)
        _lecun_normal_(self.logit, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor
                ) -> torch.Tensor:
        x = obs.permute(0, 3, 1, 2)
        for i in range(self.num_layer_blocks):
            x = self.act(F.conv2d(x, getattr(self, f"conv_{i}").weight,
                                  getattr(self, f"conv_{i}").bias,
                                  stride=2 if i == 0 else 1))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.cat([x, action], dim=-1)
        for i in range(self.num_layer_blocks):
            x = self.act(getattr(self, f"ln_{i}")(
                getattr(self, f"dense_{i}")(x)))
        x = self.logit(x)
        return torch.clamp(x, -self.clamp_magnitude, self.clamp_magnitude)


class ResNetAIRLDisc(nn.Module):
    """The residual MLP discriminator (JAX `ResNetAIRLDisc`,
    discriminators.py:97-123): `embed` -> [BatchNorm `bn_in`] -> act, then
    num_layer_blocks residual blocks x + act([BatchNorm `res_i_bn`]
    (Dense `res_i_a`(x))), then a logit clamped to +-clamp_magnitude;
    [B, input_size] -> [B, 1].  BatchNorm as `MLPDisc`'s (`train`,
    `stats`, `update_batch_stats`)."""

    def __init__(self, input_size: int, generator: torch.Generator,
                 num_layer_blocks: int = 2, hid_dim: int = 100,
                 hid_act: str = "tanh", use_bn: bool = False,
                 clamp_magnitude: float = 10.0):
        super().__init__()
        self.act = resolve_act(hid_act)
        self.num_layer_blocks = num_layer_blocks
        self.use_bn = use_bn
        self.clamp_magnitude = clamp_magnitude
        self.embed = nn.Linear(input_size, hid_dim)
        _lecun_normal_(self.embed, generator)
        if use_bn:
            self.bn_in = BatchNorm(hid_dim)
        for i in range(num_layer_blocks):
            layer = nn.Linear(hid_dim, hid_dim)
            _lecun_normal_(layer, generator)
            self.add_module(f"res_{i}_a", layer)
            if use_bn:
                self.add_module(f"res_{i}_bn", BatchNorm(hid_dim))
        self.logit = nn.Linear(hid_dim, 1)
        _lecun_normal_(self.logit, generator)

    def batch_norms(self) -> List[BatchNorm]:
        if not self.use_bn:
            return []
        return [self.bn_in] + [getattr(self, f"res_{i}_bn")
                               for i in range(self.num_layer_blocks)]

    def forward(self, x: torch.Tensor, train: bool = True,
                stats: List[Tuple[torch.Tensor, torch.Tensor]] | None = None
                ) -> torch.Tensor:
        x = self.embed(x)
        if self.use_bn:
            x = self.bn_in(x, train, stats)
        x = self.act(x)
        for i in range(self.num_layer_blocks):
            h = getattr(self, f"res_{i}_a")(x)
            if self.use_bn:
                h = getattr(self, f"res_{i}_bn")(h, train, stats)
            x = x + self.act(h)
        x = self.logit(x)
        return torch.clamp(x, -self.clamp_magnitude, self.clamp_magnitude)

    def update_batch_stats(
            self, stats: List[Tuple[torch.Tensor, torch.Tensor]]) -> None:
        """As `MLPDisc.update_batch_stats`."""
        for bn, (mean, var) in zip(self.batch_norms(), stats):
            bn.update(mean, var)
