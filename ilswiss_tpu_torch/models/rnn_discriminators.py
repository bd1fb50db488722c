"""Trajectory-window and image discriminators (counterpart:
ilswiss_tpu/models/rnn_discriminators.py; `RNNDisc`, `CNNDisc`).

The reference's rnn_disc_models.py:71-86 as the JAX package built it:
a ReLU input linear `embed`, `num_layers` recurrences, each a forward
pass `cell_f{l}` and, when `bidirectional`, a reversed pass `cell_b{l}`
whose outputs are put back in time order and concatenated after the
forward's, then a per-step logit `logit` clamped to +-clamp_magnitude:
[B, T, F] -> [B, T, 1].  The reversed pass starts at the window's last
step, padding included, as flax's `nn.RNN(reverse=True, keep_order=True)`
without `seq_lengths` does; the caller zeroes padded inputs.

The cells are flax 0.12's, written as plain modules, not `torch.nn.GRU` /
`nn.LSTM`: their parameter sets differ (flax's GRU has no biases on the
hidden side's r and z gates, its LSTM has its biases on the hidden side
only), and the gradient penalty's double backward does not run through
cuDNN's recurrences.  Each gate keeps its flax name (`ir`, `iz`, `in`,
`hr`, `hz`, `hn`; `ii`, `if`, `ig`, `io`, `hi`, `hf`, `hg`, `ho`) so
utils/convert.py maps the layers one to one.  The inits are flax's: input
kernels lecun_normal, hidden kernels orthogonal, biases zero, every draw
from the caller's generator.  A pass computes the input side of all T
steps in one product, then one hidden-side product a step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ilswiss_tpu_torch.models.discriminators import _TRUNC_STD
from ilswiss_tpu_torch.models.encoders import (
    conv_out_dim, lecun_normal_, normalize_pixels,
)


@torch.no_grad()
def _init_(layer: nn.Linear, generator: torch.Generator,
           recurrent: bool) -> None:
    """flax's cell inits: kernel orthogonal (hidden side) or lecun_normal
    (input side), bias zeros."""
    if recurrent:
        nn.init.orthogonal_(layer.weight, generator=generator)
    else:
        std = (1.0 / layer.in_features) ** 0.5 / _TRUNC_STD
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std,
                              2.0 * std, generator=generator)
    if layer.bias is not None:
        layer.bias.zero_()


class _Cell(nn.Module):
    """Gate linears named as flax's: input side `i<g>`, hidden side
    `h<g>`, a bias where `biased` names the gate's linear."""

    gates: tuple = ()
    biased: tuple = ()

    def __init__(self, input_size: int, features: int,
                 generator: torch.Generator):
        super().__init__()
        self.features = features
        for side, width in (("i", input_size), ("h", features)):
            for g in self.gates:
                name = side + g
                layer = nn.Linear(width, features, bias=name in self.biased)
                _init_(layer, generator, recurrent=side == "h")
                self.add_module(name, layer)

    def _side(self, side: str) -> tuple[torch.Tensor, torch.Tensor]:
        """The side's gates as one [G * H, in] weight and [G * H] bias
        (zeros where a gate has none)."""
        layers = [getattr(self, side + g) for g in self.gates]
        bias = [l.bias if l.bias is not None
                else torch.zeros_like(l.weight[:, 0]) for l in layers]
        return (torch.cat([l.weight for l in layers]), torch.cat(bias))

    def run(self, x: torch.Tensor, reverse: bool) -> torch.Tensor:
        """[B, T, in] -> [B, T, H] outputs, in time order; the carry
        starts at zero at the first step taken (the last, if reverse)."""
        B, T = x.shape[:2]
        xp = F.linear(x, *self._side("i"))            # [B, T, G * H]
        w_h, b_h = self._side("h")
        carry = self.zero_carry(x.new_zeros((B, self.features)))
        out = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            carry, out[t] = self.step(xp[:, t], F.linear(carry[-1], w_h,
                                                         b_h), carry)
        return torch.stack(out, dim=1)


class GRUCell(_Cell):
    """flax `GRUCell`: r = sigma(W_ir x + b_ir + W_hr h),
    z = sigma(W_iz x + b_iz + W_hz h),
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn)), h' = (1 - z) n + z h."""

    gates = ("r", "z", "n")
    biased = ("ir", "iz", "in", "hn")

    @staticmethod
    def zero_carry(zeros):
        return (zeros,)

    @staticmethod
    def step(xp, hp, carry):
        (h,) = carry
        xr, xz, xn = xp.chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        return (h,), h


class LSTMCell(_Cell):
    """flax `OptimizedLSTMCell`: i, f, o = sigma(W_h h + b_h + W_i x),
    g = tanh(...), c' = f c + i g, h' = o tanh(c'); carry (c, h)."""

    gates = ("i", "f", "g", "o")
    biased = ("hi", "hf", "hg", "ho")

    @staticmethod
    def zero_carry(zeros):
        return (zeros, zeros)

    @staticmethod
    def step(xp, hp, carry):
        c, _ = carry
        xi, xf, xg, xo = xp.chunk(4, dim=-1)
        hi, hf, hg, ho = hp.chunk(4, dim=-1)
        i = torch.sigmoid(hi + xi)
        f = torch.sigmoid(hf + xf)
        g = torch.tanh(hg + xg)
        o = torch.sigmoid(ho + xo)
        c = f * c + i * g
        h = o * torch.tanh(c)
        return (c, h), h


class RNNDisc(nn.Module):
    """[B, T, input_size] windows -> [B, T, 1] per-step logits."""

    def __init__(self, input_size: int, generator: torch.Generator,
                 hid_dim: int = 100, cell_type: str = "gru",
                 num_layers: int = 2, bidirectional: bool = True,
                 clamp_magnitude: float = 10.0):
        super().__init__()
        cells = {"gru": GRUCell, "lstm": LSTMCell}
        if cell_type not in cells:
            raise ValueError(f"unknown rnn cell {cell_type!r}; known: "
                             f"{sorted(cells)}")
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.clamp_magnitude = clamp_magnitude
        self.embed = nn.Linear(input_size, hid_dim)
        _init_(self.embed, generator, recurrent=False)
        width = hid_dim
        for layer in range(num_layers):
            for d in ("fb" if bidirectional else "f"):
                self.add_module(f"cell_{d}{layer}", cells[cell_type](
                    width, hid_dim, generator))
            width = hid_dim * (2 if bidirectional else 1)
        self.logit = nn.Linear(width, 1)
        _init_(self.logit, generator, recurrent=False)

    def forward(self, traj: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.embed(traj))
        for layer in range(self.num_layers):
            out = getattr(self, f"cell_f{layer}").run(x, reverse=False)
            if self.bidirectional:
                out = torch.cat([out, getattr(self, f"cell_b{layer}").run(
                    x, reverse=True)], dim=-1)
            x = out
        logits = self.logit(x)
        return torch.clamp(logits, -self.clamp_magnitude,
                           self.clamp_magnitude)


class CNNDisc(nn.Module):
    """The image discriminator of this module in the JAX package
    (rnn_discriminators.py:61-81), not AdvIRL's `discriminators.CNNDisc`:
    frames [B, H, W, C] (uint8-range batches divided by 255, as the pixel
    encoder's `normalize_pixels`) -> num_layers 3x3 VALID convs `conv{i}`
    (stride 2, then 1) with ReLU, flattened in (h, w, c) order -> Dense
    `fc` -> ReLU -> `logit`, clamped to +-clamp_magnitude: [B, 1].  flax's
    inits (lecun_normal kernels, zero biases) from the caller's
    generator.  Nothing in the JAX package's runs calls it."""

    def __init__(self, obs_shape, generator: torch.Generator,
                 num_filters: int = 32, num_layers: int = 3,
                 hid_dim: int = 128, clamp_magnitude: float = 10.0):
        super().__init__()
        self.num_layers = num_layers
        self.clamp_magnitude = clamp_magnitude
        h, _, c = obs_shape
        width = c
        for i in range(num_layers):
            conv = nn.Conv2d(width, num_filters, 3)
            lecun_normal_(conv.weight, width * 9, generator)
            with torch.no_grad():
                conv.bias.zero_()
            self.add_module(f"conv{i}", conv)
            width = num_filters
        hw = conv_out_dim(h, num_layers)
        self.fc = nn.Linear(num_filters * hw * hw, hid_dim)
        _init_(self.fc, generator, recurrent=False)
        self.logit = nn.Linear(hid_dim, 1)
        _init_(self.logit, generator, recurrent=False)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        x = normalize_pixels(imgs).permute(0, 3, 1, 2)
        for i in range(self.num_layers):
            conv = getattr(self, f"conv{i}")
            x = torch.relu(F.conv2d(x, conv.weight, conv.bias,
                                    stride=2 if i == 0 else 1))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.logit(torch.relu(self.fc(x)))
        return torch.clamp(x, -self.clamp_magnitude, self.clamp_magnitude)
