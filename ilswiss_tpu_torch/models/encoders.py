"""Pixel encoder and decoder for visual RL, SAC-AE / RAD / CURL
(counterpart: ilswiss_tpu/models/encoders.py; `PixelEncoder`,
`PixelDecoder`, `conv_out_dim`).

The reference conv stacks (rlkit/torch/common/encoders.py:36-177):
  - `PixelEncoder`: a 3x3 conv of stride 2, then num_layers - 1 of stride
    1, VALID, ReLU; the features flattened, then fc -> LayerNorm -> tanh
    (or the LayerNorm's output with `output_logits`);
  - `PixelDecoder`: fc -> ReLU, num_layers - 1 transposed 3x3 convs of
    stride 1 with ReLU, one of stride 2 to the image's channels, and the
    stride-2 output's one-pixel shortfall padded by repeating the edge
    (torch's output_padding in the reference, encoders.py:155-157).

Images are NHWC, as in the JAX package, the ring and the env; a conv sees
`x.permute(0, 3, 1, 2)`, which has the channels-last strides, so cuDNN
takes the NHWC tensor without a copy.  Features are flattened in (h, w, c)
order and the decoder's fc output is read as [B, hw, hw, F], the JAX
layouts, so converted fc weights (utils/convert.py) keep their meaning.
A batch whose largest value exceeds 1 is divided by 255, over the whole
batch as the JAX `jnp.where(jnp.max(x) > 1.0, ...)`, without a host read.

`compute_dtype` is the convs' dtype (bf16 by default, as the JAX
`SACAEConfig.conv_dtype`): input, kernel and bias are cast to it and the
conv's output stays in it, as flax's `nn.Conv(dtype=...)`; the parameters,
fc and LayerNorm stay float32.  LayerNorm's epsilon is flax's 1e-6.  The
inits are flax's defaults: lecun_normal kernels (fan_in = in * 3 * 3 for
the convs), zero biases, LayerNorm scale 1 and bias 0, every draw from the
caller's generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# the truncated (+-2 std) unit normal's std (flax's lecun_normal)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def conv_out_dim(in_hw: int, num_layers: int) -> int:
    """Spatial size after the encoder's conv stack (VALID; stride 2, then
    stride 1s)."""
    return (in_hw - 3) // 2 + 1 - 2 * (num_layers - 1)


def normalize_pixels(obs: torch.Tensor) -> torch.Tensor:
    """float32 obs, divided by 255 where the batch's largest value is
    above 1 (uint8-range frames)."""
    x = obs.to(torch.float32)
    return torch.where(torch.amax(x) > 1.0, x / 255.0, x)


def _linear(n_in: int, n_out: int, generator: torch.Generator) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    lecun_normal_(layer.weight, n_in, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


def _conv(cls, n_in: int, n_out: int, generator: torch.Generator):
    layer = cls(n_in, n_out, 3)
    lecun_normal_(layer.weight, n_in * 9, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class PixelEncoder(nn.Module):
    """[B, H, W, C] frames -> [B, feature_dim] features; layers `conv{i}`,
    `fc`, `ln` (the flax names)."""

    def __init__(self, image_size: int, channels: int,
                 generator: torch.Generator, feature_dim: int = 50,
                 num_layers: int = 4, num_filters: int = 32,
                 output_logits: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_layers = num_layers
        self.output_logits = output_logits
        self.compute_dtype = compute_dtype
        width = channels
        for i in range(num_layers):
            self.add_module(f"conv{i}", _conv(nn.Conv2d, width, num_filters,
                                              generator))
            width = num_filters
        hw = conv_out_dim(image_size, num_layers)
        self.fc = _linear(num_filters * hw * hw, feature_dim, generator)
        self.ln = nn.LayerNorm(feature_dim, eps=1e-6)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        x = normalize_pixels(obs).to(cdt).permute(0, 3, 1, 2)
        for i in range(self.num_layers):
            conv = getattr(self, f"conv{i}")
            x = torch.relu(F.conv2d(x, conv.weight.to(cdt),
                                    conv.bias.to(cdt),
                                    stride=2 if i == 0 else 1))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.ln(self.fc(x.to(torch.float32)))
        return x if self.output_logits else torch.tanh(x)


class PixelDecoder(nn.Module):
    """[B, feature_dim] -> [B, out_size, out_size, channels] float32;
    layers `fc`, `deconv{i}`, `deconv_out`.  The transposed convs are
    `conv_transpose2d`, the adjoint of a conv: their weights are flax's
    ConvTranspose kernels (applied unflipped) with both spatial axes
    flipped (utils/convert.py)."""

    def __init__(self, out_hw: int, channels: int, feature_dim: int,
                 generator: torch.Generator, num_layers: int = 4,
                 num_filters: int = 32, out_size: int | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.out_hw = out_hw
        self.num_layers = num_layers
        self.num_filters = num_filters
        self.out_size = out_size
        self.compute_dtype = compute_dtype
        self.fc = _linear(feature_dim, num_filters * out_hw * out_hw,
                          generator)
        for i in range(num_layers - 1):
            self.add_module(f"deconv{i}", _conv(
                nn.ConvTranspose2d, num_filters, num_filters, generator))
        self.deconv_out = _conv(nn.ConvTranspose2d, num_filters, channels,
                                generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        x = torch.relu(self.fc(h))
        x = x.reshape(-1, self.out_hw, self.out_hw, self.num_filters)
        x = x.to(cdt).permute(0, 3, 1, 2)
        for i in range(self.num_layers - 1):
            d = getattr(self, f"deconv{i}")
            x = torch.relu(F.conv_transpose2d(x, d.weight.to(cdt),
                                              d.bias.to(cdt)))
        d = self.deconv_out
        x = F.conv_transpose2d(x, d.weight.to(cdt), d.bias.to(cdt),
                               stride=2).to(torch.float32)
        if self.out_size is not None and x.shape[-1] < self.out_size:
            extra = self.out_size - x.shape[-1]
            x = F.pad(x, (0, extra, 0, extra), mode="replicate")
        return x.permute(0, 2, 3, 1)
