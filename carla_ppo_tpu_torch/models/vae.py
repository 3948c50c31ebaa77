"""ConvVAE encoder in PyTorch (port of carla_ppo_tpu/models/vae.py).

The World-Models encoder the reference uses: 4 x (conv k4 s2 VALID, relu)
with 32/64/128/256 channels, then the latent heads `mean` and
`logstd_square`. The public functions take frames in the JAX package's NHWC
layout ([B, H, W, C] floats in [0, 1]); inside, the convolutions run NCHW
and the encoder flattens NCHW (utils/convert.py permutes the JAX heads'
rows to match). Only the encode path is ported: the decoder, the losses and
VAE training wait for a later slice.

`compute_dtype` mirrors the JAX module's `dtype`: parameters stay float32;
with bfloat16 each conv casts its input, kernel and bias to bfloat16 and
rounds the convolution and the bias add to it (flax `Conv(dtype=)`), and
the latent heads run in float32 on the encoder's output cast back.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import Tensor, nn
from torch.nn import functional as F

# Truncated standard normal on [-2, 2] has this std; flax's variance_scaling
# divides by it so the truncated draw has the requested variance.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: Tensor, fan_in: int, generator: torch.Generator | None,
                  scale: float = 1.0) -> Tensor:
    """flax variance_scaling(scale, "fan_in", "truncated_normal"), the
    default kernel init of flax Dense / Conv."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def encoded_conv_shape(source_shape: Tuple[int, int, int], n_convs: int = 4,
                       channels: int = 256) -> Tuple[int, int, int]:
    h, w, _ = source_shape
    for _ in range(n_convs):
        h = (h - 4) // 2 + 1
        w = (w - 4) // 2 + 1
    return (h, w, channels)


class ConvEncoder(nn.Module):
    def __init__(self, in_channels: int, features: Sequence[int] = (32, 64, 128, 256),
                 generator: torch.Generator | None = None):
        super().__init__()
        convs, c = [], in_channels
        for f in features:
            conv = nn.Conv2d(c, f, kernel_size=4, stride=2, padding=0)
            lecun_normal_(conv.weight, c * 16, generator)
            nn.init.zeros_(conv.bias)
            convs.append(conv)
            c = f
        self.convs = nn.ModuleList(convs)

    def forward(self, x_nhwc: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        for conv in self.convs:
            if dtype == torch.float32:
                x = conv(x)
            else:
                x = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, stride=2)
                x = x + conv.bias.to(dtype)[:, None, None]
            x = torch.relu(x)
        return x.flatten(1)  # NCHW flatten


class VAE(nn.Module):
    """ConvVAE encode path: frames [B, H, W, C] -> latent mean [B, z_dim]."""

    def __init__(self, source_shape: Tuple[int, int, int] = (80, 160, 3), z_dim: int = 64,
                 features: Sequence[int] = (32, 64, 128, 256),
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.source_shape = tuple(source_shape)
        self.z_dim = z_dim
        self.encoder = ConvEncoder(source_shape[-1], features, generator)
        enc = encoded_conv_shape(self.source_shape, len(features), features[-1])
        enc_dim = enc[0] * enc[1] * enc[2]
        self.mean_head = nn.Linear(enc_dim, z_dim)
        self.logstd_head = nn.Linear(enc_dim, z_dim)
        for head in (self.mean_head, self.logstd_head):
            lecun_normal_(head.weight, enc_dim, generator)
            nn.init.zeros_(head.bias)

    def encode_params(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        h = self.encoder(x, self.compute_dtype).to(torch.float32)
        return self.mean_head(h), self.logstd_head(h)

    def encode(self, x: Tensor) -> Tensor:
        """Latent mean, what the RL observation uses."""
        return self.encode_params(x)[0]
