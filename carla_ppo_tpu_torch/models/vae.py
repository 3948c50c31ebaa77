"""beta-VAE in PyTorch (port of carla_ppo_tpu/models/vae.py).

`model_type="cnn"`: the World-Models ConvVAE the reference uses. Encoder
4 x (conv k4 s2 VALID, relu) with 32/64/128/256 channels, the latent heads
`mean` and `logstd_square`, decoder dense -> NHWC reshape -> transposed
convs (128 k4, 64 k4, 32 k5, C k4, stride 2, VALID; relu but on the last):
3x8 -> 8x18 -> 18x38 -> 39x79 -> 80x160. `model_type="mlp"`: flatten ->
MLP(512, 256) encoder, MLP(256, 512) decoder. The public functions take
frames in the JAX package's NHWC layout ([B, H, W, C] floats in [0, 1])
and give logits flattened in NHWC order, as flax emits them; inside, the
convolutions run NCHW (on the card, an encode that records no gradient
runs the NHWC kernels of ops/vae_cuda.py instead), the conv encoder
flattens NCHW (utils/convert.py permutes the JAX heads' rows to match) and
the decoder's dense output is read in NHWC order, as in flax.

A VAE built without `target_shape` is the encoder alone (the frozen
encoder of the latent observation); with it, the whole model that VAE
training and `load_vae` use. Losses (`vae_loss`) keep the reference's
reduction order: recon = mean over the batch of the sum over pixels, KL per
sample floored at kl_tolerance * z_dim, loss = recon + beta * mean KL.

`compute_dtype` mirrors the JAX module's `dtype`: parameters stay float32;
with bfloat16 each conv casts its input, kernel and bias to bfloat16 and
rounds the convolution and the bias add to it (flax `Conv(dtype=)`), and
the latent heads run in float32 on the encoder's output cast back.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import Tensor, nn
from torch.nn import functional as F

from carla_ppo_tpu_torch.ops import vae_cuda
from carla_ppo_tpu_torch.utils import profiling

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


def kl_divergence(mean: Tensor, logstd_sq: Tensor) -> Tensor:
    """Per-sample KL(q(z|x) || N(0, I))."""
    return -0.5 * torch.sum(1.0 + logstd_sq - mean**2 - torch.exp(logstd_sq), dim=-1)


def bce_loss(labels: Tensor, logits: Tensor) -> Tensor:
    """Sigmoid cross-entropy with logits."""
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def bce_loss_v2(labels: Tensor, logits: Tensor, epsilon: float = 1e-10) -> Tensor:
    """Probability-space BCE."""
    targets = torch.sigmoid(logits)
    return -(labels * torch.log(epsilon + targets) + (1.0 - labels) * torch.log(epsilon + 1.0 - targets))


def mse_loss(labels: Tensor, logits: Tensor) -> Tensor:
    """MSE against the sigmoid output."""
    return (labels - torch.sigmoid(logits)) ** 2


LOSS_FNS = {"bce": bce_loss, "bce_v2": bce_loss_v2, "mse": mse_loss}


def vae_loss(
    logits: Tensor, targets: Tensor, mean: Tensor, logstd_sq: Tensor, beta: float,
    kl_tolerance: float, z_dim: int, loss_fn: str = "bce",
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """(loss, {"reconstruction_loss", "kl_loss", "loss"}), the reference's
    reduction order."""
    flat_targets = targets.reshape(targets.shape[0], -1)
    recon = torch.mean(torch.sum(LOSS_FNS[loss_fn](flat_targets, logits), dim=1))
    kl = kl_divergence(mean, logstd_sq)
    if kl_tolerance > 0:
        kl = torch.clamp(kl, min=kl_tolerance * z_dim)
    kl = torch.mean(kl)
    loss = recon + beta * kl
    return loss, {"reconstruction_loss": recon, "kl_loss": kl, "loss": loss}


def _dense(n_in: int, n_out: int, generator: torch.Generator | None) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    lecun_normal_(layer.weight, n_in, generator)
    nn.init.zeros_(layer.bias)
    return layer


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
        """[B, C_out * h * w], flattened in NCHW order. On the card, a call
        that records no gradient (float32, 80x160 frames, these widths) runs
        the hand-written kernels of ops/vae_cuda.py; every other call runs
        the convolutions below."""
        if x_nhwc.is_cuda:
            kernel = vae_cuda.takes_kernel(x_nhwc, self.convs, dtype)
            vae_cuda.CALLS["kernel" if kernel else "module"] += 1
            if kernel:
                x = x_nhwc.contiguous()
                if x.data_ptr() % 16:  # a view off a 16-byte boundary; fresh memory is aligned
                    x = x.clone()
                return vae_cuda.encoder_cuda(x, self.convs)
        if dtype == torch.float32:
            return vae_cuda.encoder_plain(x_nhwc, self.convs)
        x = x_nhwc.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, stride=2)
            x = x + conv.bias.to(dtype)[:, None, None]
            x = torch.relu(x)
        return x.flatten(1)  # NCHW flatten


class ConvDecoder(nn.Module):
    """dense -> [B, h, w, c] (NHWC, as flax reshapes) -> transposed convs;
    returns NCHW logits."""

    LAYERS = ((128, 4), (64, 4), (32, 5))

    def __init__(self, z_dim: int, encoded_shape: Tuple[int, int, int], out_channels: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoded_shape = tuple(encoded_shape)
        self.dense = _dense(z_dim, int(math.prod(encoded_shape)), generator)
        deconvs, c = [], encoded_shape[-1]
        for f, k in self.LAYERS + ((out_channels, 4),):
            deconv = nn.ConvTranspose2d(c, f, kernel_size=k, stride=2, padding=0)
            # flax ConvTranspose's kernel (k, k, in, out): fan_in = k * k * in
            lecun_normal_(deconv.weight, k * k * c, generator)
            nn.init.zeros_(deconv.bias)
            deconvs.append(deconv)
            c = f
        self.deconvs = nn.ModuleList(deconvs)

    def forward(self, z: Tensor) -> Tensor:
        h, w, c = self.encoded_shape
        x = self.dense(z).view(-1, h, w, c).permute(0, 3, 1, 2)
        for i, deconv in enumerate(self.deconvs):
            x = deconv(x)
            if i < len(self.deconvs) - 1:
                x = torch.relu(x)
        return x


class MlpEncoder(nn.Module):
    SIZES = (512, 256)

    def __init__(self, in_dim: int, generator: torch.Generator | None = None):
        super().__init__()
        dims = (in_dim,) + self.SIZES
        self.dense = nn.ModuleList(_dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x_nhwc: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
        x = x_nhwc.reshape(x_nhwc.shape[0], -1)  # NHWC flatten, as flax
        for layer in self.dense:
            x = torch.relu(layer(x))
        return x


class MlpDecoder(nn.Module):
    SIZES = (256, 512)

    def __init__(self, z_dim: int, out_dim: int, generator: torch.Generator | None = None):
        super().__init__()
        dims = (z_dim,) + self.SIZES
        self.dense = nn.ModuleList(_dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:]))
        self.dense_out = _dense(dims[-1], out_dim, generator)

    def forward(self, z: Tensor) -> Tensor:
        x = z
        for layer in self.dense:
            x = torch.relu(layer(x))
        return self.dense_out(x)


class VAE(nn.Module):
    """encoder -> (mean, logstd_sq) -> sample -> decoder -> logits.
    `source_shape` / `target_shape` are (H, W, C); without `target_shape`
    the model is the encoder alone."""

    def __init__(self, source_shape: Tuple[int, int, int] = (80, 160, 3),
                 target_shape: Optional[Tuple[int, int, int]] = None,
                 z_dim: int = 64, model_type: str = "cnn",
                 compute_dtype: torch.dtype = torch.float32,
                 features: Sequence[int] = (32, 64, 128, 256),
                 generator: torch.Generator | None = None):
        super().__init__()
        if model_type not in ("cnn", "mlp"):
            raise ValueError(f"unknown VAE model_type {model_type!r}")
        self.compute_dtype = compute_dtype
        self.source_shape = tuple(source_shape)
        self.target_shape = None if target_shape is None else tuple(target_shape)
        self.model_type = model_type
        self.z_dim = z_dim
        if model_type == "cnn":
            self.encoder = ConvEncoder(source_shape[-1], features, generator)
            enc = encoded_conv_shape(self.source_shape, len(features), features[-1])
            enc_dim = enc[0] * enc[1] * enc[2]
        else:
            self.encoder = MlpEncoder(int(math.prod(source_shape)), generator)
            enc_dim = MlpEncoder.SIZES[-1]
        self.mean_head = _dense(enc_dim, z_dim, generator)
        self.logstd_head = _dense(enc_dim, z_dim, generator)
        self.decoder = None
        if self.target_shape is not None:
            if model_type == "cnn":
                self.decoder = ConvDecoder(z_dim, enc, self.target_shape[-1], generator)
            else:
                self.decoder = MlpDecoder(z_dim, int(math.prod(self.target_shape)), generator)

    @property
    def out_shape(self) -> Tuple[int, int, int]:
        return self.target_shape or self.source_shape

    def encode_params(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        h = self.encoder(x, self.compute_dtype).to(torch.float32)
        return self.mean_head(h), self.logstd_head(h)

    def encode(self, x: Tensor) -> Tensor:
        """Latent mean, what the RL observation uses (the logstd head is
        not computed)."""
        with profiling.span("vae.encode"):
            return self.mean_head(self.encoder(x, self.compute_dtype).to(torch.float32))

    def decode(self, z: Tensor) -> Tensor:
        """Logits [B, prod(target_shape)], flattened in NHWC order."""
        if self.decoder is None:
            raise ValueError("this VAE was built without a decoder (no target_shape)")
        x = self.decoder(z)
        if self.model_type == "cnn":
            x = x.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)

    def forward(self, x: Tensor, noise: Tensor | torch.Generator | None = None,
                training: bool = True) -> Tuple[Tensor, Tensor, Tensor]:
        """(logits [B, prod(target)], mean, logstd_sq). Training samples
        z = mean + exp(logstd_sq / 2) * eps, eps the given [B, z_dim]
        standard-normal draw or drawn from the given generator; otherwise
        z = mean."""
        mean, logstd_sq = self.encode_params(x)
        if training:
            if noise is None:
                raise ValueError("training=True requires noise (a tensor or a generator)")
            if isinstance(noise, torch.Generator):
                noise = torch.randn(mean.shape, generator=noise, device=mean.device)
            z = mean + torch.exp(0.5 * logstd_sq) * noise
        else:
            z = mean
        return self.decode(z), mean, logstd_sq

    def reconstruct(self, x: Tensor) -> Tensor:
        """Deterministic reconstruction in [0, 1], [B, *target_shape]."""
        logits, _, _ = self(x, training=False)
        return torch.sigmoid(logits).reshape(-1, *self.out_shape)

    def generate_from_latent(self, z: Tensor) -> Tensor:
        return torch.sigmoid(self.decode(z)).reshape(-1, *self.out_shape)
