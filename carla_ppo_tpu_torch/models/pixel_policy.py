"""Pixel-input actor-critic with a jointly trained VAE (port of
carla_ppo_tpu/models/pixel_policy.py).

The camera frame feeds the World-Models conv encoder (models/vae.py
ConvEncoder: 32/64/128/256, k4 s2 VALID) and the latent heads `mean_head` /
`logstd_head`; the policy and value trunks (models/policy.ActorCritic,
500/300 each) read z_mean ++ measurements, the observation a frozen-VAE
agent reads. With `with_decoder` (the default, config 4) the VAE decoder
reconstructs the frame from a sampled z for the auxiliary loss of the
update; `policy_value` and `act`, the rollout path, never run it.

A pass that records gradients keeps only the encoder's and the decoder's
inputs and outputs and recomputes their activations in the backward pass
(torch.utils.checkpoint): an update minibatch of 256 envs x 128 steps
(32,768 frames) would otherwise keep ~45 GB of activations, and on an
80 GB H100 its backward ran out of memory. The recomputation repeats the
same operations on the same inputs, so the gradients are the same; it
costs one more forward of both per update.

Frames come in NHWC ([B, H, W, C] floats in [0, 1]) as in the JAX package;
the convolutions run NCHW inside, and the converter (utils/convert.py
pixel_actor_critic_state_dict) permutes the z heads' rows to the NCHW
flatten. The model computes in float32 whatever the Trainer's policy_dtype
says, as the JAX Trainer builds it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor, nn
from torch.utils.checkpoint import checkpoint

from carla_ppo_tpu_torch.models.policy import ActorCritic
from carla_ppo_tpu_torch.models.vae import ConvDecoder, ConvEncoder, _dense, encoded_conv_shape
from carla_ppo_tpu_torch.utils import profiling


class PixelActorCritic(nn.Module):
    def __init__(
        self,
        frame_shape: Tuple[int, int, int] = (80, 160, 1),
        num_measurements: int = 3,
        z_dim: int = 64,
        num_actions: int = 2,
        action_low: Tuple[float, ...] = (-1.0, 0.0),
        action_high: Tuple[float, ...] = (1.0, 1.0),
        pi_hidden_sizes: Tuple[int, ...] = (500, 300),
        vf_hidden_sizes: Tuple[int, ...] = (500, 300),
        initial_std: float = 1.0,
        initial_mean_factor: float = 0.1,
        with_decoder: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.frame_shape = tuple(frame_shape)
        self.z_dim = z_dim
        enc = encoded_conv_shape(self.frame_shape)
        self.encoder = ConvEncoder(frame_shape[-1], generator=generator)
        self.mean_head = _dense(math.prod(enc), z_dim, generator)
        self.logstd_head = _dense(math.prod(enc), z_dim, generator)
        self.decoder = ConvDecoder(z_dim, enc, frame_shape[-1], generator) if with_decoder else None
        self.policy = ActorCritic(
            z_dim + num_measurements, num_actions, action_low, action_high, pi_hidden_sizes,
            vf_hidden_sizes, initial_std, initial_mean_factor, generator=generator,
        )

    @staticmethod
    def _run(module: nn.Module, x: Tensor) -> Tensor:
        if torch.is_grad_enabled():
            return checkpoint(module, x, use_reentrant=False)
        return module(x)

    def encode(self, frames: Tensor) -> Tuple[Tensor, Tensor]:
        h = self._run(self.encoder, frames)
        return self.mean_head(h), self.logstd_head(h)

    def policy_value(self, frames: Tensor, measurements: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """(action_mean, action_std, value): the rollout path, no decoder."""
        z_mean, _ = self.encode(frames)
        return self.policy(torch.cat([z_mean, measurements], -1))

    def forward(
        self, frames: Tensor, measurements: Tensor,
        noise: Tensor | torch.Generator | None = None,
    ) -> Tuple[Tensor, Tensor, Tensor, Dict[str, Optional[Tensor]]]:
        """(action_mean, action_std, value, aux), aux holding z_mean,
        z_logstd_sq and recon_logits [B, H*W*C] (None without a decoder).
        The decoder reads z = z_mean + exp(z_logstd_sq / 2) * noise, the
        noise a [B, z_dim] standard-normal tensor or drawn from the given
        generator; z_mean without noise."""
        z_mean, z_logstd_sq = self.encode(frames)
        mean, std, value = self.policy(torch.cat([z_mean, measurements], -1))
        recon = None
        if self.decoder is not None:
            z = z_mean
            if noise is not None:
                if isinstance(noise, torch.Generator):
                    noise = torch.randn(z_mean.shape, generator=noise, device=z_mean.device)
                z = z_mean + torch.exp(0.5 * z_logstd_sq) * noise
            # NCHW logits flattened in flax's NHWC order (with one channel,
            # a view: the two orders agree)
            x = self._run(self.decoder, z).permute(0, 2, 3, 1)
            recon = x.reshape(x.shape[0], -1)
        return mean, std, value, {"z_mean": z_mean, "z_logstd_sq": z_logstd_sq,
                                  "recon_logits": recon}

    def act(
        self, frames: Tensor, measurements: Tensor, generator: torch.Generator | None = None,
        greedy: bool = False, noise: Tensor | None = None,
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """(clipped action, its log-prob, value); no decoder work. `noise`
        replaces the generator's [B, A] draw."""
        with profiling.span("policy.sample"):
            return self.policy.sample_from(self.policy_value(frames, measurements), generator, greedy, noise)
