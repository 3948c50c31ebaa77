"""VAE <-> RL glue (port of carla_ppo_tpu/models/vae_common.py).

`create_encode_batch_fn` builds the latent observation the PPO agent
consumes, z_mean(64) ++ [steer, throttle, speed], for a whole env batch:
render the seg camera (ops/rasterizer, CUDA kernels on the card), scale
classes by 1/12, encode with the frozen VAE. Only the seg source on a shared
track is ported (rgb frames and banked tracks wait).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState
from carla_ppo_tpu_torch.models.vae import VAE
from carla_ppo_tpu_torch.ops import rasterizer


def preprocess_frame(frame: Tensor) -> Tensor:
    """uint8 -> [0, 1] floats; float frames pass through as float32."""
    if not torch.is_floating_point(frame):
        return frame.to(torch.float32) / 255.0
    return frame.to(torch.float32)


def create_encode_batch_fn(
    model: VAE,
    measurements_to_include=("steer", "throttle", "speed"),
    cam: rasterizer.CameraConfig = rasterizer.CameraConfig(),
    source: str = "seg",
) -> Callable[[EnvState, EnvParams], Tensor]:
    """Batch latent-observation builder: (states, params) -> [B, z + m]."""
    if source != "seg":
        raise NotImplementedError(f"VAE source {source!r} is not ported (only 'seg')")
    flags = tuple(m in measurements_to_include for m in ("steer", "throttle", "speed"))
    src_depth = model.source_shape[-1]

    @torch.no_grad()
    def encode_batch(states: EnvState, params: EnvParams) -> Tensor:
        frames = rasterizer.seg_to_obs(rasterizer.render_batch(states, params, cam))
        if src_depth != 1:
            frames = frames.expand(*frames.shape[:-1], src_depth)
        feats = [model.encode(frames)]
        if flags[0]:
            feats.append(states.control[:, 0:1])
        if flags[1]:
            feats.append(states.control[:, 1:2])
        if flags[2]:
            feats.append(states.vehicle.speed[:, None])
        return torch.cat(feats, 1).to(torch.float32)

    return encode_batch
