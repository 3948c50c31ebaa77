"""VAE <-> RL glue (port of carla_ppo_tpu/models/vae_common.py).

Model directories encode their configuration in the NAME (`zdim64`, `mlp`,
the `seg_` target and `from_seg_` source prefixes): `parse_model_dir` reads
it and `load_vae` builds the encoder and restores the newest checkpoint of
the directory's `checkpoints/`, in this port's format (the shipped VAEs are
converted by scripts/export_torch_checkpoints.py into models/torch/).

`create_encode_batch_fn` builds the latent observation the PPO agent
consumes, z_mean(64) ++ [steer, throttle, speed], for a whole env batch:
render the camera (ops/rasterizer, CUDA kernels on the card), encode with
the frozen VAE. `source="seg"` feeds the seg frame scaled by 1/12;
`source="rgb"` the shaded pseudo-RGB frame (the reference's deployed
observation path). Both on a shared track and (`banked=True`, the route
and lap-bank envs) on a track bank. `create_encode_state_fn` is the same
observation for one env (a batch of one, as the interactive envs hold it):
[z + m], from the shared track or the env's bank row.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Optional, Tuple

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState
from carla_ppo_tpu_torch.models.vae import VAE
from carla_ppo_tpu_torch.ops import rasterizer
from carla_ppo_tpu_torch.utils.checkpoint import Checkpointer
from carla_ppo_tpu_torch.utils.device import resolve_device


def model_dir_name(
    source: str, loss_type: str, model_type: str, z_dim: int, beta: float,
    kl_tolerance: float, source_depth: int = 3,
) -> str:
    """The directory naming scheme, e.g.
    seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_data; a 1-channel source adds
    the "from_seg_" prefix, an RGB target is "rgb_"."""
    prefix = "seg_" if source == "seg" else "rgb_"
    if source_depth == 1:
        prefix = "from_seg_" + prefix
    beta_s = int(beta) if float(beta).is_integer() else beta
    return f"{prefix}{loss_type}_{model_type}_zdim{z_dim}_beta{beta_s}_kl_tolerance{kl_tolerance}_data"


def parse_model_dir(model_dir: str) -> Tuple[int, str, int, int]:
    """(z_dim, model_type, target_depth, source_depth) from a model
    directory's name."""
    name = os.path.basename(os.path.normpath(model_dir))
    z = re.findall(r"zdim(\d+)", name)
    z_dim = int(z[0]) if z else 64
    model_type = "mlp" if "mlp" in name else "cnn"
    # The source prefix goes first, so "from_seg_bce_..." (a seg source with
    # an RGB target) parses as target depth 3.
    source_depth = 1 if name.startswith("from_seg_") else 3
    rest = name[len("from_seg_"):] if source_depth == 1 else name
    target_depth = 1 if rest.startswith("seg_") else 3
    return z_dim, model_type, target_depth, source_depth


def build_vae(
    z_dim: int, model_type: str, target_depth: int,
    source_shape: Tuple[int, int, int] = (80, 160, 3),
    dtype: torch.dtype = torch.float32,
) -> VAE:
    """The whole VAE (ConvVAE for "cnn", MlpVAE for "mlp"), its decoder
    emitting `target_depth` channels at the source's height and width."""
    return VAE(source_shape=source_shape, z_dim=z_dim, compute_dtype=dtype,
               target_shape=(source_shape[0], source_shape[1], target_depth),
               model_type=model_type)


def load_vae(
    model_dir: str,
    z_dim: Optional[int] = None,
    model_type: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> VAE:
    """Build the VAE named by `model_dir` and restore its newest
    checkpoint, in eval mode on `device`; raises FileNotFoundError when
    nothing restores (never runs on seeded weights). `dtype` is the
    compute dtype only: the weights are float32 either way."""
    dev = resolve_device(device)
    p_z, p_type, p_depth, p_src = parse_model_dir(model_dir)
    model = build_vae(z_dim or p_z, model_type or p_type, p_depth,
                      source_shape=(80, 160, p_src), dtype=dtype).to(dev)
    ckpt_dir = os.path.join(model_dir, "checkpoints")
    tree = None
    if os.path.isdir(ckpt_dir):
        tree = Checkpointer(ckpt_dir).restore_latest({"model": model.state_dict()})
    if tree is None:
        raise FileNotFoundError(f"Failed to load VAE from {model_dir}")
    model.load_state_dict(tree["model"])
    return model.eval()


def preprocess_frame(frame: Tensor) -> Tensor:
    """uint8 -> [0, 1] floats; float frames pass through as float32."""
    if not torch.is_floating_point(frame):
        return frame.to(torch.float32) / 255.0
    return frame.to(torch.float32)


def create_encode_batch_fn(
    model: VAE,
    measurements_to_include=("steer", "throttle", "speed"),
    cam: rasterizer.CameraConfig = rasterizer.CameraConfig(),
    banked: bool = False,
    source: str = "seg",
) -> Callable[[EnvState, EnvParams], Tensor]:
    """Batch latent observations: a function (states, params) -> [B, z + m].
    `banked=True` for batches whose params.track is a bank indexed by
    states.route_id. `source` is "seg" or "rgb"."""
    if source not in ("seg", "rgb"):
        raise ValueError(f"unknown VAE source {source!r}")
    flags = tuple(m in measurements_to_include for m in ("steer", "throttle", "speed"))
    src_depth = model.source_shape[-1]
    render = rasterizer.render_batch_banked if banked else rasterizer.render_batch

    @torch.no_grad()
    def encode_batch(states: EnvState, params: EnvParams) -> Tensor:
        if source == "rgb":
            frames = rasterizer.render_rgb_batch(states, params, cam)  # [B, H, W, 3]
        else:
            frames = rasterizer.seg_to_obs(render(states, params, cam))
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


def create_encode_state_fn(
    model: VAE,
    measurements_to_include=("steer", "throttle", "speed"),
    cam: rasterizer.CameraConfig = rasterizer.CameraConfig(),
    source: str = "seg",
) -> Callable[[EnvState, EnvParams], Tensor]:
    """Latent observation of a single env: a function (state, params) ->
    [z + m] over a batch-of-one state, create_encode_batch_fn's row 0 (on
    a bank the env's own row, where the JAX package slices the route out
    of the bank first)."""
    batch_fns = {
        banked: create_encode_batch_fn(model, measurements_to_include, cam, banked, source)
        for banked in (False, True)
    }

    def encode_state(state: EnvState, params: EnvParams) -> Tensor:
        if state.batch_size != 1:
            raise ValueError(f"expected a batch of one env, got {state.batch_size}")
        return batch_fns[params.track.banked](state, params)[0]

    return encode_state
