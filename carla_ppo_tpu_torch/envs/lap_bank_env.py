"""Multi-track lap environment (port of carla_ppo_tpu/envs/lap_bank_env.py).

N domain-randomised lap circuits (envs/track.make_lap_track over seeds)
stack into one bank; each env is pinned to a track, `state.route_id`
(round-robin over the batch), and keeps the lap env's respawn-checkpoint
semantics on it: auto-reset re-spawns on the same track. The lap env's
functions take the bank directly (see envs/lap_env.py).
"""

from __future__ import annotations

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs import lap_env
from carla_ppo_tpu_torch.envs import track as track_mod
from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState, TrackData


def make_lap_bank(
    n_tracks: int = 16,
    base_seed: int = 0,
    capacity: int = 2048,
    device="cuda",
    **track_kwargs,
) -> TrackData:
    """Stack N randomised lap circuits (seeds base_seed..) into one bank."""
    arrays = [
        track_mod.lap_track_arrays(seed=base_seed + i, capacity=capacity, **track_kwargs)
        for i in range(n_tracks)
    ]
    return track_mod.bank_from_arrays(arrays, device)


def lap_bank_params(bank: TrackData, **overrides) -> EnvParams:
    """EnvParams whose `track` holds the BANK."""
    if not bank.banked or not bank.is_loop:
        raise ValueError("the lap-bank env needs a bank of lap circuits (make_lap_bank)")
    return EnvParams(track=bank, **overrides)


def reset(
    params: EnvParams,
    generator: torch.Generator,
    is_training: Tensor | bool = True,
    checkpoint_idx: Tensor | int = 0,
    track_id: Tensor | int = 0,
    batch: int | None = None,
) -> EnvState:
    return lap_env.reset(params, generator, is_training, checkpoint_idx, batch=batch,
                         route_id=track_id)


step = lap_env.step
autoreset_step = lap_env.autoreset_step
observe = lap_env.observe


def round_robin(num_envs: int, params: EnvParams) -> Tensor:
    """Track ids 0, 1, .., R-1, 0, .. over a batch of `num_envs`."""
    return torch.arange(num_envs, dtype=torch.int32, device=params.device) % params.track.num_tracks


def init_env_batch(params: EnvParams, num_envs: int, generator: torch.Generator) -> EnvState:
    """Training resets at checkpoint 0, tracks assigned round-robin."""
    return reset(params, generator, track_id=round_robin(num_envs, params))
