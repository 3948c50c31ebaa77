"""Observation builders (port of carla_ppo_tpu/envs/observations.py).

The "vector" family (ground-truth road-relative features) and the
measurements appended to VAE latents. The NPC radar features wait for the
traffic slice.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs import geometry
from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState

PREVIEW_OFFSETS = (2, 4, 8, 16, 32, 64)


def wrap_index(idx: Tensor, length: int, is_loop: bool) -> Tensor:
    """Monotonic waypoint index -> table row: wraps on loops, clamps on
    open routes."""
    if is_loop:
        return torch.remainder(idx, length)
    return torch.clamp(idx, max=length - 1)


def wp_gather(track_arr: Tensor, idx: Tensor, length: int, is_loop: bool) -> Tensor:
    """Gather track rows at (batched) monotonic waypoint indices."""
    return track_arr[wrap_index(idx, length, is_loop).long()]


def vector_obs(state: EnvState, params: EnvParams) -> Tensor:
    """Ground-truth road-relative observation, [B, 18] float32."""
    track = params.track
    veh = state.vehicle
    rp = params.reward
    L, loop = track.length, track.is_loop

    cur = wp_gather(track.pos, state.waypoint_idx, L, loop)
    nxt = wp_gather(track.pos, state.waypoint_idx + 1, L, loop)
    signed_offset = geometry.signed_distance_to_line(cur, nxt, veh.pos)
    feats = [
        signed_offset / rp.max_distance,
        state.angle_to_road / rp.angle_factor_max,
        3.6 * veh.speed / rp.target_speed,
        state.control[:, 0],
        state.control[:, 1],
        veh.steer_angle / params.vehicle.max_steer,
    ]
    fwd = veh.forward
    for k in PREVIEW_OFFSETS:
        wp_pos = wp_gather(track.pos, state.waypoint_idx + k, L, loop)
        wp_fwd = wp_gather(track.fwd, state.waypoint_idx + k, L, loop)
        feats.append(geometry.angle_diff(fwd, wp_pos - veh.pos) / math.pi)
        feats.append(geometry.angle_diff(fwd, wp_fwd) / math.pi)
    return torch.stack(feats, -1).to(torch.float32)


def vector_obs_dim() -> int:
    return 6 + 2 * len(PREVIEW_OFFSETS)


def measurements(state: EnvState) -> Tensor:
    """[B, 3] = [steer, throttle, speed (m/s)] appended to VAE latents."""
    return torch.stack(
        [state.control[:, 0], state.control[:, 1], state.vehicle.speed], -1
    ).to(torch.float32)


ObsFn = Callable[[EnvState, EnvParams], Tensor]

encode_state_fns: Dict[str, ObsFn] = {"vector": vector_obs}
