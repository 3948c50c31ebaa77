"""Observation builders (port of carla_ppo_tpu/envs/observations.py).

The "vector" family (ground-truth road-relative features) and the
measurements appended to VAE latents. The NPC radar features wait for the
traffic slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs import geometry
from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState, TrackData

PREVIEW_OFFSETS = (2, 4, 8, 16, 32, 64)


def wrap_index(idx: Tensor, length: int | Tensor, is_loop: bool) -> Tensor:
    """Monotonic waypoint index -> table row: wraps on loops, clamps on
    open routes. `length` is a host int or per-env lengths broadcastable
    to `idx`."""
    if is_loop:
        return torch.remainder(idx, length)
    if isinstance(length, Tensor):
        return torch.minimum(idx, length - 1)
    return torch.clamp(idx, max=length - 1)


def wp_gather(track_arr: Tensor, idx: Tensor, length: int, is_loop: bool) -> Tensor:
    """Gather rows of one track at (batched) monotonic waypoint indices."""
    return track_arr[wrap_index(idx, length, is_loop).long()]


@dataclasses.dataclass(frozen=True)
class EnvTrack:
    """What a batch of envs reads of its track: the shared track, or each
    env's row of a bank. A bank is indexed as `arr[row, i]`, so no per-env
    copy of the track is ever made."""

    track: TrackData
    rows: Tensor | None  # [B] int64 bank rows; None on a shared track
    length: int | Tensor  # host int, or [B] int32 per env

    def _per_env(self, x: Tensor, idx: Tensor) -> Tensor:
        return x.reshape(x.shape + (1,) * (idx.ndim - 1))

    def wrap(self, idx: Tensor) -> Tensor:
        """Table rows of the envs' monotonic waypoint indices ([B] or [B, K])."""
        length = self.length if self.rows is None else self._per_env(self.length, idx)
        return wrap_index(idx, length, self.track.is_loop)

    def at(self, arr: Tensor, idx: Tensor) -> Tensor:
        """Rows of `arr` at in-range table rows `idx` ([B]), no wrapping."""
        if self.rows is None:
            return arr[idx.long()]
        return arr[self.rows, idx.long()]

    def gather(self, arr: Tensor, idx: Tensor) -> Tensor:
        """Rows of `arr` (a track array, [N, ...] or [R, N, ...]) at the
        envs' monotonic waypoint indices `idx` ([B] or [B, K])."""
        if self.rows is None:
            return wp_gather(arr, idx, self.length, self.track.is_loop)
        return arr[self._per_env(self.rows, idx), self.wrap(idx).long()]


def env_track(track: TrackData, route_id: Tensor) -> EnvTrack:
    if not track.banked:
        return EnvTrack(track, None, track.length)
    rows = route_id.long()
    return EnvTrack(track, rows, track.length[rows])


def vector_obs(state: EnvState, params: EnvParams) -> Tensor:
    """Ground-truth road-relative observation, [B, 18] float32."""
    track = params.track
    et = env_track(track, state.route_id)
    veh = state.vehicle
    rp = params.reward

    cur = et.gather(track.pos, state.waypoint_idx)
    nxt = et.gather(track.pos, state.waypoint_idx + 1)
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
        wp_pos = et.gather(track.pos, state.waypoint_idx + k)
        wp_fwd = et.gather(track.fwd, state.waypoint_idx + k)
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
