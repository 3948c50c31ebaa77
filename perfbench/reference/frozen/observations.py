# Frozen copy of carla_ppo_tpu_torch/envs/observations.py (commit cbdb1fb), the benchmark's
# reference: imports made local.
# It imports nothing of the program and is not edited when the program changes.
"""Observation builders (port of carla_ppo_tpu/envs/observations.py).

The "vector" family (ground-truth road-relative features, and with
"vector_npc" the radar-style NPC features), and the measurements appended
to VAE latents.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch
from torch import Tensor

from . import geometry
from .types import EnvParams, EnvState, TrackData

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


# Radar range for the NPC-traffic features (meters of along-track gap).
NPC_RADAR_RANGE = 50.0


def npc_gaps(state: EnvState, params: EnvParams) -> tuple[Tensor, Tensor, Tensor]:
    """Frenet gaps ego -> each NPC slot: (ds [B, M], dlat [B, M], active
    [M]). `ds` is along-track in waypoint units (positive = NPC ahead),
    wrapped to the nearest representative on loops, the same math as the
    collision test in lap_env.step; `dlat` is the NPC's lateral offset
    relative to the ego. Shared by the radar observation and the traffic
    reward."""
    track = params.track
    et = env_track(track, state.route_id)
    cur = et.gather(track.pos, state.waypoint_idx)
    nxt = et.gather(track.pos, state.waypoint_idx + 1)
    ego_lat = geometry.signed_distance_to_line(cur, nxt, state.vehicle.pos)
    length_f = float(et.length) if et.rows is None else et.length.to(torch.float32)[:, None]
    ego_s = state.waypoint_idx.to(torch.float32)
    active = torch.arange(state.npc_s.shape[1], device=state.npc_s.device) < params.num_npcs
    ds = state.npc_s - ego_s[:, None]
    if track.is_loop:
        ds = torch.remainder(ds + length_f / 2.0, length_f) - length_f / 2.0
    return ds, state.npc_lateral - ego_lat[:, None], active


def vector_npc_obs(state: EnvState, params: EnvParams) -> Tensor:
    """`vector_obs` ++ radar-style traffic features, [B, 18 + 6] float32:
    for the nearest live NPC ahead, then the nearest behind, its gap /
    NPC_RADAR_RANGE (1.0 when none is in range), its lateral offset /
    max_distance and its closing speed (ego - NPC) / target_speed (both 0
    when none is in range)."""
    base = vector_obs(state, params)
    rp = params.reward
    ds, dlat, active = npc_gaps(state, params)
    speed = state.vehicle.speed

    def radar(gap: Tensor) -> list:
        masked = torch.where(active & (gap >= 0.0), gap, torch.full_like(gap, math.inf))
        nearest, idx = masked.min(1)  # the first minimum, as jnp.argmin
        in_range = nearest < NPC_RADAR_RANGE
        rel_lat = dlat.gather(1, idx[:, None])[:, 0] / rp.max_distance
        npc_speed = state.npc_speed.gather(1, idx[:, None])[:, 0]
        closing = 3.6 * (speed - npc_speed) / rp.target_speed
        return [
            torch.where(in_range, nearest / NPC_RADAR_RANGE, torch.ones_like(nearest)),
            torch.where(in_range, rel_lat, torch.zeros_like(rel_lat)),
            torch.where(in_range, closing, torch.zeros_like(closing)),
        ]

    feats = radar(ds) + radar(-ds)
    return torch.cat([base, torch.stack(feats, -1).to(torch.float32)], 1)


def vector_npc_obs_dim() -> int:
    return vector_obs_dim() + 6


def obs_dim_for(obs_fn: str) -> int:
    return {"vector": vector_obs_dim(), "vector_npc": vector_npc_obs_dim()}[obs_fn]


def measurements(state: EnvState) -> Tensor:
    """[B, 3] = [steer, throttle, speed (m/s)] appended to VAE latents."""
    return torch.stack(
        [state.control[:, 0], state.control[:, 1], state.vehicle.speed], -1
    ).to(torch.float32)


ObsFn = Callable[[EnvState, EnvParams], Tensor]

encode_state_fns: Dict[str, ObsFn] = {"vector": vector_obs, "vector_npc": vector_npc_obs}
