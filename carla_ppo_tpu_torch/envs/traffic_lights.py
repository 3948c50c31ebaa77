"""Traffic lights: junction-entry signals with a shared timed cycle (port of
carla_ppo_tpu/envs/traffic_lights.py).

A light is (waypoint index, phase offset) in EnvParams' table on the
track's device; its state is a pure function of episode time
(`step_count * dt`), so there are no light actors and no state to carry.
The scripted agents brake for a red light within PROXIMITY_M ahead (only
red, as the reference's agents drive through yellow); the RL path never
reads the table. `bake_light_props` writes a TRAFFICSIGNS pole into the
track's roadside prop table at each light, which the camera's billboard
composite draws like any other prop.

Every function takes a batch of envs ([B] states) and reads each env's
own track row on a bank (observations.EnvTrack).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs.observations import env_track
from carla_ppo_tpu_torch.envs.types import (
    PROP_STRIDE,
    EnvParams,
    EnvState,
    RoadOption,
    SegClass,
    TrackData,
)

GREEN, YELLOW, RED = 0, 1, 2

# How far before the junction the signal pole stands, and how close the ego
# must be for a red light to gate it (the reference's proximity threshold).
SETBACK_WP = 4
PROXIMITY_M = 10.0


def light_states(params: EnvParams, t_seconds: Tensor) -> Tensor:
    """[..., L] int32 state of each light (GREEN / YELLOW / RED) at episode
    times `t_seconds` [...]: green for `light_green_frac` of the period,
    yellow for `light_yellow_frac`, red for the rest, each light shifted by
    its phase."""
    u = torch.remainder(t_seconds[..., None] + params.light_phase, params.light_period)
    u = u / max(params.light_period, 1e-6)
    green, yellow = params.light_green_frac, params.light_green_frac + params.light_yellow_frac
    state = torch.where(u < yellow, YELLOW, RED)
    return torch.where(u < green, GREEN, state).to(torch.int32)


def is_red_light_ahead(env_state: EnvState, params: EnvParams, proximity: float = PROXIMITY_M) -> Tensor:
    """[B] bool: a RED light stands within `proximity` meters ahead of each
    ego on its route (waypoints are 1 m apart, so the waypoint difference,
    wrapped to the nearest representative on loops, is meters). An empty
    table gives False everywhere."""
    B = env_state.batch_size
    if params.light_wp.numel() == 0:
        return torch.zeros(B, dtype=torch.bool, device=env_state.waypoint_idx.device)
    track = params.track
    et = env_track(track, env_state.route_id)
    ds = (params.light_wp[None, :] - env_state.waypoint_idx[:, None]).to(torch.float32)  # [B, L]
    if track.is_loop:
        length = float(et.length) if et.rows is None else et.length.to(torch.float32)[:, None]
        ds = torch.remainder(ds + length / 2.0, length) - length / 2.0
    t = env_state.step_count.to(torch.float32) * params.dt
    red = light_states(params, t) == RED
    gating = (ds >= 0.0) & (ds < proximity)
    return (red & gating).any(-1)


def place_traffic_lights(
    track: TrackData,
    max_lights: int = 8,
    min_spacing_wp: int = 60,
    period_s: float = 16.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host side: light waypoints at junction entries of one track, and
    their phases. A junction entry is a LANEFOLLOW waypoint followed by a
    turn in the baked maneuver tags; each light stands SETBACK_WP before
    it, at least `min_spacing_wp` from the others, with phases drawn from a
    numpy generator seeded by `seed`. Returns (light_wp [L] int32,
    light_phase [L] float32)."""
    if track.banked:
        raise ValueError("place_traffic_lights places lights on one track, not a bank")
    man = track.maneuver.cpu().numpy()[: int(track.length)]
    following = man == int(RoadOption.LANEFOLLOW)
    turning = np.isin(man, (int(RoadOption.LEFT), int(RoadOption.RIGHT), int(RoadOption.STRAIGHT)))
    entries = np.nonzero(following[:-1] & turning[1:])[0]

    rng = np.random.default_rng(seed ^ 0x716575)
    chosen: list[int] = []
    for e in entries:
        wp = max(int(e) - SETBACK_WP, 0)
        if all(abs(wp - c) >= min_spacing_wp for c in chosen):
            chosen.append(wp)
        if len(chosen) >= max_lights:
            break
    light_wp = np.asarray(chosen, np.int32)
    light_phase = rng.uniform(0.0, period_s, size=light_wp.size).astype(np.float32)
    return light_wp, light_phase


def bake_light_props(track: TrackData, light_wp: np.ndarray) -> TrackData:
    """A copy of `track` with a TRAFFICSIGNS signal pole in the right-hand
    prop slot of each light (4.5 m high, 0.25 m half-width, 0.6 m beyond
    the road's right edge); the seg camera shows lights as TRAFFICSIGNS
    whatever their state, as CARLA's semantic segmentation does."""
    cls = track.prop_class.cpu().numpy().copy()
    lat = track.prop_lateral.cpu().numpy().copy()
    hgt = track.prop_height.cpu().numpy().copy()
    hwd = track.prop_halfwidth.cpu().numpy().copy()
    right_w = track.right_width.cpu().numpy()
    for wp in np.asarray(light_wp):
        slot = min(int(wp) // PROP_STRIDE, track.prop_slots - 1)
        cls[slot, 1] = int(SegClass.TRAFFICSIGNS)
        lat[slot, 1] = -(right_w[int(wp)] + 0.6)
        hgt[slot, 1] = 4.5
        hwd[slot, 1] = 0.25
    dev = track.device
    return dataclasses.replace(
        track,
        prop_class=torch.as_tensor(cls, device=dev),
        prop_lateral=torch.as_tensor(lat, device=dev),
        prop_height=torch.as_tensor(hgt, device=dev),
        prop_halfwidth=torch.as_tensor(hwd, device=dev),
    )


def add_traffic_lights(
    params: EnvParams,
    max_lights: int = 8,
    min_spacing_wp: int = 60,
    period_s: float = 16.0,
    seed: int = 0,
) -> EnvParams:
    """Place junction lights on `params.track`, bake their signal poles and
    fill the light table (on the track's device). A track without junction
    entries returns `params` unchanged (an empty table)."""
    light_wp, light_phase = place_traffic_lights(params.track, max_lights, min_spacing_wp,
                                                 period_s, seed)
    if light_wp.size == 0:
        return params
    dev = params.device
    return dataclasses.replace(
        params,
        track=bake_light_props(params.track, light_wp),
        light_wp=torch.as_tensor(light_wp, device=dev),
        light_phase=torch.as_tensor(light_phase, device=dev),
        light_period=float(period_s),
    )
