"""Random-route navigation environment (port of carla_ppo_tpu/envs/route_env.py).

The lap env on a bank of open routes (envs/route_planner.make_route_bank),
each env on its own row `state.route_id`, with the reference route env's
differences:

- every reset draws a random route; finishing a route chains straight into
  a new one inside `step`, with a fresh 5 s low-speed grace period;
- terminal when distance_traveled reaches 3000 m; no lap terminal;
- `routes_completed` = routes finished + (waypoint + 1) / route length -
  route_frac_offset is the headline metric, carried in the
  `laps_completed` slot.

The random draws (route ids, the junction curriculum's uniforms) are made
by `reset` / `step` from the caller's torch.Generator and handed to the
deterministic transitions `reset_on_routes` / `step_with_routes`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs import lap_env
from carla_ppo_tpu_torch.envs.lap_env import StepOutput
from carla_ppo_tpu_torch.envs.types import (
    EnvParams,
    EnvState,
    RoadOption,
    TrackData,
    VehicleState,
    default_env_state,
)
from carla_ppo_tpu_torch.utils import profiling


def route_env_params(bank: TrackData, max_distance: float = 3000.0, **overrides) -> EnvParams:
    """EnvParams for the route env; `track` holds the BANK."""
    if not bank.banked or bank.is_loop:
        raise ValueError("the route env needs a bank of open routes (make_route_bank)")
    defaults = dict(max_distance_traveled=max_distance, max_laps=math.inf)
    defaults.update(overrides)
    return EnvParams(track=bank, **defaults)


def draw_routes(bank: TrackData, batch: int, generator: torch.Generator) -> Tensor:
    return torch.randint(0, bank.num_tracks, (batch,), generator=generator,
                         device=bank.device, dtype=torch.int32)


def _spawn_on_route(state: EnvState, bank: TrackData, route_id: Tensor, start_idx: Tensor) -> EnvState:
    rows, idx = route_id.long(), start_idx.long()
    pos = bank.pos[rows, idx]
    fwd = bank.fwd[rows, idx]
    return dataclasses.replace(
        state,
        vehicle=VehicleState.create(pos, torch.atan2(fwd[:, 1], fwd[:, 0])),
        control=torch.zeros_like(state.control),
        waypoint_idx=start_idx,
        start_waypoint_idx=start_idx.clone(),
        route_id=route_id,
        prev_pos=pos.clone(),
    )


def junction_spawn_idx(bank: TrackData, route_id: Tensor, backoff: int, u: Tensor) -> Tensor:
    """Per env, a waypoint `backoff` before a junction waypoint of its route,
    picked uniformly among them by the largest of `u` ([B, capacity]
    uniforms drawn by the caller); 0 when the route has no junction.
    Junction waypoints carry the LEFT / RIGHT / STRAIGHT maneuvers the
    planner paints; LANEFOLLOW and CHANGELANE are open road."""
    rows = route_id.long()
    m = bank.maneuver[rows]  # [B, capacity]
    live = torch.arange(m.shape[1], device=m.device)[None, :] < bank.length[rows][:, None]
    is_junction = (
        (m == int(RoadOption.LEFT)) | (m == int(RoadOption.RIGHT)) | (m == int(RoadOption.STRAIGHT))
    ) & live
    pick = torch.argmax(torch.where(is_junction, u, -1.0), dim=1).to(torch.int32)
    idx = torch.clamp(pick - backoff, min=0)
    return torch.where(is_junction.any(dim=1), idx, torch.zeros_like(idx))


def reset_on_routes(
    params: EnvParams, route_id: Tensor, start_idx: Tensor, is_training: Tensor
) -> EnvState:
    """Fresh episodes at waypoint `start_idx` of routes `route_id` ([B] each)."""
    bank = params.track
    state = default_env_state(bank, route_id.shape[0], route_id)
    state = dataclasses.replace(state, is_training=is_training)
    state = _spawn_on_route(state, bank, route_id, start_idx)
    # A mid-route spawn does not count its skipped prefix as progress.
    length = bank.length[route_id.long()]
    state = dataclasses.replace(
        state, route_frac_offset=start_idx.to(torch.float32) / length.to(torch.float32)
    )
    return lap_env._with_derived(state, params)


def reset(
    params: EnvParams,
    generator: torch.Generator,
    is_training: Tensor | bool = True,
    batch: int | None = None,
) -> EnvState:
    """Fresh episodes on random routes. Training resets spawn
    `junction_spawn_backoff` waypoints before a random junction with
    probability `params.junction_spawn_prob` (its uniforms are drawn only
    when that is above 0); eval always spawns at the route start."""
    bank = params.track
    dev = bank.device
    if batch is None:
        batch = is_training.shape[0]
    is_training = lap_env._as_batch(is_training, batch, torch.bool, dev)
    route_id = draw_routes(bank, batch, generator)
    start_idx = torch.zeros(batch, dtype=torch.int32, device=dev)
    if params.junction_spawn_prob > 0:
        u_bias = torch.rand(batch, generator=generator, device=dev)
        u_pick = torch.rand(batch, bank.capacity, generator=generator, device=dev)
        bias = is_training & (u_bias < params.junction_spawn_prob)
        picked = junction_spawn_idx(bank, route_id, params.junction_spawn_backoff, u_pick)
        start_idx = torch.where(bias, picked, start_idx)
    return reset_on_routes(params, route_id, start_idx, is_training)


def step_with_routes(
    state: EnvState,
    action: Tensor,
    params: EnvParams,
    new_route_id: Tensor,
    obs_fn: str | None = "vector",
) -> Tuple[EnvState, StepOutput]:
    """One tick; an env that reached its route's last waypoint first chains
    onto `new_route_id` (at its start, from standstill, with the low-speed
    timer reset)."""
    bank = params.track
    route_done = state.waypoint_idx >= bank.length[state.route_id.long()] - 1
    zero = torch.zeros_like(state.waypoint_idx)
    switched = dataclasses.replace(
        _spawn_on_route(state, bank, new_route_id, zero),
        num_routes_completed=state.num_routes_completed + 1,
        low_speed_timer=torch.zeros_like(state.low_speed_timer),
    )
    state = lap_env.select_envs(route_done, switched, state)
    next_state, out = lap_env.step(state, action, params, obs_fn=obs_fn)

    length = bank.length[next_state.route_id.long()].to(torch.float32)
    routes_completed = (
        next_state.num_routes_completed.to(torch.float32)
        + (next_state.waypoint_idx.to(torch.float32) + 1.0) / length
        - next_state.route_frac_offset
    )
    next_state = dataclasses.replace(next_state, laps_completed=routes_completed)
    out.laps_completed = routes_completed
    return next_state, out


def step(
    state: EnvState,
    action: Tensor,
    params: EnvParams,
    generator: torch.Generator,
    obs_fn: str | None = "vector",
) -> Tuple[EnvState, StepOutput]:
    """One tick, chaining a random new route where one was finished."""
    new_route_id = draw_routes(params.track, state.batch_size, generator)
    return step_with_routes(state, action, params, new_route_id, obs_fn)


def autoreset_step(
    state: EnvState,
    action: Tensor,
    params: EnvParams,
    generator: torch.Generator,
    obs_fn: str | None = "vector",
) -> Tuple[EnvState, StepOutput]:
    """`step`, then re-spawn every env whose episode ended on a fresh
    random route, within the step (see lap_env.autoreset_step)."""
    with profiling.span("env_step"):
        next_state, out = step(state, action, params, generator, obs_fn=obs_fn)
        fresh = reset(params, generator, is_training=state.is_training)
        next_state = lap_env.select_envs(out.done, fresh, next_state)
        if obs_fn is not None:
            out.obs = torch.where(out.done[:, None], lap_env.observe(fresh, params, obs_fn), out.obs)
        return next_state, out


observe = lap_env.observe
