"""The lap-driving environment as batched tensor functions.

Port of carla_ppo_tpu/envs/lap_env.py. Every function takes and returns a
whole env batch (EnvState fields are [B, ...]) instead of being vmapped.

Auto-reset keeps the JAX package's reset-within-step semantics: the
terminating step returns the finished episode's done / reward / metrics but
carries the re-spawned state (step_count 0) and, in StepOutput.obs, the new
episode's first observation. The persistent checkpoint index carries across
the reset.

Every function also takes a banked `EnvParams` (a TrackData with a leading
bank axis, see envs/types.py): each env then reads its own row,
`state.route_id`, through observations.EnvTrack; `reset` takes the rows as
`route_id`. The route and lap-bank envs are built on this.

NPC traffic (`params.num_npcs` > 0) is ticked inside `step` (`_npc_tick`):
car-following over the [M, M+1] gaps to every NPC and the ego, speed
jitter, lateral wander with the lane-keeping spring, NPC-ego collisions and
overtake events. With no NPC the slots only drift along the track, and the
camera's billboard composite still carries them (class NONE).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs import geometry, rewards
from carla_ppo_tpu_torch.envs.dynamics import vehicle_step
from carla_ppo_tpu_torch.envs.observations import EnvTrack, encode_state_fns, env_track
from carla_ppo_tpu_torch.envs.types import (
    NUM_NPC_SLOTS,
    EnvParams,
    EnvState,
    TerminationReason,
    VehicleState,
    default_env_state,
    map_tensors,
)
from carla_ppo_tpu_torch.utils import profiling


@dataclasses.dataclass
class StepOutput:
    obs: Optional[Tensor]  # [B, D], None when step ran with obs_fn=None
    reward: Tensor
    done: Tensor
    total_reward: Tensor
    distance_traveled: Tensor
    center_lane_deviation: Tensor
    speed_accum: Tensor
    laps_completed: Tensor
    step_count: Tensor
    termination_reason: Tensor
    npc_overtakes: Tensor


def _as_batch(x, batch: int, dtype, device) -> Tensor:
    t = torch.as_tensor(x, dtype=dtype, device=device)
    return t.expand(batch).clone() if t.ndim == 0 else t


def reset(
    params: EnvParams,
    generator: torch.Generator,
    is_training: Tensor | bool = True,
    checkpoint_idx: Tensor | int = 0,
    batch: int | None = None,
    route_id: Tensor | int | None = None,
) -> EnvState:
    """Spawn a batch of vehicles: training at the persistent checkpoint,
    eval at waypoint 0. On a bank, `route_id` names each env's row (it is
    required there). `batch` is needed only when every argument is a
    scalar."""
    track = params.track
    dev = track.device
    if track.banked and route_id is None:
        raise ValueError("a banked track needs route_id (each env's bank row)")
    if batch is None:
        batch = next(t.shape[0] for t in (checkpoint_idx, is_training, route_id)
                     if isinstance(t, Tensor) and t.ndim)
    checkpoint_idx = _as_batch(checkpoint_idx, batch, torch.int32, dev)
    is_training = _as_batch(is_training, batch, torch.bool, dev)
    route_id = _as_batch(0 if route_id is None else route_id, batch, torch.int32, dev)
    et = env_track(track, route_id)

    start_idx = torch.where(
        is_training, torch.remainder(checkpoint_idx, et.length),
        torch.zeros_like(checkpoint_idx),
    )
    pos = et.at(track.pos, start_idx)
    fwd = et.at(track.fwd, start_idx)
    yaw = torch.atan2(fwd[:, 1], fwd[:, 0])

    # One draw per quantity and env, always (so the stream does not depend
    # on which noise amplitudes are zero).
    n_pos = torch.randn(batch, generator=generator, device=dev)
    n_yaw = torch.randn(batch, generator=generator, device=dev)
    u_gap = torch.rand(batch, NUM_NPC_SLOTS, generator=generator, device=dev)
    u_speed = torch.rand(batch, NUM_NPC_SLOTS, generator=generator, device=dev)

    lateral = torch.stack([-fwd[:, 1], fwd[:, 0]], -1)
    pos = pos + lateral * (params.spawn_pos_noise * n_pos)[:, None]
    yaw = yaw + params.spawn_yaw_noise * n_yaw

    state = default_env_state(track, batch, route_id)
    lo = 25.0
    if et.rows is None:
        hi = max(float(track.length) - 25.0, 26.0)
    else:
        hi = torch.clamp(et.length.to(torch.float32) - 25.0, min=26.0)[:, None]
    npc_s = start_idx.to(torch.float32)[:, None] + (lo + (hi - lo) * u_gap)
    npc_speed = params.npc_min_speed + (params.npc_max_speed - params.npc_min_speed) * u_speed
    state = dataclasses.replace(
        state,
        vehicle=VehicleState.create(pos, yaw),
        waypoint_idx=start_idx,
        start_waypoint_idx=start_idx.clone(),
        checkpoint_idx=checkpoint_idx,
        is_training=is_training,
        prev_pos=pos.clone(),
        npc_s=npc_s,
        npc_speed=npc_speed,
    )
    return _with_derived(state, params)


def _with_derived(state: EnvState, params: EnvParams) -> EnvState:
    d, angle = _center_distance_and_angle(state, params)
    return dataclasses.replace(state, distance_from_center=d, angle_to_road=angle)


def _advance_waypoint(state: EnvState, params: EnvParams) -> Tensor:
    """New waypoint index: count the leading passed waypoints (positive dot
    of wp forward with the offset to the car) in a static lookahead."""
    track = params.track
    et = env_track(track, state.route_id)
    K = params.waypoint_lookahead
    offsets = torch.arange(1, K + 1, dtype=torch.int32, device=track.device)
    idxs = state.waypoint_idx[:, None] + offsets[None, :]
    wp_pos = et.gather(track.pos, idxs)  # [B, K, 2]
    wp_fwd = et.gather(track.fwd, idxs)
    rel = state.vehicle.pos[:, None, :] - wp_pos
    dots = (wp_fwd * rel).sum(-1)
    advance = torch.cumprod((dots > 0.0).to(torch.int32), dim=1).sum(1)
    new_idx = (state.waypoint_idx + advance).to(torch.int32)
    if not track.is_loop:
        new_idx = et.wrap(new_idx)  # open routes stop at their last waypoint
    return new_idx


def _center_distance_and_angle(state: EnvState, params: EnvParams) -> Tuple[Tensor, Tensor]:
    track = params.track
    et = env_track(track, state.route_id)
    cur_pos = et.gather(track.pos, state.waypoint_idx)
    nxt_pos = et.gather(track.pos, state.waypoint_idx + 1)
    cur_fwd = et.gather(track.fwd, state.waypoint_idx)
    d = geometry.distance_to_line(cur_pos, nxt_pos, state.vehicle.pos)
    moving = (state.vehicle.speed > 1e-3)[:, None]
    ref_vec = torch.where(moving, state.vehicle.velocity, state.vehicle.forward)
    return d, geometry.angle_diff(ref_vec, cur_fwd)


def _reason(like: Tensor, r: TerminationReason) -> Tensor:
    return torch.full_like(like, int(r), dtype=torch.int32)


def step(
    state: EnvState,
    action: Tensor,
    params: EnvParams,
    obs_fn: str | None = "vector",
) -> Tuple[EnvState, StepOutput]:
    """One synchronous tick of every env. `action` [B, 2] = (steer, throttle),
    an optional 3rd column is an unsmoothed brake. `obs_fn=None` skips the
    observation (the latent path builds its own from the camera)."""
    track = params.track
    et = env_track(track, state.route_id)
    action = action.to(torch.float32)
    act = torch.stack(
        [torch.clamp(action[:, 0], -1.0, 1.0), torch.clamp(action[:, 1], 0.0, 1.0)], -1
    )
    brake = torch.clamp(action[:, 2], 0.0, 1.0) if action.shape[1] > 2 else 0.0

    a = params.action_smoothing
    control = state.control * a + act * (1.0 - a)
    vehicle = vehicle_step(
        params.vehicle, state.vehicle, control[:, 0], control[:, 1], params.dt,
        substeps=params.physics_substeps, dynamics_model=params.dynamics_model,
        brake_cmd=brake,
    )
    mid = dataclasses.replace(state, vehicle=vehicle, control=control)
    waypoint_idx = _advance_waypoint(mid, params)
    mid = dataclasses.replace(mid, waypoint_idx=waypoint_idx)
    distance_from_center, angle = _center_distance_and_angle(mid, params)

    step_dist = torch.linalg.vector_norm(vehicle.pos - state.prev_pos, dim=-1)
    distance_traveled = state.distance_traveled + step_dist
    center_lane_deviation = state.center_lane_deviation + distance_from_center
    speed_accum = state.speed_accum + vehicle.speed

    length_f = float(et.length) if et.rows is None else et.length.to(torch.float32)
    laps_completed = (waypoint_idx - state.start_waypoint_idx).to(torch.float32) / length_f
    laps_done = laps_completed >= params.max_laps

    freq = params.checkpoint_frequency
    checkpoint_idx = torch.where(
        state.is_training,
        torch.div(waypoint_idx, freq, rounding_mode="floor") * freq,
        state.checkpoint_idx,
    ).to(torch.int32)

    cur_wp = et.gather(track.pos, waypoint_idx)
    nxt_wp = et.gather(track.pos, waypoint_idx + 1)
    ego_lat = geometry.signed_distance_to_line(cur_wp, nxt_wp, vehicle.pos)
    lw = et.gather(track.left_width, waypoint_idx)
    rw = et.gather(track.right_width, waypoint_idx)
    lane_invasion = (ego_lat > lw) | (ego_lat < -rw)
    collision = (ego_lat > lw + 1.5) | (ego_lat < -(rw + 1.5))

    npc_s, npc_lateral, npc_hit, npc_just_passed = _npc_tick(state, params, et, waypoint_idx,
                                                             ego_lat)
    if npc_hit is not None:
        collision = collision | npc_hit

    step_count = state.step_count + 1
    over_distance = distance_traveled >= params.max_distance_traveled
    over_steps = step_count >= params.max_episode_steps
    env_terminal = laps_done | over_distance | over_steps
    if params.terminate_on_collision:
        env_terminal = env_terminal | collision
    if params.terminate_on_lane_invasion:
        env_terminal = env_terminal | lane_invasion
    env_reason = _reason(step_count, TerminationReason.LANE_INVASION)
    if params.terminate_on_collision:
        env_reason = torch.where(
            collision, _reason(step_count, TerminationReason.COLLISION), env_reason
        )
    env_reason = torch.where(over_steps, _reason(step_count, TerminationReason.TIME_LIMIT), env_reason)
    env_reason = torch.where(over_distance, _reason(step_count, TerminationReason.MAX_DISTANCE), env_reason)
    env_reason = torch.where(laps_done, _reason(step_count, TerminationReason.LAPS_DONE), env_reason)

    mid = dataclasses.replace(
        mid,
        distance_from_center=distance_from_center,
        angle_to_road=angle,
        collision=collision,
        lane_invasion=lane_invasion,
        npc_s=npc_s,
        npc_lateral=npc_lateral,
        npc_just_passed=npc_just_passed,
        npc_overtakes=state.npc_overtakes + npc_just_passed,
    )
    reward, terminal, reason, low_speed_timer = rewards.step_reward(
        mid, params, env_terminal, env_reason
    )
    total_reward = state.total_reward + reward
    next_state = dataclasses.replace(
        mid,
        checkpoint_idx=checkpoint_idx,
        low_speed_timer=low_speed_timer,
        step_count=step_count,
        time=state.time + params.dt,
        terminal=terminal,
        truncated=over_steps & ~laps_done,
        termination_reason=reason,
        last_reward=reward,
        prev_pos=vehicle.pos,
        total_reward=total_reward,
        distance_traveled=distance_traveled,
        center_lane_deviation=center_lane_deviation,
        speed_accum=speed_accum,
        laps_completed=laps_completed,
    )
    obs = None if obs_fn is None else encode_state_fns[obs_fn](next_state, params)
    out = StepOutput(
        obs=obs,
        reward=reward,
        done=terminal,
        total_reward=total_reward,
        distance_traveled=distance_traveled,
        center_lane_deviation=center_lane_deviation,
        speed_accum=speed_accum,
        laps_completed=laps_completed,
        step_count=step_count,
        termination_reason=reason,
        npc_overtakes=next_state.npc_overtakes,
    )
    return next_state, out


def _npc_tick(
    state: EnvState, params: EnvParams, et: EnvTrack, waypoint_idx: Tensor, ego_lat: Tensor
) -> Tuple[Tensor, Tensor, Optional[Tensor], Tensor]:
    """(npc_s, npc_lateral, NPC-ego hit or None, npc_just_passed), each
    [B, M] or [B]: one tick of the NPC slots (on `et`, step's view of each
    env's track) against the ego's new waypoint index and signed lateral
    offset, with the JAX package's operations in its order (lap_env.step
    there). Gaps are along-track, wrapped to the nearest representative on
    loops."""
    if params.num_npcs == 0:
        npc_s = state.npc_s + state.npc_speed * params.dt
        return npc_s, state.npc_lateral, None, torch.zeros_like(state.npc_just_passed)
    track = params.track
    M = state.npc_s.shape[1]
    dev = state.npc_s.device
    active = torch.arange(M, device=dev) < params.num_npcs  # [M]
    length_f = float(et.length) if et.rows is None else et.length.to(torch.float32)[:, None]
    ego_s = waypoint_idx.to(torch.float32)

    def wrap_gap(gap: Tensor, length=length_f) -> Tensor:
        if not track.is_loop:
            return gap
        return torch.remainder(gap + length / 2.0, length) - length / 2.0

    if params.npc_reactive:
        slot_f = torch.arange(M, dtype=torch.float32, device=dev)[None, :]
        t_step = state.step_count.to(torch.float32)[:, None]
        # (a) car-following over [M, M+1] gaps (every NPC and the ego).
        others_s = torch.cat([state.npc_s, ego_s[:, None]], 1)
        others_lat = torch.cat([state.npc_lateral, ego_lat[:, None]], 1)
        others_active = torch.cat([active, torch.ones(1, dtype=torch.bool, device=dev)])
        gap_len = length_f if et.rows is None else length_f[:, :, None]
        gaps = wrap_gap(others_s[:, None, :] - state.npc_s[:, :, None], gap_len)  # [B, M, M+1]
        in_lane = (others_lat[:, None, :] - state.npc_lateral[:, :, None]).abs() < params.npc_follow_lat
        ahead = (gaps > 0.1) & in_lane & others_active
        gap_ahead = torch.where(ahead, gaps, torch.full_like(gaps, math.inf)).amin(2)
        follow = torch.clamp(
            (gap_ahead - params.npc_follow_min)
            / max(params.npc_follow_dist - params.npc_follow_min, 1e-3),
            0.0, 1.0,
        )
        # (b) speed jitter, a per-slot phase by the golden angle.
        jitter = 1.0 + params.npc_speed_jitter * torch.sin(0.23 * t_step + 2.39996 * slot_f)
        npc_speed_eff = state.npc_speed * jitter * follow
        # (c) lateral wander and the lane-keeping spring, clamped to the road
        # at the NPC's waypoint less a half-car margin.
        if track.is_loop:
            npc_wp = torch.remainder(state.npc_s, length_f)
        else:
            npc_wp = torch.minimum(torch.clamp(state.npc_s, min=0.0), length_f - 1.0)
        npc_wp = npc_wp.to(torch.int32)
        npc_lw = et.gather(track.left_width, npc_wp)
        npc_rw = et.gather(track.right_width, npc_wp)
        wander = params.npc_wander_rate * torch.sin(0.11 * t_step + 2.39996 * slot_f + 1.0)
        keep = params.npc_keep_gain * (params.npc_keep_lat - state.npc_lateral)
        npc_lateral = torch.minimum(
            torch.maximum(state.npc_lateral + (wander + keep) * params.dt, -(npc_rw - 0.8)),
            npc_lw - 0.8,
        )
    else:
        npc_speed_eff = state.npc_speed
        npc_lateral = state.npc_lateral
    npc_s = state.npc_s + npc_speed_eff * params.dt

    ds = wrap_gap(npc_s - ego_s[:, None])
    hit = (
        active
        & (ds.abs() < params.npc_collision_s)
        & ((npc_lateral - ego_lat[:, None]).abs() < params.npc_collision_lat)
    ).any(1)
    # Overtakes: a gap that flips from ahead to behind this tick. An NPC
    # lapping a slower ego flips +L/2 -> -L/2 with a ~L jump; requiring a
    # small step keeps that wrap artifact from counting as a pass.
    ds_old = wrap_gap(state.npc_s - state.waypoint_idx.to(torch.float32)[:, None])
    small_step = (ds_old - ds).abs() < length_f / 4.0
    passed = active & (ds_old > 0.0) & (ds <= 0.0) & small_step
    return npc_s, npc_lateral, hit, passed.to(torch.float32).sum(1)


def select_envs(mask: Tensor, if_true: EnvState, if_false: EnvState) -> EnvState:
    """Per-env select between two state batches ([B] bool mask)."""

    def sel(a, b):
        m = mask.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(m, a, b)

    return map_tensors(sel, if_true, if_false)


def autoreset_step(
    state: EnvState,
    action: Tensor,
    params: EnvParams,
    generator: torch.Generator,
    obs_fn: str | None = "vector",
) -> Tuple[EnvState, StepOutput]:
    """`step`, then re-spawn every env whose episode ended, within the step
    (on a bank: on the same row)."""
    with profiling.span("env_step"):
        next_state, out = step(state, action, params, obs_fn=obs_fn)
        fresh = reset(
            params, generator, checkpoint_idx=next_state.checkpoint_idx,
            is_training=state.is_training, route_id=next_state.route_id,
        )
        next_state = select_envs(out.done, fresh, next_state)
        if obs_fn is not None:
            out.obs = torch.where(out.done[:, None], observe(fresh, params, obs_fn), out.obs)
        return next_state, out


def observe(state: EnvState, params: EnvParams, obs_fn: str = "vector") -> Tensor:
    return encode_state_fns[obs_fn](state, params)


def init_env_batch(params: EnvParams, num_envs: int, generator: torch.Generator) -> EnvState:
    """Training resets of `num_envs` envs at checkpoint 0."""
    return reset(params, generator, checkpoint_idx=0, is_training=True, batch=num_envs)
