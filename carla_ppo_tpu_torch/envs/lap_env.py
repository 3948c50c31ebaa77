"""The lap-driving environment as batched tensor functions.

Port of carla_ppo_tpu/envs/lap_env.py. Every function takes and returns a
whole env batch (EnvState fields are [B, ...]) instead of being vmapped.

Auto-reset keeps the JAX package's reset-within-step semantics: the
terminating step returns the finished episode's done / reward / metrics but
carries the re-spawned state (step_count 0) and, in StepOutput.obs, the new
episode's first observation. The persistent checkpoint index carries across
the reset.

Only the zero-NPC configuration is ported: the NPC tick (reactive traffic,
NPC collisions, overtake events) waits for the traffic slice and `step`
raises for `num_npcs > 0`. The NPC state fields stay, because the camera's
billboard composite always carries the NPC slots (class NONE here).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs import geometry, rewards
from carla_ppo_tpu_torch.envs.dynamics import vehicle_step
from carla_ppo_tpu_torch.envs.observations import encode_state_fns, wp_gather
from carla_ppo_tpu_torch.envs.types import (
    NUM_NPC_SLOTS,
    EnvParams,
    EnvState,
    TerminationReason,
    VehicleState,
    default_env_state,
    map_tensors,
)


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
    checkpoint_idx: Tensor | int,
    is_training: Tensor | bool = True,
    batch: int | None = None,
) -> EnvState:
    """Spawn a batch of vehicles: training at the persistent checkpoint,
    eval at waypoint 0. `batch` is needed only when both index and flag are
    scalars."""
    track = params.track
    dev = track.device
    if batch is None:
        batch = next(t.shape[0] for t in (checkpoint_idx, is_training)
                     if isinstance(t, Tensor) and t.ndim)
    checkpoint_idx = _as_batch(checkpoint_idx, batch, torch.int32, dev)
    is_training = _as_batch(is_training, batch, torch.bool, dev)

    start_idx = torch.where(
        is_training, torch.remainder(checkpoint_idx, track.length),
        torch.zeros_like(checkpoint_idx),
    )
    pos = track.pos[start_idx.long()]
    fwd = track.fwd[start_idx.long()]
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

    state = default_env_state(track, batch)
    lo, hi = 25.0, max(float(track.length) - 25.0, 26.0)
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
    K = params.waypoint_lookahead
    offsets = torch.arange(1, K + 1, dtype=torch.int32, device=track.device)
    idxs = state.waypoint_idx[:, None] + offsets[None, :]
    wp_pos = wp_gather(track.pos, idxs, track.length, track.is_loop)  # [B, K, 2]
    wp_fwd = wp_gather(track.fwd, idxs, track.length, track.is_loop)
    rel = state.vehicle.pos[:, None, :] - wp_pos
    dots = (wp_fwd * rel).sum(-1)
    advance = torch.cumprod((dots > 0.0).to(torch.int32), dim=1).sum(1)
    new_idx = (state.waypoint_idx + advance).to(torch.int32)
    if not track.is_loop:
        new_idx = torch.clamp(new_idx, max=track.length - 1)
    return new_idx


def _center_distance_and_angle(state: EnvState, params: EnvParams) -> Tuple[Tensor, Tensor]:
    track = params.track
    L, loop = track.length, track.is_loop
    cur_pos = wp_gather(track.pos, state.waypoint_idx, L, loop)
    nxt_pos = wp_gather(track.pos, state.waypoint_idx + 1, L, loop)
    cur_fwd = wp_gather(track.fwd, state.waypoint_idx, L, loop)
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
    if params.num_npcs > 0:
        raise NotImplementedError("NPC traffic is not ported yet (num_npcs must be 0)")
    track = params.track
    L, loop = track.length, track.is_loop
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

    laps_completed = (waypoint_idx - state.start_waypoint_idx).to(torch.float32) / float(L)
    laps_done = laps_completed >= params.max_laps

    freq = params.checkpoint_frequency
    checkpoint_idx = torch.where(
        state.is_training,
        torch.div(waypoint_idx, freq, rounding_mode="floor") * freq,
        state.checkpoint_idx,
    ).to(torch.int32)

    cur_wp = wp_gather(track.pos, waypoint_idx, L, loop)
    nxt_wp = wp_gather(track.pos, waypoint_idx + 1, L, loop)
    ego_lat = geometry.signed_distance_to_line(cur_wp, nxt_wp, vehicle.pos)
    lw = wp_gather(track.left_width, waypoint_idx, L, loop)
    rw = wp_gather(track.right_width, waypoint_idx, L, loop)
    lane_invasion = (ego_lat > lw) | (ego_lat < -rw)
    collision = (ego_lat > lw + 1.5) | (ego_lat < -(rw + 1.5))

    # Zero-NPC traffic: the slots only drift along the track (inert).
    npc_s = state.npc_s + state.npc_speed * params.dt
    npc_just_passed = torch.zeros_like(state.npc_just_passed)

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
    """`step`, then re-spawn every env whose episode ended, within the step."""
    next_state, out = step(state, action, params, obs_fn=obs_fn)
    fresh = reset(
        params, generator, checkpoint_idx=next_state.checkpoint_idx,
        is_training=state.is_training,
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
