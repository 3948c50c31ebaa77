"""Scripted driving agents for a batch of envs (port of
carla_ppo_tpu/envs/agents.py).

The reference's `Agent` hazard check (an NPC vehicle ahead on the ego's
lane), `RoamingAgent` (follow the road at a target speed) and `BasicAgent`
(follow a route to its end) are classical autopilot baselines and data
drivers beside the RL path. Here they are step functions over a batch of
env states and an explicit agent state ([B] tensors), emitting the
3-channel [steer, throttle, brake] control that lap_env.step reads; the RL
action space stays 2-D. They brake for NPCs and for red lights
(envs/traffic_lights.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs import geometry, traffic_lights
from carla_ppo_tpu_torch.envs.controller import VehiclePIDController
from carla_ppo_tpu_torch.envs.observations import env_track
from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState


@dataclasses.dataclass
class AgentState:
    controller: VehiclePIDController
    target_speed_kmh: Tensor  # [B] float32

    @classmethod
    def create(cls, batch: int, device, target_speed_kmh: float = 20.0) -> "AgentState":
        return cls(
            controller=VehiclePIDController.create(batch, device),
            target_speed_kmh=torch.full((batch,), float(target_speed_kmh), device=device),
        )


def is_vehicle_hazard(
    env_state: EnvState,
    env_params: EnvParams,
    proximity: float = 10.0,
    lane_halfwidth: float = 1.75,
) -> Tensor:
    """[B] bool: an active NPC is ahead of the ego, on its lane, within
    `proximity` meters (the reference's three tests, in the road
    coordinates the simulator runs in)."""
    track = env_params.track
    et = env_track(track, env_state.route_id)
    M = env_state.npc_s.shape[1]
    ds = env_state.npc_s - env_state.waypoint_idx.to(torch.float32)[:, None]
    if track.is_loop:
        length = float(et.length) if et.rows is None else et.length.to(torch.float32)[:, None]
        ds = torch.remainder(ds + length / 2.0, length) - length / 2.0
    cur = et.gather(track.pos, env_state.waypoint_idx)
    nxt = et.gather(track.pos, env_state.waypoint_idx + 1)
    ego_lat = geometry.signed_distance_to_line(cur, nxt, env_state.vehicle.pos)
    active = torch.arange(M, device=ds.device) < env_params.num_npcs
    ahead = (ds > 0.0) & (ds < proximity)
    same_lane = (env_state.npc_lateral - ego_lat[:, None]).abs() < lane_halfwidth
    return (active & ahead & same_lane).any(-1)


def roaming_agent_step(
    agent: AgentState, env_state: EnvState, env_params: EnvParams
) -> Tuple[Tensor, AgentState]:
    """Follow the road at the target speed, slowed for the bend over the
    next 12 m (down to 45% at a 60 degree bend), with an emergency stop
    (steering kept, throttle 0, brake 1) on a vehicle hazard or a red light
    ahead. Returns ([B, 3] control, the new agent state)."""
    track = env_params.track
    et = env_track(track, env_state.route_id)
    f_now = et.gather(track.fwd, env_state.waypoint_idx)
    f_ahead = et.gather(track.fwd, env_state.waypoint_idx + 12)
    bend = geometry.angle_diff(f_now, f_ahead).abs()
    slow = torch.clamp(1.0 - bend / math.radians(60.0), 0.45, 1.0)

    action, controller = agent.controller.run_step(env_state, env_params,
                                                   agent.target_speed_kmh * slow)
    hazard = is_vehicle_hazard(env_state, env_params) | traffic_lights.is_red_light_ahead(
        env_state, env_params)
    zero = torch.zeros_like(action[:, 0])
    stop = torch.stack([action[:, 0], zero, zero + 1.0], -1)
    go = torch.stack([action[:, 0], action[:, 1], zero], -1)
    action = torch.where(hazard[:, None], stop, go)
    return action, dataclasses.replace(agent, controller=controller)


def basic_agent_step(
    agent: AgentState, env_state: EnvState, env_params: EnvParams
) -> Tuple[Tensor, AgentState, Tensor]:
    """The roaming agent on a route, with a full stop at its end. Returns
    ([B, 3] control, the new agent state, [B] bool arrived: within 2
    waypoints of the route's last one)."""
    et = env_track(env_params.track, env_state.route_id)
    arrived = et.length - 1 - env_state.waypoint_idx <= 2
    action, agent = roaming_agent_step(agent, env_state, env_params)
    stop = torch.tensor([0.0, 0.0, 1.0], device=action.device)
    return torch.where(arrived[:, None], stop, action), agent, arrived
