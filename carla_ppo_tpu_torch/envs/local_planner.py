"""Local planner: a waypoint queue and buffer with PID waypoint following,
for a batch of envs (port of carla_ppo_tpu/envs/local_planner.py).

The reference's LocalPlanner keeps a queue of waypoints, peels a 5-entry
buffer off its head, PID-follows the buffer head, purges every buffered
waypoint the vehicle came within `min_distance` of, and stops once the
queue runs dry. As in the JAX package the plan is the baked track polyline
itself (each env's row on a bank), and the queue is a cursor over it: per
env, `head` (the plan index of the buffer head). `cursor` derives from it
how many of the BUFFER_SIZE buffered entries lie inside the plan and
whether an open plan's head ran past its end, as the JAX package does in
each step; the cursor advances branch-free with torch.where. The tracks
are baked at 1 m, so the queue
strides the polyline by `sampling_stride` waypoints to keep the
reference's spacing (target speed x 1 s).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs.controller import VehiclePIDController
from carla_ppo_tpu_torch.envs.observations import EnvTrack, env_track
from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState, RoadOption

# Reference defaults.
MIN_DISTANCE_PERCENTAGE = 0.9
BUFFER_SIZE = 5
DEFAULT_TARGET_SPEED_KMH = 20.0


@dataclasses.dataclass
class LocalPlannerState:
    """The queue cursor of every env and the PID controller state.

    Entries head .. head + (BUFFER_SIZE - 1) x sampling_stride form the
    buffer; the plan beyond them is the queue."""

    controller: VehiclePIDController
    head: Tensor  # [B] int32, plan index of the buffer head
    target_speed_kmh: Tensor  # [B] float32
    sampling_stride: int  # plan waypoints per queue entry
    min_distance: float  # purge radius (m)

    @classmethod
    def create(
        cls,
        target_speed_kmh: float = DEFAULT_TARGET_SPEED_KMH,
        sampling_radius_s: float = 1.0,
        *,
        batch: int,
        device,
    ) -> "LocalPlannerState":
        """Planners of `batch` envs at the start of each env's plan.
        `sampling_radius_s`: the queue spacing in seconds of travel at the
        target speed."""
        radius_m = target_speed_kmh * sampling_radius_s / 3.6
        return cls(
            controller=VehiclePIDController.create(batch, device),
            head=torch.zeros(batch, dtype=torch.int32, device=device),
            target_speed_kmh=torch.full((batch,), float(target_speed_kmh), device=device),
            sampling_stride=max(1, round(radius_m)),
            min_distance=radius_m * MIN_DISTANCE_PERCENTAGE,
        )

    def set_global_plan(self) -> "LocalPlannerState":
        """Restart every cursor at its plan's start with a fresh controller
        (the reference clears its queue and refills it from the new plan;
        here the plan is the track, so only the cursor moves)."""
        head = torch.zeros_like(self.head)
        return dataclasses.replace(
            self, head=head, controller=VehiclePIDController.create(head.shape[0], head.device))

    def set_speed(self, speed_kmh: float) -> "LocalPlannerState":
        return dataclasses.replace(self, target_speed_kmh=torch.full_like(self.target_speed_kmh,
                                                                          float(speed_kmh)))


def _buffer_positions(head: Tensor, stride: int, et: EnvTrack) -> Tuple[Tensor, Tensor]:
    """Positions [B, BUFFER_SIZE, 2] of the buffered entries and whether
    each lies inside the plan (loops never end: the roaming extension)."""
    offsets = torch.arange(BUFFER_SIZE, dtype=torch.int32, device=head.device)
    idx = head[:, None] + offsets * stride
    pos = et.gather(et.track.pos, idx)
    if et.track.is_loop:
        return pos, torch.ones_like(idx, dtype=torch.bool)
    length = et.length if et.rows is None else et.length[:, None]
    return pos, idx < length


def _cursor(head: Tensor, stride: int, et: EnvTrack) -> Tuple[Tensor, Tensor]:
    _, in_plan = _buffer_positions(head, stride, et)
    exhausted = torch.zeros_like(in_plan[:, 0]) if et.track.is_loop else head >= et.length
    return in_plan.sum(-1, dtype=torch.int32), exhausted


def cursor(planner: LocalPlannerState, env_state: EnvState,
           env_params: EnvParams) -> Tuple[Tensor, Tensor]:
    """([B] int32 buffered entries inside the plan, [B] bool an open plan's
    head past its end) of each env's cursor."""
    return _cursor(planner.head, planner.sampling_stride,
                   env_track(env_params.track, env_state.route_id))


def run_step(
    planner: LocalPlannerState, env_state: EnvState, env_params: EnvParams
) -> Tuple[Tensor, LocalPlannerState, Tensor]:
    """One planning step -> ([B, 3] steer, throttle, brake; the new
    planner; [B] int32 RoadOption of each buffer head).

    PID toward the buffer head, then purge: the head advances past the
    farthest buffered entry within `min_distance` (the reference scans the
    whole buffer). An exhausted plan emits a full stop (steer 0, throttle
    0, brake 1) and the VOID option."""
    track = env_params.track
    et = env_track(track, env_state.route_id)
    veh = env_state.vehicle

    _, exhausted = _cursor(planner.head, planner.sampling_stride, et)
    target_pos = et.gather(track.pos, planner.head)
    target_opt = et.gather(track.maneuver, planner.head)
    action, controller = planner.controller.run_step_to_point(
        env_state, env_params, target_pos, planner.target_speed_kmh)

    buf_pos, in_plan = _buffer_positions(planner.head, planner.sampling_stride, et)
    diff = buf_pos - veh.pos[:, None, :]
    d = torch.sqrt((diff * diff).sum(-1))
    within = (d < planner.min_distance) & in_plan
    offsets = torch.arange(BUFFER_SIZE, dtype=torch.int32, device=d.device)
    max_index = torch.where(within, offsets, -1).amax(-1)
    new_head = (planner.head + (max_index + 1) * planner.sampling_stride).to(torch.int32)

    stop = torch.tensor([0.0, 0.0, 1.0], device=action.device)
    action = torch.where(exhausted[:, None], stop,
                         torch.cat([action, torch.zeros_like(action[:, :1])], -1))
    target_opt = torch.where(exhausted, int(RoadOption.VOID), target_opt).to(torch.int32)
    planner = dataclasses.replace(planner, head=new_head, controller=controller)
    return action, planner, target_opt
