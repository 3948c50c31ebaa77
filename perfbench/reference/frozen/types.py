# Frozen copy of carla_ppo_tpu_torch/envs/types.py (commit cbdb1fb), the benchmark's
# reference: imports made local.
# It imports nothing of the program and is not edited when the program changes.
"""Core types of the driving environment, as dataclasses of tensors.

Port of carla_ppo_tpu/envs/types.py. The JAX package keeps one env's state
in `flax.struct` pytrees and vmaps; here every state field carries the env
batch as its leading dimension ([B], [B, 2], ...), and the static
configuration (EnvParams, VehicleParams, RewardParams) is plain Python
numbers, so no configuration value ever becomes a device tensor.

Left out against the JAX EnvState: `rng` (the port draws from an explicit
torch.Generator passed to reset/step/rollout).

A track bank (the route env's routes, the lap bank's circuits) is one
TrackData whose arrays carry a leading bank axis ([R, cap, ...]) and whose
`length` is an [R] int32 tensor; each env reads its own row,
`EnvState.route_id`. `is_loop` stays one host bool per bank (routes are
open, laps are loops).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Callable

import torch
from torch import Tensor

# Static NPC slot count (the renderer always carries these billboard slots).
NUM_NPC_SLOTS = 8

# One roadside-prop slot per PROP_STRIDE waypoints per side.
PROP_STRIDE = 4


class RoadOption(enum.IntEnum):
    VOID = -1
    LEFT = 1
    RIGHT = 2
    STRAIGHT = 3
    LANEFOLLOW = 4
    CHANGELANELEFT = 5
    CHANGELANERIGHT = 6


class SegClass(enum.IntEnum):
    """CARLA 0.9.x semantic-segmentation class ids (13 classes)."""

    NONE = 0
    BUILDINGS = 1
    FENCES = 2
    OTHER = 3
    PEDESTRIANS = 4
    POLES = 5
    ROADLINES = 6
    ROADS = 7
    SIDEWALKS = 8
    VEGETATION = 9
    VEHICLES = 10
    WALLS = 11
    TRAFFICSIGNS = 12


NUM_SEG_CLASSES = 13


class TerminationReason(enum.IntEnum):
    RUNNING = 0
    VEHICLE_STOPPED = 1
    OFF_TRACK = 2
    TOO_FAST = 3
    LAPS_DONE = 4
    MAX_DISTANCE = 5
    COLLISION = 6
    LANE_INVASION = 7
    TIME_LIMIT = 8


def map_tensors(fn: Callable[..., Any], *objs: Any) -> Any:
    """Apply `fn` leafwise over matching (nested) dataclasses of tensors.

    Non-dataclass leaves (tensors and Python numbers) are passed to `fn`."""
    first = objs[0]
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(
            first,
            **{
                f.name: map_tensors(fn, *(getattr(o, f.name) for o in objs))
                for f in dataclasses.fields(first)
                if f.init
            },
        )
    return fn(*objs)


@dataclasses.dataclass
class TrackData:
    """Device-resident route: a padded polyline of waypoints 1 m apart.

    One track: `length` (live prefix) is a host int and the arrays are
    [N, ...]. A bank of R tracks: every array has a leading [R] axis and
    `length` is an [R] int32 tensor. `is_loop` is a host bool either way;
    every array is float32 / int32 on the track's device."""

    pos: Tensor  # [N, 2] float32 ([R, N, 2] for a bank)
    fwd: Tensor  # [N, 2] float32 unit forward
    maneuver: Tensor  # [N] int32 RoadOption
    left_width: Tensor  # [N] float32
    right_width: Tensor  # [N] float32
    length: int | Tensor  # int, or [R] int32 for a bank
    is_loop: bool
    prop_class: Tensor  # [N // PROP_STRIDE, 2] int32 SegClass
    prop_lateral: Tensor  # [S, 2] float32
    prop_height: Tensor  # [S, 2] float32
    prop_halfwidth: Tensor  # [S, 2] float32

    @property
    def banked(self) -> bool:
        return self.pos.ndim == 3

    @property
    def num_tracks(self) -> int:
        return self.pos.shape[0] if self.banked else 1

    @property
    def capacity(self) -> int:
        return self.pos.shape[-2]

    @property
    def prop_slots(self) -> int:
        return self.prop_class.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.pos.device


@dataclasses.dataclass(frozen=True)
class VehicleParams:
    """Single-track (bicycle) vehicle model parameters."""

    wheelbase: float = 2.85
    lr: float = 1.45
    mass: float = 1900.0
    max_steer: float = 0.61
    engine_force: float = 8000.0
    brake_force: float = 10000.0
    v_max: float = 38.0
    drag_coef: float = 0.42
    roll_coef: float = 0.012
    max_lat_accel: float = 7.5
    steer_tau: float = 0.08


@dataclasses.dataclass(frozen=True)
class RewardParams:
    """Constants of the reward / termination layer."""

    max_distance: float = 3.0
    target_speed: float = 20.0
    min_speed: float = 15.0
    max_speed: float = 25.0
    max_speed_terminate: float = -1.0
    low_speed_timeout: float = 5.0
    low_speed_threshold: float = 1.0 / 3.6
    terminal_penalty: float = -10.0
    angle_factor_max: float = math.radians(20.0)
    pass_bonus: float = 20.0
    blocked_scale: float = 1.0
    block_range: float = 15.0


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Environment configuration + baked track data.

    NPC traffic (`num_npcs` > 0 live slots of NUM_NPC_SLOTS) is ticked in
    lap_env.step; see the JAX EnvParams for what each NPC knob does.

    Traffic lights (envs/traffic_lights.py) are a table on the track's
    device: each light's waypoint `light_wp` [L] int32 and phase offset
    `light_phase` [L] float32 (s), sharing one green -> yellow -> red cycle
    of `light_period` s. The default empty table means no lights anywhere
    (the RL configs); only the scripted agents read it."""

    track: TrackData
    vehicle: VehicleParams = VehicleParams()
    reward: RewardParams = RewardParams()
    dt: float = 1.0 / 30.0
    action_smoothing: float = 0.0
    max_laps: float = 3.0
    max_distance_traveled: float = math.inf
    checkpoint_frequency: int = 50
    max_episode_steps: int = 1_000_000
    spawn_pos_noise: float = 0.0
    spawn_yaw_noise: float = 0.0
    junction_spawn_prob: float = 0.0  # route env, training resets only
    junction_spawn_backoff: int = 25
    num_npcs: int = 0
    npc_min_speed: float = 4.0
    npc_max_speed: float = 7.0
    npc_collision_s: float = 4.0  # ego-overlap box half-length (m)
    npc_collision_lat: float = 1.5  # ... and half-width (m)
    npc_reactive: bool = True  # car-following, speed jitter, lateral wander
    npc_follow_lat: float = 1.2
    npc_follow_min: float = 6.0
    npc_follow_dist: float = 14.0
    npc_speed_jitter: float = 0.12
    npc_wander_rate: float = 1.5
    npc_keep_lat: float = 0.0  # lane-keeping spring home (m)
    npc_keep_gain: float = 0.0  # and rate (1/s); 0 = free wander
    light_wp: Tensor = dataclasses.field(default_factory=lambda: torch.zeros(0, dtype=torch.int32))
    light_phase: Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros(0, dtype=torch.float32))
    light_period: float = 16.0
    light_green_frac: float = 0.5
    light_yellow_frac: float = 0.125
    physics_substeps: int = 2
    reward_fn: str = "reward_speed_centering_angle_multiply"
    dynamics_model: str = "kinematic"
    waypoint_lookahead: int = 8
    terminate_on_collision: bool = False
    terminate_on_lane_invasion: bool = False
    render_npc_billboards: bool = True

    @property
    def device(self) -> torch.device:
        return self.track.device


@dataclasses.dataclass
class VehicleState:
    """Pose + body-frame velocities of a batch of vehicles, each [B]
    (pos [B, 2])."""

    pos: Tensor
    yaw: Tensor
    vx: Tensor
    vy: Tensor
    yaw_rate: Tensor
    steer_angle: Tensor

    @property
    def speed(self) -> Tensor:
        return torch.sqrt(self.vx**2 + self.vy**2)

    @property
    def velocity(self) -> Tensor:
        c, s = torch.cos(self.yaw), torch.sin(self.yaw)
        return torch.stack([c * self.vx - s * self.vy, s * self.vx + c * self.vy], -1)

    @property
    def forward(self) -> Tensor:
        return torch.stack([torch.cos(self.yaw), torch.sin(self.yaw)], -1)

    @classmethod
    def create(cls, pos: Tensor, yaw: Tensor) -> "VehicleState":
        zero = torch.zeros_like(yaw)
        return cls(pos=pos, yaw=yaw, vx=zero, vy=zero.clone(),
                   yaw_rate=zero.clone(), steer_angle=zero.clone())


@dataclasses.dataclass
class EnvState:
    """Per-env simulator state, batched: every field has leading dim B."""

    vehicle: VehicleState
    control: Tensor  # [B, 2] float32 smoothed (steer, throttle)
    waypoint_idx: Tensor  # [B] int32
    start_waypoint_idx: Tensor  # [B] int32
    checkpoint_idx: Tensor  # [B] int32
    route_id: Tensor  # [B] int32 row of a track bank (0 on a shared track)
    num_routes_completed: Tensor  # [B] int32 (route env)
    low_speed_timer: Tensor  # [B] float32
    step_count: Tensor  # [B] int32
    time: Tensor  # [B] float32
    terminal: Tensor  # [B] bool
    truncated: Tensor  # [B] bool
    termination_reason: Tensor  # [B] int32
    is_training: Tensor  # [B] bool
    distance_from_center: Tensor  # [B] float32
    angle_to_road: Tensor  # [B] float32
    last_reward: Tensor  # [B] float32
    collision: Tensor  # [B] bool
    lane_invasion: Tensor  # [B] bool
    prev_pos: Tensor  # [B, 2] float32
    total_reward: Tensor
    distance_traveled: Tensor
    center_lane_deviation: Tensor
    speed_accum: Tensor
    laps_completed: Tensor
    vecnorm_return: Tensor
    npc_s: Tensor  # [B, NUM_NPC_SLOTS]
    npc_speed: Tensor  # [B, NUM_NPC_SLOTS]
    npc_lateral: Tensor  # [B, NUM_NPC_SLOTS]
    npc_just_passed: Tensor  # [B]
    npc_overtakes: Tensor  # [B]
    route_frac_offset: Tensor  # [B] float32 (route env: spawn index / route length)

    @property
    def batch_size(self) -> int:
        return self.waypoint_idx.shape[0]


def default_env_state(track: TrackData, batch: int, route_id: Tensor | None = None) -> EnvState:
    """A zero-initialised batch placed at waypoint 0 of `track` (of each
    env's `route_id` row for a bank)."""
    dev = track.device
    if route_id is None:
        route_id = torch.zeros(batch, dtype=torch.int32, device=dev)

    def f0():
        return torch.zeros(batch, dtype=torch.float32, device=dev)

    def i0():
        return torch.zeros(batch, dtype=torch.int32, device=dev)

    def b0():
        return torch.zeros(batch, dtype=torch.bool, device=dev)

    if track.banked:
        pos = track.pos[route_id.long(), 0].clone()
        fwd = track.fwd[route_id.long(), 0]
        yaw = torch.atan2(fwd[:, 1], fwd[:, 0])
    else:
        pos = track.pos[0].expand(batch, 2).clone()
        yaw = torch.atan2(track.fwd[0, 1], track.fwd[0, 0]).expand(batch).clone()
    npc = torch.zeros(batch, NUM_NPC_SLOTS, dtype=torch.float32, device=dev)
    return EnvState(
        vehicle=VehicleState.create(pos, yaw),
        control=torch.zeros(batch, 2, dtype=torch.float32, device=dev),
        waypoint_idx=i0(),
        start_waypoint_idx=i0(),
        checkpoint_idx=i0(),
        route_id=route_id.to(torch.int32),
        num_routes_completed=i0(),
        low_speed_timer=f0(),
        step_count=i0(),
        time=f0(),
        terminal=b0(),
        truncated=b0(),
        termination_reason=i0(),
        is_training=torch.ones(batch, dtype=torch.bool, device=dev),
        distance_from_center=f0(),
        angle_to_road=f0(),
        last_reward=f0(),
        collision=b0(),
        lane_invasion=b0(),
        prev_pos=pos.clone(),
        total_reward=f0(),
        distance_traveled=f0(),
        center_lane_deviation=f0(),
        speed_accum=f0(),
        laps_completed=f0(),
        vecnorm_return=f0(),
        npc_s=npc,
        npc_speed=npc.clone(),
        npc_lateral=npc.clone(),
        npc_just_passed=f0(),
        npc_overtakes=f0(),
        route_frac_offset=f0(),
    )
