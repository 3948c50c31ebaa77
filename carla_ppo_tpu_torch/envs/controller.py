"""Classical PID vehicle controllers for a batch of envs (port of
carla_ppo_tpu/envs/controller.py).

`VehiclePIDController` combines a lateral PID on the heading error to a
target point with a longitudinal PID on the speed error, as the
reference's controller does. The JAX package vmaps one controller per env;
here every state tensor has a leading env axis [B], and the state (the
running integral and the last error of each PID) is carried explicitly:
each step returns a new controller and leaves its input as it was. Gains
are host floats.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs import geometry
from carla_ppo_tpu_torch.envs.observations import env_track
from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState


@dataclasses.dataclass
class PIDState:
    integral: Tensor  # [B] float32
    prev_error: Tensor  # [B] float32

    @classmethod
    def zero(cls, batch: int, device) -> "PIDState":
        z = torch.zeros(batch, dtype=torch.float32, device=device)
        return cls(integral=z, prev_error=z.clone())


@dataclasses.dataclass(frozen=True)
class PIDParams:
    k_p: float
    k_i: float
    k_d: float


def pid_step(params: PIDParams, state: PIDState, error: Tensor, dt: float) -> Tuple[Tensor, PIDState]:
    """One PID update of every env; returns (control, new state)."""
    integral = state.integral + error * dt
    derivative = (error - state.prev_error) / max(dt, 1e-6)
    out = params.k_p * error + params.k_i * integral + params.k_d * derivative
    return out, PIDState(integral=integral, prev_error=error)


@dataclasses.dataclass
class VehiclePIDController:
    """Lateral + longitudinal PID -> [B, 2] (steer, throttle), with the JAX
    package's gains (the reference's, retuned mildly for 30 Hz)."""

    lateral: PIDParams
    longitudinal: PIDParams
    lat_state: PIDState
    lon_state: PIDState

    @classmethod
    def create(cls, batch: int, device) -> "VehiclePIDController":
        return cls(
            lateral=PIDParams(1.95, 0.07, 0.2),
            longitudinal=PIDParams(0.4, 0.05, 0.0),
            lat_state=PIDState.zero(batch, device),
            lon_state=PIDState.zero(batch, device),
        )

    def run_step(
        self,
        env_state: EnvState,
        env_params: EnvParams,
        target_speed_kmh: Tensor | float,
        lookahead: int = 4,
    ) -> Tuple[Tensor, "VehiclePIDController"]:
        """[steer, throttle] toward the waypoint `lookahead` ahead of each
        env at `target_speed_kmh` ([B] or a float)."""
        track = env_params.track
        et = env_track(track, env_state.route_id)
        wp = et.gather(track.pos, env_state.waypoint_idx + lookahead)
        return self.run_step_to_point(env_state, env_params, wp, target_speed_kmh)

    def run_step_to_point(
        self,
        env_state: EnvState,
        env_params: EnvParams,
        wp: Tensor,
        target_speed_kmh: Tensor | float,
    ) -> Tuple[Tensor, "VehiclePIDController"]:
        """[steer, throttle] toward explicit target points `wp` [B, 2] (the
        reference controller's interface; the local planner hands it its
        buffer head)."""
        veh = env_state.vehicle
        # Lateral: signed heading error to the target point.
        heading_err = geometry.angle_diff(veh.forward, wp - veh.pos)
        steer_raw, lat_state = pid_step(self.lateral, self.lat_state, heading_err, env_params.dt)
        steer = torch.clamp(steer_raw, -1.0, 1.0)
        # Longitudinal: speed error in km/h, over 3.6.
        speed_err = (target_speed_kmh - 3.6 * veh.speed) / 3.6
        throttle_raw, lon_state = pid_step(self.longitudinal, self.lon_state, speed_err,
                                           env_params.dt)
        throttle = torch.clamp(throttle_raw, 0.0, 1.0)
        action = torch.stack([steer, throttle], -1)
        return action, dataclasses.replace(self, lat_state=lat_state, lon_state=lon_state)
