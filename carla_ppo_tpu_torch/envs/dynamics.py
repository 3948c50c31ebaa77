"""Single-track (bicycle) vehicle dynamics, batched over envs.

Port of carla_ppo_tpu/envs/dynamics.py: kinematic bicycle with CG slip
angle, optional lateral-grip clamp ("dynamic"), first-order steering lag,
speed-fading engine force, drag and rolling resistance; explicit Euler over
`substeps` per env tick.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs.types import VehicleParams, VehicleState

GRAVITY = 9.81


def longitudinal_force(
    params: VehicleParams, v: Tensor, throttle: Tensor, brake: Tensor | float = 0.0
) -> Tensor:
    """Net longitudinal force (N): engine minus brake, drag and rolling."""
    engine = throttle * params.engine_force * torch.clamp(1.0 - v / params.v_max, min=0.0)
    drag = params.drag_coef * v * v
    roll = params.roll_coef * params.mass * GRAVITY * torch.sign(v)
    braking = brake * params.brake_force * torch.sign(v)
    return engine - drag - roll - braking


def _substep(
    params: VehicleParams,
    state: VehicleState,
    steer_cmd: Tensor,
    throttle_cmd: Tensor,
    brake_cmd: Tensor | float,
    dt: float,
    dynamic: bool,
) -> VehicleState:
    target_angle = steer_cmd * params.max_steer
    alpha = 1.0 - math.exp(-dt / params.steer_tau)
    steer_angle = state.steer_angle + alpha * (target_angle - state.steer_angle)
    v = torch.sqrt(state.vx**2 + state.vy**2)

    if dynamic:
        kappa_cmd = torch.tan(steer_angle) / params.wheelbase
        kappa_max = params.max_lat_accel / torch.clamp(v * v, min=1e-3)
        kappa = torch.minimum(torch.maximum(kappa_cmd, -kappa_max), kappa_max)
        eff_angle = torch.atan(kappa * params.wheelbase)
    else:
        eff_angle = steer_angle

    beta = torch.atan(params.lr / params.wheelbase * torch.tan(eff_angle))
    accel = longitudinal_force(params, v, throttle_cmd, brake_cmd) / params.mass
    v_new = torch.clamp(v + accel * dt, min=0.0)

    yaw_rate = v_new / params.lr * torch.sin(beta)
    yaw = state.yaw + yaw_rate * dt
    course = state.yaw + beta
    pos = state.pos + (v_new * dt)[:, None] * torch.stack(
        [torch.cos(course), torch.sin(course)], -1
    )
    return VehicleState(
        pos=pos,
        yaw=yaw,
        vx=v_new * torch.cos(beta),
        vy=v_new * torch.sin(beta),
        yaw_rate=yaw_rate,
        steer_angle=steer_angle,
    )


def vehicle_step(
    params: VehicleParams,
    state: VehicleState,
    steer_cmd: Tensor,
    throttle_cmd: Tensor,
    dt: float,
    substeps: int = 2,
    dynamics_model: str = "kinematic",
    brake_cmd: Tensor | float = 0.0,
) -> VehicleState:
    """Advance a batch of vehicles by one env tick of `dt` seconds."""
    dynamic = dynamics_model == "dynamic"
    sub_dt = dt / substeps
    for _ in range(substeps):
        state = _substep(params, state, steer_cmd, throttle_cmd, brake_cmd, sub_dt, dynamic)
    return state
