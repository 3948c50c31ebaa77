"""Reward / termination layer (port of carla_ppo_tpu/envs/rewards.py).

Same registry and the same `create_reward_fn`-style wrapper (`step_reward`):
per-env low-speed timer, off-center and optional over-speed termination, a
flat terminal penalty. The traffic-shaped reward waits for the traffic slice.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState, RewardParams, TerminationReason

RewardFn = Callable[[EnvState, EnvParams], Tensor]

reward_functions: Dict[str, RewardFn] = {}


def register(name: str) -> Callable[[RewardFn], RewardFn]:
    def deco(fn: RewardFn) -> RewardFn:
        reward_functions[name] = fn
        return fn

    return deco


def _speed_reward(speed_kmh: Tensor, rp: RewardParams) -> Tensor:
    rising = speed_kmh / rp.min_speed
    falling = 1.0 - (speed_kmh - rp.target_speed) / (rp.max_speed - rp.target_speed)
    return torch.where(
        speed_kmh < rp.min_speed,
        rising,
        torch.where(speed_kmh > rp.target_speed, falling, torch.ones_like(falling)),
    )


def _centering_factor(state: EnvState, rp: RewardParams) -> Tensor:
    return torch.clamp(1.0 - state.distance_from_center / rp.max_distance, min=0.0)


def _angle_factor(state: EnvState, rp: RewardParams) -> Tensor:
    return torch.clamp(1.0 - torch.abs(state.angle_to_road / rp.angle_factor_max), min=0.0)


@register("reward_kendall")
def reward_kendall(state: EnvState, params: EnvParams) -> Tensor:
    return 3.6 * state.vehicle.speed


@register("reward_speed_centering_angle_add")
def reward_speed_centering_angle_add(state: EnvState, params: EnvParams) -> Tensor:
    rp = params.reward
    return (
        _speed_reward(3.6 * state.vehicle.speed, rp)
        + _centering_factor(state, rp)
        + _angle_factor(state, rp)
    )


@register("reward_speed_centering_angle_multiply")
def reward_speed_centering_angle_multiply(state: EnvState, params: EnvParams) -> Tensor:
    rp = params.reward
    return (
        _speed_reward(3.6 * state.vehicle.speed, rp)
        * _centering_factor(state, rp)
        * _angle_factor(state, rp)
    )


def _full(like: Tensor, value: int) -> Tensor:
    return torch.full_like(like, value, dtype=torch.int32)


def step_reward(
    state: EnvState, params: EnvParams, extra_terminal: Tensor, extra_reason: Tensor
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(reward, terminal, reason, new_low_speed_timer), each [B].

    `state.low_speed_timer` is the timer before this step; `extra_terminal`
    / `extra_reason` are the env-level causes, which win over the reward
    layer's own (stopped, off-track, too fast, in that order)."""
    rp = params.reward
    speed = state.vehicle.speed
    timer = state.low_speed_timer + params.dt

    stopped = (timer > rp.low_speed_timeout) & (speed < rp.low_speed_threshold)
    off_track = state.distance_from_center > rp.max_distance
    if rp.max_speed_terminate > 0.0:
        too_fast = 3.6 * speed > rp.max_speed_terminate
    else:
        too_fast = torch.zeros_like(stopped)
    terminal = stopped | off_track | too_fast | extra_terminal

    reason = torch.where(
        too_fast, _full(extra_reason, TerminationReason.TOO_FAST),
        _full(extra_reason, TerminationReason.RUNNING),
    )
    reason = torch.where(off_track, _full(reason, TerminationReason.OFF_TRACK), reason)
    reason = torch.where(stopped, _full(reason, TerminationReason.VEHICLE_STOPPED), reason)
    reason = torch.where(extra_terminal, extra_reason, reason)

    base = reward_functions[params.reward_fn](state, params)
    reward = torch.where(terminal, torch.full_like(base, rp.terminal_penalty), base)
    timer = torch.where(terminal, torch.zeros_like(timer), timer)
    return reward, terminal, reason, timer
