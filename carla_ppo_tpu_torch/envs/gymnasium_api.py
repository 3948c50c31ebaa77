"""Standards-compliant Gymnasium adapters (port of
carla_ppo_tpu/envs/gymnasium_api.py).

`envs/gym_api` keeps the reference's own surface (reset(is_training)
returning only obs, a 4-tuple step). This module wraps the same batched
cores, each at a batch of one, in the Gymnasium API: reset(seed, options)
-> (obs, info); step -> (obs, reward, terminated, truncated, info), with a
truncation (the step budget) split from a termination. `device=None` means
the card and raises without one; draws come from a torch.Generator seeded
from reset's `seed` (0 before the first seed).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

import gymnasium

from carla_ppo_tpu_torch.envs import lap_env, route_env, route_planner
from carla_ppo_tpu_torch.envs import track as track_mod
from carla_ppo_tpu_torch.envs.observations import vector_obs_dim
from carla_ppo_tpu_torch.envs.types import EnvParams
from carla_ppo_tpu_torch.ops import rasterizer as raster
from carla_ppo_tpu_torch.utils.device import make_generator, resolve_device


def _spaces():
    action = gymnasium.spaces.Box(np.array([-1.0, 0.0], np.float32),
                                  np.array([1.0, 1.0], np.float32), dtype=np.float32)
    obs = gymnasium.spaces.Box(-np.inf, np.inf, shape=(vector_obs_dim(),), dtype=np.float32)
    return action, obs


class LapEnvGymnasium(gymnasium.Env):
    """Gymnasium single-env view of the lap simulator (vector observations)."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 30}

    def __init__(
        self,
        track_seed: int = 0,
        reward_fn: str = "reward_speed_centering_angle_multiply",
        action_smoothing: float = 0.0,
        is_training: bool = False,
        render_mode: Optional[str] = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device("cuda" if device is None else device)
        self.params = EnvParams(
            track=track_mod.make_lap_track(seed=track_seed, device=self.device),
            action_smoothing=action_smoothing, reward_fn=reward_fn,
        )
        self._setup(is_training, render_mode)

    def _setup(self, is_training: bool, render_mode: Optional[str]) -> None:
        self.is_training = is_training
        self.render_mode = render_mode
        self.action_space, self.observation_space = _spaces()
        self._generator = make_generator(0, self.device)
        self.state = None

    def _reset(self):
        return lap_env.reset(self.params, self._generator, checkpoint_idx=0,
                             is_training=self.is_training, batch=1)

    def _step(self, action: torch.Tensor):
        return lap_env.step(self.state, action, self.params)

    def _info(self) -> Dict[str, Any]:
        s = self.state
        return {
            "closed": False,  # the reference's info key
            "distance_traveled": float(s.distance_traveled),
            "laps_completed": float(s.laps_completed),
            "distance_from_center": float(s.distance_from_center),
            "speed": float(s.vehicle.speed),
        }

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)  # seeds gymnasium's np_random bookkeeping
        if seed is not None:
            self._generator = make_generator(seed, self.device)
        self.state = self._reset()
        obs = lap_env.observe(self.state, self.params)[0].cpu().numpy()
        return obs, self._info()

    def step(self, action):
        act = torch.as_tensor(np.asarray(action, np.float32), device=self.device).reshape(1, -1)
        self.state, out = self._step(act)
        truncated = bool(self.state.truncated)
        terminated = bool(out.done) and not truncated
        return out.obs[0].cpu().numpy(), float(out.reward), terminated, truncated, self._info()

    def render(self):
        if self.render_mode != "rgb_array":
            return None
        cls = raster.render_semantic(self.state, self.params)
        return (raster.seg_to_rgb(cls) * 255).to(torch.uint8).cpu().numpy()


class RouteEnvGymnasium(LapEnvGymnasium):
    """Gymnasium view of the random-route env; frames render the env's own
    bank row."""

    def __init__(
        self,
        track_seed: int = 0,
        num_routes: int = 32,
        is_training: bool = False,
        render_mode: Optional[str] = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device("cuda" if device is None else device)
        town = route_planner.make_town(seed=track_seed)
        bank = route_planner.make_route_bank(town, n_routes=num_routes, seed=track_seed,
                                             device=self.device)
        self.params = route_env.route_env_params(bank)
        self._setup(is_training, render_mode)

    def _reset(self):
        return route_env.reset(self.params, self._generator, is_training=self.is_training, batch=1)

    def _step(self, action: torch.Tensor):
        return route_env.step(self.state, action, self.params, self._generator)
