"""Gymnasium `VectorEnv` over the batched core (port of
carla_ppo_tpu/envs/vector_env.py).

The whole batch is one tensor state: one call of the batched `step` moves
every env, so the adapter exposes `gymnasium.vector.VectorEnv` (1.x)
without subprocesses or worker pipes.

Autoreset follows `AutoresetMode.SAME_STEP` (declared in metadata): an env
whose episode ends is re-spawned inside the same step, the returned
observation row is the new episode's first observation, and the finished
episode's terminal observation comes in `infos["final_obs"]` with the
standard `_final_obs` mask. The step is the batched `step` (not
`autoreset_step`, so the terminal observation survives), then a fresh
reset merged by `lap_env.select_envs`; the lap env's re-spawn keeps the
persistent checkpoint. `device=None` means the card and raises without
one; draws come from a torch.Generator seeded from reset's `seed` (0
before the first seed).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import gymnasium

from carla_ppo_tpu_torch.envs import lap_env, route_env
from carla_ppo_tpu_torch.envs import track as track_mod
from carla_ppo_tpu_torch.envs.observations import obs_dim_for
from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState, map_tensors
from carla_ppo_tpu_torch.ops import rasterizer as raster
from carla_ppo_tpu_torch.utils.device import make_generator, resolve_device


class LapVectorEnv(gymnasium.vector.VectorEnv):
    """N lap envs as one batched state (no workers, no pipes)."""

    metadata = {
        "render_modes": ["rgb_array"],
        "render_fps": 30,
        "autoreset_mode": gymnasium.vector.AutoresetMode.SAME_STEP,
    }

    def __init__(
        self,
        num_envs: int = 64,
        track_seed: int = 0,
        reward_fn: str = "reward_speed_centering_angle_multiply",
        action_smoothing: float = 0.0,
        obs_fn: str = "vector",
        is_training: bool = True,
        num_npcs: int = 0,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device("cuda" if device is None else device)
        self.params = EnvParams(
            track=track_mod.make_lap_track(seed=track_seed, device=self.device),
            action_smoothing=action_smoothing, reward_fn=reward_fn, num_npcs=num_npcs,
        )
        self._build(num_envs, obs_fn, is_training)

    def _build(self, num_envs: int, obs_fn: str, is_training: bool) -> None:
        """Spaces and state, shared by the lap and route adapters."""
        self.num_envs = int(num_envs)
        self._obs_fn = obs_fn
        self.is_training = is_training
        self.single_action_space = gymnasium.spaces.Box(
            np.array([-1.0, 0.0], np.float32), np.array([1.0, 1.0], np.float32), dtype=np.float32)
        self.single_observation_space = gymnasium.spaces.Box(
            -np.inf, np.inf, shape=(obs_dim_for(obs_fn),), dtype=np.float32)
        self.action_space = gymnasium.vector.utils.batch_space(self.single_action_space, self.num_envs)
        self.observation_space = gymnasium.vector.utils.batch_space(
            self.single_observation_space, self.num_envs)
        self._generator = make_generator(0, self.device)
        self._states: Optional[EnvState] = None

    # -- the env family's reset and step (the route adapter overrides) --

    def _reset(self, is_training) -> EnvState:
        return lap_env.reset(self.params, self._generator, checkpoint_idx=0,
                             is_training=is_training, batch=self.num_envs)

    def _fresh(self, state: EnvState) -> EnvState:
        """Re-spawns of every env: lap re-spawns keep the persistent
        respawn checkpoint."""
        return lap_env.reset(self.params, self._generator, checkpoint_idx=state.checkpoint_idx,
                             is_training=state.is_training)

    def _step(self, state: EnvState, actions: torch.Tensor):
        return lap_env.step(state, actions, self.params, self._obs_fn)

    def _observe(self, state: EnvState) -> torch.Tensor:
        return lap_env.observe(state, self.params, self._obs_fn)

    # -- the VectorEnv API --

    def _infos(self, out) -> dict:
        return {
            "distance_traveled": out.distance_traveled.cpu().numpy(),
            "laps_completed": out.laps_completed.cpu().numpy(),
            "total_reward": out.total_reward.cpu().numpy(),
            "step_count": out.step_count.cpu().numpy(),
        }

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._generator = make_generator(seed, self.device)
        self._states = self._reset(self.is_training)
        return self._observe(self._states).cpu().numpy(), {}

    def step(self, actions):
        actions = torch.as_tensor(np.asarray(actions, np.float32), device=self.device)
        next_state, out = self._step(self._states, actions)
        done = out.done
        truncated = next_state.truncated
        obs = out.obs
        final_obs = out.obs
        if bool(done.any()):
            fresh = self._fresh(next_state)
            next_state = lap_env.select_envs(done, fresh, next_state)
            obs = torch.where(done[:, None], self._observe(fresh), out.obs)
        self._states = next_state
        term = (done & ~truncated).cpu().numpy()
        trunc = (done & truncated).cpu().numpy()
        infos = self._infos(out)
        if bool(done.any()):
            infos["final_obs"] = final_obs.cpu().numpy()
            infos["_final_obs"] = term | trunc
        return obs.cpu().numpy(), out.reward.cpu().numpy(), term, trunc, infos

    def render(self):
        """Env 0's seg frame, RGB uint8 [H, W, 3] (a batch of one)."""
        first = map_tensors(lambda t: t[:1], self._states)
        cls = raster.render_semantic(first, self.params)
        return (raster.seg_to_rgb(cls) * 255).to(torch.uint8).cpu().numpy()


class RouteVectorEnv(LapVectorEnv):
    """N route envs as one batched state: every reset draws a fresh random
    route from the bank, completing a route chains into a new one inside
    step, and episodes end at the 3000 m budget. `infos["laps_completed"]`
    carries routes completed, like the metric slot it rides internally."""

    def __init__(
        self,
        num_envs: int = 64,
        track_seed: int = 0,
        num_routes: int = 32,
        reward_fn: str = "reward_speed_centering_angle_multiply",
        action_smoothing: float = 0.0,
        obs_fn: str = "vector",
        is_training: bool = True,
        device: str | torch.device | None = None,
    ):
        from carla_ppo_tpu_torch.envs import route_planner

        self.device = resolve_device("cuda" if device is None else device)
        town = route_planner.make_town(seed=track_seed)
        bank = route_planner.make_route_bank(town, n_routes=num_routes, seed=track_seed,
                                             device=self.device)
        self.params = route_env.route_env_params(bank, action_smoothing=action_smoothing,
                                                 reward_fn=reward_fn)
        self._build(num_envs, obs_fn, is_training)

    def _reset(self, is_training) -> EnvState:
        return route_env.reset(self.params, self._generator, is_training=is_training,
                               batch=self.num_envs)

    def _fresh(self, state: EnvState) -> EnvState:
        return route_env.reset(self.params, self._generator, is_training=state.is_training)

    def _step(self, state: EnvState, actions: torch.Tensor):
        return route_env.step(state, actions, self.params, self._generator, self._obs_fn)
