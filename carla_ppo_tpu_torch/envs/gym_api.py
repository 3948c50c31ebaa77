"""Gym-style class API over the batched envs (port of
carla_ppo_tpu/envs/gym_api.py).

`CarlaLapEnv` / `CarlaRouteEnv` offer the reference's object surface: the
constructor kwargs, `reset(is_training)`, `step(action) -> (obs, reward,
done, {"closed"})`, `render(mode)` with a pygame window and HUD, and the
keyboard smoke test under `__main__`. The env owns an `EnvState` that is a
batch of one env on the env's device, and renders with the batched camera
(ops/rasterizer): on the card each frame goes through the ground-pass and
composite kernels. `device=None` means the card, and raises without one;
`device="cpu"` runs the plain PyTorch versions. Random draws come from a
torch.Generator seeded from `seed`.

As in the JAX package:
- `reset()` returns `step(None)[0]`, one tick without acting; step(None)
  keeps the current control.
- The observation space declares the (H, W, 1) frame actually delivered.
- `host` / `port` / `start_carla` / `synchronous` are accepted and ignored:
  there is no server.

Two structural differences, so that the device work runs where pygame and
gymnasium are not installed (the card's machine has neither):
- `action_space` / `observation_space` are built on first access, not in
  the constructor, so constructing an env does not import gymnasium. They
  are the JAX package's Boxes.
- `render` is split. `render_frames()` is the pygame-free half: it returns
  the spectator frame (RGB uint8 from the chase camera) and the dashcam's
  RGB uint8 overlay, read back from the device. `render(mode)` adds the
  window and HUD, imports pygame, and returns what the JAX package returns
  for every mode.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from carla_ppo_tpu_torch.envs import lap_env, rewards
from carla_ppo_tpu_torch.envs import track as track_mod
from carla_ppo_tpu_torch.envs.observations import encode_state_fns
from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState, RoadOption, TerminationReason
from carla_ppo_tpu_torch.ops import rasterizer as raster
from carla_ppo_tpu_torch.utils.device import make_generator, resolve_device

TERMINATION_TEXT = {
    int(TerminationReason.RUNNING): "Running...",
    int(TerminationReason.VEHICLE_STOPPED): "Vehicle stopped",
    int(TerminationReason.OFF_TRACK): "Off-track",
    int(TerminationReason.TOO_FAST): "Too fast",
    int(TerminationReason.LAPS_DONE): "Laps completed",
    int(TerminationReason.MAX_DISTANCE): "Max distance reached",
    int(TerminationReason.COLLISION): "Collision",
    int(TerminationReason.LANE_INVASION): "Lane invasion",
    int(TerminationReason.TIME_LIMIT): "Time limit",
}

MANEUVER_TEXT = {
    int(RoadOption.LANEFOLLOW): "Follow Lane",
    int(RoadOption.LEFT): "Left",
    int(RoadOption.RIGHT): "Right",
    int(RoadOption.STRAIGHT): "Straight",
    int(RoadOption.VOID): "VOID",
}


def _to_uint8(rgb: torch.Tensor) -> np.ndarray:
    """[0, 1] float RGB -> uint8 on the host, truncating as numpy's astype."""
    return (rgb * 255).to(torch.uint8).cpu().numpy()


class CarlaLapEnv:
    """Interactive lap env."""

    metadata = {"render.modes": ["human", "rgb_array", "rgb_array_no_hud", "state_pixels"]}

    def __init__(
        self,
        host: str = "127.0.0.1",  # ignored: no server
        port: int = 2000,  # ignored
        viewer_res: Tuple[int, int] = (1280, 720),
        obs_res: Tuple[int, int] = (160, 80),
        reward_fn: Union[str, None] = "reward_speed_centering_angle_multiply",
        encode_state_fn: Union[str, Callable, None] = None,
        synchronous: bool = True,  # the sim is always synchronous
        fps: int = 30,
        action_smoothing: float = 0.9,
        start_carla: bool = True,  # ignored
        track_seed: int = 0,
        seed: Optional[int] = None,
        traffic_lights: bool = False,
        device: str | torch.device | None = None,
    ):
        del host, port, synchronous, start_carla
        self.device = resolve_device("cuda" if device is None else device)
        self.viewer_res = viewer_res
        self.obs_res = obs_res
        self.fps = self.average_fps = fps
        self.action_smoothing = action_smoothing

        if isinstance(reward_fn, str):
            if reward_fn not in rewards.reward_functions:
                raise KeyError(f"unknown reward_fn {reward_fn!r}; "
                               f"choose from {sorted(rewards.reward_functions)}")
            reward_name = reward_fn
        else:
            reward_name = "reward_speed_centering_angle_multiply"

        self.params = self._make_params(track_seed, fps, action_smoothing, reward_name)
        if traffic_lights:
            from carla_ppo_tpu_torch.envs import traffic_lights as tl

            self.params = tl.add_traffic_lights(self.params, seed=track_seed)

        # Observation encoding: a named obs fn ("vector", "vector_npc"), a
        # callable of the env, or None for the raw camera frame.
        self._custom_encoder: Optional[Callable] = None
        self._obs_fn_name: Optional[str] = None
        if callable(encode_state_fn):
            self._custom_encoder = encode_state_fn
        elif isinstance(encode_state_fn, str):
            if encode_state_fn not in encode_state_fns:
                raise KeyError(f"unknown encode_state_fn {encode_state_fn!r}")
            self._obs_fn_name = encode_state_fn
        self._spaces = None

        self._generator = make_generator(0 if seed is None else seed, self.device)
        self.state: Optional[EnvState] = None
        self.extra_info: list[str] = []
        self.closed = False
        self.display = None
        self.hud = None
        self.clock = None

        w, h = obs_res
        self._dash_cam = raster.CameraConfig(height=h, width=w)
        # Spectator chase camera: the viewer resolution over an integer scale.
        vw, vh = viewer_res
        scale = max(vw // 320, 1)
        self._spec_cam = raster.CameraConfig(
            height=vh // scale, width=vw // scale, mount_forward=-5.5, mount_height=2.8,
            pitch_deg=-15.0,
        )
        self.reset()

    # -- construction and stepping hooks the route env overrides --

    def _make_params(self, track_seed, fps, action_smoothing, reward_name) -> EnvParams:
        return EnvParams(
            track=track_mod.make_lap_track(seed=track_seed, device=self.device),
            dt=1.0 / fps, action_smoothing=action_smoothing, reward_fn=reward_name,
        )

    def _env_reset(self, is_training: bool) -> EnvState:
        ckpt = 0 if self.state is None else int(self.state.checkpoint_idx[0])
        return lap_env.reset(self.params, self._generator, checkpoint_idx=ckpt,
                             is_training=is_training, batch=1)

    def _env_step(self, state: EnvState, action: torch.Tensor):
        return lap_env.step(state, action, self.params, obs_fn="vector")

    def _render_dash(self, state: EnvState) -> torch.Tensor:
        return raster.render_semantic(state, self.params, self._dash_cam)

    # -- spaces (gymnasium Boxes, built on first access) --

    def _build_spaces(self):
        if self._spaces is None:
            import gymnasium

            w, h = self.obs_res
            self._spaces = (
                gymnasium.spaces.Box(np.array([-1.0, 0.0], np.float32),
                                     np.array([1.0, 1.0], np.float32), dtype=np.float32),
                gymnasium.spaces.Box(low=0.0, high=1.0, shape=(h, w, 1), dtype=np.float32),
            )
        return self._spaces

    @property
    def action_space(self):
        return self._build_spaces()[0]

    @property
    def observation_space(self):
        return self._build_spaces()[1]

    # -- gym-ish API --

    def seed(self, seed=None):
        if seed is not None:
            self._generator = make_generator(seed, self.device)
        return [seed]

    def reset(self, is_training: bool = True, seed: Optional[int] = None):
        if seed is not None:
            self.seed(seed)
        self.state = self._env_reset(is_training)
        self.extra_info = []
        self.closed = False
        self.observation = None
        self.viewer_image = None
        return self.step(None)[0]

    def step(self, action):
        if self.closed:
            raise RuntimeError(
                "CarlaLapEnv.step() called after the environment was closed. "
                'Check for info["closed"] == True in the learning loop.'
            )
        if action is None:
            act = self.state.control  # tick without acting
        else:
            act = torch.as_tensor(np.asarray(action, np.float32), device=self.device).reshape(1, -1)
        prev_invasion = bool(self.state.lane_invasion)
        prev_collision = bool(self.state.collision)
        self.state, out = self._env_step(self.state, act)

        self._dash = self._render_dash(self.state)
        self.observation = raster.seg_to_obs(self._dash).cpu().numpy()
        encoded = self._encode_state(out)

        if self.hud is not None:
            if bool(self.state.lane_invasion) and not prev_invasion:
                self.hud.notification("Crossed line 'Solid'")
            if bool(self.state.collision) and not prev_collision:
                self.hud.notification("Collision with roadside")

        done = bool(out.done)
        if done:
            self.extra_info.extend([TERMINATION_TEXT[int(self.state.termination_reason)], ""])
        return encoded, float(out.reward), done, {"closed": self.closed}

    def _encode_state(self, out):
        if self._custom_encoder is not None:
            return self._custom_encoder(self)
        if self._obs_fn_name is not None:
            return out.obs[0].cpu().numpy()
        return self.observation

    def render_frames(self) -> Tuple[np.ndarray, np.ndarray]:
        """The pygame-free half of render: (spectator frame [h, w, 3] uint8
        from the chase camera, dashcam overlay [H, W, 3] uint8) of the
        current state. Sets `viewer_image` to the spectator frame."""
        spec = raster.render_semantic(self.state, self.params, self._spec_cam)
        self.viewer_image = _to_uint8(raster.seg_to_rgb(spec))
        return self.viewer_image, _to_uint8(raster.seg_to_rgb(self._dash))

    def _info_lines(self) -> list[str]:
        maneuver = MANEUVER_TEXT.get(self._current_maneuver(), "INVALID")
        s = self.state
        steps = max(int(s.step_count), 1)
        return [
            "Reward: % 19.2f" % float(s.last_reward),
            "",
            "Maneuver:        % 11s" % maneuver,
            "Laps completed:    % 7.2f %%" % (float(s.laps_completed) * 100.0),
            "Distance traveled: % 7d m" % int(s.distance_traveled),
            "Center deviance:   % 7.2f m" % float(s.distance_from_center),
            "Avg center dev:    % 7.2f m" % (float(s.center_lane_deviation) / steps),
            "Avg speed:      % 7.2f km/h" % (3.6 * float(s.speed_accum) / steps),
        ]

    def render(self, mode: str = "human"):
        import pygame

        if self.display is None:
            pygame.init()
            pygame.font.init()
            self.display = pygame.display.set_mode(self.viewer_res, pygame.HWSURFACE | pygame.DOUBLEBUF)
            from carla_ppo_tpu_torch.envs.hud import HUD

            self.hud = HUD(*self.viewer_res)
            self.clock = pygame.time.Clock()
        self.clock.tick()
        self.hud.tick(self, self.clock)
        self.extra_info.extend(self._info_lines())

        # Spectator view (upscaled), dashcam superimposed top-right.
        spec, obs_rgb = self.render_frames()
        surf = pygame.transform.scale(pygame.surfarray.make_surface(spec.swapaxes(0, 1)),
                                      self.viewer_res)
        self.display.blit(surf, (0, 0))
        obs_surf = pygame.surfarray.make_surface(obs_rgb.swapaxes(0, 1))
        self.display.blit(obs_surf, (self.viewer_res[0] - obs_rgb.shape[1] - 10, 10))

        self.hud.render(self.display, self, extra_info=self.extra_info)
        self.extra_info = []
        pygame.display.flip()

        if mode == "rgb_array_no_hud":
            return self.viewer_image
        if mode == "rgb_array":
            return np.array(pygame.surfarray.array3d(self.display), dtype=np.uint8).transpose([1, 0, 2])
        if mode == "state_pixels":
            return self.observation
        return None

    def _current_maneuver(self) -> int:
        track = self.params.track
        idx = int(self.state.waypoint_idx) % int(track.length)
        return int(track.maneuver[idx])

    def close(self):
        if self.display is not None:
            import pygame

            pygame.quit()
            self.display = None
        self.closed = True


class CarlaRouteEnv(CarlaLapEnv):
    """Interactive random-route env: random A->B routes from a bank of
    `num_routes`, chained until `max_distance` m. `reset(is_training)`
    always starts a fresh random route. Every frame renders the env's own
    bank row (render_batch_banked)."""

    def __init__(self, *args, num_routes: int = 64, max_distance: float = 3000.0, **kwargs):
        self._num_routes = num_routes
        self._max_distance = max_distance
        super().__init__(*args, **kwargs)

    def _make_params(self, track_seed, fps, action_smoothing, reward_name) -> EnvParams:
        from carla_ppo_tpu_torch.envs import route_env, route_planner

        town = route_planner.make_town(seed=track_seed)
        self._bank = route_planner.make_route_bank(town, n_routes=self._num_routes, seed=track_seed,
                                                   device=self.device)
        return route_env.route_env_params(
            self._bank, max_distance=self._max_distance, dt=1.0 / fps,
            action_smoothing=action_smoothing, reward_fn=reward_name,
        )

    def _env_reset(self, is_training: bool) -> EnvState:
        from carla_ppo_tpu_torch.envs import route_env

        return route_env.reset(self.params, self._generator, is_training=is_training, batch=1)

    def _env_step(self, state: EnvState, action: torch.Tensor):
        from carla_ppo_tpu_torch.envs import route_env

        return route_env.step(state, action, self.params, self._generator, obs_fn="vector")

    def _current_maneuver(self) -> int:
        track = self.params.track
        rid = int(self.state.route_id)
        idx = min(int(self.state.waypoint_idx), int(track.length[rid]) - 1)
        return int(track.maneuver[rid, idx])


def keyboard_control_loop(env) -> None:
    """Arrow-key / WASD driving, the reference's interactive smoke test."""
    import pygame
    from pygame.locals import K_ESCAPE, K_LEFT, K_RIGHT, K_UP, K_a, K_d, K_h, K_w, KEYDOWN

    action = np.zeros(2, np.float32)
    while True:
        env.reset(is_training=True)
        while True:
            for event in pygame.event.get():
                if event.type == KEYDOWN and event.key == K_h and env.hud is not None:
                    env.hud.help.toggle()
            keys = pygame.key.get_pressed()
            if keys[K_ESCAPE]:
                env.close()
                return
            if keys[K_LEFT] or keys[K_a]:
                action[0] = -0.5
            elif keys[K_RIGHT] or keys[K_d]:
                action[0] = 0.5
            else:
                action[0] = 0.0
            action[1] = 1.0 if keys[K_UP] or keys[K_w] else 0.0

            obs, reward, done, info = env.step(action)
            if info["closed"]:
                return
            env.render()
            if done:
                break


if __name__ == "__main__":
    env = CarlaLapEnv(obs_res=(160, 80))
    keyboard_control_loop(env)
    env.close()
