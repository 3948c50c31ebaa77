"""Collect paired RGB / semantic-segmentation frames for VAE training (CLI
of the PyTorch / CUDA port).

The flags and defaults of carla_ppo_tpu/cli/collect_data.py, plus
`--device` (default "cuda"). A scripted, noisy lane-following controller drives
one env (a batch of one) on random lap tracks, with spawn noise, roadside
props and NPC traffic by default, and every `--save_every`-th frame saves a
pair: `rgb/<i>.png` (the shaded pseudo-RGB camera with texture noise) and
`segmentation/<i>.png` (the class id in the red channel, as CARLA's seg
camera writes it), through utils/png.py. `--manual` drives the interactive
lap env (envs/gym_api) from the keyboard in a pygame window: SPACE toggles
recording, ESC quits, and each recorded step saves a pair of the env's
camera.

Example:
  python -m carla_ppo_tpu_torch.cli.collect_data --output_dir vae/data --num_images 10000
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from carla_ppo_tpu_torch.envs import lap_env
from carla_ppo_tpu_torch.envs import track as track_mod
from carla_ppo_tpu_torch.envs.types import EnvParams
from carla_ppo_tpu_torch.ops import rasterizer as raster
from carla_ppo_tpu_torch.utils.device import make_generator, resolve_device
from carla_ppo_tpu_torch.utils.png import write_png

TRACK_STEPS = 2500  # the most env steps driven on one track before the next


def save_pair(rgb: np.ndarray, seg: np.ndarray, out_dir: str, idx: int) -> None:
    """rgb [H, W, 3] float in [0, 1], seg [H, W] class ids -> the pair's PNGs."""
    rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    seg8 = np.zeros((*seg.shape, 3), np.uint8)
    seg8[..., 0] = seg.astype(np.uint8)  # class id in R (CARLA raw format)
    write_png(os.path.join(out_dir, "rgb", f"{idx}.png"), rgb8)
    write_png(os.path.join(out_dir, "segmentation", f"{idx}.png"), seg8)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Collects RGB + segmentation frame pairs for VAE training"
    )
    parser.add_argument("--output_dir", type=str, default="vae/data")
    parser.add_argument("--num_images", type=int, default=10000)
    parser.add_argument("--num_tracks", type=int, default=4,
                        help="Distinct random track seeds to sample from")
    parser.add_argument("--steer_noise", type=float, default=0.4)
    parser.add_argument("--save_every", type=int, default=3,
                        help="Save every Nth frame (decorrelates the dataset)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rich_scene", type=int, default=1,
                        help="Bake roadside props (buildings/fences/poles/"
                             "signs/pedestrians/parked vehicles) + NPC "
                             "traffic so datasets cover all 13 classes")
    parser.add_argument("--num_npcs", type=int, default=6)
    parser.add_argument("--manual", action="store_true",
                        help="Interactive WASD driving like the reference")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch versions of the kernels")
    return parser


def drive_action(state, env_params: EnvParams, steer_noise: float, gen: torch.Generator):
    """The scripted controller: lane-following steer from the vector
    observation plus Gaussian noise, full throttle below 22 km/h."""
    obs = lap_env.observe(state, env_params)[0]
    noise = torch.randn((), generator=gen, device=obs.device)
    steer = torch.clamp(-0.5 * obs[0] + 2.0 * obs[6] + 1.0 * obs[8] + steer_noise * noise, -1.0, 1.0)
    slow = 3.6 * state.vehicle.speed[0] < 22.0
    throttle = torch.where(slow, torch.ones_like(steer), torch.full_like(steer, 0.1))
    return torch.stack([steer, throttle])[None]


def main(argv=None) -> int:
    """Collects the pairs; returns how many were saved."""
    params = build_parser().parse_args(argv)
    dev = resolve_device(params.device)
    os.makedirs(os.path.join(params.output_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(params.output_dir, "segmentation"), exist_ok=True)
    if params.manual:
        return _manual_collect(params, dev)

    cam = raster.CameraConfig()
    gen = make_generator(params.seed, dev)
    saved = 0
    track_idx = 0
    while saved < params.num_images:
        env_params = EnvParams(
            track=track_mod.make_lap_track(
                seed=params.seed + track_idx, props=bool(params.rich_scene), device=dev),
            spawn_pos_noise=0.8,
            spawn_yaw_noise=0.15,
            num_npcs=(params.num_npcs if params.rich_scene else 0),
        )
        track_idx = (track_idx + 1) % params.num_tracks
        state = lap_env.reset(env_params, gen, checkpoint_idx=0, batch=1)
        steps_this_track = min((params.num_images - saved) * params.save_every, TRACK_STEPS)
        for i in range(steps_this_track):
            action = drive_action(state, env_params, params.steer_noise, gen)
            state, _ = lap_env.autoreset_step(state, action, env_params, gen, obs_fn=None)
            if i % params.save_every == 0 and saved < params.num_images:
                rgb, seg = raster.render_rgb_and_semantic(state, env_params, cam, noise=gen)
                save_pair(rgb.cpu().numpy(), seg.cpu().numpy(), params.output_dir, saved)
                saved += 1
                if saved % 500 == 0:
                    print(f"saved {saved}/{params.num_images}", flush=True)
    print(f"done: {saved} pairs under {params.output_dir}")
    return saved


def _manual_collect(params, dev: torch.device) -> int:
    """Keyboard collection through the interactive lap env; SPACE toggles
    recording. Returns how many pairs were saved. pygame is initialised
    before the first event pump (the JAX collector pumps before its window
    exists, which pygame refuses unless something initialised it)."""
    import pygame
    from pygame.locals import K_ESCAPE, K_LEFT, K_RIGHT, K_SPACE, K_UP, K_a, K_d, K_w

    from carla_ppo_tpu_torch.envs.gym_api import CarlaLapEnv

    env = CarlaLapEnv(obs_res=(160, 80), device=dev)
    cam = raster.CameraConfig()
    recording = False
    saved = 0
    action = np.zeros(2, np.float32)
    gen = make_generator(params.seed, dev)
    print("Drive with WASD/arrows; SPACE toggles recording; ESC quits.")
    pygame.init()
    while saved < params.num_images:
        pygame.event.pump()
        keys = pygame.key.get_pressed()
        if keys[K_ESCAPE]:
            break
        if keys[K_SPACE]:
            recording = not recording
        action[0] = -0.5 if (keys[K_LEFT] or keys[K_a]) else (
            0.5 if (keys[K_RIGHT] or keys[K_d]) else 0.0)
        action[1] = 1.0 if (keys[K_UP] or keys[K_w]) else 0.0
        obs, _, done, info = env.step(action)
        if info["closed"]:
            break
        env.render()
        if recording:
            rgb, seg = raster.render_rgb_and_semantic(env.state, env.params, cam, noise=gen)
            save_pair(rgb.cpu().numpy(), seg.cpu().numpy(), params.output_dir, saved)
            saved += 1
        if done:
            env.reset()
    env.close()
    print(f"done: {saved} pairs under {params.output_dir}")
    return saved


if __name__ == "__main__":
    main(sys.argv[1:])
