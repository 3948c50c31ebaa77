"""Evaluate a trained agent (CLI of the PyTorch / CUDA port).

The flags and defaults of carla_ppo_tpu/cli/run_eval.py, plus `--device`
(default "cuda") and `--eval_max_steps` (the metric pass's step cap, the
Trainer's 26,000 by default, as the JAX CLI uses). Loads the newest
checkpoint of models/<model_name> (`--checkpoint best`: of the best-eval
stream) and runs the vectorised greedy metric pass over `--num_envs` envs,
then, unless `--no_video`, records `--episodes` greedy episodes of up to
`--max_steps` steps through the interactive env to
models/<model_name>/videos/eval<i>.avi (Trainer.record_eval_video).

Examples (the converted shipped latent and pixel agents):
  python -m carla_ppo_tpu_torch.cli.run_eval --model_name torch/latent_agent \\
      --vae_model models/torch/vae_models/from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data \\
      --num_envs 8
  python -m carla_ppo_tpu_torch.cli.run_eval --model_name torch/pixel_turnkey --obs pixels \\
      --num_envs 8 --no_video
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

from carla_ppo_tpu_torch.training import ppo
from carla_ppo_tpu_torch.training.loop import Trainer, TrainerSettings


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Runs a trained agent (greedy)")
    parser.add_argument("--model_name", type=str, required=True,
                        help="Name of the model to run (under models/)")
    parser.add_argument("--env", type=str, default="lap", choices=["lap", "route"])
    parser.add_argument("--num_envs", type=int, default=16,
                        help="Vectorized eval envs for the metric pass")
    parser.add_argument("--episodes", type=int, default=1,
                        help="Video episodes to record")
    parser.add_argument("--no_video", action="store_true")
    parser.add_argument("--max_steps", type=int, default=3000,
                        help="Step cap of each video episode")
    parser.add_argument("--obs", type=str, default=None,
                        choices=["vector", "latent", "pixels"],
                        help="observation pipeline the agent was trained "
                             "with (default: latent when --vae_model is "
                             "given, else vector)")
    parser.add_argument("--vae_model", type=str, default=None)
    parser.add_argument("--vae_source", type=str, default="seg",
                        choices=["seg", "rgb"])
    parser.add_argument("--rich_scene", type=lambda v: bool(int(v)),
                        default=True)
    parser.add_argument("--track_seed", type=int, default=0)
    parser.add_argument("--num_npcs", type=int, default=0,
                        help="NPC traffic during eval (enables collision termination)")
    parser.add_argument("--obs_fn", type=str, default="vector",
                        help="ground-truth obs variant the agent was trained "
                             "with (vector | vector_npc)")
    parser.add_argument("--npc_keep_lat", type=float, default=0.0)
    parser.add_argument("--npc_keep_gain", type=float, default=0.0)
    # Reward-shape overrides are part of the agent's observation: the
    # vector obs normalises speed by reward.target_speed.
    parser.add_argument("--reward_min_speed", type=float, default=None)
    parser.add_argument("--reward_target_speed", type=float, default=None)
    parser.add_argument("--reward_max_speed", type=float, default=None)
    parser.add_argument("--low_speed_threshold", type=float, default=None,
                        help="km/h; the training floor, if any")
    parser.add_argument("--reward_fn", type=str,
                        default="reward_speed_centering_angle_multiply")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default="best",
                        choices=["best", "latest"],
                        help="'best' loads the newest entry of the best-eval "
                             "stream; 'latest' keeps the Trainer's resume "
                             "choice (newest across best+autosave)")
    parser.add_argument("--eval_max_steps", type=int,
                        default=TrainerSettings.eval_max_steps,
                        help="step cap of the vectorised metric pass")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch "
                             "versions of the kernels (no silent fallback)")
    return parser


def _has_checkpoint(model_dir: str) -> bool:
    """Any step dir under checkpoints/ or autosave/ (integer-named)."""
    for sub in ("checkpoints", "autosave"):
        d = os.path.join(model_dir, sub)
        if os.path.isdir(d) and any(e.isdigit() for e in os.listdir(d)):
            return True
    return False


def main(argv=None) -> Dict[str, float]:
    """Runs the metric pass and returns its metrics."""
    params = build_parser().parse_args(argv)
    os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

    # Validate before constructing the Trainer, which creates the model's
    # directories: a mistyped --model_name must leave nothing behind.
    model_dir = os.path.join(TrainerSettings.models_root, params.model_name)
    if not _has_checkpoint(model_dir):
        print(f"No checkpoint found under {model_dir}/checkpoints")
        sys.exit(1)

    settings = TrainerSettings(
        model_name=params.model_name,
        track_seed=params.track_seed,
        reward_fn=params.reward_fn,
        vae_model=params.vae_model,
        vae_source=params.vae_source,
        rich_scene=params.rich_scene,
        seed=params.seed,
        eval_envs=params.num_envs,
        eval_max_steps=params.eval_max_steps,
        num_npcs=params.num_npcs,
        npc_keep_lat=params.npc_keep_lat,
        npc_keep_gain=params.npc_keep_gain,
        reward_min_speed=params.reward_min_speed,
        reward_target_speed=params.reward_target_speed,
        reward_max_speed=params.reward_max_speed,
        low_speed_threshold=params.low_speed_threshold,
        obs=params.obs,
    )
    config = ppo.PPOConfig(env_kind=params.env, num_envs=params.num_envs,
                           obs_fn=params.obs_fn)
    trainer = Trainer(settings, config, device=params.device)  # restores the newest
    try:
        if trainer.checkpointer.latest_step() is None:
            print(f"No checkpoint found under {model_dir}/checkpoints")
            sys.exit(1)
        if params.checkpoint == "best":
            # The best-eval stream only grows on improvement, so its newest
            # entry is its highest scorer.
            best = trainer.checkpointer.restore_latest(trainer.train_state)
            if best is not None:
                trainer.train_state = best
                print(f"Loaded best-eval checkpoint (iteration {best.iteration})")
        metrics = trainer.evaluate()
        print("Vectorized greedy eval:")
        for k, v in sorted(metrics.items()):
            print(f"  {k}: {v:.3f}")
        if not params.no_video:
            for ep in range(params.episodes):
                video = os.path.join(trainer.video_dir, f"eval{ep}.avi")
                reward = trainer.record_eval_video(video, max_steps=params.max_steps)
                print(f"episode {ep}: reward={reward:.2f} video={video}")
    finally:
        trainer.close()
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
