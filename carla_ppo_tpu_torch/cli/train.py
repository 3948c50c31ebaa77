"""Train a PPO driving agent (CLI of the PyTorch / CUDA port).

The flags and defaults of carla_ppo_tpu/cli/train.py, plus `--device`
(default "cuda"; "cpu" must be asked for). `--num_episodes` counts training
iterations (one iteration = one rollout + update over the whole env batch).
`--record_eval 1` writes a video of one greedy episode after each eval
(models/<name>/videos/iteration<N>.avi). `--obs pixels` trains the pixel
agent with the joint VAE (config 4); its model computes in float32
whatever `--policy_dtype` says.

`--num_devices N` (N > 1; <= 0: every visible card) trains data parallel,
one rank per card (training/loop.py, parallel/): the command spawns the N
ranks itself and they meet on a localhost port, NCCL between cards, gloo
with `--device cpu` or where there are more ranks than cards. Under
torchrun (WORLD_SIZE in the environment) the command is one rank of the
launcher's group instead.

Examples:
  python -m carla_ppo_tpu_torch.cli.train --model_name lap_v0 --num_episodes 200
  python -m carla_ppo_tpu_torch.cli.train --model_name lap_latent \\
      --vae_model models/torch/vae_models/from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data
  python -m carla_ppo_tpu_torch.cli.train --model_name lap_rgb --vae_source rgb \\
      --vae_model models/torch/vae_models/seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data
  python -m carla_ppo_tpu_torch.cli.train --model_name traffic --num_npcs 4 --obs_fn vector_npc \\
      --reward_fn reward_traffic_add
  python -m carla_ppo_tpu_torch.cli.train --model_name pixel_turnkey --obs pixels --deprop_aux 1 \\
      --learning_rate 3e-4 --kl_target 0.015 --freeze_on_solve 2 \\
      --warm_start_vae models/torch/vae_models/from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data
  python -m carla_ppo_tpu_torch.cli.train --model_name lap_dp --num_devices 4
  torchrun --nproc_per_node 4 -m carla_ppo_tpu_torch.cli.train --model_name lap_dp --num_devices 4
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from carla_ppo_tpu_torch.parallel import mesh
from carla_ppo_tpu_torch.training import ppo
from carla_ppo_tpu_torch.training.loop import Trainer, TrainerSettings, check_ported, world_size_for


def bool_flag(v: str) -> bool:
    """argparse-friendly 0/1 boolean (named so errors read sensibly)."""
    return bool(int(v))


def schedule_flag(spec: str):
    """Parse "0:3e-4,800:1e-4" into ((0, 3e-4), (800, 1e-4)) - a
    piecewise-constant schedule keyed by iteration (PPOConfig.lr_schedule /
    entropy_schedule). Empty string = no schedule."""
    if not spec:
        return ()
    pairs = []
    for part in spec.split(","):
        start, value = part.split(":")
        pairs.append((int(start), float(value)))
    return tuple(sorted(pairs))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Trains a driving agent with PPO on the on-device simulator "
                    "(PyTorch / CUDA port)"
    )
    # PPO hyper parameters (reference: train.py:224-235).
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--lr_decay", type=float, default=1.0,
                        help="Per-iteration exponential learning rate decay")
    parser.add_argument("--discount_factor", type=float, default=0.99)
    parser.add_argument("--gae_lambda", type=float, default=0.95)
    parser.add_argument("--ppo_epsilon", type=float, default=0.2)
    parser.add_argument("--initial_std", type=float, default=1.0)
    parser.add_argument("--value_scale", type=float, default=1.0)
    parser.add_argument("--entropy_scale", type=float, default=0.01)
    parser.add_argument("--horizon", type=int, default=128)
    parser.add_argument("--num_epochs", type=int, default=3)
    parser.add_argument("--num_minibatches", type=int, default=4,
                        help="Minibatches per epoch (the batch-size analog)")
    parser.add_argument("--minibatch_axis", type=str, default="env",
                        choices=["env", "sample"],
                        help="Minibatch shuffling axis: 'env' permutes envs "
                             "(contiguous horizons - faster at large "
                             "batches), 'sample' reproduces the reference's "
                             "flat per-sample shuffle")
    parser.add_argument("--num_episodes", type=int, default=0,
                        help="Training iterations; <= 0 trains forever")
    parser.add_argument("--max_grad_norm", type=float, default=0.0,
                        help="Global gradient-norm clip; 0 disables "
                             "(the reference clips nothing)")
    parser.add_argument("--normalize_rewards", type=bool_flag,
                        default=False,
                        help="VecNormalize-style reward scaling (config 3)")
    parser.add_argument("--policy_dtype", type=str, default="mixed",
                        choices=["float32", "bfloat16", "mixed"],
                        help="Compute dtype of the policy/value MLP matmuls "
                             "and the frozen VAE encoder (params and the "
                             "distribution math stay float32). The default "
                             "'mixed' = bfloat16 rollout + float32 update; "
                             "a memory policy (--policy) runs float32")
    parser.add_argument("--policy", type=str, default="mlp",
                        help="The policy: 'mlp' (the 500/300 actor-critic) or "
                             "'granite-4.0-h-micro' (a memory policy: one "
                             "period of granite-4.0-h-micro, Mamba-2 and "
                             "attention, carried across env steps; float32, "
                             "one device, lap env, vector or latent obs)")

    parser.add_argument("--lr_schedule", type=schedule_flag, default=(),
                        help="Piecewise-constant lr by iteration, e.g. "
                             "'0:3e-4,800:1e-4' (overrides --learning_rate/"
                             "--lr_decay); encodes multi-phase recipes so a "
                             "solve needs no mid-run intervention")
    parser.add_argument("--kl_target", type=float, default=0.0,
                        help="trust-region early stop: skip the rest of an "
                        "iteration's updates once a minibatch's approx KL "
                        "exceeds this (0 = off; 0.02 is a good value for "
                        "the pixel config's post-solve stability)")
    parser.add_argument("--adv_snr_min", type=float, default=0.0,
                        help="advantage signal-to-noise gate: freeze a whole "
                        "iteration's updates when std(raw advantages)/"
                        "std(raw returns) drops below this (0 = off). On a "
                        "solved task the value function predicts returns "
                        "almost exactly, so this freezes training ON the "
                        "solved manifold and auto-resumes if performance "
                        "degrades (post-solve drift fix beyond --kl_target)")
    parser.add_argument("--freeze_on_solve", type=int, default=0,
                        help="after this many consecutive evals at "
                        ">= --solve_laps laps, freeze updates (rollout/eval "
                        "continue; an eval below the bar unfreezes). The "
                        "production post-solve stability mechanism (0 = off)")
    parser.add_argument("--solve_laps", type=float, default=3.0,
                        help="lap bar for --freeze_on_solve")
    parser.add_argument("--solve_metric", type=str, default="auto",
                        choices=["auto", "laps", "distance"],
                        help="metric for --freeze_on_solve: 'laps', "
                             "'distance' (>= --solve_distance; the route "
                             "config's 3000 m budget), or 'auto' (distance "
                             "for --env route, laps otherwise)")
    parser.add_argument("--solve_distance", type=float, default=2995.0,
                        help="distance bar (m) when the solve metric is "
                             "'distance'")
    parser.add_argument("--best_key", type=str, default="progress",
                        choices=["progress", "finished_first",
                                 "finished_overtakes"],
                        help="best-checkpoint ranking: 'progress' = (laps, "
                             "reward); 'finished_first' additionally ranks "
                             "evals whose episodes actually concluded above "
                             "eval-budget survivors (kills the slow-crawler "
                             "artifact on traffic configs); "
                             "'finished_overtakes' = (finished, laps, "
                             "overtakes, reward) - traffic configs, where "
                             "reward-as-tiebreaker prefers agents that pace "
                             "behind NPCs over agents that pass them")
    parser.add_argument("--reward_min_speed", type=float, default=None,
                        help="override RewardParams.min_speed (km/h; start "
                             "of the full-speed-reward plateau). Traffic "
                             "configs should put the plateau ABOVE NPC pace "
                             "or following the slowest NPC already earns "
                             "the maximum speed reward")
    parser.add_argument("--reward_target_speed", type=float, default=None,
                        help="override RewardParams.target_speed (km/h; end "
                             "of the plateau)")
    parser.add_argument("--reward_max_speed", type=float, default=None,
                        help="override RewardParams.max_speed (km/h; reward "
                             "goes negative beyond)")
    parser.add_argument("--pass_bonus", type=float, default=None,
                        help="override RewardParams.pass_bonus (reward per "
                             "completed overtake, reward_traffic_add)")
    parser.add_argument("--blocked_scale", type=float, default=None,
                        help="override RewardParams.blocked_scale: scale the "
                             "positive shaping terms while queued in-lane "
                             "behind an NPC within --block_range m "
                             "(reward_traffic_add; 1.0 = off). The "
                             "anti-pacing lever: ~0.25 makes passing the "
                             "only way to earn full per-step reward")
    parser.add_argument("--block_range", type=float, default=None,
                        help="override RewardParams.block_range (m ahead "
                             "that counts as blocked)")
    parser.add_argument("--low_speed_threshold", type=float, default=None,
                        help="override RewardParams.low_speed_threshold "
                             "(km/h; default 1.0): terminate whenever speed "
                             "drops below this after the 5 s grace period. "
                             "Traffic configs set it ABOVE --npc_max_speed "
                             "so cruising behind traffic ends the episode - "
                             "the structural fix for the pacing exploit "
                             "(additive per-step reward pays slow finishers "
                             "more; see TrainerSettings.low_speed_threshold)")
    parser.add_argument("--stall_timeout", type=float, default=0.0,
                        help="exit with code 17 when no iteration completes "
                             "for this many seconds (wedged-RPC recovery; "
                             "scripts/train_unattended.sh relaunches and "
                             "training auto-resumes). 0 = off. Use >= 1800 "
                             "on a cold compile cache")
    parser.add_argument("--junction_spawn_prob", type=float, default=0.0,
                        help="route env: probability a training reset spawns "
                             "just before a junction (failure-driven junction "
                             "curriculum; eval always spawns at route start)")
    parser.add_argument("--eval_envs", type=int, default=4,
                        help="parallel greedy-eval episodes per eval (more = "
                             "less spawn-draw noise in the solve/best "
                             "criteria at the same wall-clock)")
    parser.add_argument("--entropy_schedule", type=schedule_flag, default=(),
                        help="Piecewise-constant entropy scale by iteration, "
                             "e.g. '0:0.003,800:0.002'")
    parser.add_argument("--heldout_eval", type=int, default=1,
                        help="route/lap_bank: every Nth eval also evaluates "
                             "on never-trained worlds (eval_heldout/* = "
                             "fresh routes in the same town / unseen track "
                             "seeds; eval_unseen_town/* = a different town; "
                             "0 disables)")

    # Observation pipeline (reference: constructor injection, train.py:69-76).
    parser.add_argument("--obs", type=str, default=None,
                        choices=["vector", "latent", "pixels"],
                        help="Observation pipeline; default: latent when "
                             "--vae_model is given, else vector. 'pixels' "
                             "trains the conv policy end-to-end with the "
                             "joint-VAE auxiliary loss (config 4)")
    parser.add_argument("--vae_scale", type=float, default=1e-4,
                        help="pixels: joint-VAE auxiliary loss weight")
    parser.add_argument("--warm_start_vae", type=str, default=None,
                        help="pixels: VAE model dir to initialize the "
                             "encoder/z-heads/decoder from (fresh runs only)")
    parser.add_argument("--deprop_aux", type=bool_flag, default=False,
                        help="pixels: the VAE auxiliary loss reconstructs "
                             "the plain ground-only scene (props/NPCs "
                             "removed) instead of the rich input frame - "
                             "the joint-training analog of the de-prop VAE "
                             "(free: the target is an intermediate of the "
                             "same render)")

    # VAE parameters (reference: train.py:238-242).
    parser.add_argument("--vae_model", type=str, default=None,
                        help="Trained VAE model dir for latent observations")
    parser.add_argument("--vae_model_type", type=str, default=None)
    parser.add_argument("--vae_z_dim", type=int, default=None)
    parser.add_argument("--vae_source", type=str, default="seg",
                        choices=["seg", "rgb"])

    # Environment settings (reference: train.py:245-248).
    parser.add_argument("--env", type=str, default="lap",
                        choices=["lap", "route", "lap_bank"])
    parser.add_argument("--num_envs", type=int, default=1024)
    parser.add_argument("--num_devices", type=int, default=1,
                        help="Data-parallel ranks, one per card (spawned by "
                             "this command); <= 0 uses every visible card")
    parser.add_argument("--num_tracks", type=int, default=16,
                        help="lap_bank: domain-randomized tracks in the bank")
    parser.add_argument("--rich_scene", type=bool_flag, default=True,
                        help="Bake the 13-class roadside scene into rendered "
                             "observations (props affect cameras only)")
    parser.add_argument("--num_npcs", type=int, default=0,
                        help="NPC traffic vehicles per env; > 0 also enables "
                             "real collision termination")
    parser.add_argument("--npc_min_speed", type=float, default=4.0,
                        help="NPC cruise-speed range lower bound (m/s); "
                             "per-NPC speeds draw uniformly per episode")
    parser.add_argument("--npc_max_speed", type=float, default=7.0,
                        help="NPC cruise-speed range upper bound (m/s)")
    parser.add_argument("--npc_keep_lat", type=float, default=0.0,
                        help="NPC lane-keeping home lateral offset (m; "
                             "negative = right side). With --npc_keep_gain "
                             "> 0 NPC wander oscillates around this home "
                             "instead of free-walking across the road")
    parser.add_argument("--npc_keep_gain", type=float, default=0.0,
                        help="NPC lane-keeping spring rate (1/s; 0 = "
                             "round-4 free walk)")
    parser.add_argument("--obs_fn", type=str, default="vector",
                        choices=["vector", "vector_npc"],
                        help="Ground-truth vector obs variant: 'vector_npc' "
                             "appends radar-style nearest-NPC features "
                             "(required for a blind vector agent to drive "
                             "in traffic; the camera pipelines see NPCs "
                             "anyway)")
    parser.add_argument("--synchronous", type=int, default=True,
                        help="Accepted for parity; the simulator is always synchronous")
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--action_smoothing", type=float, default=0.0)
    parser.add_argument("--track_seed", type=int, default=0)
    parser.add_argument("-start_carla", action="store_true",
                        help="Accepted for parity; there is no server to start")

    # Training parameters (reference: train.py:251-264).
    parser.add_argument("--model_name", type=str, required=True)
    parser.add_argument("--reward_fn", type=str,
                        default="reward_speed_centering_angle_multiply")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval_interval", type=int, default=5)
    parser.add_argument("--record_eval", type=bool_flag, default=False,
                        help="Record greedy-eval videos to models/<name>/videos")
    parser.add_argument("-restart", action="store_true",
                        help="Delete existing model dir before training")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch "
                             "versions of the kernels (no silent fallback)")
    return parser


def main(argv=None) -> None:
    params = vars(build_parser().parse_args(argv))
    restart = params.pop("restart")
    device = params.pop("device")
    params.pop("start_carla", None)
    params.pop("synchronous", None)
    config, settings = build_configs(params)

    if "WORLD_SIZE" in os.environ:  # one rank of a torchrun group
        world = int(os.environ["WORLD_SIZE"])
        dp = mesh.init_from_env(device, _backend(device, world))
        if dp.is_main:
            _print_params(params)
        _run_rank(config, settings, restart, device, dp)
        return

    # Interactive continue/restart on an existing model dir (reference:
    # train.py:97-105 asks before appending to existing logs). Only when a
    # human is attached - non-TTY (scripts, tests) keeps the
    # auto-resume default, which is the behavior every recipe relies on.
    model_dir = os.path.join(TrainerSettings.models_root, params["model_name"])
    if not restart and os.path.isdir(model_dir) and sys.stdin.isatty():
        answer = input(
            f"Model dir {model_dir} exists. [C]ontinue training / "
            f"[r]estart from scratch / [a]bort? "
        ).strip().lower()
        if answer.startswith("r"):
            restart = True
        elif answer.startswith("a"):
            sys.exit(0)

    _print_params(params)
    world = world_size_for(settings, torch.device(device), None)
    if world <= 1:
        _train(config, settings, restart, device, None)
        return
    # Refuse before spawning anything.
    check_ported(settings, config)
    if config.num_envs % world:
        raise ValueError(f"num_envs={config.num_envs} not divisible by num_devices={world}")
    init_method = f"tcp://127.0.0.1:{mesh.free_port()}"
    torch.multiprocessing.start_processes(
        _spawned_rank, args=(world, init_method, config, settings, restart, device), nprocs=world,
        start_method="spawn")


def _print_params(params: dict) -> None:
    print("Training parameters:")
    for k, v in params.items():
        print(f"  {k}: {v}")


def _backend(device: str, world_size: int) -> str | None:
    """gloo where ranks share a card (NCCL refuses that), else the default."""
    if torch.device(device).type == "cuda" and world_size > torch.cuda.device_count():
        return "gloo"
    return None


def _spawned_rank(rank: int, world_size: int, init_method: str, config, settings, restart: bool,
                  device: str) -> None:
    dp = mesh.init(rank, world_size, init_method, device, _backend(device, world_size))
    _run_rank(config, settings, restart, device, dp)


def _run_rank(config, settings, restart: bool, device: str, dp: mesh.DataParallel) -> None:
    try:
        _train(config, settings, restart, device, dp)
    finally:
        mesh.destroy()


def _train(config, settings, restart: bool, device: str, dp) -> None:
    trainer = Trainer(settings, config, restart=restart, device=device, dp=dp)
    try:
        final = trainer.train()
        if trainer.is_main:
            print("Final metrics:")
            for k, v in sorted(final.items()):
                print(f"  {k}: {v:.4f}")
    finally:
        trainer.close()


def build_configs(params: dict):
    """(PPOConfig, TrainerSettings) from the parsed flags."""
    config = ppo.PPOConfig(
        learning_rate=params["learning_rate"],
        lr_decay=params["lr_decay"],
        discount_factor=params["discount_factor"],
        gae_lambda=params["gae_lambda"],
        ppo_epsilon=params["ppo_epsilon"],
        initial_std=params["initial_std"],
        value_scale=params["value_scale"],
        entropy_scale=params["entropy_scale"],
        horizon=params["horizon"],
        num_epochs=params["num_epochs"],
        num_envs=params["num_envs"],
        num_minibatches=params["num_minibatches"],
        minibatch_axis=params["minibatch_axis"],
        env_kind=params["env"],
        obs_fn=params["obs_fn"],
        max_grad_norm=params["max_grad_norm"],
        normalize_rewards=params["normalize_rewards"],
        lr_schedule=params["lr_schedule"],
        entropy_schedule=params["entropy_schedule"],
        kl_target=params["kl_target"],
        adv_snr_min=params["adv_snr_min"],
    )
    settings = TrainerSettings(
        model_name=params["model_name"],
        freeze_on_solve=params["freeze_on_solve"],
        solve_laps=params["solve_laps"],
        solve_metric=params["solve_metric"],
        solve_distance=params["solve_distance"],
        best_key=params["best_key"],
        stall_timeout_s=params["stall_timeout"],
        junction_spawn_prob=params["junction_spawn_prob"],
        heldout_eval=params["heldout_eval"],
        eval_envs=params["eval_envs"],
        num_iterations=params["num_episodes"],
        eval_interval=params["eval_interval"],
        record_eval=params["record_eval"],
        seed=params["seed"],
        track_seed=params["track_seed"],
        num_devices=params["num_devices"],
        num_tracks=params["num_tracks"],
        rich_scene=params["rich_scene"],
        num_npcs=params["num_npcs"],
        npc_min_speed=params["npc_min_speed"],
        npc_max_speed=params["npc_max_speed"],
        npc_keep_lat=params["npc_keep_lat"],
        npc_keep_gain=params["npc_keep_gain"],
        blocked_scale=params["blocked_scale"],
        block_range=params["block_range"],
        low_speed_threshold=params["low_speed_threshold"],
        reward_min_speed=params["reward_min_speed"],
        reward_target_speed=params["reward_target_speed"],
        reward_max_speed=params["reward_max_speed"],
        pass_bonus=params["pass_bonus"],
        fps=params["fps"],
        action_smoothing=params["action_smoothing"],
        reward_fn=params["reward_fn"],
        obs=params["obs"],
        vae_model=params["vae_model"],
        vae_model_type=params["vae_model_type"],
        vae_z_dim=params["vae_z_dim"],
        vae_source=params["vae_source"],
        vae_scale=params["vae_scale"],
        deprop_aux=params["deprop_aux"],
        warm_start_vae=params["warm_start_vae"],
        # the CLI's default "mixed" means float32 for a memory policy
        policy_dtype=("float32" if params["policy"] != "mlp" and params["policy_dtype"] == "mixed"
                      else params["policy_dtype"]),
        policy=params["policy"],
    )

    return config, settings


if __name__ == "__main__":
    main(sys.argv[1:])
