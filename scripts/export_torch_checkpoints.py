#!/usr/bin/env python3
"""Convert the shipped JAX (orbax) checkpoints into the PyTorch port's format.

    JAX_PLATFORMS=cpu python scripts/export_torch_checkpoints.py [--out models/torch]
    JAX_PLATFORMS=cpu python scripts/export_torch_checkpoints.py --agent pixel_agent
    JAX_PLATFORMS=cpu python scripts/export_torch_checkpoints.py --reference_eval 6000 \
        [--agent latent_agent | rgb_latent | traffic_agent | pixel_turnkey | pixel_agent]
    JAX_PLATFORMS=cpu python scripts/export_torch_checkpoints.py --reference_video 1500 \
        [--agent latent_agent | route_latent | rgb_latent | pixel_turnkey]

Needs the JAX package and orbax (it reads the orbax checkpoints); the port
reads what it writes without either. For each agent the newest step
becomes `<out>/<name>/checkpoints/<step>/state.pt`: the ActorCritic
weights, the Adam moments and count, the counters and the reward moments,
through carla_ppo_tpu_torch.utils.convert.train_state_tree (the JAX PRNG key
is not carried over); a pixel agent through pixel_train_state_tree, its
optimizer's two groups (policy, encoder) as one Adam state each. The pixel
agents with their moments are ~35 MB each, so only `pixel_turnkey` is
converted by default; `--agent pixel_agent` converts the other one alone.
Each VAE's newest step becomes
`<out>/vae_models/<the JAX directory's name>/checkpoints/<step>/state.pt`,
the whole model (encoder, latent heads and decoder); the directory name
still carries the configuration that vae_common.parse_model_dir reads.

`--reference_eval STEPS` instead runs the JAX package's own greedy eval
(its Trainer.evaluate, as its cli.run_eval does) of one shipped agent
(`--agent`, see REFERENCES: the latent agent with the de-prop seg VAE, the
RGB latent agent with the rgb->de-prop VAE, the traffic agent under its
4-NPC lane-keeping traffic, or a pixel agent), capped at STEPS steps, on
the CPU, and writes the metrics with the command that made them to
`<out>/<agent>/reference_eval_<STEPS>.json`; chip_smoke.py holds the
port's drive of the converted agent against it.

`--reference_video STEPS` runs the JAX Trainer's record_eval_video of one
shipped agent instead: one greedy episode through its interactive env
(CarlaRouteEnv for route_latent, else CarlaLapEnv), capped at STEPS steps,
its frames written to a scratch video, headless. It writes the episode's
reward, distance, laps, step count, termination reason and, on the route
env, the route its reset drew, to `<out>/<agent>/reference_video_<STEPS>.json`
(chip_smoke.py `[video]` holds the port's episode against it).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from carla_ppo_tpu.envs.observations import vector_npc_obs_dim, vector_obs_dim  # noqa: E402
from carla_ppo_tpu.models import vae_common  # noqa: E402
from carla_ppo_tpu.models.pixel_policy import PixelActorCritic  # noqa: E402
from carla_ppo_tpu.models.policy import ActorCritic  # noqa: E402
from carla_ppo_tpu.training import pixels  # noqa: E402
from carla_ppo_tpu.training import ppo  # noqa: E402
from carla_ppo_tpu.utils.checkpoint import Checkpointer  # noqa: E402
from carla_ppo_tpu_torch.utils import checkpoint as torch_checkpoint  # noqa: E402
from carla_ppo_tpu_torch.utils import convert  # noqa: E402

LATENT_OBS_DIM = 67  # z64 ++ steer, throttle, speed
# (port name, shipped directory, observation width)
AGENTS = (
    ("latent_agent", "models/latent_agent_pretrained", LATENT_OBS_DIM),
    ("route_latent", "models/route_latent_pretrained", LATENT_OBS_DIM),
    ("lap_agent", "models/pretrained_agent", vector_obs_dim()),
    ("mixed_agent", "models/mixed_agent_pretrained", vector_obs_dim()),
    ("rgb_latent", "models/rgb_latent_pretrained", LATENT_OBS_DIM),
    ("traffic_agent", "models/traffic_agent_pretrained", vector_npc_obs_dim()),
)
# port name: shipped directory; only pixel_turnkey is converted by default
PIXEL_AGENTS = {"pixel_turnkey": "models/pixel_turnkey_pretrained",
                "pixel_agent": "models/pixel_agent_pretrained"}
COMMITTED_PIXEL_AGENTS = ("pixel_turnkey",)
DEPROP_VAE = "from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data"
RGB_DEPROP_VAE = "seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data"  # rgb source
VAES = (DEPROP_VAE, "seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_data", RGB_DEPROP_VAE,
        "rgb_bce_cnn_zdim64_beta1_kl_tolerance0.0_data",
        "from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_data")
# The traffic agent's NPC and reward-shape flags (README, its quality row).
TRAFFIC_SETTINGS = dict(num_npcs=4, npc_keep_lat=-0.5, npc_keep_gain=1.0, reward_min_speed=30.0,
                        reward_target_speed=38.0, reward_max_speed=55.0, low_speed_threshold=29.0)
# agent: (shipped directory, eval envs, VAE or None, TrainerSettings fields, PPOConfig fields)
REFERENCES = {
    "latent_agent": ("models/latent_agent_pretrained", 8, DEPROP_VAE, {}, {}),
    "rgb_latent": ("models/rgb_latent_pretrained", 8, RGB_DEPROP_VAE, {"vae_source": "rgb"}, {}),
    "traffic_agent": ("models/traffic_agent_pretrained", 16, None, TRAFFIC_SETTINGS,
                      {"obs_fn": "vector_npc"}),
    **{name: (src, 8, None, {"obs": "pixels"}, {}) for name, src in PIXEL_AGENTS.items()},
    "route_latent": ("models/route_latent_pretrained", 8, DEPROP_VAE, {}, {"env_kind": "route"}),
}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def restore_agent(src: str, obs_dim: int):
    """(step, JAX TrainState) of the newest checkpoint under `src`."""
    template = ppo.create_train_state(ActorCritic(), ppo.PPOConfig(), obs_dim,
                                      jax.random.PRNGKey(0))
    ck = Checkpointer(os.path.join(REPO, src, "checkpoints"))
    step = ck.latest_step()
    state = ck.restore(step, template)
    ck.close()
    return step, state


def agent_tree(state) -> dict:
    """The port's checkpoint tree of a restored JAX TrainState."""
    # optax.chain(clip_by_global_norm, adam): opt_state[1] is adam's
    # (ScaleByAdamState, ScaleByScheduleState); both count the updates.
    adam, schedule = state.opt_state[1]
    if int(adam.count) != int(schedule.count):
        raise ValueError(f"adam count {int(adam.count)} != schedule count {int(schedule.count)}")
    return convert.train_state_tree(
        np_tree(state.params),
        {"count": np.asarray(adam.count), "mu": np_tree(adam.mu), "nu": np_tree(adam.nu)},
        {k: np.asarray(getattr(state, k))
         for k in ("iteration", "train_step", "total_env_steps", "episodes_done")},
        {k: np.asarray(getattr(state.reward_norm, k)) for k in ("mean", "var", "count")},
    )


def restore_pixel_agent(src: str):
    """(step, JAX TrainState) of a shipped pixel agent's newest checkpoint."""
    template = pixels.create_pixel_train_state(PixelActorCritic(), ppo.PPOConfig(),
                                               jax.random.PRNGKey(0))
    ck = Checkpointer(os.path.join(REPO, src, "checkpoints"))
    step = ck.latest_step()
    state = ck.restore(step, template)
    ck.close()
    return step, state


def pixel_agent_tree(state) -> dict:
    """The port's checkpoint tree of a restored JAX pixel TrainState.

    The optax multi_transform state holds, per group, a MaskedState over
    (the clip's EmptyState, (ScaleByAdamState, ScaleByScheduleState)); the
    group's moments carry MaskedNode leaves where a parameter belongs to the
    other group, which are dropped here by top-level name."""
    adams = {}
    for group, masked in state.opt_state.inner_states.items():
        adam, schedule = masked.inner_state[1]
        if int(adam.count) != int(schedule.count):
            raise ValueError(f"{group}: adam count {int(adam.count)} != schedule count "
                             f"{int(schedule.count)}")
        policy = group == "policy"
        adams[group] = {"count": np.asarray(adam.count), **{
            m: np_tree({k: v for k, v in getattr(adam, m)["params"].items()
                        if (k in convert.PIXEL_POLICY_TOPLEVEL) == policy})
            for m in ("mu", "nu")}}
    return convert.pixel_train_state_tree(
        np_tree(state.params), adams,
        {k: np.asarray(getattr(state, k))
         for k in ("iteration", "train_step", "total_env_steps", "episodes_done")},
        {k: np.asarray(getattr(state.reward_norm, k)) for k in ("mean", "var", "count")},
    )


def export_pixel_agent(out: str, name: str) -> None:
    src = PIXEL_AGENTS[name]
    step, state = restore_pixel_agent(src)
    torch_checkpoint.Checkpointer(os.path.join(out, name, "checkpoints")).save(
        step, pixel_agent_tree(state))
    print(f"{src} step {step} -> {out}/{name}", flush=True)


def vae_tree(name: str):
    """(step, the port's checkpoint tree) of a shipped VAE's newest step."""
    src = os.path.join(REPO, "vae", "models", name)
    model, variables = vae_common.load_vae(src)
    ck = Checkpointer(os.path.join(src, "checkpoints"))
    step = ck.latest_step()
    ck.close()
    sd = convert.vae_state_dict(np_tree(variables), model.source_shape, model.model_type)
    return step, {"model": sd}


def export(out: str) -> None:
    for name, src, obs_dim in AGENTS:
        step, state = restore_agent(src, obs_dim)
        torch_checkpoint.Checkpointer(os.path.join(out, name, "checkpoints")).save(
            step, agent_tree(state))
        print(f"{src} step {step} -> {out}/{name}", flush=True)
    for name in COMMITTED_PIXEL_AGENTS:
        export_pixel_agent(out, name)
    for name in VAES:
        step, tree = vae_tree(name)
        torch_checkpoint.Checkpointer(os.path.join(out, "vae_models", name, "checkpoints")).save(
            step, tree)
        print(f"vae/models/{name} step {step} -> {out}/vae_models/{name}", flush=True)


def _reference_trainer(tmp: str, agent: str, steps: int):
    """A JAX Trainer of one shipped agent on a scratch copy of its newest
    checkpoint (the shipped directory is not written to)."""
    from carla_ppo_tpu.training.loop import Trainer, TrainerSettings

    src_dir, envs, vae, settings_kw, config_kw = REFERENCES[agent]
    src = os.path.join(REPO, src_dir, "checkpoints")
    step = Checkpointer(src).latest_step()
    vae_path = None if vae is None else os.path.join(REPO, "vae/models", vae)
    shutil.copytree(os.path.join(src, str(step)), os.path.join(tmp, agent, "checkpoints", str(step)))
    settings = TrainerSettings(
        model_name=agent, models_root=tmp, eval_envs=envs, eval_max_steps=steps,
        vae_model=vae_path, **settings_kw,
    )
    return Trainer(settings, ppo.PPOConfig(num_envs=envs, **config_kw)), step


def reference_eval(out: str, agent: str, steps: int, command: str) -> dict:
    """The JAX package's greedy eval of one shipped agent, the way its
    cli.run_eval runs it."""
    src_dir, envs, vae, settings_kw, config_kw = REFERENCES[agent]
    with tempfile.TemporaryDirectory() as tmp:
        trainer, step = _reference_trainer(tmp, agent, steps)
        t0 = time.perf_counter()
        metrics = trainer.evaluate()
        seconds = time.perf_counter() - t0
        trainer.close()
    result = {
        "command": command,
        "agent": src_dir, "step": int(step),
        "vae_model": None if vae is None else f"vae/models/{vae}",
        "settings": settings_kw, "config": config_kw,
        "num_envs": envs, "max_steps": steps, "device": jax.devices()[0].platform,
        "seconds": seconds, "metrics": metrics,
    }
    os.makedirs(os.path.join(out, agent), exist_ok=True)
    path = os.path.join(out, agent, f"reference_eval_{steps}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {path}: " + json.dumps(result["metrics"]), flush=True)
    return result


def reference_video(out: str, agent: str, steps: int, command: str) -> dict:
    """The JAX Trainer's record_eval_video of one shipped agent (headless
    pygame, the video to a scratch file): the episode's outcome."""
    os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
    from carla_ppo_tpu.envs.gym_api import CarlaLapEnv

    src_dir, _, vae, settings_kw, config_kw = REFERENCES[agent]
    drawn = {}
    real_reset = CarlaLapEnv.reset

    def reset(self, *args, **kwargs):
        obs = real_reset(self, *args, **kwargs)
        drawn["route_id"] = int(self.state.route_id)
        return obs

    CarlaLapEnv.reset = reset
    try:
        with tempfile.TemporaryDirectory() as tmp:
            trainer, step = _reference_trainer(tmp, agent, steps)
            t0 = time.perf_counter()
            reward = trainer.record_eval_video(os.path.join(tmp, "episode.avi"), max_steps=steps)
            seconds = time.perf_counter() - t0
            env = trainer._video_env
            s = env.state
            episode = {
                "env": type(env).__name__, "route_id": drawn["route_id"], "reward": float(reward),
                "distance_traveled": float(s.distance_traveled),
                "laps_completed": float(s.laps_completed), "step_count": int(s.step_count),
                "termination_reason": int(s.termination_reason),
                "num_routes_completed": int(s.num_routes_completed),
            }
            trainer.close()
    finally:
        CarlaLapEnv.reset = real_reset
    result = {
        "command": command, "agent": src_dir, "step": int(step),
        "vae_model": None if vae is None else f"vae/models/{vae}",
        "settings": settings_kw, "config": config_kw, "max_steps": steps,
        "device": jax.devices()[0].platform, "seconds": seconds, "episode": episode,
    }
    os.makedirs(os.path.join(out, agent), exist_ok=True)
    path = os.path.join(out, agent, f"reference_video_{steps}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {path}: " + json.dumps(episode), flush=True)
    return result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(REPO, "models", "torch"))
    parser.add_argument("--reference_eval", type=int, default=0,
                        help="steps of the JAX greedy-eval reference (0: convert instead)")
    parser.add_argument("--reference_video", type=int, default=0,
                        help="steps of the JAX record_eval_video reference (0: none)")
    parser.add_argument("--agent", default=None, choices=sorted(REFERENCES),
                        help="the agent of --reference_eval / --reference_video (default "
                             "latent_agent); without either, a pixel agent to convert alone")
    args = parser.parse_args(argv)
    if jax.default_backend() != "cpu":
        raise SystemExit("run on the CPU backend (JAX_PLATFORMS=cpu)")
    if args.reference_video > 0:
        agent = args.agent or "latent_agent"
        command = ("JAX_PLATFORMS=cpu python scripts/export_torch_checkpoints.py "
                   f"--reference_video {args.reference_video}")
        if agent != "latent_agent":
            command += f" --agent {agent}"
        reference_video(args.out, agent, args.reference_video, command)
    elif args.reference_eval > 0:
        agent = args.agent or "latent_agent"
        command = ("JAX_PLATFORMS=cpu python scripts/export_torch_checkpoints.py "
                   f"--reference_eval {args.reference_eval}")
        if agent != "latent_agent":
            command += f" --agent {agent}"
        reference_eval(args.out, agent, args.reference_eval, command)
    elif args.agent is not None:
        if args.agent not in PIXEL_AGENTS:
            raise SystemExit(f"--agent {args.agent} alone converts a pixel agent "
                             f"({', '.join(PIXEL_AGENTS)}); the others come with the default run")
        export_pixel_agent(args.out, args.agent)
    else:
        export(args.out)


if __name__ == "__main__":
    main()
