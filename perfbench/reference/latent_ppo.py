"""Reference of the frozen-VAE latent PPO training cells.

It builds the track, the env batch, the VAE and the policy again from the
configuration and the benchmark's seeded weights, with the frozen plain
copies in reference/frozen (plain camera passes, no kernel), and follows
the program's first iterations: each rollout step renders, encodes and
evaluates the policy on its own env state and steps its own envs with the
action the program sampled (the program draws its action noise inside
ppo.rollout from its own generator, so the reference takes the program's
actions as the served tokens and checks their spread about its own mean
separately); the update takes the benchmark's minibatch permutations.

`follow` is also the control and the fault runs: with `actions=None` it
samples its own actions (noise from `generator`), so that it stands in
for the program, in TF32 (`tf32=True`) or with a fault planted.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.harness.compare import SampleMoment
from perfbench.harness.weights import load_into

from . import ppo_ref
from .ppo_ref import Record
from .frozen import lap_env, rasterizer, track
from .frozen.policy import ActorCritic, gaussian_log_prob
from .frozen.types import EnvParams
from .frozen.vae import VAE


def build(config: dict, weights: Optional[Dict[str, Dict[str, torch.Tensor]]], device: torch.device):
    """(env params, VAE, policy) of the reference, with `weights` loaded
    (None leaves the constructors' own)."""
    t = config["track"]
    params = EnvParams(track=track.make_lap_track(seed=t["seed"], props=t["props"], device=device))
    v = config["vae"]
    vae = VAE(source_shape=tuple(v["source_shape"]), z_dim=v["z_dim"],
              features=tuple(v["features"])).to(device).eval()
    p = config["policy"]
    model = ActorCritic(v["z_dim"] + len(p["measurements"]),
                        pi_hidden_sizes=tuple(p["pi_hidden_sizes"]),
                        vf_hidden_sizes=tuple(p["vf_hidden_sizes"]),
                        initial_std=config["ppo"]["initial_std"]).to(device)
    if weights is not None:
        load_into(vae, weights["vae"])
        load_into(model, weights["policy"])
    return params, vae, model


def observe(states, params, vae, cam) -> torch.Tensor:
    """z_mean(64) ++ [steer, throttle, speed] of every env."""
    frames = rasterizer.seg_to_obs(rasterizer.render_batch(states, params, cam))
    z = vae.encode(frames)
    return torch.cat([z, states.control[:, 0:1], states.control[:, 1:2],
                      states.vehicle.speed[:, None]], 1).to(torch.float32)


@torch.no_grad()
def rollout(model, vae, params, states, generator, horizon: int, cam,
            actions: Optional[torch.Tensor], moment: Optional[SampleMoment],
            noise_scale: float = 1.0):
    """(states, trajectory, bootstrap value, sampled actions)."""
    buf = {k: [] for k in ("obs", "actions", "log_probs", "values", "rewards", "dones")}
    obs = observe(states, params, vae, cam)
    for t in range(horizon):
        mean, std, value = model(obs)
        if actions is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
            action = torch.minimum(torch.maximum(mean + std * (noise_scale * noise), model.action_low),
                                   model.action_high)
        else:
            action = actions[t]
        if moment is not None:
            moment.add(action, mean, std, model.action_low, model.action_high)
        logp = gaussian_log_prob(action, mean, std)
        states, out = lap_env.autoreset_step(states, action, params, generator, obs_fn=None)
        for k, v in zip(buf, (obs, action, logp, value, out.reward, out.done.to(torch.float32))):
            buf[k].append(v)
        obs = observe(states, params, vae, cam)
    traj = {k: torch.stack(v) for k, v in buf.items()}
    return states, traj, model(obs)[2], traj["actions"]


def follow(config: dict, weights, perms: List[List[torch.Tensor]], device: torch.device,
           steps: int, actions: Optional[List[torch.Tensor]] = None,
           generator: Optional[torch.Generator] = None, moment: Optional[SampleMoment] = None,
           tf32: bool = False, fault: Optional[str] = None) -> Record:
    """Run `steps` iterations of the reference (see the module docstring)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        ppo = config["ppo"]
        params, vae, model = build(config, weights, device)
        cam = rasterizer.CameraConfig(**config["camera"])
        gen = generator if generator is not None else torch.Generator(device=device)
        states = lap_env.init_env_batch(params, ppo["num_envs"], gen)
        named = list(model.named_parameters())
        names = [n for n, _ in named]
        ps = [p for _, p in named]
        opt = ppo_ref.Adam.init(ps)
        params0 = {n: p.detach().clone() for n, p in named}
        rec = Record([], [], {}, params0, {})

        def loss_of(batch):
            mean, std, value = model(batch["obs"])
            return ppo_ref.clipped_surrogate(mean, std, value, batch, ppo)

        for k in range(steps):
            states, traj, boot, acts = rollout(
                model, vae, params, states, gen, ppo["horizon"], cam,
                None if actions is None else actions[k], moment,
                noise_scale=0.5 if fault == "noise" else 1.0)
            rec.actions.append(acts)
            loss, opt = ppo_ref.update(ps, opt, ppo["max_grad_norm"], loss_of, traj, boot, ppo, perms[k],
                                       fault=fault)
            rec.losses.append(loss)
            if k == 0:
                rec.mu1 = dict(zip(names, (m.clone() for m in opt.mu)))
        rec.params_end = {n: p.detach().clone() for n, p in named}
        return rec
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
