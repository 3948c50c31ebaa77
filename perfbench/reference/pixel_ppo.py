"""Reference of the pixel PPO training cells (the joint VAE, config 4).

It builds the track, the env batch and the PixelActorCritic again from the
configuration and the benchmark's seeded weights, with the frozen plain
copies in reference/frozen (plain camera passes, the ground-only frame of
the same render as the de-prop target, no recomputation), and follows the
program's first iterations: each rollout step renders its own env state,
evaluates the policy on it and steps its own envs with the action the
program took (teacher-forced, so that rounding cannot compound through
the policy; the benchmark hands both sides the same action noise, and the
program's actions are checked against clip(mean + std * noise) of the
reference); each update takes the benchmark's permutations and z noise,
and runs in blocks of rows with the gradients summed, so that the whole
minibatch's forward and backward fit beside nothing else.

`follow` with `actions=None` stands in for the program (the control, in
TF32, and the fault runs).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.harness.weights import load_into

from . import ppo_ref
from .ppo_ref import Record
from .frozen import lap_env, rasterizer, track
from .frozen.observations import measurements
from .frozen.pixel_policy import PixelActorCritic
from .frozen.policy import gaussian_entropy, gaussian_log_prob
from .frozen.types import EnvParams
from .frozen.vae import vae_loss

BLOCK_ROWS = 4096


def build(config: dict, weights: Optional[Dict[str, torch.Tensor]], device: torch.device):
    t = config["track"]
    params = EnvParams(track=track.make_lap_track(seed=t["seed"], props=t["props"], device=device))
    m = config["model"]
    model = PixelActorCritic(frame_shape=tuple(m["frame_shape"]), z_dim=m["z_dim"],
                             pi_hidden_sizes=tuple(m["pi_hidden_sizes"]),
                             vf_hidden_sizes=tuple(m["vf_hidden_sizes"]),
                             initial_std=config["ppo"]["initial_std"],
                             initial_mean_factor=m["initial_mean_factor"]).to(device)
    if weights is not None:
        load_into(model, weights)
    return params, model


def frames_input(frames: torch.Tensor) -> torch.Tensor:
    return frames.to(torch.float32)[..., None] / 12.0


def observe(states, params, cam):
    rich, ground = rasterizer.render_batch_with_ground(states, params, cam)
    return rich.to(torch.uint8), ground.to(torch.uint8), measurements(states)


@torch.no_grad()
def rollout(model, params, states, generator, horizon: int, cam, noise: torch.Tensor,
            actions: Optional[torch.Tensor], noise_scale: float = 1.0):
    """(states, trajectory, bootstrap value, worst |program action -
    clip(mean + std * noise)| or None)."""
    buf = {k: [] for k in ("frames", "target_frames", "measurements", "actions", "log_probs",
                           "values", "rewards", "dones")}
    gap = 0.0
    rich, ground, meas = observe(states, params, cam)
    for t in range(horizon):
        mean, std, value = model.policy_value(frames_input(rich), meas)
        sampled = torch.minimum(torch.maximum(mean + std * (noise_scale * noise[t]),
                                              model.policy.action_low), model.policy.action_high)
        if actions is None:
            action = sampled
        else:
            action = actions[t]
            gap = max(gap, float((action - sampled).abs().max()))
        logp = gaussian_log_prob(action, mean, std)
        buf["frames"].append(rich)
        buf["target_frames"].append(ground)
        buf["measurements"].append(meas)
        states, out = lap_env.autoreset_step(states, action, params, generator, obs_fn=None)
        for k, v in zip(("actions", "log_probs", "values", "rewards", "dones"),
                        (action, logp, value, out.reward, out.done.to(torch.float32))):
            buf[k].append(v)
        rich, ground, meas = observe(states, params, cam)
    traj = {k: torch.stack(v) for k, v in buf.items()}
    boot = model.policy_value(frames_input(rich), meas)[2]
    return states, traj, boot, (None if actions is None else gap)


def joint_loss(model, batch, z_noise, config):
    """(loss, approx KL) of a minibatch: PPO's clipped surrogate plus
    vae_scale x the beta-VAE loss of the ground-only target, summed over
    blocks of BLOCK_ROWS rows with backward per block (the gradients add
    up to the whole minibatch's)."""
    ppo, pix, m = config["ppo"], config["pixel"], config["model"]
    n = batch["actions"].shape[0]
    total = 0.0
    kl_sum = 0.0
    for r0 in range(0, n, BLOCK_ROWS):
        r1 = min(n, r0 + BLOCK_ROWS)
        w = (r1 - r0) / n
        frames = frames_input(batch["frames"][r0:r1])
        mean, std, value, aux = model(frames, batch["measurements"][r0:r1], z_noise[r0:r1])
        logp = gaussian_log_prob(batch["actions"][r0:r1], mean, std)
        log_ratio = logp - batch["log_probs"][r0:r1]
        ratio = torch.exp(log_ratio)
        adv = batch["advantages"][r0:r1]
        eps = ppo["ppo_epsilon"]
        policy = torch.mean(torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * adv))
        value_loss = torch.mean((value - batch["returns"][r0:r1]) ** 2) * ppo["value_scale"]
        entropy = torch.mean(gaussian_entropy(std)) * ppo["entropy_scale"]
        target = frames_input(batch["target_frames"][r0:r1]) if pix["deprop_aux"] else frames
        v_loss, _ = vae_loss(aux["recon_logits"], target, aux["z_mean"], aux["z_logstd_sq"],
                             pix["beta"], pix["kl_tolerance"], m["z_dim"], "bce")
        loss = (-policy + value_loss - entropy + pix["vae_scale"] * v_loss) * w
        loss.backward()
        total += float(loss.detach())
        kl_sum += float(torch.mean(ratio - 1.0 - log_ratio).detach()) * w
    return total, kl_sum


def update(model, opt, traj, boot, config, perms, z_noises, fault: Optional[str] = None,
           first: Optional[Dict[str, torch.Tensor]] = None):
    """The epochs of joint updates of both groups (policy, encoder), each
    clipped by its own global norm, with the KL guard; returns (mean loss,
    Adam states). `first`, where given, gets Adam's first moment of every
    leaf after the first update."""
    ppo, pix = config["ppo"], config["pixel"]
    named = list(model.named_parameters())
    groups = {"policy": [p for n, p in named if n.startswith("policy.")],
              "encoder": [p for n, p in named if not n.startswith("policy.")]}
    clip = {"policy": pix["policy_grad_norm"], "encoder": pix["encoder_grad_norm"]}
    params = [p for _, p in named]
    stop = False
    losses = []
    for u, batch in enumerate(ppo_ref.minibatches(traj, boot, ppo, perms)):
        z_noise = z_noises[u]
        if fault == "half":
            batch = ppo_ref.half(batch)
            z_noise = z_noise[: z_noise.shape[0] // 2]
        for p in params:
            p.grad = None
        loss, kl = joint_loss(model, batch, z_noise, config)
        losses.append(loss)
        if ppo["kl_target"] > 0:
            stop = stop or kl > ppo["kl_target"]
        new_opt = {}
        for g, ps in groups.items():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
            new_p, new_opt[g] = ppo_ref.clip_and_adam(ps, grads, opt[g], ppo, clip[g])
            if stop:
                new_opt[g] = opt[g]
            if first is not None and u == 0:
                names = {id(p): n for n, p in named}
                first.update({names[id(p)]: m.clone() for p, m in zip(ps, new_opt[g].mu)})
            if stop:
                continue
            with torch.no_grad():
                for p, q in zip(ps, new_p):
                    p.copy_(q)
        opt = new_opt
    for p in params:
        p.grad = None
    return sum(losses) / len(losses), opt


def follow(config: dict, weights, noises: List[dict], device: torch.device, steps: int,
           actions: Optional[List[torch.Tensor]] = None, generator=None, tf32: bool = False,
           fault: Optional[str] = None):
    """Run `steps` iterations (see the module docstring); `noises[k]` holds
    the benchmark's "action" [T, B, A] noise, "perms" and "z" draws of
    iteration k. Returns (Record, worst action gap)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        ppo = config["ppo"]
        params, model = build(config, weights, device)
        cam = rasterizer.CameraConfig(**config["camera"])
        gen = generator if generator is not None else torch.Generator(device=device)
        states = lap_env.init_env_batch(params, ppo["num_envs"], gen)
        named = list(model.named_parameters())
        groups = {"policy": [p for n, p in named if n.startswith("policy.")],
                  "encoder": [p for n, p in named if not n.startswith("policy.")]}
        opt = {g: ppo_ref.Adam.init(ps) for g, ps in groups.items()}
        rec = Record([], [], {}, {n: p.detach().clone() for n, p in named}, {})
        worst = 0.0
        for k in range(steps):
            states, traj, boot, gap = rollout(model, params, states, gen, ppo["horizon"], cam,
                                              noises[k]["action"], None if actions is None else actions[k],
                                              noise_scale=0.5 if fault == "noise" else 1.0)
            worst = max(worst, gap or 0.0)
            rec.actions.append(traj["actions"])
            loss, opt = update(model, opt, traj, boot, config, noises[k]["perms"], noises[k]["z"], fault,
                               first=rec.mu_first if k == 0 else None)
            rec.losses.append(loss)
            if k == 0:
                names = {g: [n for n, _ in named if n.startswith("policy.") == (g == "policy")] for g in groups}
                rec.mu1 = {n: m.clone() for g in groups for n, m in zip(names[g], opt[g].mu)}
        rec.params_end = {n: p.detach().clone() for n, p in named}
        return rec, worst
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
