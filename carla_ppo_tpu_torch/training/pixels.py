"""End-to-end pixel PPO with the joint VAE, config 4 (port of
carla_ppo_tpu/training/pixels.py).

The camera renders seg frames (the ground-pass and composite kernels on
the card), the conv encoder of models/pixel_policy.PixelActorCritic reads
them, and the update minimises PPO's clipped surrogate plus
`vae_scale` x the beta-VAE loss on the same minibatch frames. Rollout frames
are stored as uint8 class ids [T, B, H, W] (1.68 GB at T=128, B=1024) and
scaled by 1/12 per minibatch; with `deprop_aux` the ground-only frames the
same render makes before the billboard composite are stored beside them as
the reconstruction target.

The optimizer has two groups, as the JAX package's optax multi_transform:
the policy group (the ActorCritic under `policy.`) and the encoder group
(encoder, z heads, decoder), each clipped by its own global norm and then
stepped by its own Adam on the shared learning-rate schedule
(ppo.clip_and_adam). The KL guard, the advantage-SNR gate and the
solve-aware freeze select over both groups at once, branch-free.

Randomness comes from the train state's torch.Generators: the rollout's
action noise from `generator`, each epoch's permutation and each
minibatch's z noise from `update_generator` (the same on every rank under
data parallel, `dp`, where the update averages both groups' gradients
over the ranks before their clips, as training/ppo.py does). The parity
tests inject the JAX package's draws (`noise`, `perms`, `noises`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs.observations import measurements
from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState
from carla_ppo_tpu_torch.models.pixel_policy import PixelActorCritic
from carla_ppo_tpu_torch.models.policy import gaussian_entropy, gaussian_log_prob
from carla_ppo_tpu_torch.models.vae import VAE, vae_loss
from carla_ppo_tpu_torch.ops import gae, rasterizer
from carla_ppo_tpu_torch.ops.running_stats import RunningMoments
from carla_ppo_tpu_torch.parallel.mesh import DataParallel
from carla_ppo_tpu_torch.training import ppo
from carla_ppo_tpu_torch.training.ppo import AdamState, PPOConfig
from carla_ppo_tpu_torch.utils import profiling

GROUPS = ("policy", "encoder")


@dataclasses.dataclass(frozen=True)
class PixelConfig:
    """Knobs on top of PPOConfig; the JAX PixelConfig's fields and defaults."""

    vae_scale: float = 1e-4  # weight of the VAE loss against the PPO loss
    beta: float = 1.0
    kl_tolerance: float = 0.0
    cam: rasterizer.CameraConfig = rasterizer.CameraConfig()
    # Each group's global-norm clip; <= 0 disables it.
    policy_grad_norm: float = 0.5
    encoder_grad_norm: float = 5.0
    # Reconstruct the ground-only frame (props and NPCs removed) from the
    # rich input frame, instead of the input itself.
    deprop_aux: bool = False

    def clip_norm(self, group: str) -> float:
        return self.policy_grad_norm if group == "policy" else self.encoder_grad_norm


def param_groups(model: PixelActorCritic) -> Dict[str, List[Tuple[str, torch.nn.Parameter]]]:
    """(name, parameter) pairs of each optimizer group, in model order."""
    groups: Dict[str, list] = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        groups["policy" if name.startswith("policy.") else "encoder"].append((name, p))
    return groups


@dataclasses.dataclass
class PixelTrainState(ppo.TrainState):
    """ppo.TrainState with one Adam state per optimizer group."""

    model: PixelActorCritic
    opt_state: Dict[str, AdamState]

    def opt_tree(self) -> Dict[str, Any]:
        groups = param_groups(self.model)
        return {g: ppo.adam_tree(self.opt_state[g], [n for n, _ in groups[g]]) for g in GROUPS}

    def opt_from_tree(self, tree: Dict[str, Any], model: torch.nn.Module) -> Dict[str, AdamState]:
        dev = next(model.parameters()).device
        groups = param_groups(model)
        return {g: ppo.adam_from_tree(tree[g], [n for n, _ in groups[g]], dev) for g in GROUPS}


def create_pixel_train_state(model: PixelActorCritic, config: PPOConfig,
                             generator: torch.Generator) -> PixelTrainState:
    groups = param_groups(model)
    dev = next(model.parameters()).device
    return PixelTrainState(
        model=model,
        opt_state={g: ppo.adam_init([p for _, p in groups[g]]) for g in GROUPS},
        iteration=0, train_step=0, total_env_steps=0.0, episodes_done=0,
        generator=generator, reward_norm=RunningMoments.create(dev),
    )


@dataclasses.dataclass
class PixelTrajectory:
    frames: Tensor  # [T, B, H, W] uint8 class ids
    measurements: Tensor  # [T, B, 3]
    actions: Tensor
    log_probs: Tensor
    values: Tensor
    rewards: Tensor
    dones: Tensor
    target_frames: Optional[Tensor] = None  # [T, B, H, W] uint8 ground-only (deprop_aux)


def frames_input(frames: Tensor) -> Tensor:
    """uint8 class ids [..., H, W] -> the model's [..., H, W, 1] float input."""
    return frames.to(torch.float32)[..., None] / 12.0


def render_and_measure(states: EnvState, params: EnvParams,
                       cam: rasterizer.CameraConfig) -> Tuple[Tensor, Tensor, Tensor]:
    """(rich frames, ground-only frames) [B, H, W] int32 and measurements
    [B, 3], on the shared track or a bank alike."""
    rich, ground = rasterizer.render_batch_with_ground(states, params, cam)
    return rich, ground, measurements(states)


@torch.no_grad()
def pixel_rollout(
    model: PixelActorCritic,
    env_states: EnvState,
    env_params: EnvParams,
    generator: torch.Generator,
    config: PPOConfig,
    pix: PixelConfig,
    noise: Tensor | None = None,
) -> Tuple[EnvState, PixelTrajectory, Tensor, Dict[str, Tensor]]:
    """`config.horizon` steps of policy + env; returns (env_states,
    trajectory, bootstrap value, episodic metrics). `noise` ([T, B, A]
    standard normal) replaces the generator's action draws."""
    with profiling.span("rollout"):
        env = ppo.ENV_KINDS[config.env_kind]
        T, B = config.horizon, env_states.batch_size
        dev = env_states.vehicle.pos.device
        frames = torch.empty((T + 1, B, pix.cam.height, pix.cam.width), dtype=torch.uint8, device=dev)
        targets = torch.empty_like(frames) if pix.deprop_aux else None
        meas = torch.empty((T + 1, B, 3), device=dev)

        def observe(t: int, states: EnvState) -> None:
            rich, ground, m = render_and_measure(states, env_params, pix.cam)
            frames[t].copy_(rich)
            if targets is not None:
                targets[t].copy_(ground)
            meas[t] = m

        keys = ("actions", "log_probs", "values", "rewards", "dones")
        buf: Dict[str, list] = {k: [] for k in keys}
        ep: Dict[str, list] = {k: [] for k in ("done", "rew", "dist", "laps")}
        observe(0, env_states)
        for t in range(T):
            action, logp, value = model.act(frames_input(frames[t]), meas[t], generator,
                                            noise=None if noise is None else noise[t])
            env_states, out = env.autoreset_step(env_states, action, env_params, generator, obs_fn=None)
            done = out.done.to(torch.float32)
            for k, v in zip(keys, (action, logp, value, out.reward, done)):
                buf[k].append(v)
            for k, v in zip(ep, (done, out.total_reward, out.distance_traveled, out.laps_completed)):
                ep[k].append(v)
            observe(t + 1, env_states)
        bootstrap = model.policy_value(frames_input(frames[T]), meas[T])[2]
        traj = PixelTrajectory(frames=frames[:T], measurements=meas[:T],
                               target_frames=None if targets is None else targets[:T],
                               **{k: torch.stack(v) for k, v in buf.items()})
        e = {k: torch.stack(v) for k, v in ep.items()}
        n_done = torch.clamp(e["done"].sum(), min=1.0)
        episodic = {
            "train/reward": (e["rew"] * e["done"]).sum() / n_done,
            "train/distance_traveled": (e["dist"] * e["done"]).sum() / n_done,
            "train/laps_completed": (e["laps"] * e["done"]).sum() / n_done,
            "train/episodes_finished": e["done"].sum(),
        }
        return env_states, traj, bootstrap, episodic


def pixel_loss(
    model: PixelActorCritic,
    batch: Dict[str, Tensor],
    config: PPOConfig,
    pix: PixelConfig,
    noise: Tensor | torch.Generator | None,
    entropy_scale: Tensor | float | None = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """PPO's clipped loss plus pix.vae_scale x the beta-VAE loss (BCE
    reconstruction of the input frame, or of the ground-only target with
    deprop_aux) on one flat minibatch; the JAX package's metric set."""
    if entropy_scale is None:
        entropy_scale = config.entropy_scale
    frames = frames_input(batch["frames"])
    mean, std, value, aux = model(frames, batch["measurements"], noise)
    logp = gaussian_log_prob(batch["actions"], mean, std)
    log_ratio = logp - batch["log_probs"]
    ratio = torch.exp(log_ratio)
    adv = batch["advantages"]
    eps = config.ppo_epsilon
    policy_loss = torch.mean(torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * adv))
    value_loss = torch.mean((value - batch["returns"]) ** 2) * config.value_scale
    entropy_loss = torch.mean(gaussian_entropy(std)) * entropy_scale
    total = -policy_loss + value_loss - entropy_loss

    def d(x: Tensor) -> Tensor:
        return x.detach()

    metrics = {
        "train_loss/policy": d(policy_loss),
        "train_loss/value": d(value_loss),
        "train_loss/entropy": d(entropy_loss),
        "train/prob_ratio": d(ratio.mean()),
        "train/approx_kl": d(torch.mean(ratio - 1.0 - log_ratio)),
        "train/ratio_max": d(ratio.max()),
        "train/value_mean": d(value.mean()),
        "train/value_abs_max": d(value.abs().max()),
        "train/action_std_min": d(std.min()),
    }
    if model.decoder is not None:
        target = frames
        if batch.get("target_frames") is not None:
            target = frames_input(batch["target_frames"])
        v_loss, v_metrics = vae_loss(aux["recon_logits"], target, aux["z_mean"], aux["z_logstd_sq"],
                                     pix.beta, pix.kl_tolerance, model.z_dim, "bce")
        total = total + pix.vae_scale * v_loss
        metrics["train_loss/vae_recon"] = d(v_metrics["reconstruction_loss"])
        metrics["train_loss/vae_kl"] = d(v_metrics["kl_loss"])
    metrics["train_loss/loss"] = d(total)
    return total, metrics


def pixel_update(
    train_state: PixelTrainState,
    traj: PixelTrajectory,
    bootstrap: Tensor,
    config: PPOConfig,
    pix: PixelConfig,
    freeze: Tensor | None = None,
    perms: Sequence[Tensor] | None = None,
    noises: Sequence[Tensor] | None = None,
    dp: DataParallel | None = None,
) -> Dict[str, Tensor]:
    """GAE + the epochs of minibatch updates of both groups, applied to
    train_state in place; returns the metrics averaged over the updates.
    `perms` (one per epoch) and `noises` (one [minibatch, z_dim] draw per
    update, in update order) replace the update generator's draws. Under
    `dp`, `traj` is this rank's slice."""
    with profiling.span("update"):
        model = train_state.model
        with profiling.span("update.gae"):
            advantages = gae.compute_gae(traj.rewards, traj.values, bootstrap, traj.dones,
                                         config.discount_factor, config.gae_lambda)
            returns = advantages + traj.values
            adv_snr, stop = ppo.adv_snr_gate(advantages, returns, config, dp)
            if freeze is not None:
                stop = stop | freeze
            if config.normalize_advantage:
                advantages = ppo.normalize_advantages(advantages, dp)

        T, B = traj.rewards.shape
        fields = {"frames": traj.frames, "measurements": traj.measurements, "actions": traj.actions,
                  "log_probs": traj.log_probs, "returns": returns, "advantages": advantages}
        if traj.target_frames is not None:
            fields["target_frames"] = traj.target_frames
        # env-axis minibatches (contiguous horizons of permuted envs), else a
        # flat per-sample shuffle, as ppo_update
        env_axis = config.minibatch_axis == "env" and B % config.num_minibatches == 0
        if env_axis:
            data = {k: v.transpose(0, 1) for k, v in fields.items()}
            perm_size = B
        else:
            data = {k: v.reshape((T * B,) + tuple(v.shape[2:])) for k, v in fields.items()}
            perm_size = T * B

        ent_scale = ppo.schedule_value(
            config.entropy_schedule, config.entropy_scale,
            torch.tensor(train_state.iteration, device=bootstrap.device),
        )
        groups = {g: [p for _, p in named] for g, named in param_groups(model).items()}
        opt = train_state.opt_state
        gated = config.kl_target > 0 or config.adv_snr_min > 0 or freeze is not None
        all_metrics: List[Dict[str, Tensor]] = []
        update = 0
        for epoch in range(config.num_epochs):
            perm = perms[epoch] if perms is not None else torch.randperm(
                perm_size, generator=train_state.update_generator, device=bootstrap.device)
            for idx in perm.reshape(config.num_minibatches, -1):
                if env_axis:
                    batch = {k: v[idx].reshape((-1,) + tuple(v.shape[2:])) for k, v in data.items()}
                else:
                    batch = {k: v[idx] for k, v in data.items()}
                noise = noises[update] if noises is not None else train_state.update_generator
                update += 1
                for p in model.parameters():
                    p.grad = None
                with profiling.span("update.loss"):
                    loss, metrics = pixel_loss(model, batch, config, pix, noise, ent_scale)
                with profiling.span("update.backward"):
                    loss.backward()
                del loss, batch
                flat = [p.grad if p.grad is not None else torch.zeros_like(p) for p in model.parameters()]
                flat, metrics = ppo.reduce_grads_and_metrics(flat, metrics, dp)
                grads_of = dict(zip(model.parameters(), flat))
                new_params, new_opt = {}, {}
                with profiling.span("update.adam"):
                    for g, params in groups.items():
                        grads = [grads_of[p] for p in params]
                        metrics[f"train_grad/{g}_norm"] = ppo.global_norm(grads).detach()
                        new_params[g], new_opt[g] = ppo.clip_and_adam(params, grads, opt[g], config,
                                                                      clip_norm=pix.clip_norm(g))
                    if gated:
                        if config.kl_target > 0:
                            stop = stop | (metrics["train/approx_kl"] > config.kl_target)
                        keep = ~stop
                        for g, params in groups.items():
                            new_params[g] = ppo.select_each(keep, new_params[g], params)
                            new_opt[g] = ppo.select_adam(keep, new_opt[g], opt[g])
                        metrics["train/update_skipped"] = 1.0 - keep.to(torch.float32)
                    with torch.no_grad():
                        for g, params in groups.items():
                            for p, q in zip(params, new_params[g]):
                                p.copy_(q)
                opt = new_opt
                all_metrics.append(metrics)
        for p in model.parameters():
            p.grad = None
        train_state.opt_state = opt
        mean_metrics = {k: torch.stack([m[k] for m in all_metrics]).mean() for k in all_metrics[0]}
        if config.adv_snr_min > 0:
            mean_metrics["train/adv_snr"] = adv_snr
        return mean_metrics


def pixel_train_iteration(
    train_state: PixelTrainState,
    env_states: EnvState,
    env_params: EnvParams,
    config: PPOConfig,
    pix: PixelConfig = PixelConfig(),
    freeze: Tensor | None = None,
    dp: DataParallel | None = None,
    noise: Tensor | None = None,
    perms: Sequence[Tensor] | None = None,
    noises: Sequence[Tensor] | None = None,
) -> Tuple[PixelTrainState, EnvState, Dict[str, Tensor]]:
    """One pixel-PPO iteration: rollout -> GAE -> epochs of joint updates;
    updates train_state in place and returns (train_state, env_states,
    metrics). Rewards are used as they come (the JAX pixel iteration does
    not normalise them). Under `dp`, `env_states` is this rank's slice.
    `noise`, `perms` and `noises` replace the generators' draws, as in
    pixel_rollout and pixel_update."""
    env_states, traj, bootstrap, episodic = pixel_rollout(
        train_state.model, env_states, env_params, train_state.generator, config, pix, noise=noise)
    metrics = pixel_update(train_state, traj, bootstrap, config, pix, freeze=freeze, perms=perms,
                           noises=noises, dp=dp)
    episodic, env_steps = ppo.reduce_episodic(episodic, traj.rewards.numel(), dp)
    ppo.finish_iteration(train_state, metrics, episodic, config, env_steps)
    return train_state, env_states, metrics


@torch.no_grad()
def warm_start_from_vae(model: PixelActorCritic, vae: VAE) -> None:
    """Copy a trained conv VAE's encoder, latent heads and (when both have
    one) decoder into `model`, in place; the policy keeps its own weights.

    A 3-channel source (RGB) adapts to the 1-channel seg input by summing
    the first conv's weight over its input channels (the response to a
    channel-replicated frame is kept). A decoder whose shapes differ (a
    3-channel output) keeps the model's own decoder whole; any other
    mismatch raises ValueError."""
    src, dst = vae.state_dict(), model.state_dict()
    parts = ["encoder.", "mean_head.", "logstd_head."]
    if model.decoder is not None and vae.decoder is not None:
        parts.append("decoder.")

    def adapt(name: str, d: Tensor) -> Tensor:
        s = src.get(name)
        if s is None:
            raise ValueError(f"warm start: the VAE has no {name}")
        if s.shape == d.shape:
            return s
        if (name.startswith("encoder.") and d.ndim == s.ndim == 4 and d.shape[1] == 1
                and d.shape[0] == s.shape[0] and d.shape[2:] == s.shape[2:]):
            return s.sum(1, keepdim=True)  # OIHW: input channels are dim 1
        raise ValueError(f"shape mismatch warm-starting {name}: {tuple(d.shape)} vs {tuple(s.shape)}")

    for prefix in parts:
        try:
            new = {n: adapt(n, t) for n, t in dst.items() if n.startswith(prefix)}
        except ValueError:
            if prefix == "decoder.":
                continue
            raise
        for n, t in new.items():
            dst[n].copy_(t)


@torch.no_grad()
def evaluate(
    model: PixelActorCritic,
    env_params: EnvParams,
    generator: torch.Generator,
    num_envs: int = 8,
    max_steps: int = 26_000,
    config: PPOConfig = PPOConfig(),
    pix: PixelConfig = PixelConfig(),
    chunk: int = 256,
) -> Dict[str, Tensor]:
    """Greedy evaluation of a pixel agent: ppo.evaluate's loop and metric
    set (lap-bank evals round-robin over the bank), acting on the action
    mean from the rendered frame and the measurements."""
    return ppo.greedy_episodes(*greedy_policy(model, env_params, pix), env_params, generator,
                               num_envs, max_steps, config, chunk)


def greedy_policy(model: PixelActorCritic, env_params: EnvParams, pix: PixelConfig):
    """(act_mean, observe, step_obs) of `evaluate` for ppo.greedy_episodes
    / greedy_snaps."""

    def observe(states: EnvState, out) -> Tuple[Tensor, Tensor]:
        rich, _, m = render_and_measure(states, env_params, pix.cam)
        return rich.to(torch.uint8), m

    def act_mean(obs: Tuple[Tensor, Tensor]) -> Tensor:
        return model.policy_value(frames_input(obs[0]), obs[1])[0]

    return act_mean, observe, None
