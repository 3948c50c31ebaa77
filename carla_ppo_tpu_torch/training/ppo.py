"""PPO: rollout -> GAE -> clipped-surrogate updates (port of
carla_ppo_tpu/training/ppo.py).

`train_iteration` runs one iteration for a batch of envs: a `horizon`-step
rollout (camera + frozen VAE + policy + env when a LatentObs is given),
GAE, then `num_epochs x num_minibatches` Adam updates of the clipped loss

    ratio  = exp(logpi(a|s) - logpi_rollout(a|s))
    loss   = -mean(min(ratio * A, clip(ratio, 1 +- eps) * A))
             + value_scale * mean((V - R)^2) - entropy_scale * mean(H)

The optimizer is written out to match optax's chain(clip_by_global_norm,
adam) exactly: the global-norm clip scales only when the norm is at or
above the threshold (no +1e-6), Adam's eps is added to sqrt(nu_hat) after
bias correction, and the learning rate is a function of the optimizer's
update count. The KL guard and the advantage-SNR / freeze gates keep the
old parameters and optimizer state branch-free (torch.where), like the JAX
package, so nothing waits on the card mid-iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs import lap_env
from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState, TerminationReason
from carla_ppo_tpu_torch.models.policy import ActorCritic, gaussian_entropy, gaussian_log_prob
from carla_ppo_tpu_torch.ops import gae
from carla_ppo_tpu_torch.ops.running_stats import RunningMoments, normalize_rewards


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters; the same fields and defaults as the JAX PPOConfig.

    Ported values: env_kind "lap", obs_fn "vector" (or a LatentObs), the
    scan-form GAE (use_associative_gae must stay False)."""

    learning_rate: float = 1e-4
    lr_decay: float = 1.0
    discount_factor: float = 0.99
    gae_lambda: float = 0.95
    ppo_epsilon: float = 0.2
    initial_std: float = 1.0
    value_scale: float = 1.0
    entropy_scale: float = 0.01
    horizon: int = 128
    num_epochs: int = 3
    num_envs: int = 1024
    num_minibatches: int = 4
    normalize_advantage: bool = True
    normalize_rewards: bool = False
    obs_fn: str = "vector"
    env_kind: str = "lap"
    max_grad_norm: float = 0.0
    use_associative_gae: bool = False
    lr_schedule: Tuple[Tuple[int, float], ...] = ()
    entropy_schedule: Tuple[Tuple[int, float], ...] = ()
    minibatch_axis: str = "env"
    kl_target: float = 0.0
    adv_snr_min: float = 0.0

    @property
    def updates_per_iteration(self) -> int:
        return self.num_epochs * self.num_minibatches

    def __post_init__(self):
        if self.env_kind != "lap":
            raise NotImplementedError(f"env_kind {self.env_kind!r} is not ported (only 'lap')")
        if self.use_associative_gae:
            raise NotImplementedError("associative GAE is not ported (scan form only)")


@dataclasses.dataclass(frozen=True)
class LatentObs:
    """Frozen-VAE latent observation spec: z_mean(z_dim) ++ measurements."""

    vae_model: Any  # models.vae.VAE (frozen)
    source: str = "seg"
    measurements: Tuple[str, ...] = ("steer", "throttle", "speed")

    @property
    def obs_dim(self) -> int:
        return self.vae_model.z_dim + len(self.measurements)


def make_obs_fn(latent_obs: LatentObs | None, config: PPOConfig) -> Callable[[EnvState, EnvParams], Tensor]:
    """Batched obs builder: (env_states, env_params) -> [B, obs_dim]."""
    if latent_obs is None:
        return lambda s, p: lap_env.observe(s, p, config.obs_fn)
    from carla_ppo_tpu_torch.models.vae_common import create_encode_batch_fn

    return create_encode_batch_fn(
        latent_obs.vae_model, measurements_to_include=latent_obs.measurements,
        source=latent_obs.source,
    )


# ---------------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm, adam(schedule, eps=1e-8))
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdamState:
    count: Tensor  # [] int32, updates applied
    mu: List[Tensor]
    nu: List[Tensor]


def adam_init(params: Sequence[Tensor]) -> AdamState:
    dev = params[0].device
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params],
    )


def schedule_value(schedule: Tuple[Tuple[int, float], ...], default: float, at: Tensor) -> Tensor:
    """Piecewise-constant value of `schedule` at `at` (a device scalar)."""
    if not schedule:
        return torch.full((), default, dtype=torch.float32, device=at.device)
    val = torch.full((), schedule[0][1], dtype=torch.float32, device=at.device)
    for start, v in schedule[1:]:
        val = torch.where(at >= start, torch.full_like(val, v), val)
    return val


def lr_at(config: PPOConfig, count: Tensor) -> Tensor:
    """Learning rate at optimizer update `count`: the piecewise
    lr_schedule (iteration starts x updates_per_iteration), else staircase
    exponential decay per iteration."""
    upi = config.updates_per_iteration
    if config.lr_schedule:
        scaled = tuple((int(s) * upi, v) for s, v in config.lr_schedule)
        return schedule_value(scaled, config.learning_rate, count)
    steps = torch.floor(count.to(torch.float32) / upi)
    return config.learning_rate * torch.pow(
        torch.tensor(config.lr_decay, dtype=torch.float32, device=count.device), steps
    )


@torch.no_grad()
def clip_and_adam(
    params: Sequence[Tensor], grads: Sequence[Tensor], state: AdamState, config: PPOConfig,
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
) -> Tuple[List[Tensor], AdamState]:
    """New parameters and Adam state (nothing is modified in place)."""
    max_norm = config.max_grad_norm if config.max_grad_norm > 0 else 1e9
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
    trigger = g_norm < max_norm
    grads = [torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads]
    lr = lr_at(config, state.count)
    count = state.count + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=cf.device), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=cf.device), cf)
    mu = [(1.0 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1.0 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
    new_params = [
        p + (-lr) * ((m / bc1) / (torch.sqrt(v / bc2) + eps))
        for p, m, v in zip(params, mu, nu)
    ]
    return new_params, AdamState(count=count, mu=mu, nu=nu)


# ---------------------------------------------------------------------------
# State, rollout, loss
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    model: ActorCritic
    opt_state: AdamState
    iteration: int
    train_step: int
    total_env_steps: float
    episodes_done: int
    generator: torch.Generator
    reward_norm: RunningMoments


@dataclasses.dataclass
class Trajectory:
    obs: Tensor  # [T, B, D]
    actions: Tensor  # [T, B, A]
    log_probs: Tensor  # [T, B]
    values: Tensor  # [T, B]
    rewards: Tensor  # [T, B]
    dones: Tensor  # [T, B] float


def create_train_state(model: ActorCritic, config: PPOConfig, generator: torch.Generator) -> TrainState:
    dev = next(model.parameters()).device
    return TrainState(
        model=model,
        opt_state=adam_init(list(model.parameters())),
        iteration=0,
        train_step=0,
        total_env_steps=0.0,
        episodes_done=0,
        generator=generator,
        reward_norm=RunningMoments.create(dev),
    )


@torch.no_grad()
def rollout(
    model: ActorCritic,
    env_states: EnvState,
    env_params: EnvParams,
    generator: torch.Generator,
    horizon: int,
    config: PPOConfig,
    latent_obs: LatentObs | None = None,
) -> Tuple[EnvState, Trajectory, Tensor, Dict[str, Tensor]]:
    """Run policy + env for `horizon` steps over the batch.

    Returns (env_states, trajectory, bootstrap_value, episodic_metrics);
    episodic metrics average the episodes that finished in the rollout."""
    obs_builder = make_obs_fn(latent_obs, config)
    step_obs = None if latent_obs is not None else config.obs_fn
    obs = obs_builder(env_states, env_params)
    keys = ("obs", "actions", "log_probs", "values", "rewards", "dones")
    buf: Dict[str, list] = {k: [] for k in keys}
    ep: Dict[str, list] = {k: [] for k in ("done", "rew", "dist", "speed", "dev", "laps", "len", "ot")}
    for _ in range(horizon):
        action, logp, value = model.sample(obs, generator)
        env_states, out = lap_env.autoreset_step(
            env_states, action, env_params, generator, obs_fn=step_obs
        )
        next_obs = obs_builder(env_states, env_params) if latent_obs is not None else out.obs
        done = out.done.to(torch.float32)
        for k, v in zip(keys, (obs, action, logp, value, out.reward, done)):
            buf[k].append(v)
        for k, v in zip(ep, (done, out.total_reward, out.distance_traveled, out.speed_accum,
                             out.center_lane_deviation, out.laps_completed,
                             out.step_count.to(torch.float32), out.npc_overtakes)):
            ep[k].append(v)
        obs = next_obs
    traj = Trajectory(**{k: torch.stack(v) for k, v in buf.items()})
    bootstrap = model(obs)[2]

    e = {k: torch.stack(v) for k, v in ep.items()}
    done_w = e["done"]
    n_done = torch.clamp(done_w.sum(), min=1.0)

    def ep_mean(x):
        return (x * done_w).sum() / n_done

    safe_len = torch.clamp(e["len"], min=1.0)
    safe_dev = torch.clamp(e["dev"], min=1e-6)
    episodic = {
        "train/reward": ep_mean(e["rew"]),
        "train/distance_traveled": ep_mean(e["dist"]),
        "train/average_speed": ep_mean(3.6 * e["speed"] / safe_len),
        "train/center_lane_deviation": ep_mean(e["dev"]),
        "train/average_center_lane_deviation": ep_mean(e["dev"] / safe_len),
        "train/distance_over_deviation": ep_mean(e["dist"] / safe_dev),
        "train/laps_completed": ep_mean(e["laps"]),
        "train/episode_length": ep_mean(e["len"]),
        "train/episodes_finished": done_w.sum(),
        "train/overtakes": ep_mean(e["ot"]),
    }
    return env_states, traj, bootstrap, episodic


def ppo_loss(
    model: ActorCritic,
    batch: Dict[str, Tensor],
    config: PPOConfig,
    entropy_scale: Tensor | float | None = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Clipped-surrogate loss on a flat minibatch, with the JAX package's
    metric set."""
    if entropy_scale is None:
        entropy_scale = config.entropy_scale
    mean, std, value = model(batch["obs"])
    logp = gaussian_log_prob(batch["actions"], mean, std)
    log_ratio = logp - batch["log_probs"]
    ratio = torch.exp(log_ratio)
    adv = batch["advantages"]
    eps = config.ppo_epsilon
    policy_loss = torch.mean(torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * adv))
    value_loss = torch.mean((value - batch["returns"]) ** 2) * config.value_scale
    entropy_loss = torch.mean(gaussian_entropy(std)) * entropy_scale
    loss = -policy_loss + value_loss - entropy_loss
    def d(x: Tensor) -> Tensor:
        return x.detach()

    metrics = {
        "train_loss/policy": d(policy_loss),
        "train_loss/value": d(value_loss),
        "train_loss/entropy": d(entropy_loss),
        "train_loss/loss": d(loss),
        "train/prob_ratio": d(ratio.mean()),
        "train/approx_kl": d(torch.mean(ratio - 1.0 - log_ratio)),
        "train/ratio_max": d(ratio.max()),
        "train/returns": d(batch["returns"].mean()),
        "train/advantage": d(adv.mean()),
        "train_actor/action_0/mean": d(mean[:, 0].mean()),
        "train_actor/action_1/mean": d(mean[:, 1].mean()),
        "train_actor/action_0/std": d(std[0]),
        "train_actor/action_1/std": d(std[1]),
        "train_actor/action_0/taken_actions": d(batch["actions"][:, 0].mean()),
        "train_actor/action_1/taken_actions": d(batch["actions"][:, 1].mean()),
    }
    return loss, metrics


def adv_snr_gate(advantages: Tensor, returns: Tensor, config: PPOConfig) -> Tuple[Tensor, Tensor]:
    """(snr, stop0): std(raw advantages) / std(raw returns) and whether it
    is below config.adv_snr_min (0 disables)."""
    dev = advantages.device
    if config.adv_snr_min <= 0:
        return torch.zeros((), device=dev), torch.zeros((), dtype=torch.bool, device=dev)
    snr = torch.sqrt(advantages.var(correction=0)) / (torch.sqrt(returns.var(correction=0)) + 1e-8)
    return snr, snr < config.adv_snr_min


def _select(keep: Tensor, new: Sequence[Tensor], old: Sequence[Tensor]) -> List[Tensor]:
    return [torch.where(keep, a, b) for a, b in zip(new, old)]


def ppo_update(
    train_state: TrainState,
    traj: Trajectory,
    bootstrap: Tensor,
    config: PPOConfig,
    freeze: Tensor | None = None,
    perms: Sequence[Tensor] | None = None,
) -> Dict[str, Tensor]:
    """GAE + the epochs of minibatch updates, applied to train_state.model
    and train_state.opt_state in place; returns the metrics averaged over
    the updates. `traj.rewards` are used as given (train_iteration
    normalises them first when config.normalize_rewards is set).

    `perms` (one permutation per epoch) replaces the generator's draws."""
    model = train_state.model
    rewards = traj.rewards
    advantages = gae.compute_gae(
        rewards, traj.values, bootstrap, traj.dones, config.discount_factor, config.gae_lambda
    )
    returns = advantages + traj.values
    adv_snr, stop = adv_snr_gate(advantages, returns, config)
    if freeze is not None:
        stop = stop | freeze
    if config.normalize_advantage:
        advantages = gae.normalize_advantages(advantages)

    T, B = traj.rewards.shape
    n = T * B
    env_axis = config.minibatch_axis == "env" and B % config.num_minibatches == 0
    if env_axis:
        data = {
            "obs": traj.obs.transpose(0, 1), "actions": traj.actions.transpose(0, 1),
            "log_probs": traj.log_probs.transpose(0, 1), "returns": returns.transpose(0, 1),
            "advantages": advantages.transpose(0, 1),
        }
        perm_size = B
    else:
        data = {
            "obs": traj.obs.reshape(n, -1), "actions": traj.actions.reshape(n, -1),
            "log_probs": traj.log_probs.reshape(n), "returns": returns.reshape(n),
            "advantages": advantages.reshape(n),
        }
        perm_size = n

    ent_scale = schedule_value(
        config.entropy_schedule, config.entropy_scale,
        torch.tensor(train_state.iteration, device=rewards.device),
    )
    params = list(model.parameters())
    opt = train_state.opt_state
    gated = config.kl_target > 0 or config.adv_snr_min > 0 or freeze is not None
    all_metrics: List[Dict[str, Tensor]] = []
    for epoch in range(config.num_epochs):
        perm = perms[epoch] if perms is not None else torch.randperm(
            perm_size, generator=train_state.generator, device=rewards.device
        )
        for idx in perm.reshape(config.num_minibatches, -1):
            if env_axis:
                batch = {k: v[idx].reshape((-1,) + tuple(v.shape[2:])) for k, v in data.items()}
            else:
                batch = {k: v[idx] for k, v in data.items()}
            for p in params:
                p.grad = None
            loss, metrics = ppo_loss(model, batch, config, ent_scale)
            loss.backward()
            grads = [p.grad for p in params]
            new_params, new_opt = clip_and_adam(params, grads, opt, config)
            if gated:
                if config.kl_target > 0:
                    stop = stop | (metrics["train/approx_kl"] > config.kl_target)
                keep = ~stop
                new_params = _select(keep, new_params, params)
                new_opt = AdamState(
                    count=torch.where(keep, new_opt.count, opt.count),
                    mu=_select(keep, new_opt.mu, opt.mu),
                    nu=_select(keep, new_opt.nu, opt.nu),
                )
                metrics["train/update_skipped"] = 1.0 - keep.to(torch.float32)
            with torch.no_grad():
                for p, q in zip(params, new_params):
                    p.copy_(q)
            opt = new_opt
            all_metrics.append(metrics)
    for p in params:
        p.grad = None
    train_state.opt_state = opt
    mean_metrics = {k: torch.stack([m[k] for m in all_metrics]).mean() for k in all_metrics[0]}
    if config.adv_snr_min > 0:
        mean_metrics["train/adv_snr"] = adv_snr
    return mean_metrics


def train_iteration(
    train_state: TrainState,
    env_states: EnvState,
    env_params: EnvParams,
    config: PPOConfig,
    latent_obs: LatentObs | None = None,
    freeze: Tensor | None = None,
) -> Tuple[TrainState, EnvState, Dict[str, Tensor]]:
    """One PPO iteration: rollout(horizon) -> GAE -> epochs of updates (the
    single-device train_iteration_core of the JAX package). Updates
    train_state's model in place; returns (train_state, env_states,
    metrics)."""
    env_states, traj, bootstrap, episodic = rollout(
        train_state.model, env_states, env_params, train_state.generator,
        config.horizon, config, latent_obs=latent_obs,
    )
    if config.normalize_rewards:
        rewards, reward_norm, ret_carry = normalize_rewards(
            train_state.reward_norm, env_states.vecnorm_return, traj.rewards, traj.dones,
            config.discount_factor,
        )
        traj = dataclasses.replace(traj, rewards=rewards)
        env_states = dataclasses.replace(env_states, vecnorm_return=ret_carry)
        train_state.reward_norm = reward_norm
    metrics = ppo_update(train_state, traj, bootstrap, config, freeze=freeze)
    metrics.update(episodic)
    if config.lr_schedule:
        lr = schedule_value(config.lr_schedule, config.learning_rate,
                            torch.tensor(train_state.iteration))
    else:
        lr = torch.tensor(config.learning_rate * config.lr_decay ** train_state.iteration)
    metrics["train/learning_rate"] = lr
    metrics["train/entropy_scale"] = schedule_value(
        config.entropy_schedule, config.entropy_scale, torch.tensor(train_state.iteration)
    )
    T, B = traj.rewards.shape
    train_state.iteration += 1
    train_state.train_step += config.updates_per_iteration
    train_state.total_env_steps += float(T * B)
    train_state.episodes_done += int(episodic["train/episodes_finished"].item())
    return train_state, env_states, metrics


# ---------------------------------------------------------------------------
# Greedy evaluation
# ---------------------------------------------------------------------------

_SNAP_KEYS = ("reward", "distance", "deviation", "speed_accum", "laps", "steps", "overtakes", "reason")


def _snap_of(out_or_state) -> Dict[str, Tensor]:
    o = out_or_state
    return {
        "reward": o.total_reward, "distance": o.distance_traveled,
        "deviation": o.center_lane_deviation, "speed_accum": o.speed_accum,
        "laps": o.laps_completed, "steps": o.step_count.to(torch.float32),
        "overtakes": o.npc_overtakes, "reason": o.termination_reason.to(torch.float32),
    }


@torch.no_grad()
def evaluate(
    model: ActorCritic,
    env_params: EnvParams,
    generator: torch.Generator,
    num_envs: int = 1,
    max_steps: int = 3000,
    config: PPOConfig = PPOConfig(),
    latent_obs: LatentObs | None = None,
    chunk: int = 256,
) -> Dict[str, Tensor]:
    """Greedy evaluation episodes (spawn at waypoint 0, act with the mean),
    until every env finished or `max_steps`; the JAX package's eval metric
    set. The loop checks for early exit once per `chunk` steps."""
    obs_builder = make_obs_fn(latent_obs, config)
    step_obs = None if latent_obs is not None else config.obs_fn
    states = lap_env.reset(env_params, generator, checkpoint_idx=0, is_training=False,
                           batch=num_envs)
    obs = obs_builder(states, env_params)
    dev = obs.device
    done = torch.zeros(num_envs, dtype=torch.bool, device=dev)
    snap = {k: torch.zeros(num_envs, device=dev) for k in _SNAP_KEYS}
    t = 0
    while t < max_steps and not bool(done.all()):
        for _ in range(chunk):
            active = ~done & (t < max_steps)
            mean = model(obs)[0]
            next_states, out = lap_env.step(states, mean, env_params, obs_fn=step_obs)
            new_obs = obs_builder(next_states, env_params) if latent_obs is not None else out.obs
            newly = out.done & active
            fresh = _snap_of(out)
            snap = {k: torch.where(newly, fresh[k], snap[k]) for k in _SNAP_KEYS}
            done = done | newly
            states = lap_env.select_envs(active, next_states, states)
            obs = torch.where(active[:, None], new_obs, obs)
            t += 1
    live = _snap_of(states)
    snap = {k: torch.where(done, snap[k], live[k]) for k in _SNAP_KEYS}
    return evaluate_metrics(snap, done)


def evaluate_metrics(snap: Dict[str, Tensor], done: Tensor) -> Dict[str, Tensor]:
    steps = torch.clamp(snap["steps"], min=1.0)
    dev = torch.clamp(snap["deviation"], min=1e-6)
    reasons = torch.nn.functional.one_hot(
        snap["reason"].to(torch.int64), len(TerminationReason)
    ).to(torch.float32).sum(0)
    return {
        "eval/reward": snap["reward"].mean(),
        "eval/distance_traveled": snap["distance"].mean(),
        "eval/average_speed": (3.6 * snap["speed_accum"] / steps).mean(),
        "eval/center_lane_deviation": snap["deviation"].mean(),
        "eval/average_center_lane_deviation": (snap["deviation"] / steps).mean(),
        "eval/distance_over_deviation": (snap["distance"] / dev).mean(),
        "eval/laps_completed": snap["laps"].mean(),
        "eval/episode_steps": snap["steps"].mean(),
        "eval/finished": done.to(torch.float32).mean(),
        "eval/overtakes": snap["overtakes"].mean(),
        "eval/termination_reasons": reasons,
    }


def init_env_batch(env_params: EnvParams, num_envs: int, generator: torch.Generator,
                   env_kind: str = "lap") -> EnvState:
    if env_kind != "lap":
        raise NotImplementedError(f"env_kind {env_kind!r} is not ported (only 'lap')")
    return lap_env.init_env_batch(env_params, num_envs, generator)

