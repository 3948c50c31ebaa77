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

Data parallel (`dp`, a parallel.mesh.DataParallel; None is the
single-device path): each rank rolls out its own slice of the env batch
from its own generator, and the update does what the JAX package's
train_iteration_core(axis_name=) does: advantages normalised (and the
SNR gate taken) by the global moments, gradients and minibatch metrics
averaged over the ranks before the clip and Adam, the reward moments
averaged after each rank's own update, the episodic metrics averaged.
Every rank then applies the same update to the same parameters, and the
minibatch permutations come from `TrainState.shared_generator`, which all
ranks draw alike.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs import lap_bank_env, lap_env, route_env
from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState, TerminationReason, map_tensors
from carla_ppo_tpu_torch.models.policy import ActorCritic, gaussian_entropy, gaussian_log_prob
from carla_ppo_tpu_torch.ops import gae
from carla_ppo_tpu_torch.ops.running_stats import RunningMoments, normalize_rewards
from carla_ppo_tpu_torch.parallel.mesh import DataParallel
from carla_ppo_tpu_torch.utils import profiling
from carla_ppo_tpu_torch.utils.device import derived_generator


ENV_KINDS = {"lap": lap_env, "route": route_env, "lap_bank": lap_bank_env}


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters; the same fields and defaults as the JAX PPOConfig.

    Ported values: env_kind "lap", "route" or "lap_bank" (the last two on
    a track bank), obs_fn "vector" (or a LatentObs); use_associative_gae
    takes ops/gae.compute_gae_associative."""

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
        if self.env_kind not in ENV_KINDS:
            raise NotImplementedError(
                f"env_kind {self.env_kind!r} is not ported (one of {sorted(ENV_KINDS)})")


@dataclasses.dataclass(frozen=True)
class LatentObs:
    """Frozen-VAE latent observation spec: z_mean(z_dim) ++ measurements."""

    vae_model: Any  # models.vae.VAE (frozen)
    source: str = "seg"
    measurements: Tuple[str, ...] = ("steer", "throttle", "speed")

    @property
    def obs_dim(self) -> int:
        return self.vae_model.z_dim + len(self.measurements)


def _env_module(config: PPOConfig):
    return ENV_KINDS[config.env_kind]


def make_obs_fn(latent_obs: LatentObs | None, config: PPOConfig) -> Callable[[EnvState, EnvParams], Tensor]:
    """Batched obs builder: (env_states, env_params) -> [B, obs_dim]."""
    if latent_obs is None:
        env = _env_module(config)
        return lambda s, p: env.observe(s, p, config.obs_fn)
    from carla_ppo_tpu_torch.models.vae_common import create_encode_batch_fn

    return create_encode_batch_fn(
        latent_obs.vae_model, measurements_to_include=latent_obs.measurements,
        banked=config.env_kind in ("route", "lap_bank"), source=latent_obs.source,
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


def schedule_value(schedule: Tuple[Tuple[int, float], ...], default: float,
                   iteration: Tensor) -> Tensor:
    """Piecewise-constant value of `schedule` at `iteration` (a device
    scalar)."""
    if not schedule:
        return torch.full((), default, dtype=torch.float32, device=iteration.device)
    val = torch.full((), schedule[0][1], dtype=torch.float32, device=iteration.device)
    for start, v in schedule[1:]:
        val = torch.where(iteration >= start, torch.full_like(val, v), val)
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


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


@torch.no_grad()
def clip_and_adam(
    params: Sequence[Tensor], grads: Sequence[Tensor], state: AdamState, config: PPOConfig,
    clip_norm: float | None = None, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
) -> Tuple[List[Tensor], AdamState]:
    """New parameters and Adam state (nothing is modified in place).
    `clip_norm` replaces config.max_grad_norm (a parameter group's own
    clip); <= 0 disables the clip (1e9, as the JAX package writes it)."""
    max_norm = config.max_grad_norm if clip_norm is None else clip_norm
    max_norm = max_norm if max_norm > 0 else 1e9
    g_norm = global_norm(grads)
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


def adam_tree(state: AdamState, names: Sequence[str]) -> Dict[str, Any]:
    return {"count": state.count, "mu": dict(zip(names, state.mu)), "nu": dict(zip(names, state.nu))}


def adam_from_tree(tree: Dict[str, Any], names: Sequence[str], device: torch.device) -> AdamState:
    return AdamState(
        count=tree["count"].to(device=device, dtype=torch.int32),
        mu=[tree["mu"][n].to(device) for n in names],
        nu=[tree["nu"][n].to(device) for n in names],
    )


# ---------------------------------------------------------------------------
# State, rollout, loss
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """Model, optimizer state, counters, reward moments and random streams.

    `generator` drives the rollout (action noise, resets). The minibatch
    permutations (and the pixel path's z noise) come from
    `shared_generator` when it is set, else from `generator`: the
    single-device path draws everything from one stream, while data
    parallel gives every rank the same shared stream and its own rollout
    stream (rank 0's is the one a single device would have;
    parallel/train_dp.replicate)."""

    model: ActorCritic
    opt_state: AdamState
    iteration: int
    train_step: int
    total_env_steps: float
    episodes_done: int
    generator: torch.Generator
    reward_norm: RunningMoments
    shared_generator: torch.Generator | None = None

    @property
    def update_generator(self) -> torch.Generator:
        """The stream of the update's draws (permutations, z noise)."""
        return self.shared_generator if self.shared_generator is not None else self.generator

    def opt_tree(self) -> Dict[str, Any]:
        """The Adam state as saved: count, and the moments keyed by
        parameter name."""
        return adam_tree(self.opt_state, [n for n, _ in self.model.named_parameters()])

    def opt_from_tree(self, tree: Dict[str, Any], model: torch.nn.Module) -> Any:
        """Inverse of opt_tree, onto `model`'s parameter names and device."""
        return adam_from_tree(tree, [n for n, _ in model.named_parameters()],
                              next(model.parameters()).device)

    def checkpoint_tree(self) -> Dict[str, Any]:
        """What utils.checkpoint saves: the model's state_dict, the Adam
        moments keyed by parameter name, the counters, the reward moments
        and the generators' states (the shared one where it is set; under
        data parallel, rank 0 saves, so `generator` is rank 0's rollout
        stream)."""
        tree = {
            "model": self.model.state_dict(),
            "opt_state": self.opt_tree(),
            "iteration": int(self.iteration),
            "train_step": int(self.train_step),
            "total_env_steps": float(self.total_env_steps),
            "episodes_done": int(self.episodes_done),
            "reward_norm": dataclasses.asdict(self.reward_norm),
            "generator": self.generator.get_state(),
            "generator_device": self.generator.device.type,
        }
        if self.shared_generator is not None:
            tree["shared_generator"] = self.shared_generator.get_state()
        return tree

    def restored(self, tree: Dict[str, Any]) -> "TrainState":
        """A new TrainState from a checkpoint tree, on this state's devices
        (this one is left as it is).

        A tree without a generator state (one converted from the JAX
        package, whose PRNG key has no torch counterpart) keeps a copy of
        this state's generator. A generator state saved on another device
        type (a CUDA generator's state restored for a CPU run, or the other
        way round) cannot be set; the copy of this state's generator is kept
        then too, and a line says so. A state with a shared generator gets
        the tree's, else (a single-device tree, or another device type) one
        derived from the restored generator."""
        model = copy.deepcopy(self.model)
        model.load_state_dict(tree["model"])
        dev = next(model.parameters()).device
        generator = torch.Generator(device=self.generator.device)
        saved = tree.get("generator")
        if saved is not None and tree.get("generator_device") == self.generator.device.type:
            generator.set_state(saved)
        else:
            if saved is not None:
                print(f"checkpoint generator was on {tree.get('generator_device')}, this run is on "
                      f"{self.generator.device.type}: keeping this run's seeded generator", flush=True)
            generator.set_state(self.generator.get_state())
        shared = None
        if self.shared_generator is not None:
            if "shared_generator" in tree and tree.get("generator_device") == self.generator.device.type:
                shared = torch.Generator(device=self.generator.device)
                shared.set_state(tree["shared_generator"])
            else:
                shared = derived_generator(generator, "shared")
        rn = tree["reward_norm"]
        return type(self)(
            model=model,
            opt_state=self.opt_from_tree(tree["opt_state"], model),
            iteration=int(tree["iteration"]),
            train_step=int(tree["train_step"]),
            total_env_steps=float(tree["total_env_steps"]),
            episodes_done=int(tree["episodes_done"]),
            generator=generator,
            reward_norm=RunningMoments(**{k: torch.as_tensor(rn[k], dtype=torch.float32).to(dev)
                                          for k in ("mean", "var", "count")}),
            shared_generator=shared,
        )


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
    noise: Tensor | None = None,
) -> Tuple[EnvState, Trajectory, Tensor, Dict[str, Tensor]]:
    """Run policy + env for `horizon` steps over the batch.

    Returns (env_states, trajectory, bootstrap_value, episodic_metrics);
    episodic metrics average the episodes that finished in the rollout.
    `noise` ([horizon, B, A] standard normal) replaces the generator's
    action draws."""
    with profiling.span("rollout"):
        env = _env_module(config)
        obs_builder = make_obs_fn(latent_obs, config)
        step_obs = None if latent_obs is not None else config.obs_fn
        obs = obs_builder(env_states, env_params)
        keys = ("obs", "actions", "log_probs", "values", "rewards", "dones")
        buf: Dict[str, list] = {k: [] for k in keys}
        ep: Dict[str, list] = {k: [] for k in ("done", "rew", "dist", "speed", "dev", "laps", "len", "ot")}
        for t in range(horizon):
            action, logp, value = model.sample(obs, generator, noise=None if noise is None else noise[t])
            env_states, out = env.autoreset_step(
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


def global_moments(x: Tensor, dp: DataParallel | None) -> Tuple[Tensor, Tensor]:
    """(mean, population variance) of `x` over every rank's values: the
    sum and count reduced first, then the squared deviations from the
    global mean (the JAX package's two-psum form). Single-device: torch's
    mean and var."""
    if dp is None:
        return x.mean(), x.var(correction=0)
    total, n = dp.mean([x.sum(), torch.tensor(float(x.numel()), device=x.device)])
    mean = total / n
    (ssq,) = dp.mean([((x - mean) ** 2).sum()])
    return mean, ssq / n


def adv_snr_gate(advantages: Tensor, returns: Tensor, config: PPOConfig,
                 dp: DataParallel | None = None) -> Tuple[Tensor, Tensor]:
    """(snr, stop0): std(raw advantages) / std(raw returns) and whether it
    is below config.adv_snr_min (0 disables); over every rank's values
    under data parallel, so the ranks stop alike."""
    dev = advantages.device
    if config.adv_snr_min <= 0:
        return torch.zeros((), device=dev), torch.zeros((), dtype=torch.bool, device=dev)
    a_var = global_moments(advantages, dp)[1]
    r_var = global_moments(returns, dp)[1]
    snr = torch.sqrt(a_var) / (torch.sqrt(r_var) + 1e-8)
    return snr, snr < config.adv_snr_min


def normalize_advantages(advantages: Tensor, dp: DataParallel | None) -> Tensor:
    """(A - mean) / (std + 1e-8), by the global moments under data
    parallel."""
    if dp is None:
        return gae.normalize_advantages(advantages)
    mean, var = global_moments(advantages, dp)
    return (advantages - mean) / (torch.sqrt(var) + 1e-8)


def reduce_grads_and_metrics(grads: List[Tensor], metrics: Dict[str, Tensor],
                             dp: DataParallel | None) -> Tuple[List[Tensor], Dict[str, Tensor]]:
    """The gradients and minibatch metrics averaged over the ranks in one
    all-reduce (unchanged on a single device), before any clip or gate
    reads them."""
    if dp is None:
        return grads, metrics
    keys = list(metrics)
    out = dp.mean(list(grads) + [metrics[k] for k in keys])
    return out[: len(grads)], dict(zip(keys, out[len(grads):]))


def select_each(keep: Tensor, new: Sequence[Tensor], old: Sequence[Tensor]) -> List[Tensor]:
    return [torch.where(keep, a, b) for a, b in zip(new, old)]


def select_adam(keep: Tensor, new: AdamState, old: AdamState) -> AdamState:
    return AdamState(count=torch.where(keep, new.count, old.count),
                     mu=select_each(keep, new.mu, old.mu), nu=select_each(keep, new.nu, old.nu))


def ppo_update(
    train_state: TrainState,
    traj: Trajectory,
    bootstrap: Tensor,
    config: PPOConfig,
    freeze: Tensor | None = None,
    perms: Sequence[Tensor] | None = None,
    dp: DataParallel | None = None,
) -> Dict[str, Tensor]:
    """GAE + the epochs of minibatch updates, applied to train_state.model
    and train_state.opt_state in place; returns the metrics averaged over
    the updates. `traj.rewards` are used as given (train_iteration
    normalises them first when config.normalize_rewards is set).

    `perms` (one permutation per epoch) replaces the update generator's
    draws. Under `dp`, `traj` is this rank's slice."""
    model = train_state.model
    rewards = traj.rewards
    gae_fn = gae.compute_gae_associative if config.use_associative_gae else gae.compute_gae
    with profiling.span("update.gae"):
        advantages = gae_fn(
            rewards, traj.values, bootstrap, traj.dones, config.discount_factor, config.gae_lambda
        )
        returns = advantages + traj.values
        adv_snr, stop = adv_snr_gate(advantages, returns, config, dp)
        if freeze is not None:
            stop = stop | freeze
        if config.normalize_advantage:
            advantages = normalize_advantages(advantages, dp)

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
            perm_size, generator=train_state.update_generator, device=rewards.device
        )
        for idx in perm.reshape(config.num_minibatches, -1):
            if env_axis:
                batch = {k: v[idx].reshape((-1,) + tuple(v.shape[2:])) for k, v in data.items()}
            else:
                batch = {k: v[idx] for k, v in data.items()}
            for p in params:
                p.grad = None
            with profiling.span("update.loss"):
                loss, metrics = ppo_loss(model, batch, config, ent_scale)
            with profiling.span("update.backward"):
                loss.backward()
            grads, metrics = reduce_grads_and_metrics([p.grad for p in params], metrics, dp)
            with profiling.span("update.adam"):
                new_params, new_opt = clip_and_adam(params, grads, opt, config)
                if gated:
                    if config.kl_target > 0:
                        stop = stop | (metrics["train/approx_kl"] > config.kl_target)
                    keep = ~stop
                    new_params = select_each(keep, new_params, params)
                    new_opt = select_adam(keep, new_opt, opt)
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
    rollout_model: ActorCritic | None = None,
    freeze: Tensor | None = None,
    dp: DataParallel | None = None,
    perms: Sequence[Tensor] | None = None,
) -> Tuple[TrainState, EnvState, Dict[str, Tensor]]:
    """One PPO iteration: rollout(horizon) -> GAE -> epochs of updates (the
    JAX package's train_iteration_core). Updates train_state's model in
    place; returns (train_state, env_states, metrics). Under `dp`,
    `env_states` is this rank's slice of the batch. `perms` (one
    permutation per epoch) replaces the update generator's draws.

    `rollout_model` acts in the rollout in place of train_state.model: the
    "mixed" recipe passes `model.with_compute_dtype(torch.bfloat16)`, a
    bfloat16-trunk twin on the same parameters, while the update stays in
    the model's own dtype. The stored log-probs are the twin's, so the
    ratio is exact importance sampling."""
    env_states, traj, bootstrap, episodic = rollout(
        rollout_model if rollout_model is not None else train_state.model,
        env_states, env_params, train_state.generator,
        config.horizon, config, latent_obs=latent_obs,
    )
    env_states, metrics = update_from_rollout(train_state, env_states, traj, bootstrap, episodic,
                                              config, freeze=freeze, dp=dp, perms=perms)
    return train_state, env_states, metrics


def update_from_rollout(
    train_state: TrainState,
    env_states: EnvState,
    traj: Trajectory,
    bootstrap: Tensor,
    episodic: Dict[str, Tensor],
    config: PPOConfig,
    freeze: Tensor | None = None,
    dp: DataParallel | None = None,
    perms: Sequence[Tensor] | None = None,
) -> Tuple[EnvState, Dict[str, Tensor]]:
    """The rest of train_iteration after its rollout: reward normalisation
    (under `dp` each rank updates the moments with its own returns, then
    the moments are averaged over the ranks, as the JAX package pmeans
    them), the update phase, the episodic metrics (averaged over the
    ranks, `train/episodes_finished` summed) and the counters. Returns
    (env_states with the new return carries, metrics)."""
    with profiling.span("update"):
        if config.normalize_rewards:
            rewards, reward_norm, ret_carry = normalize_rewards(
                train_state.reward_norm, env_states.vecnorm_return, traj.rewards, traj.dones,
                config.discount_factor,
            )
            traj = dataclasses.replace(traj, rewards=rewards)
            env_states = dataclasses.replace(env_states, vecnorm_return=ret_carry)
            if dp is not None:
                reward_norm = RunningMoments(*dp.mean([reward_norm.mean, reward_norm.var,
                                                       reward_norm.count]))
            train_state.reward_norm = reward_norm
        metrics = ppo_update(train_state, traj, bootstrap, config, freeze=freeze, perms=perms, dp=dp)
        episodic, env_steps = reduce_episodic(episodic, traj.rewards.numel(), dp)
        finish_iteration(train_state, metrics, episodic, config, env_steps)
        return env_states, metrics


def reduce_episodic(episodic: Dict[str, Tensor], env_steps: int,
                    dp: DataParallel | None) -> Tuple[Dict[str, Tensor], int]:
    """(episodic metrics, env steps) of the whole batch: under `dp` each
    rank's episodic means averaged over the ranks and the finished-episode
    count and the steps times the world size, as the JAX package does."""
    if dp is None:
        return episodic, env_steps
    keys = list(episodic)
    episodic = dict(zip(keys, dp.mean([episodic[k] for k in keys])))
    episodic["train/episodes_finished"] = episodic["train/episodes_finished"] * dp.world_size
    return episodic, env_steps * dp.world_size


def finish_iteration(train_state: TrainState, metrics: Dict[str, Tensor],
                     episodic: Dict[str, Tensor], config: PPOConfig, env_steps: int) -> None:
    """Add the episodic metrics and this iteration's learning rate and
    entropy scale to `metrics`, and advance train_state's counters."""
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
    train_state.iteration += 1
    train_state.train_step += config.updates_per_iteration
    train_state.total_env_steps += float(env_steps)
    train_state.episodes_done += int(episodic["train/episodes_finished"].item())


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
    """Greedy evaluation episodes (spawn at waypoint 0 or the route start,
    act with the mean), until every env finished or `max_steps`; the JAX
    package's eval metric set. Lap-bank evals assign the bank's tracks
    round-robin and add `eval/laps_per_track` ([n_tracks]). The loop
    checks for early exit once per `chunk` steps."""
    return greedy_episodes(*greedy_policy(model, env_params, config, latent_obs), env_params,
                           generator, num_envs, max_steps, config, chunk)


def greedy_policy(
    model: ActorCritic, env_params: EnvParams, config: PPOConfig, latent_obs: LatentObs | None,
) -> Tuple[Callable[[Any], Tensor], Callable[[EnvState, Any], Any], str | None]:
    """(act_mean, observe, step_obs) of `evaluate` for greedy_episodes /
    greedy_snaps."""
    obs_builder = make_obs_fn(latent_obs, config)

    def observe(states, out):
        if out is None or latent_obs is not None:
            return obs_builder(states, env_params)
        return out.obs  # the env step's vector observation

    return (lambda obs: model(obs)[0]), observe, (None if latent_obs is not None else config.obs_fn)


def greedy_episodes(
    act_mean: Callable[[Any], Tensor],
    observe: Callable[[EnvState, Any], Any],
    step_obs: str | None,
    env_params: EnvParams,
    generator: torch.Generator,
    num_envs: int,
    max_steps: int,
    config: PPOConfig,
    chunk: int,
) -> Dict[str, Tensor]:
    """The greedy eval loop of `evaluate`, for any observation: `observe`
    (states, step output or None at the reset) gives the observation (a
    tensor or a tuple of tensors, env-major) and `act_mean` the action
    mean from it. Finished envs stay frozen; each env's first terminal
    snapshot is latched."""
    snap, done, track_ids = greedy_snaps(act_mean, observe, step_obs, env_params, generator,
                                         num_envs, max_steps, config, chunk)
    return evaluate_metrics(snap, done, track_ids, env_params.track.num_tracks)


def greedy_snaps(
    act_mean: Callable[[Any], Tensor],
    observe: Callable[[EnvState, Any], Any],
    step_obs: str | None,
    env_params: EnvParams,
    generator: torch.Generator,
    num_envs: int,
    max_steps: int,
    config: PPOConfig,
    chunk: int,
    shard: slice | None = None,
) -> Tuple[Dict[str, Tensor], Tensor, Tensor | None]:
    """greedy_episodes' loop: (each env's terminal or last snapshot, its
    done flag, the lap bank's track of every env or None).

    `shard` runs only those envs of the batch: the resets (and the route
    env's chained routes) are drawn for all `num_envs` and sliced, so each
    env sees the same draws as in the whole batch (data-parallel
    evaluation, parallel/train_dp.py)."""
    track_ids = None
    if config.env_kind == "route":
        states = route_env.reset(env_params, generator, is_training=False, batch=num_envs)
    elif config.env_kind == "lap_bank":
        track_ids = lap_bank_env.round_robin(num_envs, env_params)
        states = lap_bank_env.reset(env_params, generator, is_training=False, track_id=track_ids)
    else:
        states = lap_env.reset(env_params, generator, checkpoint_idx=0, is_training=False,
                               batch=num_envs)
    if shard is not None:
        states = map_tensors(lambda t: t[shard], states)

    def env_step(s, a):
        if config.env_kind != "route":
            return lap_env.step(s, a, env_params, obs_fn=step_obs)
        if shard is None:
            return route_env.step(s, a, env_params, generator, obs_fn=step_obs)
        routes = route_env.draw_routes(env_params.track, num_envs, generator)[shard]
        return route_env.step_with_routes(s, a, env_params, routes, obs_fn=step_obs)

    def keep_active(active, new, old):
        if isinstance(new, tuple):
            return tuple(keep_active(active, n, o) for n, o in zip(new, old))
        return torch.where(active.view((-1,) + (1,) * (new.ndim - 1)), new, old)

    obs = observe(states, None)
    dev = states.vehicle.pos.device
    n = states.batch_size
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    snap = {k: torch.zeros(n, device=dev) for k in _SNAP_KEYS}
    t = 0
    while t < max_steps and not bool(done.all()):
        for _ in range(chunk):
            active = ~done & (t < max_steps)
            mean = act_mean(obs)
            next_states, out = env_step(states, mean)
            new_obs = observe(next_states, out)
            newly = out.done & active
            fresh = _snap_of(out)
            snap = {k: torch.where(newly, fresh[k], snap[k]) for k in _SNAP_KEYS}
            done = done | newly
            states = lap_env.select_envs(active, next_states, states)
            obs = keep_active(active, new_obs, obs)
            t += 1
    live = _snap_of(states)
    snap = {k: torch.where(done, snap[k], live[k]) for k in _SNAP_KEYS}
    return snap, done, track_ids


def evaluate_metrics(
    snap: Dict[str, Tensor], done: Tensor, track_ids: Tensor | None = None, n_tracks: int = 0
) -> Dict[str, Tensor]:
    steps = torch.clamp(snap["steps"], min=1.0)
    dev = torch.clamp(snap["deviation"], min=1e-6)
    reasons = torch.nn.functional.one_hot(
        snap["reason"].to(torch.int64), len(TerminationReason)
    ).to(torch.float32).sum(0)
    metrics = {
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
    if track_ids is not None:
        onehot = torch.nn.functional.one_hot(track_ids.long(), n_tracks).to(torch.float32)
        counts = torch.clamp(onehot.sum(0), min=1.0)
        metrics["eval/laps_per_track"] = (snap["laps"] @ onehot) / counts
    return metrics


def init_env_batch(env_params: EnvParams, num_envs: int, generator: torch.Generator,
                   env_kind: str = "lap") -> EnvState:
    """Training resets: at checkpoint 0 (lap), on random routes (route), or
    at checkpoint 0 of round-robin tracks (lap_bank)."""
    if env_kind == "route":
        return route_env.reset(env_params, generator, is_training=True, batch=num_envs)
    if env_kind == "lap_bank":
        return lap_bank_env.init_env_batch(env_params, num_envs, generator)
    if env_kind != "lap":
        raise NotImplementedError(f"env_kind {env_kind!r} is not ported")
    return lap_env.init_env_batch(env_params, num_envs, generator)

