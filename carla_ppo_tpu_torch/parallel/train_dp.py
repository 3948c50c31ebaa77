"""Data-parallel PPO over torch.distributed (port of
carla_ppo_tpu/parallel/train_dp.py).

Each rank owns a contiguous slice of the env batch (the simulator is
tensor state, so sharding the environment is slicing its state), rolls it
out on its own card, and joins the others only in the update's
collectives (training/ppo.py and training/pixels.py under `dp`). The
parameters, the optimizer state, the counters and the shared random stream
start equal on every rank (`replicate`) and stay bitwise equal, because
every rank applies the same update computed from the same all-reduced
values.

Random streams: `generator` (the rollout's) is rank 0's own stream, the
one a single device would have, and every other rank's is derived from the
shared stream and its rank; `shared_generator` (the minibatch permutations
and the pixel z noise) is the same on every rank. A checkpoint (written by
rank 0) holds rank 0's rollout stream and the shared stream; `replicate`
after a restore re-derives the other ranks' streams, so a resume on another
world size keeps rank 0's and the shared stream and restarts the rest.

The greedy evaluation splits `num_envs` envs over the ranks: every rank
draws the resets (and the route env's chained routes) of the whole batch
from the same eval generator and steps its slice; the per-env snapshots
are gathered and aggregated by ppo.evaluate_metrics. Discrete outcomes
(laps, steps, termination reasons, done flags) equal the single-device
evaluate's; float accumulators agree to rounding (a policy forward over a
slice may round differently from one over the whole batch).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs.types import EnvParams, EnvState, map_tensors
from carla_ppo_tpu_torch.parallel.mesh import DataParallel
from carla_ppo_tpu_torch.training import pixels as pixels_mod
from carla_ppo_tpu_torch.training import ppo
from carla_ppo_tpu_torch.training.ppo import PPOConfig, TrainState
from carla_ppo_tpu_torch.utils.device import derived_generator


def make_dp_train_iteration(
    dp: DataParallel,
    config: PPOConfig,
    env_params: EnvParams,
    latent_obs: ppo.LatentObs | None = None,
) -> Callable[..., Any]:
    """fn(train_state, env_states, freeze=None, rollout_model=None) ->
    (train_state, env_states, metrics): ppo.train_iteration on this rank's
    slice of the envs. The solve-aware freeze (the JAX `with_freeze`
    variant) and the mixed recipe's behaviour twin are arguments of each
    call: nothing is compiled, so one function serves both."""

    def dp_iteration(train_state: TrainState, env_states: EnvState, freeze: Tensor | None = None,
                     rollout_model=None):
        return ppo.train_iteration(train_state, env_states, env_params, config,
                                   latent_obs=latent_obs, freeze=freeze,
                                   rollout_model=rollout_model, dp=dp)

    return dp_iteration


def make_dp_pixel_train_iteration(
    dp: DataParallel,
    config: PPOConfig,
    env_params: EnvParams,
    pix: pixels_mod.PixelConfig = pixels_mod.PixelConfig(),
) -> Callable[..., Any]:
    """fn(train_state, env_states, freeze=None) -> (train_state,
    env_states, metrics): pixels.pixel_train_iteration on this rank's slice
    of the envs (each rank renders its own frames; the joint update's
    gradients of both groups are averaged over the ranks)."""

    def dp_iteration(train_state, env_states: EnvState, freeze: Tensor | None = None):
        return pixels_mod.pixel_train_iteration(train_state, env_states, env_params, config, pix,
                                                freeze=freeze, dp=dp)

    return dp_iteration


def make_dp_evaluate(
    dp: DataParallel,
    model,
    config: PPOConfig,
    env_params: EnvParams,
    num_envs: int,
    chunk: int = 256,
    latent_obs: ppo.LatentObs | None = None,
) -> Callable[[torch.Generator, int], Dict[str, Tensor]]:
    """fn(generator, max_steps) -> ppo.evaluate's metrics, each rank
    stepping num_envs / world envs of `model` (its parameters as they are
    at the call). `generator` must be in the same state on every rank."""
    return _build_dp_evaluate(dp, ppo.greedy_policy(model, env_params, config, latent_obs),
                              env_params, config, num_envs, chunk)


def make_dp_pixel_evaluate(
    dp: DataParallel,
    model,
    config: PPOConfig,
    env_params: EnvParams,
    num_envs: int,
    pix: pixels_mod.PixelConfig = pixels_mod.PixelConfig(),
    chunk: int = 256,
) -> Callable[[torch.Generator, int], Dict[str, Tensor]]:
    """make_dp_evaluate for the pixel agent (pixels.evaluate's policy)."""
    return _build_dp_evaluate(dp, pixels_mod.greedy_policy(model, env_params, pix), env_params,
                              config, num_envs, chunk)


def _build_dp_evaluate(dp: DataParallel, policy, env_params: EnvParams, config: PPOConfig,
                       num_envs: int, chunk: int) -> Callable[[torch.Generator, int], Dict[str, Tensor]]:
    act_mean, observe, step_obs = policy
    shard = dp.shard(num_envs)

    def dp_evaluate(generator: torch.Generator, max_steps: int) -> Dict[str, Tensor]:
        snap, done, track_ids = ppo.greedy_snaps(act_mean, observe, step_obs, env_params, generator,
                                                 num_envs, max_steps, config, chunk, shard=shard)
        keys = list(snap)
        local = torch.stack([snap[k] for k in keys] + [done.to(torch.float32)], 1)
        full = dp.all_gather(local)
        snap = {k: full[:, i] for i, k in enumerate(keys)}
        return ppo.evaluate_metrics(snap, full[:, -1] > 0.5, track_ids, env_params.track.num_tracks)

    return dp_evaluate


def shard_env_batch(env_states: EnvState, dp: DataParallel) -> EnvState:
    """This rank's slice of an env batch (the whole batch, drawn alike on
    every rank)."""
    shard = dp.shard(env_states.batch_size)
    return map_tensors(lambda t: t[shard], env_states)


def _state_tensors(train_state: TrainState) -> List[Tensor]:
    opt = train_state.opt_state
    groups = opt.values() if isinstance(opt, dict) else [opt]
    tensors = list(train_state.model.state_dict().values())
    for g in groups:
        tensors += [g.count] + list(g.mu) + list(g.nu)
    rn = train_state.reward_norm
    return tensors + [rn.mean, rn.var, rn.count]


@torch.no_grad()
def replicate(train_state: TrainState, dp: DataParallel) -> TrainState:
    """Make `train_state` rank 0's on every rank, in place: its parameters
    and buffers, optimizer state, reward moments, counters, rollout
    generator and shared generator (derived from the rollout generator if
    it has none); then give every rank other than 0 its own rollout stream,
    derived from the shared stream and its rank. Returns train_state."""
    dp.broadcast_(_state_tensors(train_state))
    counters = torch.tensor([train_state.iteration, train_state.train_step,
                             train_state.total_env_steps, train_state.episodes_done],
                            dtype=torch.float64, device=dp.device)
    dp.broadcast_([counters])
    it, step, env_steps, episodes = counters.tolist()
    train_state.iteration, train_state.train_step = int(it), int(step)
    train_state.total_env_steps, train_state.episodes_done = float(env_steps), int(episodes)

    gen = train_state.generator
    shared = train_state.shared_generator
    if shared is None:
        shared = derived_generator(gen, "shared")
    states = [gen.get_state(), shared.get_state()]
    dp.broadcast_(states)
    gen.set_state(states[0])
    shared.set_state(states[1])
    train_state.shared_generator = shared
    if dp.rank != 0:
        train_state.generator = derived_generator(shared, f"rank {dp.rank}")
    return train_state
