"""Driver of the pixel PPO training cells (the joint VAE, config 4).

The timed call is one pixel-PPO iteration of the program, as
`pixels.pixel_train_iteration` runs it: `pixels.pixel_rollout`, then
`pixels.pixel_update`, `ppo.reduce_episodic` and `ppo.finish_iteration`,
with the rollout's action noise, each epoch's permutation and each
update's z noise made by the benchmark from the seed and handed to the
program (its `noise`, `perms` and `noises` arguments), so that the
reference takes the same draws.

Set-up builds the train state once, drives it through CHECK_STEPS
iterations (which also warm up every shape) and hands it to the window;
the check follows them with reference/pixel_ppo.py after the window.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch

from perfbench.harness import compare, yardstick
from perfbench.harness.spans import timed, wrapped
from perfbench.harness.weights import load_into, seeded_weights
from perfbench.reference import pixel_ppo as reference

CHECK_STEPS = 3
STAND_INS = ("control", "half", "noise")


def make_weights(ctx, model) -> Dict[str, torch.Tensor]:
    return seeded_weights(model, ctx.seed_for("pixel_model"), ctx.device,
                          {"policy.action_mean.weight": ctx.config["model"]["initial_mean_factor"]})


def make_noises(ctx, generator) -> dict:
    """One iteration's draws: action noise [T, B, A], a permutation per
    epoch, a z noise [minibatch, z_dim] per update."""
    ppo, dev = ctx.config["ppo"], ctx.device
    T, B = ppo["horizon"], ppo["num_envs"]
    rows = T * B // ppo["num_minibatches"]
    return {"action": torch.randn((T, B, 2), generator=generator, device=dev),
            "perms": [torch.randperm(B, generator=generator, device=dev) for _ in range(ppo["num_epochs"])],
            "z": [torch.randn((rows, ctx.config["model"]["z_dim"]), generator=generator, device=dev)
                  for _ in range(ppo["num_epochs"] * ppo["num_minibatches"])]}


def compared(gaps: Dict[str, float], action_gap: float) -> Dict[str, float]:
    """The numbers the check compares. Not the iterations' losses: their gap
    grows over the updates as Adam's first step turns rounding into whole
    steps, so a sound seed reads as high as the TF32 control and a third of
    half a batch left out; no reading bounds it (PERF.md, Findings)."""
    gaps.pop("loss_gap")
    return {**gaps, "action_gap": action_gap}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        ppo = ctx.config["ppo"]
        self.units_per_step = ppo["num_envs"] * ppo["horizon"]
        self.rollout_steps = ppo["horizon"]
        self.flops_per_step = yardstick.pixel_iteration_flops(ppo["horizon"], ppo["num_envs"], ppo["num_epochs"])
        self.kernel_calls: Dict[str, list] = {}

    def setup(self) -> None:
        from carla_ppo_tpu_torch.envs import track
        from carla_ppo_tpu_torch.envs.types import EnvParams
        from carla_ppo_tpu_torch.models.pixel_policy import PixelActorCritic
        from carla_ppo_tpu_torch.ops import rasterizer
        from carla_ppo_tpu_torch.training import pixels, ppo

        ctx, cfg = self.ctx, self.ctx.config
        dev = ctx.device
        self.pixels, self.ppo = pixels, ppo
        self.config = ppo.PPOConfig(**cfg["ppo"])
        px = cfg["pixel"]
        self.pix = pixels.PixelConfig(vae_scale=px["vae_scale"], beta=px["beta"], kl_tolerance=px["kl_tolerance"],
                                      cam=rasterizer.CameraConfig(**cfg["camera"]),
                                      policy_grad_norm=px["policy_grad_norm"],
                                      encoder_grad_norm=px["encoder_grad_norm"], deprop_aux=px["deprop_aux"])
        t, m = cfg["track"], cfg["model"]
        self.params = EnvParams(track=track.make_lap_track(seed=t["seed"], props=t["props"], device=dev))
        model = PixelActorCritic(frame_shape=tuple(m["frame_shape"]), z_dim=m["z_dim"],
                                 pi_hidden_sizes=tuple(m["pi_hidden_sizes"]),
                                 vf_hidden_sizes=tuple(m["vf_hidden_sizes"]),
                                 initial_std=cfg["ppo"]["initial_std"],
                                 initial_mean_factor=m["initial_mean_factor"]).to(dev)
        self.weights = make_weights(ctx, model)
        load_into(model, self.weights)
        self.ts = pixels.create_pixel_train_state(model, self.config, ctx.generator("rollout"))
        self.envs = ppo.init_env_batch(self.params, self.config.num_envs, self.ts.generator)
        self.noise_gen = ctx.generator("noises")

        named = list(model.named_parameters())
        groups = pixels.param_groups(model)
        self.record = reference.Record([], [], {}, {n: q.detach().clone() for n, q in named}, {})
        self.noises = []
        for k in range(CHECK_STEPS):
            noises = make_noises(ctx, self.noise_gen)
            with self._first_update({id(q): n for n, q in named}) if k == 0 else contextlib.nullcontext():
                traj, metrics = self._iteration(noises)
            self.noises.append(noises)
            self.record.actions.append(traj.actions.clone())
            self.record.losses.append(float(metrics["train_loss/loss"]))
            if k == 0:
                self.record.mu1 = {n: mom.clone() for g in pixels.GROUPS
                                   for (n, _), mom in zip(groups[g], self.ts.opt_state[g].mu)}
        self.record.params_end = {n: q.detach().clone() for n, q in named}

    @contextlib.contextmanager
    def _first_update(self, names):
        """Keep Adam's first moment of every leaf after the program's first
        update (its first clip_and_adam call of each group): the first
        gradient as the optimizer got it, before Adam's sign-like first
        step lets rounding grow through the later updates."""
        first = self.record.mu_first

        def factory(real):
            def call(params, grads, state, *args, **kwargs):
                new_params, new_state = real(params, grads, state, *args, **kwargs)
                for q, m in zip(params, new_state.mu):
                    if names[id(q)] not in first:
                        first[names[id(q)]] = m.clone()
                return new_params, new_state
            return call

        with wrapped([(self.ppo, "clip_and_adam", factory)]):
            yield

    def _iteration(self, noises):
        spans = self.ctx.spans
        with spans.span("rollout"):
            self.envs, traj, boot, episodic = self.pixels.pixel_rollout(
                self.ts.model, self.envs, self.params, self.ts.generator, self.config, self.pix,
                noise=noises["action"])
        with spans.span("update"):
            metrics = self.pixels.pixel_update(self.ts, traj, boot, self.config, self.pix,
                                               perms=noises["perms"], noises=noises["z"])
        episodic, env_steps = self.ppo.reduce_episodic(episodic, traj.rewards.numel(), None)
        self.ppo.finish_iteration(self.ts, metrics, episodic, self.config, env_steps)
        return traj, metrics

    def step(self) -> bool:
        _, metrics = self._iteration(make_noises(self.ctx, self.noise_gen))
        return math.isfinite(float(metrics["train_loss/loss"]))

    def trace_block(self) -> None:
        self.step()

    @contextlib.contextmanager
    def instrument(self):
        from carla_ppo_tpu_torch.envs import lap_env

        with wrapped([(lap_env, "autoreset_step", timed(self.ctx.spans, "env_step"))]):
            yield

    @contextlib.contextmanager
    def kernel_inputs(self):
        yield

    def release(self) -> None:
        for name in ("ts", "envs", "params"):
            setattr(self, name, None)

    def check(self) -> Dict[str, float]:
        ref, action_gap = reference.follow(self.ctx.config, self.weights, self.noises, self.ctx.device,
                                           CHECK_STEPS, actions=self.record.actions)
        return compared(compare.training_gaps(self.record, ref, first_update=True), action_gap)


def stand_in_readings(ctx, kind: str) -> Dict[str, float]:
    """The reference in the program's place: "control" in TF32, "half"
    (half of each minibatch left out) or "noise" (the action noise halved
    where the actions are produced)."""
    _, model = reference.build(ctx.config, None, ctx.device)
    weights = make_weights(ctx, model)
    del model
    gen = ctx.generator("noises")
    noises = [make_noises(ctx, gen) for _ in range(CHECK_STEPS)]
    stand_in, _ = reference.follow(ctx.config, weights, noises, ctx.device, CHECK_STEPS,
                                   generator=ctx.generator("rollout"), tf32=kind == "control",
                                   fault=None if kind == "control" else kind)
    torch.cuda.empty_cache() if ctx.device.type == "cuda" else None
    ref, action_gap = reference.follow(ctx.config, weights, noises, ctx.device, CHECK_STEPS,
                                       actions=stand_in.actions)
    return compared(compare.training_gaps(stand_in, ref, first_update=True), action_gap)
