"""Driver of the frozen-VAE latent PPO training cells (the lap env).

The timed call is one PPO iteration of the program: `ppo.rollout` with a
LatentObs (camera kernels, VAE encode, policy sample, env step with
auto-reset), then `ppo.update_from_rollout` (GAE and the epochs of Adam
updates), which is what `ppo.train_iteration` runs, with each epoch's
minibatch permutation made by the benchmark from the seed and handed to
the program (its `perms` argument) so that the reference can take the same.

Set-up builds the train state once, drives it through the first CHECK_STEPS
iterations (they also warm up every shape the window uses) and hands the
same object to the window. The check follows those iterations with the
reference after the window (reference/latent_ppo.py).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch

from perfbench.harness import compare, readers, yardstick
from perfbench.harness.spans import recorded, timed, wrapped
from perfbench.harness.weights import load_into, seeded_weights
from perfbench.reference import latent_ppo as reference

CHECK_STEPS = 3
STAND_INS = ("control", "half", "noise")


def make_weights(ctx, vae, model) -> Dict[str, Dict[str, torch.Tensor]]:
    """The benchmark's weights of both models, from the seed, on the device."""
    return {"vae": seeded_weights(vae, ctx.seed_for("vae"), ctx.device),
            "policy": seeded_weights(model, ctx.seed_for("policy"), ctx.device,
                                     {"action_mean.weight": ctx.config["policy"]["initial_mean_factor"]})}


def make_perms(ctx, generator) -> List[torch.Tensor]:
    """One iteration's minibatch permutations, one per epoch."""
    ppo = ctx.config["ppo"]
    return [torch.randperm(ppo["num_envs"], generator=generator, device=ctx.device)
            for _ in range(ppo["num_epochs"])]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        ppo = ctx.config["ppo"]
        self.units_per_step = ppo["num_envs"] * ppo["horizon"]
        self.rollout_steps = ppo["horizon"]
        self.flops_per_step = yardstick.latent_iteration_flops(
            ppo["horizon"], ppo["num_envs"], ppo["num_epochs"], ctx.config["vae"]["z_dim"],
            tuple(ctx.config["vae"]["source_shape"]), tuple(ctx.config["vae"]["features"]),
            tuple(ctx.config["policy"]["pi_hidden_sizes"]), len(ctx.config["policy"]["measurements"]))
        self.kernel_calls: Dict[str, list] = {"ground_pass": [], "composite": []}

    def setup(self) -> None:
        from carla_ppo_tpu_torch.envs import track
        from carla_ppo_tpu_torch.envs.types import EnvParams
        from carla_ppo_tpu_torch.models.policy import ActorCritic
        from carla_ppo_tpu_torch.models.vae import VAE
        from carla_ppo_tpu_torch.training import ppo

        ctx, cfg = self.ctx, self.ctx.config
        dev = ctx.device
        self.ppo = ppo
        self.config = ppo.PPOConfig(**cfg["ppo"])
        t = cfg["track"]
        self.params = EnvParams(track=track.make_lap_track(seed=t["seed"], props=t["props"], device=dev))
        v, p = cfg["vae"], cfg["policy"]
        vae = VAE(source_shape=tuple(v["source_shape"]), z_dim=v["z_dim"],
                  features=tuple(v["features"])).to(dev).eval()
        self.latent = ppo.LatentObs(vae_model=vae, measurements=tuple(p["measurements"]))
        model = ActorCritic(self.latent.obs_dim, pi_hidden_sizes=tuple(p["pi_hidden_sizes"]),
                            vf_hidden_sizes=tuple(p["vf_hidden_sizes"]),
                            initial_std=cfg["ppo"]["initial_std"]).to(dev)
        self.weights = make_weights(ctx, vae, model)
        load_into(vae, self.weights["vae"])
        load_into(model, self.weights["policy"])
        self.ts = ppo.create_train_state(model, self.config, ctx.generator("rollout"))
        self.envs = ppo.init_env_batch(self.params, self.config.num_envs, self.ts.generator)
        self.perm_gen = ctx.generator("perms")

        # The first iterations, recorded for the check.
        named = list(model.named_parameters())
        self.record = reference.Record([], [], {}, {n: q.detach().clone() for n, q in named}, {})
        self.perms = []
        for k in range(CHECK_STEPS):
            perms = make_perms(ctx, self.perm_gen)
            traj, metrics = self._iteration(perms)
            self.perms.append(perms)
            self.record.actions.append(traj.actions.clone())
            self.record.losses.append(float(metrics["train_loss/loss"]))
            if k == 0:
                self.record.mu1 = {n: m.clone() for (n, _), m in zip(named, self.ts.opt_state.mu)}
        self.record.params_end = {n: q.detach().clone() for n, q in named}

    def _iteration(self, perms):
        spans = self.ctx.spans
        with spans.span("rollout"):
            self.envs, traj, boot, episodic = self.ppo.rollout(
                self.ts.model, self.envs, self.params, self.ts.generator, self.config.horizon,
                self.config, latent_obs=self.latent)
        with spans.span("update"):
            self.envs, metrics = self.ppo.update_from_rollout(
                self.ts, self.envs, traj, boot, episodic, self.config, perms=perms)
        return traj, metrics

    def step(self) -> bool:
        """One timed iteration; False where its loss is not finite."""
        _, metrics = self._iteration(make_perms(self.ctx, self.perm_gen))
        return math.isfinite(float(metrics["train_loss/loss"]))

    def trace_block(self) -> None:
        self.step()

    @contextlib.contextmanager
    def instrument(self):
        """Spans around the calls into the layers below the iteration."""
        from carla_ppo_tpu_torch.envs import lap_env
        from carla_ppo_tpu_torch.ops import rasterizer

        spans = self.ctx.spans
        vae = self.latent.vae_model
        with wrapped([(lap_env, "autoreset_step", timed(spans, "env_step")),
                      (rasterizer, "prep_windows", timed(spans, "prep_windows")),
                      (rasterizer, "prep_candidates", timed(spans, "prep_candidates")),
                      (vae, "encode", timed(spans, "vae_encode"))]):
            yield

    @contextlib.contextmanager
    def kernel_inputs(self):
        """Keep the arguments of every camera kernel call of the traced
        block (references only, no device work)."""
        from carla_ppo_tpu_torch.ops import rasterizer_cuda

        for calls in self.kernel_calls.values():
            calls.clear()
        with wrapped([(rasterizer_cuda, "ground_pass_cuda",
                       recorded(self.kernel_calls["ground_pass"], readers.ground_pass_inputs)),
                      (rasterizer_cuda, "composite_cuda",
                       recorded(self.kernel_calls["composite"], readers.composite_inputs))]):
            yield

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("ts", "envs", "latent", "params"):
            setattr(self, name, None)
        for calls in self.kernel_calls.values():
            calls.clear()

    def check(self) -> Dict[str, float]:
        """The reference follows the check steps with the program's actions
        and the same permutations: compare.training_gaps, and the spread of
        the program's actions about the reference's mean."""
        moment = compare.SampleMoment()
        ref = reference.follow(self.ctx.config, self.weights, self.perms, self.ctx.device, CHECK_STEPS,
                               actions=self.record.actions, moment=moment)
        return {**compare.training_gaps(self.record, ref), "sample_gap": moment.gap()}


def stand_in_readings(ctx, kind: str) -> Dict[str, float]:
    """The readings of the reference put in the program's place: "control"
    in TF32, or with a fault planted: "half" (half of each minibatch left
    out, the mean taken over the rest) or "noise" (the sampled actions'
    noise halved where they are produced). Made on the chip at the cell's
    own size by perfbench/calibrate.py."""
    _, vae, model = reference.build(ctx.config, None, ctx.device)
    weights = make_weights(ctx, vae, model)
    gen = ctx.generator("perms")
    perms = [make_perms(ctx, gen) for _ in range(CHECK_STEPS)]
    stand_in = reference.follow(ctx.config, weights, perms, ctx.device, CHECK_STEPS,
                                generator=ctx.generator("rollout"), tf32=kind == "control",
                                fault=None if kind == "control" else kind)
    moment = compare.SampleMoment()
    ref = reference.follow(ctx.config, weights, perms, ctx.device, CHECK_STEPS,
                           actions=stand_in.actions, moment=moment)
    return {**compare.training_gaps(stand_in, ref), "sample_gap": moment.gap()}
