"""Driver of the memory-policy PPO training cells (the hybrid Mamba-2 /
attention torso on frozen-VAE latents, the lap env).

The timed call is one `ppo.train_iteration` of the program with the
policy's per-env memory: the rollout (camera kernels, VAE encode, the
torso's step form with the state-space step kernel, env step with
auto-reset) carries the memory and stores it at its start, then the update
runs whole env sequences from it (the sequence form) through the epochs of
Adam updates, with each epoch's minibatch permutation made by the
benchmark from the seed (the program's `perms` argument).

Set-up builds the train state and the memory once, advances the envs and
the memory through WARM_ROLLOUTS rollouts without an update (so that
episodes end, and memories reset, inside the iterations that follow),
then runs the check iteration, which also warms up every shape the window
uses, and hands the same objects to the window. The check iteration keeps,
on the host, what the reference needs (observations, episode starts, the
stored memory, actions, log-probs, rewards, dones) and what it is compared
with: the rollout's means and values, the ratio of the update's log-probs
to the rollout's on the first minibatch, Adam's first moment after the
first update and the parameters after the last. The check runs
reference/granite_h_ppo.py after the window.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch

from perfbench.harness import compare, yardstick_seq
from perfbench.harness.spans import recorded, wrapped
from perfbench.harness.weights import load_into, seeded_weights
from perfbench.reference import granite_h_ppo as reference
from perfbench.reference.ppo_ref import Record

WARM_ROLLOUTS = 3
STAND_INS = ("control", "no_reset", "stale_memory")
# Env blocks of the reference: its forward (no gradient) and its update,
# whose step-by-step recurrence keeps one state per env, layer and step.
FORWARD_BLOCK = 256
UPDATE_BLOCK = 32


def make_weights(ctx, vae, model) -> Dict[str, Dict[str, torch.Tensor]]:
    """The benchmark's weights of both models, from the seed: every Linear
    as the other cells seed theirs (the action mean at variance scale
    initial_mean_factor), and the torso's other leaves by Mamba-2's
    published init (A = -U[1, 16], dt log-uniform in [0.001, 0.1] under a
    softplus, D = 1), torch's depthwise conv init (U(-1/sqrt(d_conv), +))
    and norms of 1. The policy's are kept on the host."""
    dev = ctx.device
    policy = seeded_weights(model, ctx.seed_for("policy"), dev,
                            {"action_mean.weight": ctx.config["policy"]["initial_mean_factor"]})
    g = ctx.generator("torso")
    for name, p in model.named_parameters():
        if name in policy:
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("conv_weight", "conv_bias"):
            bound = 1.0 / math.sqrt(ctx.config["mamba_d_conv"])
            w = torch.empty(p.shape, device=dev).uniform_(-bound, bound, generator=g)
        elif leaf == "A_log":
            w = torch.log(torch.empty(p.shape, device=dev).uniform_(1.0, 16.0, generator=g))
        elif leaf == "dt_bias":
            dt = torch.exp(torch.empty(p.shape, device=dev).uniform_(math.log(1e-3), math.log(1e-1), generator=g))
            dt = dt.clamp(min=1e-4)
            w = dt + torch.log(-torch.expm1(-dt))
        elif leaf in ("D", "weight") or name == "action_logstd":
            w = p.detach().clone()  # D and the norms 1; the log-std the configuration's initial std
        else:
            raise KeyError(f"no seeded init for {name}")
        policy[name] = w
    return {"vae": seeded_weights(vae, ctx.seed_for("vae"), dev),
            "policy": {n: w.cpu() for n, w in policy.items()}}


def make_perms(ctx, generator) -> List[torch.Tensor]:
    ppo = ctx.config["ppo"]
    return [torch.randperm(ppo["num_envs"], generator=generator, device=ctx.device)
            for _ in range(ppo["num_epochs"])]


def hybrid_sizes(config: dict):
    """The program's HybridSizes from the configuration file's keys."""
    from carla_ppo_tpu_torch.models.hybrid_policy import HybridSizes

    return HybridSizes(
        hidden_size=config["hidden_size"], intermediate_size=config["shared_intermediate_size"],
        layer_types=tuple(config["layer_types"]), mamba_expand=config["mamba_expand"],
        mamba_n_heads=config["mamba_n_heads"], mamba_d_head=config["mamba_d_head"],
        mamba_d_state=config["mamba_d_state"], mamba_n_groups=config["mamba_n_groups"],
        mamba_d_conv=config["mamba_d_conv"], mamba_chunk_size=config["mamba_chunk_size"],
        num_attention_heads=config["num_attention_heads"], num_key_value_heads=config["num_key_value_heads"],
        attention_multiplier=config["attention_multiplier"], residual_multiplier=config["residual_multiplier"],
        embedding_multiplier=float(config["embedding_multiplier"]), rms_norm_eps=config["rms_norm_eps"],
        memory_window=config["policy"]["memory_window"])


def host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        ppo = ctx.config["ppo"]
        self.units_per_step = ppo["num_envs"] * ppo["horizon"]
        self.flops_per_step = yardstick_seq.iteration_flops(ctx.config)
        self.kernel_calls: Dict[str, list] = {"ssm_step": []}

    def setup(self) -> None:
        from carla_ppo_tpu_torch.envs import track
        from carla_ppo_tpu_torch.envs.types import EnvParams
        from carla_ppo_tpu_torch.models.hybrid_policy import HybridActorCritic
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
        model = HybridActorCritic(self.latent.obs_dim, hybrid_sizes(cfg), initial_std=cfg["ppo"]["initial_std"],
                                  initial_mean_factor=p["initial_mean_factor"], device=dev)
        self.weights = make_weights(ctx, vae, model)
        load_into(vae, self.weights["vae"])
        load_into(model, {n: w.to(dev) for n, w in self.weights["policy"].items()})
        self.ts = ppo.create_train_state(model, self.config, ctx.generator("rollout"))
        self.envs = ppo.init_env_batch(self.params, self.config.num_envs, self.ts.generator)
        self.memory = model.initial_memory(self.config.num_envs)
        self.perm_gen = ctx.generator("perms")
        for _ in range(WARM_ROLLOUTS):
            self.envs, _, _, _ = ppo.rollout(model, self.envs, self.params, self.ts.generator,
                                             self.config.horizon, self.config, latent_obs=self.latent,
                                             memory=self.memory)
        self._check_iteration(model)

    def _check_iteration(self, model) -> None:
        """One timed-path iteration, keeping what the check reads."""
        ppo = self.ppo
        named = list(model.named_parameters())
        names = {id(q): n for n, q in named}
        rec = self.record = {"params0": {n: host(q) for n, q in named}, "steps": [], "ratio_gap": None,
                             "mu_first": {}}
        kept: Dict[str, object] = {}

        def keep_rollout(real):
            def call(*args, **kwargs):
                out = real(*args, **kwargs)
                kept["rollout"] = out
                return out
            return call

        def keep_steps(real):
            def call(model_, obs, memory, first, commit=True):
                out = real(model_, obs, memory, first, commit)
                rec["steps"].append((host(obs), host(first), host(out[0]), host(out[2])))
                return out
            return call

        def keep_ratio(real):
            def call(m, batch, cfg, ent=None):
                if rec["ratio_gap"] is None:
                    with torch.no_grad():
                        mean, std, _ = m.sequence(batch["obs"], batch["memory0"], batch["firsts"], batch.get("envs"))
                    logp = reference.torso.gaussian_log_prob(batch["actions"], mean, std)
                    rec["ratio_gap"] = float((torch.exp(logp - batch["log_probs"]) - 1.0).abs().max())
                return real(m, batch, cfg, ent)
            return call

        def keep_first_moment(real):
            def call(params, grads, state, *args, **kwargs):
                new_params, new_state = real(params, grads, state, *args, **kwargs)
                if not rec["mu_first"]:
                    rec["mu_first"] = {names[id(q)]: host(m) for q, m in zip(params, new_state.mu)}
                return new_params, new_state
            return call

        self.perms = make_perms(self.ctx, self.perm_gen)
        with wrapped([(ppo, "rollout", keep_rollout), (type(model), "step", keep_steps),
                      (ppo, "ppo_loss", keep_ratio), (ppo, "clip_and_adam", keep_first_moment)]):
            self._iteration(self.perms)
        _, traj, _, _ = kept.pop("rollout")
        rec["params_end"] = {n: host(q) for n, q in named}
        mem = traj.memory0
        rec["memory0"] = {"ssm": host(mem.ssm), "conv": host(mem.conv), "keys": host(mem.keys),
                          "values": host(mem.values), "length": host(mem.length), "slot": mem.slot}
        rec["traj"] = {k: host(getattr(traj, k)) for k in ("actions", "log_probs", "rewards", "dones")}
        del traj, mem

    def _iteration(self, perms) -> Dict[str, torch.Tensor]:
        self.ts, self.envs, metrics = self.ppo.train_iteration(
            self.ts, self.envs, self.params, self.config, latent_obs=self.latent, perms=perms, memory=self.memory)
        return metrics

    def step(self) -> bool:
        """One timed iteration; False where its loss is not finite."""
        metrics = self._iteration(make_perms(self.ctx, self.perm_gen))
        return math.isfinite(float(metrics["train_loss/loss"]))

    def trace_block(self) -> None:
        self.step()

    @contextlib.contextmanager
    def instrument(self):
        yield

    @contextlib.contextmanager
    def kernel_inputs(self):
        """Keep the sizes, reset flags and commit of every state-space step
        call of the traced block (references only, no device work)."""
        from carla_ppo_tpu_torch.ops import ssm_cuda

        calls = self.kernel_calls["ssm_step"]
        calls.clear()
        with wrapped([(ssm_cuda, "ssm_step_cuda", recorded(calls, yardstick_seq.ssm_step_inputs))]):
            yield

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("ts", "envs", "latent", "params", "memory"):
            setattr(self, name, None)
        for calls in self.kernel_calls.values():
            calls.clear()

    def check(self) -> Dict[str, float]:
        """The reference from the check iteration's inputs: its rollout
        means and values against the program's (rollout_gap), the spread of
        the program's actions about its means (sample_gap), the program's
        first-minibatch ratio (ratio_gap), and its update against the
        program's: Adam's first moment after the first update
        (first_grad_gap) and every leaf's change over the iteration
        (change_gap). The iteration's mean loss is not compared: Adam's
        first steps turn rounding into whole steps (as in the pixel cell)."""
        cfg, dev, rec = self.ctx.config, self.ctx.device, self.record
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            s = reference.sizes(cfg)
            P = reference.parameters(self.weights["policy"], dev)
            memory0 = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in rec["memory0"].items()}
            steps = rec["steps"]  # T committed steps, then the bootstrap value's
            obs = torch.stack([o for o, _, _, _ in steps], 1).to(dev)
            firsts = torch.stack([f for _, f, _, _ in steps], 1).to(dev)
            prog_means = torch.stack([m for _, _, m, _ in steps], 1).to(dev)
            prog_values = torch.stack([v for _, _, _, v in steps], 1).to(dev)
            means, std, values = reference.rollout_forward(P, s, obs, firsts, memory0, FORWARD_BLOCK)
            rollout_gap = max(float((prog_means - means).abs().max() / means.abs().max()),
                              float((prog_values - values).abs().max() / values.abs().max()))
            T = obs.shape[1] - 1
            traj = {k: v.to(dev) for k, v in rec["traj"].items()}
            moment = compare.SampleMoment()
            moment.add(traj["actions"].transpose(0, 1), means[:, :T], std, P["action_low"], P["action_high"])
            data = {"obs": obs[:, :T], "firsts": firsts[:, :T], "actions": traj["actions"].transpose(0, 1),
                    "log_probs": traj["log_probs"].transpose(0, 1), "rewards": traj["rewards"], "dones": traj["dones"]}
            mu_first, params_end, _ = reference.update(P, s, cfg, data, memory0, values[:, :T].transpose(0, 1),
                                                       values[:, T], self.perms, UPDATE_BLOCK)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        program = Record([], [0.0], {}, rec["params0"], rec["params_end"], rec["mu_first"])
        ref = Record([], [0.0], {}, rec["params0"], {n: host(w) for n, w in params_end.items()},
                     {n: host(m) for n, m in mu_first.items()})
        gaps = compare.training_gaps(program, ref, first_update=True)
        gaps.pop("loss_gap")
        return {"rollout_gap": rollout_gap, "ratio_gap": rec["ratio_gap"], **gaps, "sample_gap": moment.gap()}


@contextlib.contextmanager
def planted(kind: str):
    """The stand-ins, planted in the program: "control" runs it with TF32
    matmuls (the precision below the configuration's), "no_reset" keeps
    each env's memory across episode starts (both forms), "stale_memory"
    starts the update's sequences from zero memory."""
    from carla_ppo_tpu_torch.models import hybrid_policy

    if kind == "control":
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        return
    cls = hybrid_policy.HybridActorCritic
    if kind == "no_reset":
        def step(real):
            return lambda self, obs, memory, first, commit=True: real(self, obs, memory, torch.zeros_like(first), commit)

        def sequence(real):
            return lambda self, obs, memory0, firsts, envs=None: real(self, obs, memory0, torch.zeros_like(firsts),
                                                                      envs)

        targets = [(cls, "step", step), (cls, "sequence", sequence)]
    elif kind == "stale_memory":
        def sequence(real):  # every sequence continues the one env of a zero memory
            def call(self, obs, memory0, firsts, envs=None):
                zero = self.initial_memory(1, obs.device)
                return real(self, obs, zero, firsts, torch.zeros(obs.shape[0], dtype=torch.long, device=obs.device))
            return call

        targets = [(cls, "sequence", sequence)]
    else:
        raise KeyError(kind)
    with wrapped(targets):
        yield


def stand_in_readings(ctx, kind: str) -> Dict[str, float]:
    """The check's readings with a stand-in in the program's place (made on
    the chip at the cell's own size by perfbench/calibrate.py)."""
    drv = Driver(ctx)
    with planted(kind):
        drv.setup()
    drv.release()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return drv.check()
