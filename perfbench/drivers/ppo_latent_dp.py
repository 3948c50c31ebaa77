"""Driver of the data-parallel latent PPO training cells: one rank a card.

This process is rank 0 on the first card; set-up starts the other ranks
(`python3 -m perfbench.drivers.ppo_latent_dp <args>`, one process each, on
the next cards) and joins them in a process group through
carla_ppo_tpu_torch.parallel.mesh (NCCL on cards, gloo on the CPU). Every
rank builds the same train state (train_dp.replicate makes it rank 0's),
takes its slice of the env batch and runs the timed call, one
`ppo.train_iteration(dp=, perms=)` of the program on its own envs, when
rank 0 says so: rank 0 broadcasts a command before each call (the
program's own collectives inside the update keep the ranks in step).
The rate counts the env-steps of every rank.

Set-up runs CHECK_STEPS iterations (they warm every shape) and gathers, on
rank 0, what the reference needs: every rank's actions, the mean loss and
Adam's first moment after the first iteration, the parameters before and
after. `release` gathers every rank's parameters once more
(`replica_gap`: the ranks must hold the same bits) and stops the ranks.
The check follows the iterations with reference/latent_ppo_dp.py over the
ranks' envs together.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import torch

from perfbench.harness import compare
from perfbench.harness.weights import load_into, seeded_weights
from perfbench.reference import latent_ppo_dp as reference

CHECK_STEPS = 1
STAND_INS = ("control", "local")
STEP, SKEW, PARAMS, STOP = 1, 2, 3, 0
JOIN_S = 120.0
TIMEOUT_S = 300.0  # a collective that waits longer fails


def make_weights(ctx, vae, model) -> Dict[str, Dict[str, torch.Tensor]]:
    """The benchmark's weights of both models, from the seed, on the device."""
    return {"vae": seeded_weights(vae, ctx.seed_for("vae"), ctx.device),
            "policy": seeded_weights(model, ctx.seed_for("policy"), ctx.device,
                                     {"action_mean.weight": ctx.config["policy"]["initial_mean_factor"]})}


def make_perms(ctx, generator) -> List[torch.Tensor]:
    """One iteration's permutations of a rank's envs, the same on every rank."""
    ppo = ctx.config["ppo"]
    return [torch.randperm(ppo["num_envs"], generator=generator, device=ctx.device)
            for _ in range(ppo["num_epochs"])]


@contextlib.contextmanager
def planted(kind):
    """The stand-ins, planted in the program on every rank: "control" runs
    it with TF32 matmuls and convolutions (the precision below the
    configuration's), "local" has each rank skip the all-reduce of the
    update (its collectives return its own values)."""
    if kind is None:
        yield
        return
    if kind == "control":
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        return
    if kind != "local":
        raise KeyError(kind)
    from carla_ppo_tpu_torch.parallel.mesh import DataParallel

    from perfbench.harness.spans import wrapped

    def local(real):
        return lambda self, tensors: [t.detach().to(torch.float32) for t in tensors]

    with wrapped([(DataParallel, "mean", local)]):
        yield


class Rank:
    """What every rank holds and runs (rank 0 inside the Driver)."""

    def __init__(self, ctx, rank: int, world: int, init_method: str):
        from carla_ppo_tpu_torch.envs import track
        from carla_ppo_tpu_torch.envs.types import EnvParams
        from carla_ppo_tpu_torch.models.policy import ActorCritic
        from carla_ppo_tpu_torch.models.vae import VAE
        from carla_ppo_tpu_torch.parallel import mesh, train_dp
        from carla_ppo_tpu_torch.training import ppo

        self.ctx, self.ppo = ctx, ppo
        cfg = ctx.config
        self.dp = mesh.init(rank, world, init_method, device=ctx.device.type, timeout_s=TIMEOUT_S)
        dev = ctx.device = self.dp.device
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
        train_dp.replicate(self.ts, self.dp)
        full = ppo.init_env_batch(self.params, world * self.config.num_envs, ctx.generator("envs"))
        self.envs = train_dp.shard_env_batch(full, self.dp)
        self.perm_gen = ctx.generator("perms")
        self.cmd = torch.zeros(1, dtype=torch.int64, device=dev)
        self.rollout_ms = float("nan")

    def iteration(self, perms):
        self.ts, self.envs, metrics = self.ppo.train_iteration(
            self.ts, self.envs, self.params, self.config, latent_obs=self.latent, dp=self.dp, perms=perms)
        return metrics

    def skew_iteration(self) -> None:
        """One iteration inside the program's span recorder, keeping the
        `rollout` span's host ms."""
        from carla_ppo_tpu_torch.utils import profiling

        with profiling.recording() as rec:
            self.iteration(make_perms(self.ctx, self.perm_gen))
        self.rollout_ms = rec.totals_by_name()["rollout"].host_ms

    def flat_params(self) -> torch.Tensor:
        return torch.cat([q.detach().reshape(-1) for q in self.ts.model.parameters()])

    def command(self, cmd: int) -> int:
        """Rank 0 sends `cmd`; every other rank receives rank 0's."""
        import torch.distributed as dist

        self.cmd.fill_(cmd)
        dist.broadcast(self.cmd, 0)
        return int(self.cmd.item())

    def serve(self) -> None:
        """A rank other than 0: follow rank 0's commands until STOP."""
        import torch.distributed as dist

        for _ in range(CHECK_STEPS):
            self.check_iteration()
        while True:
            cmd = self.command(0)
            if cmd == STEP:
                self.iteration(make_perms(self.ctx, self.perm_gen))
            elif cmd == SKEW:
                self.skew_iteration()
                self.dp.all_gather(torch.tensor([self.rollout_ms], device=self.dp.device))
            elif cmd == PARAMS:
                self.dp.all_gather(self.flat_params()[None])
            else:
                break
        dist.barrier()

    def check_iteration(self):
        """A check iteration: every rank's actions gathered on rank 0."""
        perms = make_perms(self.ctx, self.perm_gen)
        holder = {}
        real = self.ppo.rollout

        def rollout(*args, **kwargs):
            out = real(*args, **kwargs)
            holder["actions"] = out[1].actions
            return out

        self.ppo.rollout = rollout
        try:
            metrics = self.iteration(perms)
        finally:
            self.ppo.rollout = real
        acts = holder["actions"]  # [T, n, A]
        gathered = self.dp.all_gather(acts.transpose(0, 1).contiguous())  # [world * n, T, A]
        return perms, gathered.transpose(0, 1), metrics


class Driver:
    def __init__(self, ctx, fault=None):
        self.ctx = ctx
        self.fault = fault
        ppo = ctx.config["ppo"]
        self.world = int(ctx.traffic["ranks"])
        self.units_per_step = self.world * ppo["num_envs"] * ppo["horizon"]
        self.procs: List[subprocess.Popen] = []
        self.rank = None
        self.replica_gap = math.inf

    def _spawn(self, init_method: str) -> None:
        ctx = self.ctx
        self._tmp = tempfile.TemporaryDirectory(prefix="perfbench-dp-")
        spec = os.path.join(self._tmp.name, "rank.json")
        with open(spec, "w") as f:
            json.dump({"seed": ctx.seed, "device": ctx.device.type, "config": ctx.config, "traffic": ctx.traffic,
                       "world": self.world, "init_method": init_method, "fault": self.fault}, f)
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for r in range(1, self.world):
            self.procs.append(subprocess.Popen([sys.executable, "-m", "perfbench.drivers.ppo_latent_dp", spec, str(r)],
                                               cwd=root, stdout=sys.stderr))

    def setup(self) -> None:
        from carla_ppo_tpu_torch.parallel import mesh

        if self.ctx.device.type == "cuda":  # build the kernels once, before the ranks look for them
            from carla_ppo_tpu_torch.utils import cuda_build

            cuda_build.build()
        init_method = f"tcp://127.0.0.1:{mesh.free_port()}"
        self._spawn(init_method)
        with planted(self.fault):
            self.rank = Rank(self.ctx, 0, self.world, init_method)
            rank = self.rank
            named = list(rank.ts.model.named_parameters())
            self.record = reference.Record([], [], {}, {n: q.detach().clone() for n, q in named}, {})
            self.perms = []
            for k in range(CHECK_STEPS):
                perms, actions, metrics = rank.check_iteration()
                self.perms.append(perms)
                self.record.actions.append(actions)
                self.record.losses.append(float(metrics["train_loss/loss"]))
                if k == 0:
                    self.record.mu1 = {n: m.clone() for (n, _), m in zip(named, rank.ts.opt_state.mu)}
            self.record.params_end = {n: q.detach().clone() for n, q in named}

    def step(self) -> bool:
        rank = self.rank
        rank.command(STEP)
        with planted(self.fault):
            metrics = rank.iteration(make_perms(self.ctx, rank.perm_gen))
        return math.isfinite(float(metrics["train_loss/loss"]))

    def trace_block(self) -> None:
        self.step()

    def rollout_skew_ms(self) -> float:
        """Max minus min over the ranks of the `rollout` span's host ms in
        one more iteration (every rank recording)."""
        rank = self.rank
        rank.command(SKEW)
        with planted(self.fault):
            rank.skew_iteration()
        ms = rank.dp.all_gather(torch.tensor([rank.rollout_ms], device=rank.dp.device))
        return float(ms.max() - ms.min())

    @contextlib.contextmanager
    def instrument(self):
        yield

    @contextlib.contextmanager
    def kernel_inputs(self):
        yield

    def release(self) -> None:
        """Gather every rank's parameters (replica_gap), stop the ranks,
        leave the group, free the program's state."""
        import torch.distributed as dist

        from carla_ppo_tpu_torch.parallel import mesh

        rank = self.rank
        if rank is not None:
            rank.command(PARAMS)
            flat = rank.dp.all_gather(rank.flat_params()[None])
            self.replica_gap = float((flat - flat[0:1]).abs().max())
            rank.command(STOP)
            dist.barrier()
            mesh.destroy()
        deadline = time.time() + JOIN_S
        for p in self.procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
        bad = [p.returncode for p in self.procs if p.returncode != 0]
        self.procs = []
        if bad:
            raise RuntimeError(f"ranks exited with {bad}")
        self.rank = None

    def check(self) -> Dict[str, float]:
        """The reference follows the check iterations over every rank's envs
        with the program's actions and the same permutations:
        compare.training_gaps and the actions' spread about the reference's
        mean; and the ranks' parameters against each other (replica_gap)."""
        moment = compare.SampleMoment()
        ref = reference.follow(self.ctx.config, self.weights(), self.perms, self.ctx.device, CHECK_STEPS,
                               self.world, self.record.actions, moment)
        return {**compare.training_gaps(self.record, ref), "sample_gap": moment.gap(),
                "replica_gap": self.replica_gap}

    def weights(self):
        """The seeded weights again (the same seed gives the same tensors)."""
        from perfbench.reference import latent_ppo

        _, vae, model = latent_ppo.build(self.ctx.config, None, self.ctx.device)
        return make_weights(self.ctx, vae, model)


def stand_in_readings(ctx, kind: str) -> Dict[str, float]:
    """The check's readings with the stand-in planted on every rank."""
    drv = Driver(ctx, fault=kind)
    drv.setup()
    drv.release()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return drv.check()


def _exit_with_parent() -> None:
    """End this rank when rank 0's process ends (a rank blocked in a
    collective would otherwise wait for the group's timeout)."""
    import threading

    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def worker(spec_path: str, rank: int) -> None:
    from perfbench.harness.main import Context
    from perfbench.harness.spans import NoSpans

    _exit_with_parent()

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(spec["seed"], torch.device(spec["device"]), spec["config"], spec["traffic"], NoSpans())
    with planted(spec["fault"]):
        Rank(ctx, rank, spec["world"], spec["init_method"]).serve()
    from carla_ppo_tpu_torch.parallel import mesh

    mesh.destroy()


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]))
