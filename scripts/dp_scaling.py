"""Data-parallel scaling of latent lap PPO over the visible cards.

    python scripts/dp_scaling.py                       # world sizes 1, 2, 4 over NCCL
    python scripts/dp_scaling.py --worlds 1,2 --device cpu --envs_per_rank 8 --horizon 4

For each world size W, W ranks (spawned processes, one card each; NCCL on
cards, gloo on the CPU) train the lap path of chip_smoke.py phase 7 (the
lap track with props, the seeded de-prop seg VAE widths, a 500/300
policy, PPOConfig defaults with W x `envs_per_rank` envs) for
`iterations` data-parallel iterations, run a 300-step data-parallel
evaluate, then drive the Trainer (vector observations, tiny): one
iteration with a data-parallel eval and a checkpoint, then a second
Trainer that resumes it and evaluates on rank 0 alone (an eval batch that
does not divide over the ranks, so rank 0's metrics are broadcast).

Prints one JSON line per world size: the warm iteration's seconds and
global env-steps/s, the collective calls and ms per rank (CUDA events
around DataParallel.mean), the camera kernels' launches per rollout, and
the card's name and power limit. Exits non-zero when the ranks' states
(every parameter, buffer, Adam and reward moment) or evaluate metrics
differ, or the resume does not continue at iteration 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_STEPS = 300
DEADLINE_S = 900


def _checksum(torch, train_state) -> str:
    from carla_ppo_tpu_torch.parallel import train_dp

    h = hashlib.sha256()
    for t in train_dp._state_tensors(train_state):
        h.update(t.detach().cpu().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed_collectives(torch, dev, spans):
    """Wrap DataParallel.mean to record its device (CUDA events) and host
    ms into `spans`; returns the original to restore."""
    from carla_ppo_tpu_torch.parallel import mesh

    real = mesh.DataParallel.mean

    def timed(self, tensors):
        h0 = time.perf_counter()
        if dev.type != "cuda":
            out = real(self, tensors)
            spans.append((None, None, time.perf_counter() - h0))
            return out
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(self, tensors)
        end.record()
        spans.append((start, end, time.perf_counter() - h0))
        return out

    mesh.DataParallel.mean = timed
    return real


def rank_main(rank: int, world: int, init_method: str, out_dir: str, args: dict) -> None:
    import torch

    sys.path.insert(0, REPO)
    from carla_ppo_tpu_torch.envs import track
    from carla_ppo_tpu_torch.envs.types import EnvParams
    from carla_ppo_tpu_torch.models.policy import ActorCritic
    from carla_ppo_tpu_torch.models.vae import VAE
    from carla_ppo_tpu_torch.ops import rasterizer_cuda as RC
    from carla_ppo_tpu_torch.parallel import mesh, train_dp
    from carla_ppo_tpu_torch.training import loop, ppo
    from carla_ppo_tpu_torch.utils.device import exact_float32, make_generator

    exact_float32()
    dp = mesh.init(rank, world, init_method, args["device"], timeout_s=DEADLINE_S / 2)
    try:
        dev = dp.device
        params = EnvParams(track=track.make_lap_track(seed=0, props=True, device=dev))
        seed_gen = make_generator(1, "cpu")
        vae = VAE(source_shape=(80, 160, 1), z_dim=64, generator=seed_gen).to(dev).eval()
        latent = ppo.LatentObs(vae_model=vae)
        model = ActorCritic(latent.obs_dim, generator=seed_gen).to(dev)
        config = ppo.PPOConfig(num_envs=world * args["envs_per_rank"], horizon=args["horizon"])
        ts = ppo.create_train_state(model, config, make_generator(2, dev))
        envs = train_dp.shard_env_batch(ppo.init_env_batch(params, config.num_envs, ts.generator), dp)
        train_dp.replicate(ts, dp)
        step = train_dp.make_dp_train_iteration(dp, config, params, latent)
        spans: list = []
        real = _timed_collectives(torch, dev, spans)
        out = {"iterations": []}
        try:
            for _ in range(args["iterations"]):
                del spans[:]
                RC.reset_launch_counts()
                _sync(torch, dev)
                h0 = time.perf_counter()
                ts, envs, m = step(ts, envs)
                _sync(torch, dev)
                seconds = time.perf_counter() - h0
                out["iterations"].append({
                    "seconds": seconds, "launches": dict(RC.LAUNCHES),
                    "checksum": _checksum(torch, ts), "collectives": len(spans),
                    "collective_ms": sum(s.elapsed_time(e) for s, e, _ in spans if s is not None),
                    "collective_host_ms": 1e3 * sum(h for _, _, h in spans),
                    "loss": m["train_loss/loss"].item()})
        finally:
            mesh.DataParallel.mean = real
        h0 = time.perf_counter()
        ev = train_dp.make_dp_evaluate(dp, ts.model, config, params, config.num_envs, chunk=EVAL_STEPS,
                                       latent_obs=latent)(make_generator(3, dev), EVAL_STEPS)
        _sync(torch, dev)
        out["eval"] = {"seconds": time.perf_counter() - h0,
                       "metrics": {k: v.tolist() for k, v in ev.items()}}

        # The Trainer: a DP eval and a checkpoint, then a resume with a
        # rank-0 eval.
        tconf = ppo.PPOConfig(num_envs=64 * world, horizon=16, num_minibatches=2, num_epochs=1)
        out["trainer"] = []
        for target, eval_envs in ((1, world), (2, world + 1)):
            settings = loop.TrainerSettings(
                model_name="dp", models_root=os.path.join(out_dir, "models"), num_iterations=target,
                eval_interval=1, eval_envs=eval_envs, eval_max_steps=64, checkpoint_interval=1,
                num_devices=world)
            tr = loop.Trainer(settings, tconf, device=dev, dp=dp)
            try:
                start = tr.iteration
                metrics = tr.train()
                out["trainer"].append({"start": start, "end": tr.iteration,
                                       "checksum": _checksum(torch, tr.train_state),
                                       "metrics": metrics})
            finally:
                tr.close()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        mesh.destroy()


def run_world(world: int, args: dict) -> dict:
    import torch.multiprocessing as mp

    from carla_ppo_tpu_torch.parallel import mesh

    with tempfile.TemporaryDirectory() as out_dir:
        h0 = time.perf_counter()
        ctx = mp.start_processes(rank_main, args=(world, f"tcp://127.0.0.1:{mesh.free_port()}",
                                                  out_dir, args),
                                 nprocs=world, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=max(1.0, DEADLINE_S - (time.perf_counter() - h0))):
                if time.perf_counter() - h0 > DEADLINE_S:
                    raise SystemExit(f"world {world}: ranks still running after {DEADLINE_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    its = [[rk["iterations"][i] for rk in ranks] for i in range(args["iterations"])]
    bad = []
    for i, per_rank in enumerate(its):
        if len({it["checksum"] for it in per_rank}) != 1:
            bad.append(f"iteration {i}: the ranks' states differ")
    if any(rk["eval"]["metrics"] != ranks[0]["eval"]["metrics"] for rk in ranks):
        bad.append("the ranks' evaluate metrics differ")
    for run in range(2):
        if len({rk["trainer"][run]["checksum"] for rk in ranks}) != 1 or any(
                rk["trainer"][run]["metrics"] != ranks[0]["trainer"][run]["metrics"] for rk in ranks):
            bad.append(f"Trainer run {run}: the ranks differ")
    if [(t["start"], t["end"]) for t in ranks[0]["trainer"]] != [(0, 1), (1, 2)]:
        bad.append(f"the Trainer did not resume at 1: {ranks[0]['trainer']}")
    warm = its[-1]
    seconds = max(it["seconds"] for it in warm)
    steps = world * args["envs_per_rank"] * args["horizon"]
    return {
        "world": world, "envs": world * args["envs_per_rank"],
        "iteration_s": [max(it["seconds"] for it in per_rank) for per_rank in its],
        "warm_env_steps_per_s": steps / seconds,
        "collectives_per_rank": [it["collectives"] for it in warm],
        "collective_ms_per_rank": [it["collective_ms"] for it in warm],
        "collective_host_ms_per_rank": [it["collective_host_ms"] for it in warm],
        "launches_per_rollout": warm[0]["launches"],
        "eval_s": max(rk["eval"]["seconds"] for rk in ranks),
        "eval_distance": ranks[0]["eval"]["metrics"]["eval/distance_traveled"],
        "wall_s": time.perf_counter() - h0, "faults": bad,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--worlds", default="1,2,4")
    parser.add_argument("--envs_per_rank", type=int, default=1024)
    parser.add_argument("--horizon", type=int, default=128)
    parser.add_argument("--iterations", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args = vars(parser.parse_args())
    import torch

    sys.path.insert(0, REPO)
    if args["device"] == "cuda":
        if not torch.cuda.is_available():
            print("dp_scaling: no CUDA device", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    else:
        card = "cpu"
    print(card, flush=True)
    faults = []
    for world in (int(w) for w in args["worlds"].split(",")):
        result = run_world(world, args)
        print(json.dumps({"card": card.splitlines()[0], **result}), flush=True)
        faults += result["faults"]
    if faults:
        print(f"dp_scaling: {faults}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
