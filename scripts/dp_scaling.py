"""Data-parallel scaling of PPO over the visible cards.

    python scripts/dp_scaling.py        # lap at 1, 2, 4 ranks; route, lap_bank at 4; pixels at 2
    python scripts/dp_scaling.py --runs lap:1,2 --device cpu --envs_per_rank 8 --horizon 4

Each run is a path and a world size W: W ranks (spawned processes, one
card each; NCCL on cards, gloo on the CPU) train that path with PPOConfig
defaults and W x `envs_per_rank` envs for `iterations` data-parallel
iterations (PIXEL_ITERATIONS on the pixel path), then run a 300-step
data-parallel evaluate. The paths, at the widths of chip_smoke.py:
- lap: the lap track with props, the seeded de-prop seg VAE widths, a
  500/300 policy (phase 7); after the evaluate it drives the Trainer
  (vector observations, tiny): one iteration with a data-parallel eval and
  a checkpoint, then a second Trainer that resumes it and evaluates on
  rank 0 alone (an eval batch that does not divide over the ranks, so rank
  0's metrics are broadcast);
- route: the same latent observation on a bank of 64 random routes
  (capacity 1024, props) with reward normalisation (phase 9);
- lap_bank: on 16 lap circuits (capacity 2048, props) (phase 9);
- pixels: the pixel agent with the joint VAE at full width (2,951,842
  parameters), one rank per card (a rank peaks at ~52 GiB).

Prints one JSON line per run: the warm (last) iteration's seconds and
global env-steps/s, the collective calls and ms per rank (CUDA events
around DataParallel.mean), the camera kernels' launches per rollout of
each rank, and the card's name and power limit. Exits non-zero when the
ranks' states (every parameter, buffer, Adam and reward moment) or
evaluate metrics differ, a rank's rollout did not launch the ground pass
and the composite horizon + 1 times each, or the resume does not continue
at iteration 1.
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
RUNS = "lap:1,2,4;route:4;lap_bank:4;pixels:2"
# A pixel iteration at 1024 envs per rank takes about 27 s (NVIDIA H100 80GB
# HBM3, 700 W); two give the warm one that is timed.
PIXEL_ITERATIONS = 2


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


def _path_setup(path: str, world: int, args: dict, dp):
    """(config, train state, this rank's envs, DP iteration, a builder of
    the DP evaluate of a train state) of one path, every rank seeded
    alike."""
    from carla_ppo_tpu_torch.envs import lap_bank_env, route_env, route_planner, track
    from carla_ppo_tpu_torch.envs.types import EnvParams
    from carla_ppo_tpu_torch.models.pixel_policy import PixelActorCritic
    from carla_ppo_tpu_torch.models.policy import ActorCritic
    from carla_ppo_tpu_torch.models.vae import VAE
    from carla_ppo_tpu_torch.parallel import train_dp
    from carla_ppo_tpu_torch.training import pixels, ppo
    from carla_ppo_tpu_torch.utils.device import make_generator

    dev = dp.device
    n = world * args["envs_per_rank"]
    seed_gen = make_generator(1, "cpu")
    if path == "route":
        bank = route_planner.make_route_bank(route_planner.make_town(seed=0), n_routes=64,
                                             capacity=1024, props=True, device=dev)
        params = route_env.route_env_params(bank)
        config = ppo.PPOConfig(env_kind="route", normalize_rewards=True, num_envs=n,
                               horizon=args["horizon"])
    elif path == "lap_bank":
        bank = lap_bank_env.make_lap_bank(n_tracks=16, capacity=2048, props=True, device=dev)
        params = lap_bank_env.lap_bank_params(bank)
        config = ppo.PPOConfig(env_kind="lap_bank", num_envs=n, horizon=args["horizon"])
    else:
        params = EnvParams(track=track.make_lap_track(seed=0, props=True, device=dev))
        config = ppo.PPOConfig(num_envs=n, horizon=args["horizon"])
    if path == "pixels":
        model = PixelActorCritic(initial_std=config.initial_std, generator=seed_gen).to(dev)
        ts = pixels.create_pixel_train_state(model, config, make_generator(2, dev))
        step = train_dp.make_dp_pixel_train_iteration(dp, config, params)

        def evaluate(ts):
            return train_dp.make_dp_pixel_evaluate(dp, ts.model, config, params, n,
                                                   chunk=EVAL_STEPS)
    else:
        vae = VAE(source_shape=(80, 160, 1), z_dim=64, generator=seed_gen).to(dev).eval()
        latent = ppo.LatentObs(vae_model=vae)
        model = ActorCritic(latent.obs_dim, generator=seed_gen).to(dev)
        ts = ppo.create_train_state(model, config, make_generator(2, dev))
        step = train_dp.make_dp_train_iteration(dp, config, params, latent)

        def evaluate(ts):
            return train_dp.make_dp_evaluate(dp, ts.model, config, params, n,
                                             chunk=EVAL_STEPS, latent_obs=latent)
    envs = ppo.init_env_batch(params, n, ts.generator, config.env_kind)
    return config, ts, train_dp.shard_env_batch(envs, dp), step, evaluate



def rank_main(rank: int, world: int, init_method: str, out_dir: str, args: dict,
              path: str) -> None:
    import torch

    sys.path.insert(0, REPO)
    from carla_ppo_tpu_torch.ops import rasterizer_cuda as RC
    from carla_ppo_tpu_torch.parallel import mesh, train_dp
    from carla_ppo_tpu_torch.training import loop, ppo
    from carla_ppo_tpu_torch.utils.device import exact_float32, make_generator

    exact_float32()
    dp = mesh.init(rank, world, init_method, args["device"], timeout_s=DEADLINE_S / 2)
    try:
        dev = dp.device
        config, ts, envs, step, evaluate = _path_setup(path, world, args, dp)
        train_dp.replicate(ts, dp)
        iterations = PIXEL_ITERATIONS if path == "pixels" else args["iterations"]
        spans: list = []
        real = _timed_collectives(torch, dev, spans)
        out = {"iterations": []}
        try:
            for _ in range(iterations):
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
        ev = evaluate(ts)(make_generator(3, dev), EVAL_STEPS)
        _sync(torch, dev)
        out["eval"] = {"seconds": time.perf_counter() - h0,
                       "metrics": {k: v.tolist() for k, v in ev.items()}}
        out["trainer"] = []
        if path != "lap":
            with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
                json.dump(out, f)
            return

        # The Trainer: a DP eval and a checkpoint, then a resume with a
        # rank-0 eval.
        tconf = ppo.PPOConfig(num_envs=64 * world, horizon=16, num_minibatches=2, num_epochs=1)
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


def run_world(path: str, world: int, args: dict) -> dict:
    import torch.multiprocessing as mp

    from carla_ppo_tpu_torch.parallel import mesh

    with tempfile.TemporaryDirectory() as out_dir:
        h0 = time.perf_counter()
        ctx = mp.start_processes(rank_main, args=(world, f"tcp://127.0.0.1:{mesh.free_port()}",
                                                  out_dir, args, path),
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
    its = [[rk["iterations"][i] for rk in ranks] for i in range(len(ranks[0]["iterations"]))]
    bad = []
    for i, per_rank in enumerate(its):
        if len({it["checksum"] for it in per_rank}) != 1:
            bad.append(f"{path} iteration {i}: the ranks' states differ")
        for r, it in enumerate(per_rank):  # the CPU's plain versions count no launch
            if args["device"] == "cuda" and any(
                    it["launches"][k] != args["horizon"] + 1 for k in ("ground_pass", "composite")):
                bad.append(f"{path} iteration {i} rank {r}: launches {it['launches']}, not horizon "
                           "+ 1 of each camera kernel")
    if any(rk["eval"]["metrics"] != ranks[0]["eval"]["metrics"] for rk in ranks):
        bad.append(f"{path}: the ranks' evaluate metrics differ")
    if path == "lap":
        for run in range(2):
            if len({rk["trainer"][run]["checksum"] for rk in ranks}) != 1 or any(
                    rk["trainer"][run]["metrics"] != ranks[0]["trainer"][run]["metrics"]
                    for rk in ranks):
                bad.append(f"Trainer run {run}: the ranks differ")
        if [(t["start"], t["end"]) for t in ranks[0]["trainer"]] != [(0, 1), (1, 2)]:
            bad.append(f"the Trainer did not resume at 1: {ranks[0]['trainer']}")
    warm = its[-1]
    seconds = max(it["seconds"] for it in warm)
    steps = world * args["envs_per_rank"] * args["horizon"]
    return {
        "path": path, "world": world, "envs": world * args["envs_per_rank"],
        "iteration_s": [max(it["seconds"] for it in per_rank) for per_rank in its],
        "warm_env_steps_per_s": steps / seconds,
        "collectives_per_rank": [it["collectives"] for it in warm],
        "collective_ms_per_rank": [it["collective_ms"] for it in warm],
        "collective_host_ms_per_rank": [it["collective_host_ms"] for it in warm],
        "launches_per_rollout": [it["launches"] for it in warm],
        "checksums": [it["checksum"][:16] for it in warm],
        "eval_s": max(rk["eval"]["seconds"] for rk in ranks),
        "eval_distance": ranks[0]["eval"]["metrics"]["eval/distance_traveled"],
        "wall_s": time.perf_counter() - h0, "faults": bad,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--runs", default=RUNS,
                        help="path:worlds;... (paths lap, route, lap_bank, pixels)")
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
    for run in args["runs"].split(";"):
        path, worlds = run.split(":")
        for world in (int(w) for w in worlds.split(",")):
            result = run_world(path, world, args)
            print(json.dumps({"card": card.splitlines()[0], **result}), flush=True)
            faults += result["faults"]
    if faults:
        print(f"dp_scaling: {faults}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
