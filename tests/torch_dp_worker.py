"""One rank of the data-parallel parity runs of tests/test_torch_dp.py.

    python -m tests.torch_dp_worker RANK WORLD INIT_METHOD WORKDIR

Joins a gloo group on the CPU, runs each scenario of WORKDIR/cases.pt (made
by the test with the JAX package's trajectories) and the port's own
scenarios, and writes what it found to WORKDIR/rank<RANK>.pt. It imports
neither JAX nor the JAX package: the test compares the results.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

from carla_ppo_tpu_torch.envs import lap_bank_env, route_env, route_planner, track
from carla_ppo_tpu_torch.envs.types import EnvParams
from carla_ppo_tpu_torch.models.pixel_policy import PixelActorCritic
from carla_ppo_tpu_torch.models.policy import ActorCritic
from carla_ppo_tpu_torch.parallel import mesh, train_dp
from carla_ppo_tpu_torch.training import loop, pixels, ppo
from carla_ppo_tpu_torch.utils.device import make_generator

PG_TIMEOUT_S = 120.0


def _snapshot(ts) -> dict:
    """Every parameter, buffer, Adam moment and reward moment, cloned."""
    return {i: t.detach().clone() for i, t in enumerate(train_dp._state_tensors(ts))}


def update_parity(dp, case) -> dict:
    """One DP update phase on this rank's half of the JAX trajectory."""
    ts = ppo.create_train_state(case["model"], case["config"], make_generator(0, "cpu"))
    half = case["halves"][dp.rank]
    envs, metrics = ppo.update_from_rollout(ts, half["env_states"], half["traj"], half["bootstrap"],
                                            half["episodic"], case["config"], dp=dp,
                                            perms=case["perms"])
    return {"params": {n: p.detach().clone() for n, p in ts.model.named_parameters()},
            "reward_norm": dataclasses.asdict(ts.reward_norm), "count": int(ts.opt_state.count),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "total_env_steps": ts.total_env_steps, "vecnorm_return": envs.vecnorm_return}


def sync(dp) -> dict:
    """Two vector-obs iterations with every collective site on (reward
    normalisation, the SNR gate, the KL guard, the clip)."""
    params = EnvParams(track=track.make_lap_track(seed=0, device="cpu"))
    config = ppo.PPOConfig(num_envs=8, horizon=8, num_minibatches=2, num_epochs=2,
                           normalize_rewards=True, adv_snr_min=0.01, kl_target=0.05,
                           max_grad_norm=0.5)
    ts = ppo.create_train_state(ActorCritic(18, generator=make_generator(rank_seed(dp), "cpu")),
                                config, make_generator(1, "cpu"))
    envs = train_dp.shard_env_batch(ppo.init_env_batch(params, 8, ts.generator), dp)
    train_dp.replicate(ts, dp)
    step = train_dp.make_dp_train_iteration(dp, config, params)
    out = []
    for _ in range(2):
        ts, envs, m = step(ts, envs)
        out.append({"state": _snapshot(ts), "metrics": {k: float(v) for k, v in m.items()},
                    "counters": (ts.iteration, ts.train_step, ts.total_env_steps, ts.episodes_done)})
    return {"iterations": out, "rollout_state": ts.generator.get_state(),
            "shared_state": ts.shared_generator.get_state()}


def _route_params():
    """4 random routes of the town of seed 0 (no props)."""
    bank = route_planner.make_route_bank(route_planner.make_town(seed=0), n_routes=4, device="cpu")
    return route_env.route_env_params(bank)


def route_sync(dp) -> dict:
    """Two vector-obs route iterations (8 envs, 4 a rank, horizon 4, with
    reward normalisation as the route config trains): each rank chains and
    re-spawns its own routes from its own stream."""
    params = _route_params()
    config = ppo.PPOConfig(env_kind="route", num_envs=8, horizon=4, num_minibatches=2,
                           num_epochs=1, normalize_rewards=True)
    ts = ppo.create_train_state(ActorCritic(18, generator=make_generator(rank_seed(dp), "cpu")),
                                config, make_generator(4, "cpu"))
    envs = train_dp.shard_env_batch(ppo.init_env_batch(params, 8, ts.generator, "route"), dp)
    train_dp.replicate(ts, dp)
    step = train_dp.make_dp_train_iteration(dp, config, params)
    out = []
    for _ in range(2):
        ts, envs, m = step(ts, envs)
        out.append({"state": _snapshot(ts), "metrics": {k: float(v) for k, v in m.items()},
                    "route_id": envs.route_id.clone()})
    return {"iterations": out}


def rank_seed(dp) -> int:
    """A different weight seed on each rank: replicate must make them equal."""
    return 100 + dp.rank


def evaluate(dp) -> dict:
    """DP greedy evaluate of a policy that turns off the road, against the
    single-device evaluate of the whole batch (rank 0), on a lap, a lap
    bank and 4 routes (the whole batch's chained routes, sliced)."""
    out = {}
    bank = lap_bank_env.lap_bank_params(lap_bank_env.make_lap_bank(n_tracks=4, capacity=2048,
                                                                   device="cpu"))
    lap = EnvParams(track=track.make_lap_track(seed=0, device="cpu"))
    for kind, params in (("lap", lap), ("lap_bank", bank), ("route", _route_params())):
        config = ppo.PPOConfig(env_kind=kind)
        model = ActorCritic(18, generator=make_generator(7, "cpu"))
        with torch.no_grad():
            model.action_mean.bias.copy_(torch.tensor([0.25, 0.9]))
        fn = train_dp.make_dp_evaluate(dp, model, config, params, num_envs=8, chunk=16)
        got = fn(make_generator(3, "cpu"), 160)
        want = ppo.evaluate(model, params, make_generator(3, "cpu"), num_envs=8, max_steps=160,
                            config=config, chunk=16) if dp.is_main else None
        out[kind] = {"dp": got, "single": want}
    return out


def pixel_sync(dp) -> dict:
    """A tiny data-parallel pixel iteration (2 envs a rank), then a DP
    pixel evaluate against the single-device one (rank 0)."""
    params = EnvParams(track=track.make_lap_track(seed=0, props=True, device="cpu"))
    config = ppo.PPOConfig(num_envs=4, horizon=2, num_minibatches=2, num_epochs=1,
                           kl_target=0.05)
    model = PixelActorCritic(generator=make_generator(rank_seed(dp), "cpu"))
    ts = pixels.create_pixel_train_state(model, config, make_generator(2, "cpu"))
    envs = train_dp.shard_env_batch(ppo.init_env_batch(params, 4, ts.generator), dp)
    train_dp.replicate(ts, dp)
    step = train_dp.make_dp_pixel_train_iteration(dp, config, params)
    ts, envs, m = step(ts, envs)
    evaluate = train_dp.make_dp_pixel_evaluate(dp, ts.model, config, params, num_envs=4, chunk=8)
    got = evaluate(make_generator(3, "cpu"), 16)
    want = pixels.evaluate(ts.model, params, make_generator(3, "cpu"), num_envs=4, max_steps=16,
                           config=config, chunk=8) if dp.is_main else None
    return {"state": _snapshot(ts), "metrics": {k: float(v) for k, v in m.items()},
            "total_env_steps": ts.total_env_steps, "evaluate": {"dp": got, "single": want}}


def trainer(dp, workdir) -> dict:
    """The Trainer at num_devices=2: 2 iterations with a data-parallel
    eval after each (eval_envs 2) and a checkpoint every iteration, then a
    second Trainer that resumes and trains a third with a rank-0-only eval
    (eval_envs 3)."""
    config = ppo.PPOConfig(horizon=4, num_envs=8, num_minibatches=2, num_epochs=1)
    out = {}
    for run, (target, eval_envs) in enumerate(((2, 2), (3, 3))):
        settings = loop.TrainerSettings(
            model_name="dp", models_root=os.path.join(workdir, "models"), num_iterations=target,
            eval_interval=1, eval_envs=eval_envs, eval_max_steps=8, checkpoint_interval=1,
            num_devices=2, rich_scene=False)
        tr = loop.Trainer(settings, config, device="cpu", dp=dp)
        try:
            start = tr.iteration
            metrics = tr.train()
            out[run] = {"start": start, "end": tr.iteration, "metrics": metrics,
                        "state": _snapshot(tr.train_state), "best": tr.best_eval_score,
                        "envs": tr.env_states.batch_size}
        finally:
            tr.close()
    return out


def main(rank: int, world: int, init_method: str, workdir: str) -> None:
    torch.set_num_threads(1)
    dp = mesh.init(rank, world, init_method, "cpu", timeout_s=PG_TIMEOUT_S)
    try:
        cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
        result = {"update": {name: update_parity(dp, c) for name, c in cases.items()},
                  "sync": sync(dp), "route": route_sync(dp), "evaluate": evaluate(dp),
                  "pixels": pixel_sync(dp),
                  "trainer": trainer(dp, workdir)}
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        mesh.destroy()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
