"""Data-parallel PPO of the port (carla_ppo_tpu_torch/parallel/, the
`dp` paths of training/ppo.py, training/pixels.py and training/loop.py)
over two gloo ranks on the CPU, against the JAX package's shard_map data
parallel on a 2-device CPU mesh and against the port's own single-device
paths.

The two ranks are subprocesses (tests/torch_dp_worker.py), started once
for the module with a deadline of RANKS_DEADLINE_S and a process-group
timeout of their own, so a hang fails in minutes instead of stalling the
run. Tolerances, stated before measuring:
- the DP update phase on each rank's half of the JAX package's own
  trajectory, with the same permutations, against JAX
  train_iteration_core under shard_map: parameters within 1e-4 and each
  Adam step within 2% of the learning rate (test_torch_ppo.py::
  test_update_phase_matches' bounds), the loss metrics within rel 1e-3;
  with normalize_rewards, the pmean'd reward moments within rel 1e-5;
- parameters, buffers, Adam moments and reward moments bitwise equal on
  both ranks after every iteration (vector lap and route paths, the pixel
  path, the Trainer);
- the DP evaluate against the single-device evaluate of the same batch:
  discrete outcomes (steps, termination reasons, finished) exactly, float
  accumulators (reward, distance, deviation, speed, the fractional laps
  and the lap bank's laps per track) within 1e-5; on the lap, the lap
  bank, 4 routes and the pixel agent.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from carla_ppo_tpu.models.policy import ActorCritic as JActorCritic
from carla_ppo_tpu.parallel import train_dp as jdp
from carla_ppo_tpu.parallel.mesh import make_mesh
from carla_ppo_tpu.training import ppo as jppo
from carla_ppo_tpu_torch.models.policy import ActorCritic
from carla_ppo_tpu_torch.parallel import mesh
from carla_ppo_tpu_torch.training import loop
from carla_ppo_tpu_torch.training import ppo as tppo
from carla_ppo_tpu_torch.utils import convert
from tests.test_torch_common import REPO, np_tree, port_state

WORLD = 2
T, B = 8, 8
RANKS_DEADLINE_S = 420
CONFIG = dict(num_envs=B, horizon=T, num_epochs=2, num_minibatches=2, learning_rate=3e-4,
              max_grad_norm=0.5, kl_target=0.05)


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_case(lap_params, normalize_rewards):
    """The JAX shard_map iteration on a 2-device mesh, and what each shard
    rolled out (its trajectory, recomputed with the shard's folded key)
    and permuted, as the port's objects."""
    config = jppo.PPOConfig(normalize_rewards=normalize_rewards, **CONFIG)
    jm = JActorCritic()
    jstate = jppo.create_train_state(jm, config, 18, jax.random.PRNGKey(0))
    envs = jppo.init_env_batch(lap_params, B, jax.random.PRNGKey(1))
    m = make_mesh(WORLD)
    step = jdp.make_dp_train_iteration(m, jm, config, lap_params)
    new_state, _, jmet = step(jdp.replicate(jstate, m), jdp.shard_env_batch(envs, m))

    _, roll_key, perm_key = jax.random.split(jstate.rng, 3)
    per = B // WORLD
    perms = [_t(jax.random.permutation(k, per)).long()
             for k in jax.random.split(perm_key, config.num_epochs)]
    halves = []
    for r in range(WORLD):
        part = jax.tree.map(lambda x: x[r * per:(r + 1) * per], envs)
        after, traj, boot, episodic = jppo.rollout(jm, jstate.params, part, lap_params,
                                                   jax.random.fold_in(roll_key, r), T, config)
        halves.append({"env_states": port_state(after),
                       "traj": tppo.Trajectory(**{k: _t(v) for k, v in np_tree(traj).items()}),
                       "bootstrap": _t(boot), "episodic": {k: _t(v) for k, v in episodic.items()}})
    tconf = tppo.PPOConfig(**{f.name: getattr(config, f.name) for f in dataclasses.fields(config)})
    model = ActorCritic(18)
    model.load_state_dict(convert.actor_critic_state_dict(np_tree(jstate.params)), strict=False)
    case = {"config": tconf, "model": model, "halves": halves, "perms": perms}
    want = {"before": convert.actor_critic_state_dict(np_tree(jstate.params)),
            "after": convert.actor_critic_state_dict(np_tree(new_state.params)),
            "reward_norm": {k: float(v) for k, v in np_tree(new_state.reward_norm).items()},
            "metrics": {k: float(v) for k, v in jmet.items()},
            "total_env_steps": float(new_state.total_env_steps),
            "count": int(new_state.opt_state[1][0].count)}
    return case, want


@pytest.fixture(scope="module")
def ranks(lap_params, tmp_path_factory):
    """Run the two ranks once; (results of rank 0, results of rank 1, the
    JAX references)."""
    workdir = tmp_path_factory.mktemp("dp")
    cases, wants = {}, {}
    for name, norm in (("plain", False), ("normalize_rewards", True)):
        cases[name], wants[name] = _jax_case(lap_params, norm)
    torch.save(cases, workdir / "cases.pt")
    init = f"tcp://127.0.0.1:{mesh.free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_dp_worker", str(r), str(WORLD),
                               init, str(workdir)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANKS_DEADLINE_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r][-6000:]}"
    results = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return results[0], results[1], wants


def _assert_same(a, b, what):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: tensor {k} differs between the ranks"


@pytest.mark.parametrize("case", ["plain", "normalize_rewards"])
def test_dp_update_matches_jax_shard_map(ranks, case):
    r0, r1, wants = ranks
    want = wants[case]
    for got in (r0["update"][case], r1["update"][case]):
        for name, p in got["params"].items():
            step_got = p.numpy() - want["before"][name].numpy()
            step_want = want["after"][name].numpy() - want["before"][name].numpy()
            np.testing.assert_allclose(p.numpy(), want["after"][name].numpy(), atol=1e-4, rtol=0,
                                       err_msg=name)
            np.testing.assert_allclose(step_got, step_want, atol=0.02 * CONFIG["learning_rate"],
                                       rtol=0, err_msg=name)
        assert got["count"] == want["count"]
        assert got["total_env_steps"] == want["total_env_steps"] == T * B
        for k in ("train_loss/loss", "train/approx_kl", "train/update_skipped",
                  "train/episodes_finished", "train/reward"):
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-3, atol=1e-6,
                                       err_msg=k)
    _assert_same(r0["update"][case]["params"], r1["update"][case]["params"], case)


def test_dp_reward_moments_pmean_rule(ranks):
    """normalize_rewards: each rank updates the moments with its own
    returns, then the moments are averaged over the ranks (the JAX pmean
    after each shard's update), not recomputed from the global batch."""
    r0, r1, wants = ranks
    want = wants["normalize_rewards"]["reward_norm"]
    for got in (r0, r1):
        rn = got["update"]["normalize_rewards"]["reward_norm"]
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(float(rn[k]), want[k], rtol=1e-5, err_msg=k)
    assert torch.equal(r0["update"]["normalize_rewards"]["reward_norm"]["var"],
                       r1["update"]["normalize_rewards"]["reward_norm"]["var"])
    # The per-env return carries stay each rank's own.
    assert not torch.equal(r0["update"]["normalize_rewards"]["vecnorm_return"],
                           r1["update"]["normalize_rewards"]["vecnorm_return"])


def test_dp_ranks_stay_bitwise_in_sync(ranks):
    """Two iterations with every collective site on; the ranks started
    from different weight seeds (replicate makes them rank 0's), roll out
    different envs from different streams, and end equal."""
    r0, r1, _ = ranks
    for i, (a, b) in enumerate(zip(r0["sync"]["iterations"], r1["sync"]["iterations"])):
        _assert_same(a["state"], b["state"], f"iteration {i}")
        assert a["metrics"] == b["metrics"]
        assert a["counters"] == b["counters"]
        assert a["counters"][2] == (i + 1) * T * B  # the global batch
    assert torch.equal(r0["sync"]["shared_state"], r1["sync"]["shared_state"])
    assert not torch.equal(r0["sync"]["rollout_state"], r1["sync"]["rollout_state"])


def _evaluates(ranks, kind):
    r0, r1, _ = ranks
    if kind == "pixels":
        return r0["pixels"]["evaluate"]["dp"], r0["pixels"]["evaluate"]["single"], \
            r1["pixels"]["evaluate"]["dp"]
    return r0["evaluate"][kind]["dp"], r0["evaluate"][kind]["single"], r1["evaluate"][kind]["dp"]


def test_dp_route_iteration_stays_in_sync(ranks):
    """Two route iterations (4 routes, 8 envs): the ranks end each
    iteration bitwise equal, each on its own routes."""
    r0, r1, _ = ranks
    for i, (a, b) in enumerate(zip(r0["route"]["iterations"], r1["route"]["iterations"])):
        _assert_same(a["state"], b["state"], f"route iteration {i}")
        assert a["metrics"] == b["metrics"]
        assert all(np.isfinite(v) for v in a["metrics"].values())
        assert a["route_id"].shape == (4,)


@pytest.mark.parametrize("kind", ["lap", "lap_bank", "route", "pixels"])
def test_dp_evaluate_matches_single_device(ranks, kind):
    got, want, other = _evaluates(ranks, kind)
    assert set(got) == set(want)
    for k in ("eval/episode_steps", "eval/termination_reasons", "eval/finished"):
        assert torch.equal(got[k], want[k]), k
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    if kind != "pixels":  # the pixel agent's 16 steps end no episode
        assert float(want["eval/finished"]) > 0
    for k in got:
        assert torch.equal(got[k], other[k])
    if kind == "lap_bank":
        assert got["eval/laps_per_track"].shape == (4,)


def test_dp_pixel_iteration_stays_in_sync(ranks):
    r0, r1, _ = ranks
    _assert_same(r0["pixels"]["state"], r1["pixels"]["state"], "pixel iteration")
    assert r0["pixels"]["metrics"] == r1["pixels"]["metrics"]
    assert all(np.isfinite(v) for v in r0["pixels"]["metrics"].values())
    assert r0["pixels"]["total_env_steps"] == 2 * 4


def test_trainer_dp_end_to_end_and_resume(ranks):
    """The Trainer at num_devices=2: trains 2 iterations with evals and
    checkpoints, a second Trainer resumes at 2 and trains the third; the
    ranks agree throughout and hold half the batch each."""
    r0, r1, _ = ranks
    first, second = r0["trainer"][0], r0["trainer"][1]
    assert (first["start"], first["end"]) == (0, 2)
    assert (second["start"], second["end"]) == (2, 3)
    assert first["envs"] == second["envs"] == 4
    assert np.isfinite(second["metrics"]["train_loss/loss"])
    for run in (0, 1):
        _assert_same(r0["trainer"][run]["state"], r1["trainer"][run]["state"], f"trainer run {run}")
        assert r0["trainer"][run]["best"] == r1["trainer"][run]["best"]
        assert r0["trainer"][run]["metrics"] == r1["trainer"][run]["metrics"]


def test_trainer_dp_refusals(tmp_path):
    settings = loop.TrainerSettings(model_name="dp_bad", models_root=str(tmp_path), num_devices=2)
    with pytest.raises(ValueError, match="divisible"):
        loop.Trainer(settings, tppo.PPOConfig(horizon=4, num_envs=5), device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        loop.Trainer(settings, tppo.PPOConfig(horizon=4, num_envs=4), device="cpu")
    assert not os.path.exists(tmp_path / "dp_bad")


def test_cli_train_num_devices_2_trains_and_resumes(tmp_path):
    """`cli.train --num_devices 2 --device cpu` spawns two gloo ranks and
    trains 25 tiny iterations (no evals; the autosave at 25), then a second
    command resumes there and trains the 26th."""
    common = [sys.executable, "-m", "carla_ppo_tpu_torch.cli.train", "--model_name", "dp",
              "--device", "cpu", "--num_devices", "2", "--num_envs", "4", "--horizon", "2",
              "--num_minibatches", "2", "--num_epochs", "1", "--eval_interval", "0"]
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    for episodes in (25, 26):
        out = subprocess.run(common + ["--num_episodes", str(episodes)], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=RANKS_DEADLINE_S)
        assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
        assert out.stdout.count("Final metrics:") == 1  # rank 0 alone prints
        assert out.stdout.count("resumed at iteration 25") == (episodes == 26)
    assert sorted(os.listdir(tmp_path / "models" / "dp" / "autosave")) == ["25"]
    tree = torch.load(tmp_path / "models" / "dp" / "autosave" / "25" / "state.pt")
    assert tree["iteration"] == 25 and tree["total_env_steps"] == 25 * 2 * 4
    assert "shared_generator" in tree
