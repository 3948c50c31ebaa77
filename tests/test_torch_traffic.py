"""NPC traffic in the port's lap env (carla_ppo_tpu_torch/envs) against the
JAX package's: the NPC tick, NPC-ego collisions, overtake events and their
wrap exclusions, the radar observation `vector_npc` and
`reward_traffic_add`.

Both packages start from the same injected states (the JAX reset of 8
envs, with NPC slots placed from a numpy seed, two of them at the loop's
far boundary) and step under the same fixed action sequence for
300 steps. Tolerances, stated before measuring:
- NPC lateral offset and speed within 1e-5 absolute;
- NPC s within 2 float32 ulps of the largest |s| (1.2e-4 at the ~1000 m
  these tracks reach): s is a float32 position in waypoint units, and the
  two packages' sin (XLA's and torch's) and XLA's fused multiply-adds
  round the last bit differently now and then, so 1e-5 absolute is below
  float32's resolution there;
- collisions, npc_just_passed, overtake counts, waypoint indices, done and
  termination reasons exactly;
- the observation (vector + radar) and the reward within 1e-3, the bound
  tests/test_torch_env.py puts on the ego's pose after 50 steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.envs import lap_env
from carla_ppo_tpu.envs import observations as jobs
from carla_ppo_tpu.envs import rewards as jrewards
from carla_ppo_tpu_torch.envs import lap_env as tenv
from carla_ppo_tpu_torch.envs import observations as tobs
from carla_ppo_tpu_torch.envs import rewards as trewards
from carla_ppo_tpu_torch.utils.device import make_generator
from tests.test_torch_common import port_params, port_state

B = 8
STEPS = 300
TOL = 1e-3

# (num_npcs, npc_reactive, npc_keep_gain): each value of each knob twice.
CONFIGS = [(4, True, 0.0), (4, False, 1.0), (6, True, 1.0), (6, False, 0.0)]


def _params(lap_params, num_npcs, reactive, keep_gain):
    kw = dict(num_npcs=num_npcs, npc_reactive=reactive, npc_keep_lat=-0.5,
              reward_fn="reward_traffic_add", terminate_on_collision=True)
    jp = lap_params.replace(npc_keep_gain=jnp.float32(keep_gain), **{
        k: (jnp.float32(v) if isinstance(v, float) else v) for k, v in kw.items()})
    return jp, port_params(lap_params, npc_keep_gain=keep_gain, **kw)


def _start_states(jp, seed=0):
    """JAX resets at 8 checkpoints, with NPC slots placed around the ego
    from a numpy seed and the ego already at 9 m/s. Env 0 has an NPC 0.05 m
    short of the far boundary ahead (+L/2), env 1 one 0.05 m past it
    (-L/2), whose wrapped gap flips to +L/2 as the faster ego gains on it
    (the ego lapping an NPC: never a pass)."""
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    js = jax.vmap(lambda k, c: lap_env.reset(jp, k, True, c))(keys, jnp.arange(B, dtype=jnp.int32) * 150)
    rng = np.random.default_rng(seed)
    L = int(jp.track.length)
    ego = np.asarray(js.waypoint_idx).astype(np.float32)
    npc_s = ego[:, None] + rng.uniform(-20, 40, size=(B, 8)).astype(np.float32)
    npc_s[0, 0] = ego[0] + L / 2 - 0.05
    npc_s[1, 0] = ego[1] - L / 2 + 0.05
    return js.replace(
        npc_s=jnp.asarray(npc_s),
        npc_speed=jnp.asarray(rng.uniform(4, 7, size=(B, 8)).astype(np.float32)),
        npc_lateral=jnp.asarray(rng.uniform(-1.5, 1.5, size=(B, 8)).astype(np.float32)),
        vehicle=js.vehicle.replace(vx=jnp.full((B,), 9.0, jnp.float32)),
    )


def _actions(seed=0):
    rng = np.random.default_rng(seed)
    steer = 0.3 * np.clip(np.cumsum(rng.normal(0, 0.03, (STEPS, B)), 0), -1, 1)
    return np.stack([steer, rng.uniform(0.5, 1.0, (STEPS, B))], 2).astype(np.float32)


@pytest.mark.parametrize("num_npcs, reactive, keep_gain", CONFIGS)
def test_traffic_300_steps_match(lap_params, num_npcs, reactive, keep_gain):
    jp, tp = _params(lap_params, num_npcs, reactive, keep_gain)
    js = _start_states(jp)
    ts = port_state(js)
    step = jax.jit(jax.vmap(lambda s, a: lap_env.step(s, a, jp, obs_fn="vector_npc")))
    s_tol = 2 * float(np.spacing(np.float32(2 * int(jp.track.length))))
    hits = passes = 0
    for i, a in enumerate(_actions()):
        js, jo = step(js, jnp.asarray(a))
        ts, to = tenv.step(ts, torch.as_tensor(a), tp, obs_fn="vector_npc")
        np.testing.assert_allclose(ts.npc_s.numpy(), np.asarray(js.npc_s), rtol=0, atol=s_tol,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(ts.npc_lateral.numpy(), np.asarray(js.npc_lateral), rtol=0,
                                   atol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(ts.npc_speed.numpy(), np.asarray(js.npc_speed), rtol=0, atol=1e-5)
        for name in ("collision", "npc_just_passed", "npc_overtakes", "waypoint_idx"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                          err_msg=f"{name} at step {i}")
        np.testing.assert_array_equal(to.done.numpy(), np.asarray(jo.done))
        np.testing.assert_array_equal(to.termination_reason.numpy(), np.asarray(jo.termination_reason))
        np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), rtol=0, atol=TOL)
        np.testing.assert_allclose(to.reward.numpy(), np.asarray(jo.reward), rtol=0, atol=TOL)
        hits += int(np.asarray(js.collision).sum())
        passes += int(np.asarray(js.npc_just_passed).sum())
    assert hits > 0 and passes > 0  # the run exercised both events
    if not reactive:  # rails: the lateral offsets never move
        np.testing.assert_array_equal(ts.npc_lateral.numpy(), np.asarray(_start_states(jp).npc_lateral))


def test_wrap_artifacts_do_not_count(lap_params):
    """One step from crafted gaps. Envs 0-3: the ego stands, and an NPC
    0.05 m short of the far boundary ahead (+L/2) drives across it, so its
    wrapped gap flips to -L/2: no pass. Envs 4-7: the ego at 40 m/s and an
    NPC 0.05 m ahead at 4 m/s: a pass. Both packages agree."""
    jp, tp = _params(lap_params, 2, False, 0.0)
    js = _start_states(jp)
    L = int(jp.track.length)
    ego = np.asarray(js.waypoint_idx).astype(np.float32)
    npc_s = np.asarray(js.npc_s).copy()
    npc_s[:, 0] = ego + L / 2 - 0.05
    npc_s[:, 1] = ego + L / 2 + 0.05  # behind at -L/2 + 0.05
    npc_s[4:, 1] = ego[4:] + 0.05
    vx = np.where(np.arange(B) < 4, 0.0, 40.0).astype(np.float32)
    js = js.replace(npc_s=jnp.asarray(npc_s), npc_speed=jnp.full((B, 8), 4.0, jnp.float32),
                    npc_lateral=jnp.full((B, 8), 1.4, jnp.float32),  # beside the ego: no hit
                    vehicle=js.vehicle.replace(vx=jnp.asarray(vx)))
    ts = port_state(js)
    a = np.tile(np.array([[0.0, 1.0]], np.float32), (B, 1))
    js1, _ = jax.vmap(lambda s, x: lap_env.step(s, x, jp))(js, jnp.asarray(a))
    ts1, _ = tenv.step(ts, torch.as_tensor(a), tp)
    want = np.asarray(js1.npc_just_passed)
    np.testing.assert_array_equal(ts1.npc_just_passed.numpy(), want)
    np.testing.assert_array_equal(ts1.collision.numpy(), np.asarray(js1.collision))
    ds_old = npc_s[:4, 0] - ego[:4]
    ds_new = np.asarray(js1.npc_s)[:4, 0] - np.asarray(js1.waypoint_idx)[:4]
    assert (ds_old < L / 2).all() and (ds_new > L / 2).all()  # the gap did cross +L/2
    np.testing.assert_array_equal(want[:4], 0.0)
    np.testing.assert_array_equal(want[4:], 1.0)


@pytest.mark.parametrize("num_npcs", [0, 4, 6])
def test_radar_obs_and_traffic_reward_match(lap_params, num_npcs):
    """vector_npc_obs, npc_gaps and reward_traffic_add on the injected
    states (and a second draw), as pure functions of one state."""
    jp, tp = _params(lap_params, num_npcs, True, 1.0)
    for seed in (0, 1):
        js = _start_states(jp, seed)
        js = js.replace(npc_just_passed=jnp.asarray(np.arange(B) % 2, jnp.float32))
        ts = port_state(js)
        np.testing.assert_allclose(tobs.vector_npc_obs(ts, tp).numpy(),
                                   np.asarray(jax.vmap(lambda s: jobs.vector_npc_obs(s, jp))(js)),
                                   rtol=0, atol=1e-5)
        got = tobs.npc_gaps(ts, tp)
        want = jax.vmap(lambda s: jobs.npc_gaps(s, jp))(js)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2])[0])
        np.testing.assert_allclose(
            trewards.reward_traffic_add(ts, tp).numpy(),
            np.asarray(jax.vmap(lambda s: jrewards.reward_traffic_add(s, jp))(js)), rtol=0, atol=1e-5)
    assert tobs.obs_dim_for("vector_npc") == jobs.obs_dim_for("vector_npc") == 24
    assert tobs.obs_dim_for("vector") == jobs.obs_dim_for("vector")


def test_reset_npc_spawns_in_range(lap_params):
    """The port's reset draws its NPC spawns as the JAX reset does (from
    its own generator): at least 25 m ahead of the ego and at most 25 m
    short of a lap, speeds in [npc_min_speed, npc_max_speed), lateral 0."""
    _, tp = _params(lap_params, 6, True, 0.0)
    cps = torch.arange(64, dtype=torch.int32) * 31
    ts = tenv.reset(tp, make_generator(0, "cpu"), checkpoint_idx=cps)
    gap = ts.npc_s - ts.waypoint_idx.to(torch.float32)[:, None]
    L = float(tp.track.length)
    assert bool((gap >= 25.0).all()) and bool((gap <= L - 25.0).all())
    assert bool((ts.npc_speed >= tp.npc_min_speed).all()) and bool((ts.npc_speed < tp.npc_max_speed).all())
    assert bool((ts.npc_lateral == 0).all())
