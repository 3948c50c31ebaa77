"""The port's lap env (carla_ppo_tpu_torch/envs) against the JAX package's.

States and actions are carried across as numpy arrays; the port then runs
on its own states. Tolerance: rewards, deviations and poses within 1e-3
over 50 steps, the bound tests/test_golden.py puts on the JAX env itself
(float32 on both sides, transcendental functions from different libraries).
Discrete fields (waypoint index, done, termination reason) must be equal.
NPC spawn slots are drawn from each package's own RNG and are not compared
(with num_npcs = 0 nothing reads them but the renderer's inert slots).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.envs import lap_env
from carla_ppo_tpu.envs.types import TerminationReason
from carla_ppo_tpu_torch.envs import lap_env as tenv
from carla_ppo_tpu_torch.envs import track as ttrack
from carla_ppo_tpu_torch.envs.types import EnvParams as TParams
from carla_ppo_tpu_torch.utils.device import make_generator
from tests.test_golden import GOLDEN
from tests.test_torch_common import port_params, port_state

B = 8
TOL = 1e-3


def _jax_batch(params, checkpoints):
    keys = jax.random.split(jax.random.PRNGKey(3), len(checkpoints))
    return jax.vmap(lambda k, c: lap_env.reset(params, k, True, c))(
        keys, jnp.asarray(checkpoints, jnp.int32)
    )


def _actions(n_steps, seed=0):
    rng = np.random.default_rng(seed)
    steer = np.cumsum(rng.normal(0.0, 0.08, size=(n_steps, B)), axis=0).clip(-1, 1)
    throttle = rng.uniform(0.3, 1.0, size=(n_steps, B))
    return np.stack([steer, throttle], axis=2).astype(np.float32)


def _assert_close(jstate, tstate, jout=None, tout=None):
    np.testing.assert_allclose(tstate.vehicle.pos.numpy(), np.asarray(jstate.vehicle.pos), atol=TOL, rtol=0)
    np.testing.assert_allclose(tstate.vehicle.yaw.numpy(), np.asarray(jstate.vehicle.yaw), atol=TOL, rtol=0)
    np.testing.assert_allclose(tstate.vehicle.vx.numpy(), np.asarray(jstate.vehicle.vx), atol=TOL, rtol=0)
    np.testing.assert_array_equal(tstate.waypoint_idx.numpy(), np.asarray(jstate.waypoint_idx))
    np.testing.assert_array_equal(tstate.checkpoint_idx.numpy(), np.asarray(jstate.checkpoint_idx))
    np.testing.assert_array_equal(tstate.step_count.numpy(), np.asarray(jstate.step_count))
    np.testing.assert_allclose(
        tstate.distance_from_center.numpy(), np.asarray(jstate.distance_from_center), atol=TOL, rtol=0
    )
    if jout is not None:
        np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))
        np.testing.assert_array_equal(
            tout.termination_reason.numpy(), np.asarray(jout.termination_reason)
        )
        np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs), atol=TOL, rtol=0)


def test_reset_matches(lap_params):
    cps = [0, 50, 97, 400, 777, 1000, 1500, 2000]
    js = _jax_batch(lap_params, cps)
    tp = port_params(lap_params)
    ts = tenv.reset(tp, make_generator(0, "cpu"), checkpoint_idx=torch.tensor(cps, dtype=torch.int32))
    _assert_close(js, ts)
    np.testing.assert_allclose(
        tenv.observe(ts, tp).numpy(),
        np.asarray(jax.vmap(lambda s: lap_env.observe(s, lap_params))(js)), atol=TOL, rtol=0,
    )


def test_step_50_matches(lap_params):
    js = _jax_batch(lap_params, [0, 60, 150, 300, 450, 600, 750, 900])
    tp = port_params(lap_params)
    ts = port_state(js)
    step = jax.jit(jax.vmap(lambda s, a: lap_env.step(s, a, lap_params)))
    for a in _actions(50):
        js, jo = step(js, jnp.asarray(a))
        ts, to = tenv.step(ts, torch.as_tensor(a), tp)
        _assert_close(js, ts, jo, to)
    np.testing.assert_allclose(ts.distance_traveled.numpy(), np.asarray(js.distance_traveled), atol=1e-2)


@pytest.mark.parametrize("variant", [
    {"reward_fn": "reward_speed_centering_angle_add"},
    {"reward_fn": "reward_kendall"},
    {"dynamics_model": "dynamic"},
    {"action_smoothing": 0.6},
    {"brake": True},
])
def test_step_variants_match(lap_params, variant):
    """The other registered rewards, the grip-clamped dynamics, action
    smoothing and the brake channel, 30 steps each."""
    variant = dict(variant)
    brake = variant.pop("brake", False)
    jparams = lap_params.replace(**variant)
    tp = port_params(lap_params, **variant)
    js = _jax_batch(jparams, [0, 60, 150, 300, 450, 600, 750, 900])
    ts = port_state(js)
    step = jax.jit(jax.vmap(lambda s, a: lap_env.step(s, a, jparams)))
    acts = _actions(30, seed=1)
    if brake:
        acts = np.concatenate([acts, np.linspace(0, 0.5, 30)[:, None, None].repeat(B, 1)], axis=2)
    for a in acts.astype(np.float32):
        js, jo = step(js, jnp.asarray(a))
        ts, to = tenv.step(ts, torch.as_tensor(a), tp)
        _assert_close(js, ts, jo, to)


def test_autoreset_50_matches(lap_params):
    """Hard steering drives envs off the track within 50 steps: the
    terminating step reports the finished episode and carries the
    re-spawned state, as in the JAX package."""
    js = _jax_batch(lap_params, [0, 100, 200, 300, 400, 500, 600, 700])
    tp = port_params(lap_params)
    ts = port_state(js)
    g = make_generator(0, "cpu")
    step = jax.jit(jax.vmap(lambda s, a: lap_env.autoreset_step(s, a, lap_params)))
    acts = np.zeros((50, B, 2), np.float32)
    acts[:, :, 0] = np.linspace(-1.0, 1.0, B)
    acts[:, :, 1] = 1.0
    n_done = 0
    for a in acts:
        js, jo = step(js, jnp.asarray(a))
        ts, to = tenv.autoreset_step(ts, torch.as_tensor(a), tp, g)
        _assert_close(js, ts, jo, to)
        n_done += int(to.done.sum())
    assert n_done >= 4


def test_stopped_terminates_at_151(lap_params):
    """Zero throttle: first done at step 151 (5 s grace at 30 fps + 1),
    reason VEHICLE_STOPPED, reward -10, in both packages."""
    tp = port_params(lap_params)
    ts = tenv.init_env_batch(tp, 2, make_generator(0, "cpu"))
    js = _jax_batch(lap_params, [0, 0])
    step = jax.jit(jax.vmap(lambda s, a: lap_env.step(s, a, lap_params)))
    zero = np.zeros((2, 2), np.float32)
    for t in range(1, 152):
        ts, to = tenv.step(ts, torch.as_tensor(zero), tp)
        js, jo = step(js, jnp.asarray(zero))
        np.testing.assert_array_equal(to.done.numpy(), np.asarray(jo.done))
        if t < 151:
            assert not bool(to.done.any())
    assert bool(to.done.all())
    assert (to.termination_reason == int(TerminationReason.VEHICLE_STOPPED)).all()
    np.testing.assert_allclose(to.reward.numpy(), -10.0)


def test_golden_trajectory_on_port():
    """tests/test_golden.py's action script and pinned values, on the port."""
    tp = TParams(track=ttrack.make_lap_track(seed=0, device="cpu"))
    s = tenv.init_env_batch(tp, 1, make_generator(42, "cpu"))
    actions = [(0.0, 1.0)] * 30 + [(0.3, 0.8)] * 30 + [(-0.2, 0.5)] * 30
    rewards, devs = [], []
    for a in actions:
        s, out = tenv.step(s, torch.tensor([a], dtype=torch.float32), tp, obs_fn=None)
        rewards.append(float(out.reward[0]))
        devs.append(float(s.distance_from_center[0]))
    for i, want in GOLDEN["rewards"].items():
        assert abs(rewards[i] - want) < TOL, (i, rewards[i], want)
    for i, want in GOLDEN["devs"].items():
        assert abs(devs[i] - want) < TOL, (i, devs[i], want)
    np.testing.assert_allclose(s.vehicle.pos[0].numpy(), GOLDEN["pos"], atol=1e-2)
    assert abs(float(s.vehicle.yaw[0]) - GOLDEN["yaw"]) < TOL
    assert int(s.waypoint_idx[0]) == GOLDEN["wp"]
    assert abs(float(s.distance_traveled[0]) - GOLDEN["dist"]) < 1e-2


@pytest.mark.parametrize("kind", ["lap", "lap_props", "segment"])
def test_track_baking_matches(kind):
    """The port's numpy track baking gives the JAX package's arrays, cast
    to float32 once at the tensor boundary (exactly equal)."""
    from carla_ppo_tpu.envs import track as jtrack

    segs = [jtrack.Straight(40.0), jtrack.Arc(90.0, 30.0), jtrack.Straight(25.0),
            jtrack.Arc(-45.0, 20.0)]
    tsegs = [ttrack.Straight(40.0), ttrack.Arc(90.0, 30.0), ttrack.Straight(25.0),
             ttrack.Arc(-45.0, 20.0)]
    if kind == "segment":
        want = jtrack.make_segment_track(segs, capacity=256)
        got = ttrack.make_segment_track(tsegs, capacity=256, device="cpu")
    elif kind == "lap":
        want = jtrack.make_lap_track(seed=3)
        got = ttrack.bake_props(ttrack.make_lap_track(seed=3, device="cpu"), seed=5)
        want = jtrack.bake_props(want, seed=5)
    else:
        want = jtrack.make_lap_track(seed=0, props=True)
        got = ttrack.make_lap_track(seed=0, props=True, device="cpu")
    arrays = ttrack.track_to_arrays(got)
    assert arrays["length"] == int(want.length) and arrays["is_loop"] == bool(want.is_loop)
    for name in ("pos", "fwd", "maneuver", "left_width", "right_width", "prop_class",
                 "prop_lateral", "prop_height", "prop_halfwidth"):
        ref = np.asarray(getattr(want, name))
        assert arrays[name].dtype == ref.dtype, name
        np.testing.assert_array_equal(arrays[name], ref, err_msg=name)


def test_npc_traffic_not_ported(lap_params):
    tp = port_params(lap_params, num_npcs=2)
    ts = tenv.init_env_batch(tp, 2, make_generator(0, "cpu"))
    with pytest.raises(NotImplementedError):
        tenv.step(ts, torch.zeros(2, 2), tp)
