"""The port's traffic lights, PID controller, local planner and scripted
agents (carla_ppo_tpu_torch/envs/traffic_lights.py, controller.py,
local_planner.py, agents.py) against the JAX package's, on the same numpy
inputs.

Tolerances, stated before measuring:
- light states on a time grid, red-light gating, the vehicle hazard and
  the placed light tables and baked prop tables: exact;
- the lights in a seg frame of the port's plain path against the JAX
  render_semantic: tests/test_torch_rasterizer.py's MIN_AGREEMENT of
  pixels, with the TRAFFICSIGNS pole in both frames;
- controller, planner and agent actions within 1e-5 on the same states
  (the JAX package's states, carried across each step; the controllers'
  integrals carried by each package itself);
- the planner's head, buffer fill and exhaustion exactly;
- each package's own closed-loop drive (8 envs, 300 steps, lights and
  NPCs): the same waypoint indices, dones and termination reasons at
  every step.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.envs import agents as jagents
from carla_ppo_tpu.envs import controller as jctrl
from carla_ppo_tpu.envs import lap_env
from carla_ppo_tpu.envs import local_planner as jlp
from carla_ppo_tpu.envs import track as track_mod
from carla_ppo_tpu.envs import traffic_lights as jtl
from carla_ppo_tpu.envs.types import EnvParams, SegClass
from carla_ppo_tpu.ops import rasterizer as R
from carla_ppo_tpu_torch.envs import agents as tagents
from carla_ppo_tpu_torch.envs import controller as tctrl
from carla_ppo_tpu_torch.envs import lap_env as tenv
from carla_ppo_tpu_torch.envs import local_planner as tlp
from carla_ppo_tpu_torch.envs import traffic_lights as ttl
from carla_ppo_tpu_torch.ops import rasterizer as TR
from tests.test_torch_common import port_params, port_state
from tests.test_torch_rasterizer import MIN_AGREEMENT

B = 8
ACT_TOL = 1e-5


def _lap_with_lights(props=False, **kw):
    params = jtl.add_traffic_lights(EnvParams(track=track_mod.make_lap_track(seed=0, props=props)))
    return params.replace(**{k: jnp.float32(v) for k, v in kw.items()})


def _resets(params, starts, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(starts))
    return jax.vmap(lambda k, c: lap_env.reset(params, k, True, c))(
        keys, jnp.asarray(starts, jnp.int32))


@pytest.mark.parametrize("fracs", [(0.5, 0.125), (0.3, 0.2), (0.0, 0.0)])
def test_light_states_on_time_grid(fracs):
    green, yellow = fracs
    jp = EnvParams(track=track_mod.make_lap_track(seed=0),
                   light_wp=jnp.asarray([50, 200, 400], jnp.int32),
                   light_phase=jnp.asarray([0.0, 10.0, 3.3], jnp.float32),
                   light_green_frac=jnp.float32(green), light_yellow_frac=jnp.float32(yellow))
    grid = (np.arange(1000, dtype=np.float32) * np.float32(0.04)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda t: jtl.light_states(jp, t))(jnp.asarray(grid)))
    got = ttl.light_states(port_params(jp), torch.as_tensor(grid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == ({jtl.RED} if green == yellow == 0.0 else {0, 1, 2})


def test_place_and_bake_lights_match():
    """add_traffic_lights: the same junction entries, phases and baked
    signal poles, field for field, on a dressed lap and a bare one."""
    for props, max_lights in ((True, 8), (False, 6)):
        jp = EnvParams(track=track_mod.make_lap_track(seed=0, props=props))
        jp2 = jtl.add_traffic_lights(jp, max_lights=max_lights, seed=3)
        tp2 = ttl.add_traffic_lights(port_params(jp), max_lights=max_lights, seed=3)
        assert 1 <= tp2.light_wp.numel() <= max_lights
        np.testing.assert_array_equal(tp2.light_wp.numpy(), np.asarray(jp2.light_wp))
        np.testing.assert_array_equal(tp2.light_phase.numpy(), np.asarray(jp2.light_phase))
        assert tp2.light_period == float(jp2.light_period)
        for name in ("prop_class", "prop_lateral", "prop_height", "prop_halfwidth"):
            np.testing.assert_array_equal(getattr(tp2.track, name).numpy(),
                                          np.asarray(getattr(jp2.track, name)), err_msg=name)


def test_empty_table_is_noop():
    """The default table is empty; gating is False everywhere and a track
    with no junction entry keeps its params."""
    tp = port_params(EnvParams(track=track_mod.make_lap_track(seed=0)))
    assert tp.light_wp.shape == (0,) and tp.light_phase.shape == (0,)
    ts = port_state(_resets(EnvParams(track=track_mod.make_lap_track(seed=0)), range(0, 800, 100)))
    assert not bool(ttl.is_red_light_ahead(ts, tp).any())
    straight = port_params(EnvParams(track=track_mod.make_segment_track([track_mod.Straight(80.0)])))
    assert ttl.add_traffic_lights(straight) is straight


def test_red_light_ahead_on_driven_states():
    """is_red_light_ahead on the states of a JAX roaming fleet driving
    through its lights, every 5th step of 300."""
    jp = _lap_with_lights()
    tp = port_params(jp)
    starts = np.asarray(jp.light_wp)[np.arange(B) % jp.light_wp.shape[0]] - 30 + 3 * np.arange(B)
    js = _resets(jp, starts)
    agent = jax.vmap(lambda _: jagents.AgentState.create(target_speed_kmh=18.0))(jnp.arange(B))
    act = jax.jit(jax.vmap(lambda a, s: jagents.roaming_agent_step(a, s, jp)))
    step = jax.jit(jax.vmap(lambda s, a: lap_env.step(s, a, jp)))
    red = jax.jit(jax.vmap(lambda s: jtl.is_red_light_ahead(s, jp)))
    seen = 0
    for i in range(300):
        if i % 5 == 0:
            want = np.asarray(red(js))
            np.testing.assert_array_equal(ttl.is_red_light_ahead(port_state(js), tp).numpy(), want)
            seen += int(want.sum())
        a, agent = act(agent, js)
        js, _ = step(js, a)
    assert seen > 0


def test_is_vehicle_hazard_matches(lap_params):
    """The JAX package's hazard cases (ahead on the lane, the other side,
    behind, too far, an inactive slot) as one batch."""
    js = _resets(lap_params, [0] * 5)
    ego = np.asarray(js.waypoint_idx).astype(np.float32)
    cases = [(6.0, 0.0), (6.0, 2.5), (-6.0, 0.0), (40.0, 0.0), (6.0, 0.0)]
    npc_s = np.asarray(js.npc_s).copy()
    npc_lat = np.asarray(js.npc_lateral).copy()
    for b, (ds, lat) in enumerate(cases):
        npc_s[b, 0], npc_lat[b, 0] = ego[b] + ds, lat
    js = js.replace(npc_s=jnp.asarray(npc_s), npc_lateral=jnp.asarray(npc_lat))
    for n in (1, 0):
        jp = lap_params.replace(num_npcs=n)
        want = np.asarray(jax.vmap(lambda s: jagents.is_vehicle_hazard(s, jp))(js))
        got = tagents.is_vehicle_hazard(port_state(js), port_params(lap_params, num_npcs=n)).numpy()
        np.testing.assert_array_equal(got, want)
    assert want.tolist() == [False] * 5 and got.tolist() == [False] * 5
    jp = lap_params.replace(num_npcs=1)
    assert np.asarray(jax.vmap(lambda s: jagents.is_vehicle_hazard(s, jp))(js)).tolist() == [
        True, False, False, False, True]


def test_lights_render_in_seg_frame():
    """A baked pole 12 m ahead shows as TRAFFICSIGNS in the port's plain
    seg frame and in the JAX render_semantic, which agree."""
    jt = track_mod.make_lap_track(seed=0, props=True)
    poles = np.asarray([12, 212, 612], np.int32)
    jp = EnvParams(track=jtl.bake_light_props(jt, poles))
    tp = port_params(EnvParams(track=jt))
    tp = dataclasses.replace(tp, track=ttl.bake_light_props(tp.track, poles))
    np.testing.assert_array_equal(tp.track.prop_class.numpy(), np.asarray(jp.track.prop_class))
    js = _resets(jp, poles - 12)
    want = np.asarray(jax.vmap(lambda s: R.render_semantic(s, jp, R.CameraConfig(render_props=True)))(js))
    got = TR.render_batch(port_state(js), tp, TR.CameraConfig()).numpy()
    assert got.shape == want.shape == (3, 80, 160)
    assert (got == want).mean() >= MIN_AGREEMENT
    signs = int(SegClass.TRAFFICSIGNS)
    bare = TR.render_batch(port_state(js), port_params(EnvParams(track=jt)), TR.CameraConfig()).numpy()
    for b in range(3):
        assert (got[b] == signs).sum() > (bare[b] == signs).sum() + 3
        assert (want[b] == signs).sum() > 3


def test_pid_step_and_controller_match(lap_params):
    rng = np.random.default_rng(0)
    err = rng.normal(size=(20, B)).astype(np.float32)
    jp = jctrl.PIDParams.create(1.95, 0.07, 0.2)
    tpid = tctrl.PIDParams(1.95, 0.07, 0.2)
    jst = jax.vmap(lambda _: jctrl.PIDState.zero())(jnp.arange(B))
    tst = tctrl.PIDState.zero(B, "cpu")
    dt = 1.0 / 30.0
    for e in err:
        jout, jst = jax.vmap(lambda s, x: jctrl.pid_step(jp, s, x, jnp.float32(dt)))(jst, jnp.asarray(e))
        tout, tst = tctrl.pid_step(tpid, tst, torch.as_tensor(e), dt)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=ACT_TOL)
    np.testing.assert_allclose(tst.integral.numpy(), np.asarray(jst.integral), rtol=0, atol=ACT_TOL)

    js = _resets(lap_params, np.arange(B) * 131)
    tp = port_params(lap_params)
    jc = jax.vmap(lambda _: jctrl.VehiclePIDController.create())(jnp.arange(B))
    tc = tctrl.VehiclePIDController.create(B, "cpu")
    speed = jnp.linspace(10.0, 30.0, B)
    run = jax.jit(jax.vmap(lambda c, s, v: c.run_step(s, lap_params, v)))
    step = jax.jit(jax.vmap(lambda s, a: lap_env.step(s, a, lap_params)))
    for _ in range(60):
        ja, jc = run(jc, js, speed)
        ta, tc = tc.run_step(port_state(js), tp, torch.as_tensor(np.array(speed)))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=ACT_TOL)
        js, _ = step(js, ja)
    np.testing.assert_allclose(tc.lat_state.integral.numpy(), np.asarray(jc.lat_state.integral),
                               rtol=0, atol=ACT_TOL)


def _planner_params(kind):
    """A lap, or an open plan short enough to run dry in 200 steps; every
    env spawns at waypoint 0 with its own lateral and yaw noise."""
    noise = dict(spawn_pos_noise=jnp.float32(0.6), spawn_yaw_noise=jnp.float32(0.1))
    if kind == "open":
        return EnvParams(track=track_mod.make_segment_track(
            [track_mod.Straight(12.0), track_mod.Arc(45.0, 10.0), track_mod.Straight(6.0)]), **noise)
    return EnvParams(track=track_mod.make_lap_track(seed=0), **noise)


@pytest.mark.parametrize("kind", ["lap", "open"])
def test_local_planner_200_steps(kind):
    """The planner driving 8 envs for 200 steps: on the JAX states of each
    step, the same actions, head, buffer fill, exhaustion and target
    option; the open plan runs dry inside the drive."""
    jp = _planner_params(kind)
    tp = port_params(jp, spawn_pos_noise=0.6, spawn_yaw_noise=0.1)
    js = _resets(jp, [0] * B, seed=5)
    jplan = jax.vmap(lambda _: jlp.LocalPlannerState.create())(jnp.arange(B))
    tplan = tlp.LocalPlannerState.create(batch=B, device="cpu")
    run = jax.jit(jax.vmap(lambda p, s: jlp.run_step(p, s, jp)))
    fill = jax.jit(jax.vmap(lambda p: jlp._buffer_positions(p, jp)[1].sum().astype(jnp.int32)))
    step = jax.jit(jax.vmap(lambda s, a: lap_env.step(s, a, jp)))
    L, loop = int(jp.track.length), bool(jp.track.is_loop)
    exhausted_seen = 0
    for i in range(200):
        np.testing.assert_array_equal(tplan.head.numpy(), np.asarray(jplan.head), err_msg=f"step {i}")
        t_fill, t_exhausted = tlp.cursor(tplan, port_state(js), tp)
        np.testing.assert_array_equal(t_fill.numpy(), np.asarray(fill(jplan)))
        want_ex = np.zeros(B, bool) if loop else np.asarray(jplan.head) >= L
        np.testing.assert_array_equal(t_exhausted.numpy(), want_ex)
        exhausted_seen += int(want_ex.sum())
        ja, jplan, jopt = run(jplan, js)
        ta, tplan, topt = tlp.run_step(tplan, port_state(js), tp)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=ACT_TOL, err_msg=f"step {i}")
        np.testing.assert_array_equal(topt.numpy(), np.asarray(jopt))
        js, _ = step(js, ja)
    assert (exhausted_seen > 0) == (kind == "open")
    assert int(np.asarray(jplan.head).min()) > 20


def _fleet(jp, seed=0):
    """8 JAX resets around the lights, with NPC slots placed from a numpy
    seed (some on the ego's lane just ahead), as tests/test_torch_traffic.py
    builds them."""
    lights = np.asarray(jp.light_wp)
    starts = lights[np.arange(B) % lights.size] - 40 + 7 * np.arange(B)
    js = _resets(jp, starts, seed=3)
    rng = np.random.default_rng(seed)
    ego = np.asarray(js.waypoint_idx).astype(np.float32)
    npc_s = ego[:, None] + rng.uniform(5, 80, size=(B, 8)).astype(np.float32)
    npc_lat = rng.uniform(-2.0, 2.0, size=(B, 8)).astype(np.float32)
    npc_lat[::2, 0] = 0.0
    return js.replace(
        npc_s=jnp.asarray(npc_s), npc_lateral=jnp.asarray(npc_lat),
        npc_speed=jnp.asarray(rng.uniform(3, 6, size=(B, 8)).astype(np.float32)))


@pytest.mark.parametrize("which", ["roaming", "basic"])
def test_agents_drive_with_lights_and_npcs(which):
    jp = _lap_with_lights(props=True).replace(num_npcs=4)
    tp = port_params(jp, num_npcs=4)
    js = _fleet(jp)
    ts = port_state(js)
    jag = jax.vmap(lambda _: jagents.AgentState.create(target_speed_kmh=18.0))(jnp.arange(B))
    tag_on_j = tagents.AgentState.create(B, "cpu", target_speed_kmh=18.0)
    tag_own = tagents.AgentState.create(B, "cpu", target_speed_kmh=18.0)
    if which == "roaming":
        jact = jax.jit(jax.vmap(lambda a, s: jagents.roaming_agent_step(a, s, jp)))

        def tact(a, s):
            return tagents.roaming_agent_step(a, s, tp)
    else:
        jact = jax.jit(jax.vmap(lambda a, s: jagents.basic_agent_step(a, s, jp)[:2]))

        def tact(a, s):
            return tagents.basic_agent_step(a, s, tp)[:2]
    step = jax.jit(jax.vmap(lambda s, a: lap_env.step(s, a, jp)))
    brakes = 0
    for i in range(300):
        ja, jag = jact(jag, js)
        ta, tag_on_j = tact(tag_on_j, port_state(js))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=ACT_TOL, err_msg=f"step {i}")
        own, tag_own = tact(tag_own, ts)
        js, jo = step(js, ja)
        ts, to = tenv.step(ts, own, tp, obs_fn=None)
        np.testing.assert_array_equal(ts.waypoint_idx.numpy(), np.asarray(js.waypoint_idx),
                                      err_msg=f"step {i}")
        np.testing.assert_array_equal(to.done.numpy(), np.asarray(jo.done))
        np.testing.assert_array_equal(to.termination_reason.numpy(), np.asarray(jo.termination_reason))
        brakes += int((np.asarray(ja)[:, 2] == 1.0).sum())
    assert brakes > 0
    assert float(np.asarray(js.distance_traveled).mean()) > 20.0
