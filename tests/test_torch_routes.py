"""The port's banked-track slice against the JAX package's: the town and
route planner, the route bank and the lap bank, the route and lap-bank
envs, the banked camera, the ground pass on unaligned cameras and odd
batch sizes, the pose-fed ground pass (Pallas v6), and route / lap-bank
PPO.

Inputs are made from numpy seeds or by the JAX package and carried across
as numpy arrays. Where the JAX env draws a random route, the port is given
the route the JAX env drew. Pallas kernels run in interpret mode.

Tolerances: ints exact; track and bank arrays within 1e-5 (both sides bake
them with the same numpy code, so in practice they are equal); env
trajectories within 1e-3 (the bound tests/test_golden.py puts on the JAX
env); frames agree on >= 99.9% of pixels (tests/test_torch_rasterizer.py's
bound: the port evaluates the v5 arithmetic, the XLA path a recentered
matmul-expanded d2, so an exact nearest-waypoint tie may round the other
way); eval metrics within 1e-3.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.envs import lap_bank_env as jbank_env
from carla_ppo_tpu.envs import lap_env as jlap_env
from carla_ppo_tpu.envs import route_env as jroute_env
from carla_ppo_tpu.envs import route_planner as jplanner
from carla_ppo_tpu.envs import track as jtrack
from carla_ppo_tpu.envs.types import EnvParams
from carla_ppo_tpu.ops import rasterizer as R
from carla_ppo_tpu.ops.rasterizer_pallas import (
    _prep_pose_v6,
    render_batch_pallas_v3c,
    render_batch_pallas_v3d,
    render_batch_pallas_v4,
    render_batch_pallas_v6,
)
from carla_ppo_tpu.training import ppo as jppo
from carla_ppo_tpu_torch.envs import lap_bank_env as tbank_env
from carla_ppo_tpu_torch.envs import lap_env as tlap_env
from carla_ppo_tpu_torch.envs import route_env as troute_env
from carla_ppo_tpu_torch.envs import route_planner as tplanner
from carla_ppo_tpu_torch.envs import track as ttrack
from carla_ppo_tpu_torch.ops import rasterizer as TR
from carla_ppo_tpu_torch.ops import rasterizer_cuda as TRC
from carla_ppo_tpu_torch.training import ppo as tppo
from carla_ppo_tpu_torch.utils.device import make_generator
from tests.test_torch_common import np_tree, port_params, port_state
from tests.test_torch_env import _actions, _assert_close
from tests.test_torch_ppo import _policy_pair

B = 8
TOL = 1e-3
ARRAY_TOL = 1e-5
MIN_AGREEMENT = 0.999
TRACK_FIELDS = ("pos", "fwd", "maneuver", "left_width", "right_width", "prop_class",
                "prop_lateral", "prop_height", "prop_halfwidth")
SPECTATOR = dict(height=180, width=320, mount_forward=-5.5, mount_height=2.8, pitch_deg=-15.0)


def _assert_track_arrays(got, want):
    """Port track / bank arrays against a JAX TrackData: ints exact, floats
    within ARRAY_TOL."""
    assert bool(got.is_loop) == bool(np.asarray(want.is_loop).all())
    np.testing.assert_array_equal(np.asarray(got.length), np.asarray(want.length))
    for name in TRACK_FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=ARRAY_TOL, rtol=0, err_msg=name)


def port_bank(jbank):
    """A JAX bank (leading route axis, per-route length / is_loop arrays) as
    a port bank on the CPU."""
    arrays = np_tree(jbank)
    lengths = arrays.pop("length")
    loops = arrays.pop("is_loop")
    per_track = [
        dict({k: v[i] for k, v in arrays.items()}, length=int(lengths[i]), is_loop=bool(loops[i]))
        for i in range(lengths.shape[0])
    ]
    return ttrack.bank_from_arrays(per_track, "cpu")


@pytest.fixture(scope="module")
def town():
    return jplanner.make_town(seed=0)


@pytest.fixture(scope="module")
def route_bank(town):
    return jplanner.make_route_bank(town, n_routes=8, capacity=1024, seed=0, props=True)


@pytest.fixture(scope="module")
def lap_bank():
    return jbank_env.make_lap_bank(n_tracks=3, capacity=2048, props=True)


# ---------------------------------------------------------------------------
# Town, planner, banks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_town_matches(seed):
    """Same nodes, the same edge list in networkx's order, the same dual
    flags (drawn from the rng in that order)."""
    want = jplanner.make_town(seed=seed)
    got = tplanner.make_town(seed=seed)
    np.testing.assert_array_equal(got.nodes, want.nodes)
    assert got.edges == [tuple(e) for e in want.edges]
    assert got.dual == want.dual


@pytest.mark.parametrize("pair", [(0, 24), (4, 20), (12, 3), (7, 18), (21, 2), (10, 14)])
def test_route_waypoints_match(town, pair):
    want = jplanner.compute_route_waypoints(town, *pair)
    got = tplanner.compute_route_waypoints(tplanner.make_town(seed=0), *pair)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=ARRAY_TOL, rtol=0)


def test_astar_matches_on_every_pair(town):
    """The port's A* and the JAX package's give the same node path for every
    ordered node pair (compared through the waypoints' length and ends)."""
    ttown = tplanner.make_town(seed=0)
    for a in range(len(town.nodes)):
        for b in range(len(town.nodes)):
            if a == b:
                continue
            got = tplanner.route_astar(ttown.nodes, ttown.edges, a, b)
            assert got[0] == a and got[-1] == b
            want = jplanner.compute_route_waypoints(town, a, b)[0]
            mine = tplanner.compute_route_waypoints(ttown, a, b)[0]
            assert mine.shape == want.shape
            np.testing.assert_array_equal(mine, want)


@pytest.mark.parametrize("props", [False, True])
def test_route_bank_matches(town, props):
    want = jplanner.make_route_bank(town, n_routes=8, capacity=1024, seed=3, props=props)
    got = tplanner.make_route_bank(tplanner.make_town(seed=0), n_routes=8, capacity=1024, seed=3,
                                   props=props, device="cpu")
    assert got.banked and got.num_tracks == 8 and not got.is_loop
    _assert_track_arrays(got, want)
    if props:
        assert (got.prop_class.numpy() > 0).any()


def test_bank_constructors_default_to_cuda():
    """Like every entry point of the port, the bank constructors put their
    tensors on the card unless the caller asks for the CPU."""
    makers = (lambda: tbank_env.make_lap_bank(n_tracks=2),
              lambda: tplanner.make_route_bank(tplanner.make_town(seed=0), n_routes=2))
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                make()


def test_lap_bank_matches(lap_bank):
    got = tbank_env.make_lap_bank(n_tracks=3, capacity=2048, props=True, device="cpu")
    assert got.banked and got.is_loop and got.capacity == 2048
    _assert_track_arrays(got, lap_bank)


# ---------------------------------------------------------------------------
# Route env
# ---------------------------------------------------------------------------


def _jax_route_batch(params, seed=0, n=B):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.vmap(lambda k: jroute_env.reset(params, k))(keys)


def _assert_route_close(js, ts, jo=None, to=None):
    _assert_close(js, ts, jo, to)
    for name in ("route_id", "num_routes_completed", "start_waypoint_idx"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), err_msg=name)
    np.testing.assert_allclose(ts.route_frac_offset.numpy(), np.asarray(js.route_frac_offset), atol=TOL)
    np.testing.assert_allclose(ts.laps_completed.numpy(), np.asarray(js.laps_completed), atol=TOL)
    if jo is not None:
        np.testing.assert_allclose(to.laps_completed.numpy(), np.asarray(jo.laps_completed), atol=TOL)


@pytest.mark.parametrize("junction_prob", [0.0, 1.0])
def test_route_reset_matches(route_bank, junction_prob):
    """The port's spawn on the routes (and junction starts) JAX drew."""
    jp = jroute_env.route_env_params(route_bank, junction_spawn_prob=junction_prob)
    tp = troute_env.route_env_params(port_bank(route_bank), junction_spawn_prob=junction_prob)
    js = _jax_route_batch(jp)
    ts = troute_env.reset_on_routes(
        tp, torch.as_tensor(np.asarray(js.route_id)), torch.as_tensor(np.asarray(js.waypoint_idx)),
        torch.ones(B, dtype=torch.bool),
    )
    _assert_route_close(js, ts)
    if junction_prob:
        assert (np.asarray(js.waypoint_idx) > 0).any()
    np.testing.assert_allclose(
        troute_env.observe(ts, tp).numpy(),
        np.asarray(jax.vmap(lambda s: jroute_env.observe(s, jp))(js)), atol=TOL, rtol=0,
    )


def test_junction_spawn_idx_matches(route_bank):
    """The junction pick from the same uniforms: JAX draws them from its key,
    the port is handed them."""
    jp = jroute_env.route_env_params(route_bank)
    bank = port_bank(route_bank)
    keys = jax.random.split(jax.random.PRNGKey(5), bank.num_tracks)
    want, us = [], []
    for r in range(bank.num_tracks):
        trk = jroute_env.route_track(route_bank, jnp.int32(r))
        want.append(int(jroute_env._junction_spawn_idx(trk, jp, keys[r])))
        us.append(np.asarray(jax.random.uniform(keys[r], (bank.capacity,))))
    got = troute_env.junction_spawn_idx(bank, torch.arange(bank.num_tracks, dtype=torch.int32), 25,
                                        torch.as_tensor(np.stack(us)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got > 0).any()


def _place_on_routes(states, bank, idx):
    """Put env i at waypoint idx[i] of its own route, on the centerline."""
    rid = np.asarray(states.route_id)
    idx = np.asarray(idx, np.int32)
    pos = np.asarray(bank.pos)[rid, idx]
    fwd = np.asarray(bank.fwd)[rid, idx]
    return states.replace(
        waypoint_idx=jnp.asarray(idx),
        vehicle=states.vehicle.replace(pos=jnp.asarray(pos),
                                       yaw=jnp.asarray(np.arctan2(fwd[:, 1], fwd[:, 0]))),
        prev_pos=jnp.asarray(pos),
    )


def test_route_step_50_with_chaining_matches(route_bank):
    """50 steps; half the envs start 3 waypoints before their route's end and
    chain onto the route the JAX env drew."""
    jp = jroute_env.route_env_params(route_bank)
    tp = troute_env.route_env_params(port_bank(route_bank))
    js = _jax_route_batch(jp, seed=1)
    lengths = np.asarray(route_bank.length)[np.asarray(js.route_id)]
    idx = np.where(np.arange(B) % 2 == 0, lengths - 3, np.arange(B) * 7)
    js = _place_on_routes(js, route_bank, idx)
    ts = port_state(js)
    step = jax.jit(jax.vmap(lambda s, a: jroute_env.step(s, a, jp)))
    acts = _actions(50, seed=2)
    acts[:, :, 0] *= 0.2
    for a in acts:
        js_next, jo = step(js, jnp.asarray(a))
        ts, to = troute_env.step_with_routes(
            ts, torch.as_tensor(a), tp, torch.as_tensor(np.asarray(js_next.route_id))
        )
        js = js_next
        _assert_route_close(js, ts, jo, to)
    assert int(ts.num_routes_completed.sum()) >= 2


def test_route_autoreset_matches(route_bank):
    """Hard steering ends episodes; each finished env re-spawns on the route
    JAX drew for it, and `autoreset_step` itself returns the same step
    output and re-spawns at its own route's start."""
    jp = jroute_env.route_env_params(route_bank)
    tp = troute_env.route_env_params(port_bank(route_bank))
    js = _jax_route_batch(jp, seed=2)
    ts = port_state(js)
    step = jax.jit(jax.vmap(lambda s, a: jroute_env.autoreset_step(s, a, jp)))
    g = make_generator(0, "cpu")
    acts = np.zeros((50, B, 2), np.float32)
    acts[:, :, 0] = np.linspace(-1.0, 1.0, B)
    acts[:, :, 1] = 1.0
    n_done = 0
    for a in acts:
        ta = torch.as_tensor(a)
        js, jo = step(js, jnp.asarray(a))
        nxt, to = troute_env.step_with_routes(ts, ta, tp, ts.route_id)
        done = to.done
        fresh = troute_env.reset_on_routes(
            tp, torch.as_tensor(np.asarray(js.route_id)), torch.zeros(B, dtype=torch.int32),
            ts.is_training,
        )
        to.obs = torch.where(done[:, None], troute_env.observe(fresh, tp), to.obs)
        auto_state, auto_out = troute_env.autoreset_step(ts, ta, tp, g)
        ts = tlap_env.select_envs(done, fresh, nxt)
        _assert_route_close(js, ts, jo, to)
        np.testing.assert_array_equal(auto_out.done.numpy(), done.numpy())
        np.testing.assert_allclose(auto_out.reward.numpy(), to.reward.numpy(), atol=TOL, rtol=0)
        spawn = troute_env.reset_on_routes(tp, auto_state.route_id, torch.zeros(B, dtype=torch.int32),
                                           ts.is_training)
        for name in ("waypoint_idx", "step_count", "distance_traveled"):
            np.testing.assert_array_equal(getattr(auto_state, name)[done].numpy(),
                                          getattr(spawn, name)[done].numpy())
        n_done += int(done.sum())
    assert n_done >= 4


# ---------------------------------------------------------------------------
# Lap bank env
# ---------------------------------------------------------------------------


def test_lap_bank_step_and_autoreset_match(lap_bank):
    """Round-robin tracks, 50 autoreset steps of hard steering: every track
    has envs that terminate and re-spawn on it at their checkpoint."""
    jp = jbank_env.lap_bank_params(lap_bank)
    tp = tbank_env.lap_bank_params(port_bank(lap_bank))
    n = 9
    cps = jnp.asarray([0, 100, 250, 400, 550, 700, 850, 1000, 1150], jnp.int32)
    tids = jnp.arange(n, dtype=jnp.int32) % 3
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    js = jax.vmap(lambda k, c, t: jbank_env.reset(jp, k, True, c, t))(keys, cps, tids)
    ts = tbank_env.reset(tp, make_generator(0, "cpu"), checkpoint_idx=torch.as_tensor(np.asarray(cps)),
                         track_id=torch.as_tensor(np.asarray(tids)))
    _assert_close(js, ts)
    np.testing.assert_array_equal(ts.route_id.numpy(), np.asarray(tids))
    step = jax.jit(jax.vmap(lambda s, a: jbank_env.autoreset_step(s, a, jp)))
    g = make_generator(1, "cpu")
    acts = np.zeros((50, n, 2), np.float32)
    acts[:, :, 0] = np.linspace(-1.0, 1.0, n)
    acts[:, :, 1] = 1.0
    done_tracks = set()
    for a in acts:
        js, jo = step(js, jnp.asarray(a))
        ts, to = tbank_env.autoreset_step(ts, torch.as_tensor(a), tp, g)
        _assert_close(js, ts, jo, to)
        np.testing.assert_array_equal(ts.route_id.numpy(), np.asarray(tids))
        done_tracks |= set(np.asarray(tids)[to.done.numpy()].tolist())
    assert done_tracks == {0, 1, 2}


def test_lap_bank_init_round_robin(lap_bank):
    tp = tbank_env.lap_bank_params(port_bank(lap_bank))
    ts = tbank_env.init_env_batch(tp, 7, make_generator(0, "cpu"))
    np.testing.assert_array_equal(ts.route_id.numpy(), np.arange(7) % 3)
    js = jbank_env.init_env_batch(jbank_env.lap_bank_params(lap_bank), 7, jax.random.PRNGKey(0))
    _assert_close(js, ts)


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------


def _banked_batch(kind, route_bank, lap_bank):
    """(JAX params, JAX states, port params, port states) with envs scattered
    over their bank rows: route starts (window before waypoint 0), middles
    and ends; lap wrap corners."""
    if kind == "route":
        jp = jroute_env.route_env_params(route_bank)
        js = _jax_route_batch(jp, seed=3)
        L = np.asarray(route_bank.length)[np.asarray(js.route_id)]
        idx = np.array([0, 3, 9, 15, 0, 0, 0, 0]) + np.array([0, 0, 0, 0, 1, 1, 1, 1]) * np.array(
            [0, 0, 0, 0, L[4] // 2, L[5] - 30, L[6] - 5, L[7] - 1])
        js = _place_on_routes(js, route_bank, idx)
        tp = troute_env.route_env_params(port_bank(route_bank))
    else:
        jp = jbank_env.lap_bank_params(lap_bank)
        js = jbank_env.init_env_batch(jp, B, jax.random.PRNGKey(6))
        L = np.asarray(lap_bank.length)[np.asarray(js.route_id)]
        idx = np.array([0, 5, 300, 700]).repeat(2) + np.array([0, 1] * 4) * (L - 9)
        rid = np.asarray(js.route_id)
        row = idx % L
        fwd = np.asarray(lap_bank.fwd)[rid, row]
        js = js.replace(
            waypoint_idx=jnp.asarray(idx, jnp.int32),
            vehicle=js.vehicle.replace(pos=jnp.asarray(np.asarray(lap_bank.pos)[rid, row]),
                                       yaw=jnp.asarray(np.arctan2(fwd[:, 1], fwd[:, 0]))),
        )
        tp = tbank_env.lap_bank_params(port_bank(lap_bank))
    return jp, js, tp, port_state(js)


@pytest.mark.parametrize("kind", ["route", "lap_bank"])
def test_render_batch_banked_matches(kind, route_bank, lap_bank):
    """Rich frames against JAX's render_batch_banked; ground frames against
    the Pallas v3d and v4 kernels with per-env `tracks`."""
    jp, js, tp, ts = _banked_batch(kind, route_bank, lap_bank)
    want = np.asarray(R.render_batch_banked(js, jp))
    rich = TR.render_batch_banked(ts, tp)
    _, ground = TR.render_batch_with_ground(ts, tp)
    assert rich.shape == (B, 80, 160) and rich.dtype == torch.int32
    assert (rich.numpy() == want).mean() >= MIN_AGREEMENT
    assert (rich != ground).any(), "no billboard drawn: the case tests nothing"
    tracks = jax.tree.map(lambda x: x[js.route_id], jp.track)
    for kernel in (render_batch_pallas_v3d, render_batch_pallas_v4):
        ref = np.asarray(kernel(js, jp, interpret=True, tracks=tracks))
        assert (ground.numpy() == ref).mean() >= MIN_AGREEMENT
    with pytest.raises(ValueError):
        TR.render_batch(ts, tp)


def _lap_states(params, n, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    states = jax.vmap(lambda k: jlap_env.reset(params, k))(keys)
    L = int(params.track.length)
    idx = (np.arange(n) * 131) % L
    fwd = np.asarray(params.track.fwd)[idx]
    return states.replace(
        waypoint_idx=jnp.asarray(idx, jnp.int32),
        vehicle=states.vehicle.replace(pos=jnp.asarray(np.asarray(params.track.pos)[idx]),
                                       yaw=jnp.asarray(np.arctan2(fwd[:, 1], fwd[:, 0]))),
    )


@pytest.mark.parametrize("camera", ["84x84", "spectator_180x320"])
def test_ground_pass_unaligned_camera_matches_v4(lap_params_props, camera):
    """Stripe breaks that are not 128-lane aligned (the pixel-policy camera,
    the gym API's chase camera): the port's ground pass against Pallas v4."""
    kw = dict(height=84, width=84) if camera == "84x84" else SPECTATOR
    jcam, tcam = R.CameraConfig(**kw), TR.CameraConfig(**kw)
    js = _lap_states(lap_params_props, B)
    ref = np.asarray(render_batch_pallas_v4(js, lap_params_props, jcam, interpret=True))
    tp, ts = port_params(lap_params_props), port_state(js)
    got = TR.ground_pass(*TR.prep_windows(ts, tp, tcam), tcam, TR.RoadStyle())
    assert got.shape == (B, tcam.height * tcam.width)
    assert (got.numpy().reshape(ref.shape) == ref).mean() >= MIN_AGREEMENT
    rich = TR.render_batch(ts, tp, tcam)
    want = np.asarray(R.render_batch(js, lap_params_props, jcam))
    assert (rich.numpy() == want).mean() >= MIN_AGREEMENT


def test_ground_pass_odd_batch_matches_v3c(lap_params_props):
    """An odd batch size (B=5): the port's ground pass against Pallas v3c."""
    js = _lap_states(lap_params_props, 5, seed=1)
    ref = np.asarray(render_batch_pallas_v3c(js, lap_params_props, interpret=True))
    tp, ts = port_params(lap_params_props), port_state(js)
    cam = TR.CameraConfig()
    got = TR.ground_pass(*TR.prep_windows(ts, tp, cam), cam, TR.RoadStyle())
    assert (got.numpy().reshape(ref.shape) == ref).mean() >= MIN_AGREEMENT


@pytest.fixture(scope="module")
def lap_params_props():
    return EnvParams(track=jtrack.make_lap_track(seed=0, props=True))


def _pose_case(case, lap_params_props):
    if case == "open":
        trk = jtrack.make_segment_track(
            [jtrack.Straight(40.0), jtrack.Arc(90.0, 30.0), jtrack.Straight(60.0),
             jtrack.Arc(-60.0, 25.0), jtrack.Straight(40.0)]
        )
        params = EnvParams(track=trk)
    else:
        params = lap_params_props
    L = int(params.track.length)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    states = jax.vmap(lambda k: jlap_env.reset(params, k))(keys)
    if case == "driven":
        states = _lap_states(params, B)
        step = jax.jit(jax.vmap(lambda s, a: jlap_env.step(s, a, params)))
        steer = jnp.linspace(-0.3, 0.3, B)
        for t in range(30):
            act = jnp.stack([steer * jnp.sin(0.1 * t), jnp.full((B,), 0.9)], axis=1)
            states, _ = step(states, act)
        return params, states
    idx = {
        "fresh": (np.arange(B) * 97) % L,
        "wrap": np.array([0, 1, 15, 16, L - 2, L - 1, L, 2 * L - 4]),
        "open": np.array([0, 3, 9, 15, L // 2, L - 30, L - 5, L - 1]),
    }[case]
    row = idx % L if case != "open" else idx
    fwd = np.asarray(params.track.fwd)[row]
    return params, states.replace(
        waypoint_idx=jnp.asarray(idx, jnp.int32),
        vehicle=states.vehicle.replace(pos=jnp.asarray(np.asarray(params.track.pos)[row]),
                                       yaw=jnp.asarray(np.arctan2(fwd[:, 1], fwd[:, 0]))),
    )


@pytest.mark.parametrize("case", ["fresh", "driven", "wrap", "open"])
def test_ground_pass_pose_matches_v6(case, lap_params_props):
    """The pose-fed plain ground pass against Pallas v6; its prep against
    _prep_pose_v6; on loops also equal to the port's own ground pass."""
    params, js = _pose_case(case, lap_params_props)
    ref = np.asarray(render_batch_pallas_v6(js, params, interpret=True))
    tp, ts = port_params(params), port_state(js)
    cam = TR.CameraConfig()
    starts, table, pose = TR.prep_pose(ts, tp, cam)
    jstarts, jt2, jpose = (np.asarray(x) for x in _prep_pose_v6(js, params, R.CameraConfig()))
    np.testing.assert_array_equal(starts.numpy(), jstarts)
    np.testing.assert_allclose(table.numpy(), jt2[:table.shape[0]], atol=ARRAY_TOL, rtol=0)
    np.testing.assert_allclose(pose.numpy(), jpose, atol=ARRAY_TOL, rtol=0)
    got = TR.render_batch_pose(ts, tp, cam)
    assert got.shape == ref.shape == (B, 80 * 160)
    assert (got.numpy() == ref).mean() >= MIN_AGREEMENT
    if case != "open":
        own = TR.ground_pass(*TR.prep_windows(ts, tp, cam), cam, TR.RoadStyle())
        assert torch.equal(got, own)


def test_render_batch_pose_refuses_a_bank(lap_bank):
    tp = tbank_env.lap_bank_params(port_bank(lap_bank))
    ts = tbank_env.init_env_batch(tp, 3, make_generator(0, "cpu"))
    with pytest.raises(ValueError, match="bank"):
        TR.render_batch_pose(ts, tp)


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------


def test_route_train_iteration_runs_on_cpu():
    """Two latent route iterations (reward normalisation on) and a greedy
    evaluate at a tiny size: finite metrics, counters advanced, rows within
    the bank, no kernel launched on the CPU path."""
    from carla_ppo_tpu_torch.models.policy import ActorCritic
    from carla_ppo_tpu_torch.models.vae import VAE

    g = make_generator(0, "cpu")
    bank = tplanner.make_route_bank(tplanner.make_town(seed=0), n_routes=4, capacity=1024,
                                    props=True, device="cpu")
    tp = troute_env.route_env_params(bank)
    vae = VAE(source_shape=(80, 160, 1), generator=g).eval()
    lat = tppo.LatentObs(vae_model=vae)
    config = tppo.PPOConfig(env_kind="route", normalize_rewards=True, num_envs=4, horizon=4,
                            num_epochs=1, num_minibatches=2)
    ts = tppo.create_train_state(ActorCritic(lat.obs_dim, generator=g), config, g)
    envs = tppo.init_env_batch(tp, 4, g, env_kind="route")
    before = dict(TRC.LAUNCHES)
    for _ in range(2):
        ts, envs, met = tppo.train_iteration(ts, envs, tp, config, latent_obs=lat)
        assert np.isfinite(met["train_loss/loss"].item())
    assert (ts.iteration, ts.train_step, ts.total_env_steps) == (2, 4, 32.0)
    assert float(ts.reward_norm.count) > 0
    assert int(envs.route_id.min()) >= 0 and int(envs.route_id.max()) < 4
    assert TRC.LAUNCHES == before
    ev = tppo.evaluate(ts.model, tp, g, num_envs=2, max_steps=6, config=config, latent_obs=lat, chunk=3)
    assert all(np.isfinite(v.numpy()).all() for v in ev.values())


def test_lap_bank_evaluate_matches(lap_bank):
    """Greedy lap-bank evaluate (vector obs, round-robin tracks): the same
    metrics as the JAX package, eval/laps_per_track included."""
    jm, jparams, tm = _policy_pair(18, seed=4)
    jp = jbank_env.lap_bank_params(lap_bank)
    tp = tbank_env.lap_bank_params(port_bank(lap_bank))
    want = jppo.evaluate(jparams, jp, jm, jax.random.PRNGKey(0), num_envs=6, max_steps=40,
                         config=jppo.PPOConfig(env_kind="lap_bank"), chunk=16)
    got = tppo.evaluate(tm, tp, make_generator(0, "cpu"), num_envs=6, max_steps=40,
                        config=tppo.PPOConfig(env_kind="lap_bank"), chunk=16)
    assert set(got) == set(want)
    assert got["eval/laps_per_track"].shape == (3,)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-3, rtol=1e-4, err_msg=k)
