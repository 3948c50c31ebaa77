"""The port's camera (carla_ppo_tpu_torch/ops/rasterizer.py) against the JAX
package's: the plain ground pass against the Pallas v5 kernel in interpret
mode and the rich frame against the XLA render_batch, on the cases of
tests/test_rasterizer_pallas.py; the plain composite against the Pallas
composite (interpret mode) and the XLA flat composite on the same candidate
tables.

Tolerances: class ids must agree on >= 99.9% of pixels. The port's ground
pass evaluates the v5 kernel's arithmetic (rotated windows, direct d2, exact
payload fetch) and the XLA path a recentered matmul-expanded d2, so a pixel
on an exact nearest-waypoint tie may round the other way; in practice all
cases agree exactly. The composite is int32 min/max on identical tables, so
it must be exactly equal.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.envs import lap_env
from carla_ppo_tpu.envs import track as track_mod
from carla_ppo_tpu.envs.types import EnvParams
from carla_ppo_tpu.ops import rasterizer as R
from carla_ppo_tpu.ops.rasterizer_pallas import (
    _prep_candidates,
    composite_billboards_pallas,
    render_batch_pallas_v5,
)
from carla_ppo_tpu_torch.ops import rasterizer as TR
from tests.test_torch_common import port_params, port_state

B = 8
MIN_AGREEMENT = 0.999


def _place(states, params, idx):
    """Put env i at waypoint idx[i] (monotonic index), on the centerline."""
    trk = params.track
    L = int(trk.length)
    idx = jnp.asarray(idx, jnp.int32)
    row = jnp.mod(idx, L) if bool(trk.is_loop) else jnp.minimum(idx, L - 1)
    fwd = trk.fwd[row]
    return states.replace(
        waypoint_idx=idx,
        start_waypoint_idx=idx,
        vehicle=states.vehicle.replace(
            pos=trk.pos[row], yaw=jnp.arctan2(fwd[:, 1], fwd[:, 0])
        ),
    )


def _params_for(case):
    if case == "open":
        trk = track_mod.make_segment_track(
            [track_mod.Straight(40.0), track_mod.Arc(90.0, 30.0), track_mod.Straight(60.0),
             track_mod.Arc(-60.0, 25.0), track_mod.Straight(40.0)]
        )
        return EnvParams(track=trk)
    trk = track_mod.make_lap_track(seed=0, props=True)
    if case == "asym":
        n = trk.capacity
        lw = 1.75 + 1.6 * (np.arange(n) % 50 < 25)
        trk = trk.replace(left_width=jnp.asarray(lw, jnp.float32))
    return EnvParams(track=trk)


def _states_for(case, params):
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    states = jax.vmap(lambda k: lap_env.reset(params, k))(keys)
    L = int(params.track.length)
    if case in ("fresh", "asym"):
        return _place(states, params, (np.arange(B) * 97) % L)
    if case == "wrap":
        return _place(states, params, np.array([L - 1, L - 3, L - 8, L - 15, L, L + 2, L + 9, 2 * L - 4]))
    if case == "open":
        return _place(states, params, np.array([0, 3, 9, 15, L // 2, L - 30, L - 5, L - 1]))
    assert case == "driven"
    states = _place(states, params, (np.arange(B) * 131) % L)
    step = jax.jit(jax.vmap(lambda s, a: lap_env.step(s, a, params)))
    steer = jnp.linspace(-0.3, 0.3, B)
    for t in range(40):
        act = jnp.stack([steer * jnp.sin(0.1 * t), jnp.full((B,), 0.9)], axis=1)
        states, _ = step(states, act)
    return states


CASES = ["fresh", "driven", "wrap", "open", "asym"]


@pytest.mark.parametrize("case", CASES)
def test_ground_pass_matches_pallas_v5(case):
    params = _params_for(case)
    states = _states_for(case, params)
    ref = np.asarray(render_batch_pallas_v5(states, params, interpret=True))
    tp, ts = port_params(params), port_state(states)
    win_cols, payload = TR.prep_windows(ts, tp, TR.CameraConfig())
    got = TR.ground_pass(win_cols, payload, TR.CameraConfig(), TR.RoadStyle()).numpy()
    assert got.shape == ref.shape == (B, 80 * 160)
    assert (got == ref).mean() >= MIN_AGREEMENT


@pytest.mark.parametrize("case", CASES)
def test_render_batch_matches_xla(case):
    params = _params_for(case)
    states = _states_for(case, params)
    ref_rich, ref_ground = (np.asarray(x) for x in R.render_batch_with_ground(states, params))
    rich, ground = TR.render_batch_with_ground(port_state(states), port_params(params))
    assert rich.dtype == torch.int32 and rich.shape == (B, 80, 160)
    assert (rich.numpy() == ref_rich).mean() >= MIN_AGREEMENT
    assert (ground.numpy() == ref_ground).mean() >= MIN_AGREEMENT
    obs = TR.seg_to_obs(rich)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(R.seg_to_obs(jnp.asarray(rich.numpy()))))


@pytest.mark.parametrize("case", ["fresh", "driven"])
def test_composite_exact_on_same_tables(case):
    """The plain composite equals the Pallas composite (interpret) and the
    XLA flat composite bit for bit on the JAX package's candidate tables."""
    params = _params_for(case)
    states = _states_for(case, params)
    cam = R.CameraConfig()
    ground = render_batch_pallas_v5(states, params, interpret=True)
    want_pallas = np.asarray(composite_billboards_pallas(ground, states, params, interpret=True))
    want_xla = np.asarray(R._composite_billboards_flat(ground, states, params, cam))
    rows = torch.as_tensor(np.array(_prep_candidates(states, params, cam)[0]))
    depth = torch.as_tensor(np.asarray(R._row_geometry(cam)[2], np.float32))
    got = TR.composite_plain(rows, depth, torch.as_tensor(np.array(ground)), cam.width).numpy()
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_xla)
    assert (got != np.asarray(ground)).any(), "no billboard drawn: the case tests nothing"


def test_candidate_tables_match():
    """The port's candidate prep against _prep_candidates: geometry within
    f32 rounding (1e-3 px), class bits and validity exact."""
    params = _params_for("driven")
    states = _states_for("driven", params)
    want = np.asarray(_prep_candidates(states, params, R.CameraConfig())[0])
    got = TR.prep_candidates(port_state(states), port_params(params), TR.CameraConfig()).numpy()
    assert got.shape == want.shape == (B, 72, 8)
    np.testing.assert_allclose(got[..., [0, 1, 4, 5]], want[..., [0, 1, 4, 5]], atol=1e-3, rtol=1e-5)
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    np.testing.assert_array_equal(got[..., 2].view(np.int32) & 15, want[..., 2].view(np.int32) & 15)


def test_stripe_plan_matches():
    cam = R.CameraConfig()
    assert TR._row_stripes(TR.CameraConfig()) == R._row_stripes(cam)
    from carla_ppo_tpu.ops.rasterizer_pallas import _stripe_layout_v5

    plan, slab, sky = _stripe_layout_v5(cam)
    tplan, tslab, tsky = TR.stripe_layout(TR.CameraConfig())
    assert (tplan, tsky) == (plan, sky)
    np.testing.assert_array_equal(tslab, slab)
