"""The port's RGB camera (carla_ppo_tpu_torch/ops/rasterizer.py
render_rgb_batch and the composite's depth-and-sky mode) against the JAX
package's render_rgb (vmapped on the CPU, as its CPU path runs it).

Tolerances:
- classes and sky exactly; the composite's depth-and-sky plain version
  bit for bit against the XLA _composite_billboards_flat(...,
  return_depth_sky=True) on the same candidate tables;
- depth within 4e-6 relative: the JAX single-env path computes it in
  float32 from each pixel's ray (ground_points' t, off by up to ~11 ulps,
  1.3e-6 relative, on these cameras), the port takes the static per-row
  depth (computed in float64, rounded to float32 once);
- RGB within 1e-6 absolute, the fog that depth feeds and the float32
  palette, haze and sky-gradient arithmetic (XLA may fuse a multiply-add);
- with texture noise the same bound, the noise injected: the JAX draw
  (jax.random.normal of each env's key, as render_rgb draws it) is handed
  to the port.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.envs import lap_bank_env as jbank_env
from carla_ppo_tpu.envs import lap_env
from carla_ppo_tpu.envs import track as track_mod
from carla_ppo_tpu.envs.types import EnvParams
from carla_ppo_tpu.ops import rasterizer as R
from carla_ppo_tpu.ops.rasterizer_pallas import _prep_candidates
from carla_ppo_tpu_torch.envs import lap_bank_env as tbank_env
from carla_ppo_tpu_torch.ops import rasterizer as TR
from tests.test_torch_common import port_params, port_state
from tests.test_torch_routes import port_bank

B = 8
CAMERAS = {"80x160": {}, "84x84": dict(height=84, width=84)}


@pytest.fixture(scope="module")
def traffic_case():
    """(JAX params, JAX states): the props track with 4 live NPC billboards
    placed 6-30 m ahead of 8 envs driven 30 steps."""
    params = EnvParams(track=track_mod.make_lap_track(seed=0, props=True), num_npcs=4)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    states = jax.vmap(lambda k, c: lap_env.reset(params, k, True, c))(
        keys, jnp.arange(B, dtype=jnp.int32) * 211)
    step = jax.jit(jax.vmap(lambda s, a: lap_env.step(s, a, params)))
    steer = jnp.linspace(-0.2, 0.2, B)
    for t in range(30):
        states, _ = step(states, jnp.stack([steer * jnp.sin(0.1 * t), jnp.full((B,), 0.8)], 1))
    rng = np.random.default_rng(0)
    ego = np.asarray(states.waypoint_idx).astype(np.float32)
    states = states.replace(
        npc_s=jnp.asarray(ego[:, None] + rng.uniform(6, 30, size=(B, 8)).astype(np.float32)),
        npc_lateral=jnp.asarray(rng.uniform(-1.5, 1.5, size=(B, 8)).astype(np.float32)),
    )
    return params, states


def _jax_parts(states, params, cam):
    """The JAX single-env path's (cls, depth, sky), each [B, H, W]."""
    def one(s):
        cls, depth, sky = R._ground_pass(s, params, cam, R.RoadStyle())
        return R.billboard_pass(cls, depth, sky, s, params, cam)

    return [np.asarray(x) for x in jax.vmap(one)(states)]


def _port_parts(ts, tp, tcam):
    win_cols, payload = TR.prep_windows(ts, tp, tcam)
    ground = TR.ground_pass(win_cols, payload, tcam, TR.RoadStyle())
    cls, depth, sky = TR.composite_depth_sky(TR.prep_candidates(ts, tp, tcam), ground, tcam)
    shape = (ts.batch_size, tcam.height, tcam.width)
    return [x.view(shape).numpy() for x in (cls, depth, sky)]


@pytest.mark.parametrize("camera", sorted(CAMERAS))
def test_rgb_batch_matches_jax(traffic_case, camera):
    params, states = traffic_case
    cam, tcam = R.CameraConfig(**CAMERAS[camera]), TR.CameraConfig(**CAMERAS[camera])
    tp = port_params(params, num_npcs=4)
    ts = port_state(states)
    want_cls, want_depth, want_sky = _jax_parts(states, params, cam)
    cls, depth, sky = _port_parts(ts, tp, tcam)
    np.testing.assert_array_equal(cls, want_cls)
    np.testing.assert_array_equal(sky, want_sky)
    np.testing.assert_allclose(depth, want_depth, rtol=4e-6, atol=0)
    assert (cls == 10).any(), "no NPC billboard in view: the case tests nothing"
    want = np.asarray(jax.vmap(lambda s: R.render_rgb(s, params, cam))(states))
    got = TR.render_rgb_batch(ts, tp, tcam)
    assert got.shape == (B, tcam.height, tcam.width, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(TR.seg_to_rgb(torch.as_tensor(cls)).numpy(),
                                  np.asarray(R.seg_to_rgb(jnp.asarray(cls))))


def test_rgb_noise_matches_jax(traffic_case):
    """Texture noise: the JAX per-env keys' draws, injected into the port."""
    params, states = traffic_case
    cam = R.CameraConfig()
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    want = np.asarray(jax.vmap(lambda s, k: R.render_rgb(s, params, cam, key=k))(states, keys))
    noise = jax.vmap(lambda k: jax.random.normal(k, (cam.height * cam.width, 3)))(keys)
    noise = torch.as_tensor(np.array(noise).reshape(B, cam.height, cam.width, 3))
    got = TR.render_rgb_batch(port_state(states), port_params(params, num_npcs=4), noise=noise)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # a generator draws noise of the right shape and scale
    g = torch.Generator().manual_seed(0)
    noisy = TR.render_rgb_batch(port_state(states), port_params(params, num_npcs=4), noise=g)
    clean = TR.render_rgb_batch(port_state(states), port_params(params, num_npcs=4))
    d = (noisy - clean).numpy()
    assert abs(float(d.std()) - TR.NOISE_STD) < 0.002 and float(np.abs(d).max()) <= 0.2


@pytest.mark.parametrize("case", ["fresh", "driven"])
def test_composite_depth_sky_exact_on_same_tables(case):
    """composite_plain(..., return_depth_sky=True) equals the XLA flat
    composite with return_depth_sky bit for bit: classes, depth bits, sky."""
    from tests.test_torch_rasterizer import _params_for, _states_for

    params = _params_for(case)
    states = _states_for(case, params)
    cam = R.CameraConfig()
    tcam = TR.CameraConfig()
    # any ground frames will do; the port's plain ground pass is the quick one
    ground = TR.ground_pass(*TR.prep_windows(port_state(states), port_params(params), tcam), tcam,
                            TR.RoadStyle()).numpy()
    want = [np.asarray(x) for x in R._composite_billboards_flat(jnp.asarray(ground), states, params, cam,
                                                                return_depth_sky=True)]
    rows = torch.as_tensor(np.array(_prep_candidates(states, params, cam)[0]))
    depth = torch.as_tensor(np.asarray(R._row_geometry(cam)[2], np.float32))
    got = [x.numpy() for x in TR.composite_plain(rows, depth, torch.as_tensor(ground),
                                                 cam.width, return_depth_sky=True)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32), want[1].astype(np.float32).view(np.int32))
    np.testing.assert_array_equal(got[2], want[2])
    assert (got[0] != np.asarray(ground)).any() and got[2].any()


def test_banked_rgb_matches_jax():
    """A lap-bank batch through render_rgb_batch (the banked prep, the same
    kernels) against the JAX package's per-env render_rgb on each env's
    track, as its banked encode path runs it."""
    bank = jbank_env.make_lap_bank(n_tracks=3, capacity=2048, props=True)
    jp = jbank_env.lap_bank_params(bank)
    js = jbank_env.init_env_batch(jp, B, jax.random.PRNGKey(6))
    step = jax.jit(jax.vmap(lambda s, a: lap_env.step(s, a, jp.replace(track=jax.tree.map(
        lambda x: x[s.route_id], jp.track)))))
    for _ in range(10):
        js, _ = step(js, jnp.tile(jnp.asarray([[0.05, 0.8]]), (B, 1)))
    want = np.asarray(jax.vmap(
        lambda s: R.render_rgb(s, jp.replace(track=jax.tree.map(lambda x: x[s.route_id], jp.track)))
    )(js))
    tp = tbank_env.lap_bank_params(port_bank(bank))
    got = TR.render_rgb_batch(port_state(js), tp)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_single_env_renders_are_a_batch_of_one(traffic_case):
    """render_rgb_and_semantic (what cli.collect_data calls) equals row 0
    of the batch renders, props on and off, and refuses a batch of more
    than one."""
    from carla_ppo_tpu_torch.envs.types import map_tensors

    params, states = traffic_case
    tp, ts = port_params(params, num_npcs=4), port_state(states)
    one = map_tensors(lambda t: t[:1], ts)
    cam = dataclasses.replace(TR.CameraConfig(), render_props=False)
    for c in (TR.CameraConfig(), cam):
        rgb, seg = TR.render_rgb_and_semantic(one, tp, c)
        assert torch.equal(seg, TR.render_batch(ts, tp, c)[0])
        assert torch.equal(rgb, TR.render_rgb_batch(ts, tp, c)[0])
    with pytest.raises(ValueError, match="one env"):
        TR.render_rgb_and_semantic(ts, tp)
    plain = TR.render_rgb_batch(ts, tp, cam)
    assert plain.shape == (B, 80, 160, 3) and not torch.equal(plain, TR.render_rgb_batch(ts, tp))
