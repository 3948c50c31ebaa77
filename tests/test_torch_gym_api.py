"""The port's interactive envs (carla_ppo_tpu_torch/envs/gym_api.py) and the
single-env latent observation (models/vae_common.create_encode_state_fn)
against the JAX package's, on the CPU with headless pygame.

Tolerances:
- observations and rewards within 1e-5, `done` equal (the same float32
  env step on the same actions; the JAX step is XLA, fused differently);
- the `state_pixels` and `rgb_array_no_hud` frames on at least 99.9% of
  pixels (MIN_AGREEMENT of test_torch_rasterizer: a waypoint tie or a
  last-bit ray difference may flip a boundary pixel), and `rgb_array` (the
  720x1280 window with the HUD) on as many, with each env's clock pinned
  to 30 fps so that the HUD prints the same text;
- the latent observation within 1e-4, the VAE tolerance of
  test_torch_models.

Both packages' envs draw into pygame's one display, one render at a time,
each covering the whole window before it is read back.
"""

from __future__ import annotations

import os

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.envs import gym_api as jgym
from carla_ppo_tpu.envs import lap_env as jlap_env
from carla_ppo_tpu.envs import track as jtrack
from carla_ppo_tpu.envs.types import EnvParams
from carla_ppo_tpu.models import vae_common as jvae_common
from carla_ppo_tpu.models.vae import ConvVAE as JConvVAE
from carla_ppo_tpu_torch.envs import gym_api
from carla_ppo_tpu_torch.models import vae_common
from carla_ppo_tpu_torch.models.vae import VAE, encoded_conv_shape
from carla_ppo_tpu_torch.utils import convert
from tests.test_torch_common import np_tree, port_params, port_state
from tests.test_torch_rasterizer import MIN_AGREEMENT

STEPS = 30
NONE_AT = 10  # the step that ticks with step(None)
RENDER_EVERY = 10


class PinnedClock:
    """A pygame clock that always reports 30 fps."""

    def tick(self):
        return 0

    def get_fps(self):
        return 30.0


def _actions(seed=0):
    rng = np.random.default_rng(seed)
    return [None if i == NONE_AT else
            np.array([rng.uniform(-0.3, 0.3), rng.uniform(0.3, 1.0)], np.float32)
            for i in range(STEPS)]


def _agreement(a, b) -> float:
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.ndim == 3 and a.shape[-1] == 3:
        return float((a == b).all(-1).mean())
    return float((a == b).mean())


def _one(jstate):
    """A JAX single-env state as the port's batch of one."""
    return port_state(jax.tree.map(lambda x: x[None], jstate))


def _drive_and_compare(jenv, tenv):
    """The same actions through both envs: obs and reward within 1e-5,
    done equal, and every RENDER_EVERY steps each render mode compared."""
    for i, a in enumerate(_actions()):
        jo, jr, jd, jinfo = jenv.step(a)
        to, tr, td, tinfo = tenv.step(a)
        assert to.shape == jo.shape and to.dtype == jo.dtype
        np.testing.assert_allclose(to, jo, atol=1e-5, rtol=0)
        assert abs(tr - jr) <= 1e-5 and isinstance(tr, float)
        assert td == jd and isinstance(td, bool)
        assert tinfo == jinfo == {"closed": False}
        if i % RENDER_EVERY == RENDER_EVERY - 1:
            for env in (jenv, tenv):
                if env.clock is None:
                    env.render("rgb_array")
                env.clock = PinnedClock()
            for mode in ("state_pixels", "rgb_array_no_hud", "rgb_array"):
                jf, tf = jenv.render(mode), tenv.render(mode)
                assert _agreement(tf, jf) >= MIN_AGREEMENT, mode
            assert tf.shape == (720, 1280, 3)
    np.testing.assert_allclose(tenv.state.control.numpy()[0], np.asarray(jenv.state.control),
                               atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def lap_envs():
    jenv = jgym.CarlaLapEnv(obs_res=(160, 80), encode_state_fn="vector")
    tenv = gym_api.CarlaLapEnv(obs_res=(160, 80), encode_state_fn="vector", device="cpu")
    yield jenv, tenv
    jenv.close()
    tenv.close()


def test_lap_env_matches_jax(lap_envs):
    jenv, tenv = lap_envs
    jo, to = jenv.reset(), tenv.reset()
    assert to.shape == (18,)
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=0)
    _drive_and_compare(jenv, tenv)


def test_route_env_matches_jax():
    """CarlaRouteEnv(num_routes=4): the same bank; the port's env takes the
    JAX env's reset state (the route draw is each package's own), then
    both drive the same actions."""
    jenv = jgym.CarlaRouteEnv(obs_res=(160, 80), encode_state_fn="vector", num_routes=4)
    tenv = gym_api.CarlaRouteEnv(obs_res=(160, 80), encode_state_fn="vector", num_routes=4,
                                 device="cpu")
    try:
        for f in ("pos", "length", "maneuver", "left_width"):
            np.testing.assert_array_equal(getattr(tenv.params.track, f).numpy(),
                                          np.asarray(getattr(jenv.params.track, f)))
        jenv.reset()
        tenv.reset()
        tenv.state = _one(jenv.state)
        _drive_and_compare(jenv, tenv)
        assert int(tenv.state.route_id) == int(jenv.state.route_id)
        assert tenv._current_maneuver() == jenv._current_maneuver()
    finally:
        jenv.close()
        tenv.close()


def test_step_none_ticks_without_acting(lap_envs):
    _, env = lap_envs
    env.reset()
    env.step(np.array([0.5, 0.5]))
    control = env.state.control.clone()
    env.step(None)
    torch.testing.assert_close(env.state.control, control)


def test_action_smoothing_default(lap_envs):
    """The constructor's smoothing is 0.9, like the reference."""
    _, env = lap_envs
    env.reset()
    env.step(np.array([1.0, 1.0]))
    assert abs(float(env.state.control[0, 0]) - 0.1) < 1e-5


def test_raw_pixel_obs_and_custom_encoder():
    raw = gym_api.CarlaLapEnv(obs_res=(160, 80), encode_state_fn=None, device="cpu")
    custom = gym_api.CarlaLapEnv(
        obs_res=(160, 80), device="cpu",
        encode_state_fn=lambda env: np.array([float(env.state.vehicle.speed)]))
    try:
        obs = raw.reset()
        assert obs.shape == (80, 160, 1) and obs.dtype == np.float32
        assert 0.0 <= obs.min() and obs.max() <= 1.0
        assert custom.reset().shape == (1,)
    finally:
        raw.close()
        custom.close()


def test_spaces_built_on_first_access(lap_envs):
    """Constructing an env builds no gymnasium space; the spaces are the
    JAX env's Boxes."""
    jenv, _ = lap_envs
    tenv = gym_api.CarlaLapEnv(obs_res=(160, 80), encode_state_fn="vector", device="cpu")
    assert tenv._spaces is None
    assert tenv.action_space == jenv.action_space
    assert tenv.observation_space == jenv.observation_space
    assert tenv.observation_space.shape == (80, 160, 1)


def test_step_after_close_raises():
    env = gym_api.CarlaLapEnv(obs_res=(160, 80), encode_state_fn="vector", device="cpu")
    env.render("rgb_array")
    env.close()
    assert env.closed and env.display is None
    with pytest.raises(RuntimeError, match="closed"):
        env.step(np.array([0.0, 1.0]))


def test_render_frames_need_no_pygame():
    """The pygame-free half of render gives the spectator frame that
    render("rgb_array_no_hud") returns, and the dashcam overlay. (An env of
    its own: closing any env quits pygame's one display, under every env.)"""
    env = gym_api.CarlaLapEnv(obs_res=(160, 80), encode_state_fn="vector", device="cpu")
    try:
        env.step(np.array([0.0, 0.5]))
        spec, dash = env.render_frames()
        assert spec.shape == (180, 320, 3) and spec.dtype == np.uint8
        assert dash.shape == (80, 160, 3) and dash.dtype == np.uint8
        np.testing.assert_array_equal(env.render("rgb_array_no_hud"), spec)
    finally:
        env.close()


@pytest.mark.parametrize("source", ["seg", "rgb"])
def test_create_encode_state_fn_matches_jax(source):
    """One env's latent observation, on the props track after a few steps,
    from the same seeded VAE weights: within 1e-4."""
    depth = 1 if source == "seg" else 3
    jm = JConvVAE(source_shape=(80, 160, depth), target_shape=(80, 160, 1), z_dim=64)
    jvars = jm.init(jax.random.PRNGKey(depth), jnp.zeros((1, 80, 160, depth)),
                    jax.random.PRNGKey(1), True)
    model = VAE(source_shape=(80, 160, depth), z_dim=64)
    model.load_state_dict(convert.vae_encoder_state_dict(
        np_tree(jvars), encoded_conv_shape((80, 160, depth))))
    model.eval()

    params = EnvParams(track=jtrack.make_lap_track(seed=0, props=True))
    state = jlap_env.reset(params, jax.random.PRNGKey(0), True, 40)
    for _ in range(5):
        state, _ = jlap_env.step(state, jnp.array([0.05, 0.8]), params)
    want = np.asarray(jax.jit(jvae_common.create_encode_state_fn(jm, jvars, source=source))(
        state, params))
    got = vae_common.create_encode_state_fn(model, source=source)(_one(state), port_params(params))
    assert got.shape == (67,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
