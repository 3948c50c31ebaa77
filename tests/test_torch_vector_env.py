"""The port's Gymnasium adapters (carla_ppo_tpu_torch/envs/vector_env.py and
gymnasium_api.py): the five cases of tests/test_vector_env.py, the port's
lap and route vector envs against the JAX package's on one seeded action
sequence, and gymnasium's env checker on both single-env adapters.

Tolerances: observations and rewards within 1e-5, terminated / truncated
/ the final-obs mask equal; the info arrays, episode accumulators summed
over up to 180 float32 steps (distance, total reward), within 1e-5
absolute plus 1e-5 relative. The lap envs reset
deterministically (eval spawns at waypoint 0, no spawn noise); the route
envs draw their routes from each package's own stream, so the port's
vector env takes the JAX env's reset states, and the sequence is short
enough that no route ends.
"""

from __future__ import annotations

import numpy as np
import pytest

import gymnasium

from carla_ppo_tpu.envs import vector_env as jvector
from carla_ppo_tpu_torch.envs.gymnasium_api import LapEnvGymnasium, RouteEnvGymnasium
from carla_ppo_tpu_torch.envs.vector_env import LapVectorEnv, RouteVectorEnv
from tests.test_torch_common import port_state


@pytest.fixture(scope="module")
def venv():
    return LapVectorEnv(num_envs=8, is_training=False, device="cpu")


def test_spaces_and_reset(venv):
    assert isinstance(venv, gymnasium.vector.VectorEnv)
    assert venv.metadata["autoreset_mode"] is gymnasium.vector.AutoresetMode.SAME_STEP
    obs, infos = venv.reset(seed=0)
    assert obs.shape == (8, venv.single_observation_space.shape[0])
    assert venv.observation_space.contains(obs)
    assert infos == {}


def test_step_batch(venv):
    venv.reset(seed=0)
    actions = np.tile(np.array([0.0, 1.0], np.float32), (8, 1))
    obs, rew, term, trunc, infos = venv.step(actions)
    assert obs.shape == (8, venv.single_observation_space.shape[0])
    assert rew.shape == term.shape == trunc.shape == (8,)
    assert not term.any() and not trunc.any()
    assert infos["distance_traveled"].shape == (8,)


def test_same_step_autoreset_final_obs(venv):
    """Zero throttle -> VEHICLE_STOPPED at step 151; the returned obs row is
    the respawned episode's first obs while final_obs carries the terminal."""
    venv.reset(seed=0)
    actions = np.zeros((8, 2), np.float32)
    for _ in range(151):
        obs, rew, term, trunc, infos = venv.step(actions)
    assert term.all()
    assert "final_obs" in infos and infos["_final_obs"].all()
    assert infos["final_obs"].shape == obs.shape
    obs2, _, term2, trunc2, infos2 = venv.step(actions)
    assert not term2.any() and not trunc2.any()
    assert (infos2["step_count"] == 1).all()


def test_reward_sign_matches_single_env(venv):
    venv.reset(seed=1)
    actions = np.tile(np.array([0.0, 1.0], np.float32), (8, 1))
    total = np.zeros(8)
    for _ in range(30):
        _, rew, _, _, _ = venv.step(actions)
        total += rew
    assert (total > 0).all()


def test_route_vector_env():
    venv = RouteVectorEnv(num_envs=4, num_routes=8, is_training=False, device="cpu")
    assert isinstance(venv, gymnasium.vector.VectorEnv)
    obs, _ = venv.reset(seed=3)
    assert obs.shape == (4, venv.single_observation_space.shape[0])
    assert len(set(venv._states.route_id.tolist())) > 1
    actions = np.tile(np.array([0.0, 1.0], np.float32), (4, 1))
    for _ in range(30):
        obs, rew, term, trunc, infos = venv.step(actions)
    assert venv.observation_space.contains(obs)
    assert (infos["distance_traveled"] > 0).all()
    assert (infos["laps_completed"] > 0).all()
    assert venv.render().shape[2] == 3


def _compare_steps(jenv, tenv, actions):
    for a in actions:
        jout, tout = jenv.step(a), tenv.step(a)
        for j, t in zip(jout[:4], tout[:4]):
            if j.dtype == np.bool_:
                np.testing.assert_array_equal(t, j)
            else:
                np.testing.assert_allclose(t, np.asarray(j), atol=1e-5, rtol=0)
        jinfo, tinfo = jout[4], tout[4]
        assert sorted(tinfo) == sorted(jinfo)
        for k in jinfo:
            if k == "_final_obs":
                np.testing.assert_array_equal(tinfo[k], jinfo[k])
            else:
                np.testing.assert_allclose(tinfo[k], np.asarray(jinfo[k]), atol=1e-5, rtol=1e-5)


def test_lap_vector_env_matches_jax():
    """Eval resets, a seeded throttle / steer sequence, then zero throttle
    through the stop at step 151 and the same-step re-spawn."""
    jenv = jvector.LapVectorEnv(num_envs=4, is_training=False)
    tenv = LapVectorEnv(num_envs=4, is_training=False, device="cpu")
    jo, _ = jenv.reset(seed=0)
    to, _ = tenv.reset(seed=0)
    np.testing.assert_allclose(to, np.asarray(jo), atol=1e-5, rtol=0)
    rng = np.random.default_rng(0)
    drive = [np.stack([rng.uniform(-0.2, 0.2, 4), rng.uniform(0.0, 1.0, 4)], 1).astype(np.float32)
             for _ in range(20)]
    _compare_steps(jenv, tenv, drive + [np.zeros((4, 2), np.float32)] * 160)


def test_route_vector_env_matches_jax():
    jenv = jvector.RouteVectorEnv(num_envs=4, num_routes=4, is_training=False)
    tenv = RouteVectorEnv(num_envs=4, num_routes=4, is_training=False, device="cpu")
    jenv.reset(seed=3)
    tenv.reset(seed=3)
    tenv._states = port_state(jenv._states)
    rng = np.random.default_rng(1)
    actions = [np.stack([rng.uniform(-0.2, 0.2, 4), rng.uniform(0.3, 1.0, 4)], 1).astype(np.float32)
               for _ in range(30)]
    _compare_steps(jenv, tenv, actions)
    np.testing.assert_array_equal(tenv._states.route_id.numpy(), np.asarray(jenv._states.route_id))
    np.testing.assert_array_equal(tenv.render(), np.asarray(jenv.render()))


@pytest.mark.parametrize("cls, kwargs", [(LapEnvGymnasium, dict(render_mode="rgb_array")),
                                         (RouteEnvGymnasium, dict(num_routes=4))],
                         ids=["lap", "route"])
def test_gymnasium_adapters_pass_env_checker(cls, kwargs):
    """gymnasium's official env checker, and the API basics of
    tests/test_gym_api.py's gymnasium cases."""
    from gymnasium.utils.env_checker import check_env

    env = cls(device="cpu", **kwargs)
    check_env(env, skip_render_check=False)
    obs, info = env.reset(seed=1)
    assert obs.shape == (18,) and "laps_completed" in info
    for _ in range(3):
        obs, reward, terminated, truncated, info = env.step(np.array([0.0, 1.0]))
    assert isinstance(reward, float) and not terminated and not truncated
    assert env.observation_space.contains(obs)
    assert env.action_space.contains(np.array([0.5, 0.5], np.float32))
    if env.render_mode == "rgb_array":
        frame = env.render()
        assert frame.shape == (80, 160, 3) and frame.dtype == np.uint8


def test_gymnasium_lap_adapter_matches_jax():
    from carla_ppo_tpu.envs.gymnasium_api import LapEnvGymnasium as JLap

    jenv, tenv = JLap(render_mode="rgb_array"), LapEnvGymnasium(render_mode="rgb_array",
                                                                device="cpu")
    jo, ji = jenv.reset(seed=0)
    to, ti = tenv.reset(seed=0)
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=0)
    assert sorted(ti) == sorted(ji)
    for a in ([0.1, 1.0], [0.0, 0.8], [-0.1, 0.5]):
        jstep, tstep = jenv.step(np.array(a)), tenv.step(np.array(a))
        np.testing.assert_allclose(tstep[0], jstep[0], atol=1e-5, rtol=0)
        assert abs(tstep[1] - jstep[1]) <= 1e-5 and tstep[2:4] == jstep[2:4]
        for k in ji:
            assert abs(tstep[4][k] - jstep[4][k]) <= 1e-5, k
    np.testing.assert_array_equal(tenv.render(), jenv.render())
