"""The port's plain ground pass against the float64 C++ golden rasterizer
(carla_ppo_tpu/utils/native.py `render_semantic_cpu`, ground only), under
the JAX package's own contract for its device renderer
(tests/test_native.py::test_golden_rasterizer_matches_device): over 95% of
pixels equal (float32 against float64 differ on band-boundary pixels), the
same set of classes, the sky rows exact. Skips where the native library
cannot be built, as tests/test_native.py does."""

from __future__ import annotations

import types

import jax
import numpy as np
import pytest

from carla_ppo_tpu.envs import lap_env
from carla_ppo_tpu.envs import track as track_mod
from carla_ppo_tpu.envs.types import EnvParams
from carla_ppo_tpu.utils import native
from carla_ppo_tpu_torch.ops import rasterizer as TR
from tests.test_torch_common import port_params, port_state

SKY_ROWS = 39


def _one(states, b):
    """Env b of a JAX batch, as the fields render_semantic_cpu reads."""
    v = states.vehicle
    return types.SimpleNamespace(
        vehicle=types.SimpleNamespace(pos=np.asarray(v.pos[b]), yaw=np.asarray(v.yaw[b])),
        waypoint_idx=np.asarray(states.waypoint_idx[b]))


@pytest.mark.parametrize("case", ["lap", "open", "driven"])
def test_plain_ground_pass_matches_float64_golden(case):
    if not native.available():
        pytest.skip("native library not built (run make -C native)")
    if case == "open":
        params = EnvParams(track=track_mod.make_segment_track(
            [track_mod.Straight(40.0), track_mod.Arc(90.0, 30.0), track_mod.Straight(60.0)]))
    else:
        params = EnvParams(track=track_mod.make_lap_track(seed=0))
    L = int(params.track.length)
    starts = np.asarray([0, 5, L // 3, L // 2, L - 40, 2 * L // 3]) % L
    keys = jax.random.split(jax.random.PRNGKey(0), starts.size)
    states = jax.vmap(lambda k, c: lap_env.reset(params, k, True, c))(keys, starts.astype(np.int32))
    if case == "driven":
        step = jax.jit(jax.vmap(lambda s, a: lap_env.step(s, a, params)))
        act = np.stack([np.linspace(-0.3, 0.3, starts.size), np.full(starts.size, 0.9)], 1)
        for _ in range(60):
            states, _ = step(states, act.astype(np.float32))
    cam = TR.CameraConfig(render_props=False)
    got = TR.render_batch(port_state(states), port_params(params), cam).numpy()
    for b in range(starts.size):
        gold = native.render_semantic_cpu(_one(states, b), params).reshape(got.shape[1:])
        assert (gold == got[b]).mean() > 0.95, b
        assert set(np.unique(gold)) == set(np.unique(got[b])), b
        np.testing.assert_array_equal(got[b, :SKY_ROWS], gold[:SKY_ROWS])
