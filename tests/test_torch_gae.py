"""The port's two GAE forms (carla_ppo_tpu_torch/ops/gae.py) against both
of the JAX package's (the reverse scan and the associative scan) at the
rollout length PPO uses, T=128, with dones; and PPOConfig's
use_associative_gae taking the associative form in ppo_update.

Tolerance, stated before measuring: 1e-5 absolute (float32; the log-depth
scan multiplies the discounts in another order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from carla_ppo_tpu.ops import gae as jgae
from carla_ppo_tpu_torch.models.policy import ActorCritic
from carla_ppo_tpu_torch.ops import gae as tgae
from carla_ppo_tpu_torch.training import ppo as tppo
from carla_ppo_tpu_torch.utils.device import make_generator


def _inputs(T=128, B=16, seed=0, p_done=0.05):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, B)).astype(np.float32), rng.normal(size=(T, B)).astype(np.float32),
            rng.normal(size=(B,)).astype(np.float32),
            (rng.uniform(size=(T, B)) < p_done).astype(np.float32))


@pytest.mark.parametrize("T", [128, 1, 5])
def test_associative_gae_matches_both_jax_forms(T):
    r, v, b, d = _inputs(T=T)
    assert T < 128 or d.any()
    got = tgae.compute_gae_associative(*(torch.from_numpy(x) for x in (r, v, b, d)), 0.99, 0.95)
    for fn in (jgae.compute_gae, jgae.compute_gae_associative):
        np.testing.assert_allclose(got.numpy(), np.asarray(fn(r, v, b, d, 0.99, 0.95)), atol=1e-5, rtol=0)
    scan = tgae.compute_gae(*(torch.from_numpy(x) for x in (r, v, b, d)), 0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), scan.numpy(), atol=1e-5, rtol=0)


def test_ppo_update_takes_the_associative_form(monkeypatch):
    """use_associative_gae is accepted and routes ppo_update through
    compute_gae_associative (it raised NotImplementedError before)."""
    config = tppo.PPOConfig(num_envs=4, horizon=8, num_epochs=1, num_minibatches=2,
                            use_associative_gae=True)
    calls = []
    real = tgae.compute_gae_associative
    monkeypatch.setattr(tgae, "compute_gae_associative", lambda *a: calls.append(1) or real(*a))
    g = make_generator(0, "cpu")
    ts = tppo.create_train_state(ActorCritic(5, generator=g), config, g)
    r, v, b, d = _inputs(T=8, B=4)
    rng = np.random.default_rng(1)
    traj = tppo.Trajectory(obs=torch.from_numpy(rng.normal(size=(8, 4, 5)).astype(np.float32)),
                           actions=torch.full((8, 4, 2), 0.5), log_probs=torch.full((8, 4), -1.0),
                           values=torch.from_numpy(v), rewards=torch.from_numpy(r),
                           dones=torch.from_numpy(d))
    met = tppo.ppo_update(ts, traj, torch.from_numpy(b), config)
    assert calls == [1] and np.isfinite(met["train_loss/loss"].item())
