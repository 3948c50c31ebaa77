"""The converted checkpoints under models/torch/ against the shipped orbax
checkpoints they come from (scripts/export_torch_checkpoints.py).

1. Running the converter again reproduces every committed file, tensor for
   tensor, the Adam moments and the counters included.
2. The converted Adam moments sit beside the right parameters: one optax
   update (the JAX optimizer on the orbax state) and one clip_and_adam of
   the port (on the converted state), with the same gradients, give the
   same parameters, within 1e-6 absolute (an update of ~lr = 1e-4, float32).
   A transposed or misplaced moment passes every eval and would only show
   here, after a resumed update.
"""

from __future__ import annotations

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.training import ppo as j_ppo
from carla_ppo_tpu_torch.models.policy import ActorCritic
from carla_ppo_tpu_torch.training import ppo
from carla_ppo_tpu_torch.utils import convert
from carla_ppo_tpu_torch.utils.checkpoint import Checkpointer
from carla_ppo_tpu_torch.utils.device import make_generator
from tests.test_torch_common import REPO, np_tree


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoints", REPO / "scripts" / "export_torch_checkpoints.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def test_export_reproduces_committed_files(tmp_path):
    ex = _exporter()
    ex.export(str(tmp_path))
    names = [a[0] for a in ex.AGENTS] + [f"vae_models/{v}" for v in ex.VAES]
    for name in names:
        committed = Checkpointer(REPO / "models" / "torch" / name / "checkpoints")
        fresh = Checkpointer(tmp_path / name / "checkpoints")
        assert committed.all_steps() == fresh.all_steps() and len(fresh.all_steps()) == 1, name
        step = fresh.latest_step()
        _assert_trees_equal(fresh.read_tree(step), committed.read_tree(step), name)


@pytest.mark.parametrize("agent", ["latent_agent", "lap_agent"])
def test_converted_adam_moments_continue_an_update(agent):
    ex = _exporter()
    _, src, obs_dim = next(a for a in ex.AGENTS if a[0] == agent)
    _, jstate = ex.restore_agent(src, obs_dim)
    config = j_ppo.PPOConfig(max_grad_norm=0.5)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)),
                         jstate.params)
    tx = j_ppo.make_optimizer(config)
    updates, _ = tx.update(grads, jstate.opt_state, jstate.params)
    want = np_tree(jax.tree.map(lambda p, u: p + u, jstate.params, updates))

    template = ppo.create_train_state(ActorCritic(obs_dim, generator=make_generator(0, "cpu")),
                                      ppo.PPOConfig(), make_generator(0, "cpu"))
    ts = Checkpointer(REPO / "models" / "torch" / agent / "checkpoints").restore_latest(template)
    names = [n for n, _ in ts.model.named_parameters()]
    t_grads = convert.actor_critic_state_dict(np_tree(grads))
    params = list(ts.model.parameters())
    new_params, new_opt = ppo.clip_and_adam(params, [t_grads[n] for n in names], ts.opt_state,
                                            ppo.PPOConfig(max_grad_norm=0.5))
    want_sd = convert.actor_critic_state_dict(want)
    for n, p in zip(names, new_params):
        np.testing.assert_allclose(p.numpy(), want_sd[n].numpy(), rtol=0, atol=1e-6, err_msg=n)
        assert not torch.equal(p, dict(ts.model.named_parameters())[n]), n
    assert int(new_opt.count) == ts.train_step + 1
