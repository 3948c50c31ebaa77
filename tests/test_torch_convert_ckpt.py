"""The converted checkpoints under models/torch/ against the shipped orbax
checkpoints they come from (scripts/export_torch_checkpoints.py).

1. Running the converter again reproduces every committed file, tensor for
   tensor, the Adam moments and the counters included.
2. The converted Adam moments sit beside the right parameters: one optax
   update (the JAX optimizer on the orbax state) and one clip_and_adam of
   the port (on the converted state), with the same gradients, give the
   same parameters, within 1e-6 absolute (an update of ~lr = 1e-4, float32).
   A transposed or misplaced moment passes every eval and would only show
   here, after a resumed update. For the pixel agents the optimizer is
   optax's two-group multi_transform: each group (policy, encoder) with its
   own clip, count and moments, continued group by group.
3. The pixel agent of step 1300 (models/pixel_agent_pretrained, not
   committed converted: ~35 MB) converted from its orbax checkpoint here,
   against its pinned golden: mean / std / value within 1e-5 relative.
"""

from __future__ import annotations

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.training import pixels as j_pixels
from carla_ppo_tpu.training import ppo as j_ppo
from carla_ppo_tpu_torch.models.pixel_policy import PixelActorCritic
from carla_ppo_tpu_torch.models.policy import ActorCritic
from carla_ppo_tpu_torch.training import pixels as t_pixels
from carla_ppo_tpu_torch.training import ppo
from carla_ppo_tpu_torch.utils import convert
from carla_ppo_tpu_torch.utils.checkpoint import Checkpointer
from carla_ppo_tpu_torch.utils.device import make_generator
from tests.test_torch_checkpoints import _goldens
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
    names = ([a[0] for a in ex.AGENTS] + list(ex.COMMITTED_PIXEL_AGENTS)
             + [f"vae_models/{v}" for v in ex.VAES])
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


@pytest.fixture(scope="module")
def pixel_agent_1300():
    """(JAX state, the port's checkpoint tree) of the step-1300 pixel agent,
    converted here from its orbax checkpoint."""
    ex = _exporter()
    step, jstate = ex.restore_pixel_agent(ex.PIXEL_AGENTS["pixel_agent"])
    assert step == 1300
    return jstate, ex.pixel_agent_tree(jstate)


def test_pixel_agent_matches_golden(pixel_agent_1300):
    from tests.test_torch_checkpoints import pixel_golden_outputs

    _, tree = pixel_agent_1300
    model = PixelActorCritic()
    model.load_state_dict(tree["model"])
    want = _goldens()["pixel_agent"]
    for got, exp in zip(pixel_golden_outputs(model), (want["mean"], want["std"], want["value"])):
        np.testing.assert_allclose(got, np.asarray(exp, np.float32), rtol=1e-5, atol=1e-7)
    assert tree["iteration"] == 1300


@pytest.mark.parametrize("agent", ["pixel_agent", "pixel_turnkey"])
def test_converted_pixel_adam_groups_continue_an_update(agent, pixel_agent_1300):
    """One optax multi_transform update of the orbax state against each
    group's clip_and_adam on the converted state (the committed one for
    pixel_turnkey), with the same gradients scaled so that both groups
    clip: parameters within 1e-6, each group's count one further."""
    ex = _exporter()
    if agent == "pixel_agent":
        jstate, tree = pixel_agent_1300
    else:
        step, jstate = ex.restore_pixel_agent(ex.PIXEL_AGENTS[agent])
        tree = Checkpointer(REPO / "models" / "torch" / agent / "checkpoints").read_tree(step)
    config, pix = j_ppo.PPOConfig(learning_rate=3e-4), j_pixels.PixelConfig()
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)),
                         jstate.params)
    tx = j_pixels.make_pixel_optimizer(config, pix)
    updates, _ = tx.update(grads, jstate.opt_state, jstate.params)
    want = convert.pixel_actor_critic_state_dict(
        np_tree(jax.tree.map(lambda p, u: p + u, jstate.params, updates)))

    template = t_pixels.create_pixel_train_state(PixelActorCritic(), ppo.PPOConfig(),
                                                 make_generator(0, "cpu"))
    ts = template.restored(tree)
    t_grads = convert.pixel_actor_critic_state_dict(np_tree(grads))
    t_config, t_pix = ppo.PPOConfig(learning_rate=3e-4), t_pixels.PixelConfig()
    for group, named in t_pixels.param_groups(ts.model).items():
        names = [n for n, _ in named]
        g = [t_grads[n] for n in names]
        assert float(ppo.global_norm(g)) > t_pix.clip_norm(group)  # this group clips
        new_params, new_opt = ppo.clip_and_adam([p for _, p in named], g, ts.opt_state[group],
                                                t_config, clip_norm=t_pix.clip_norm(group))
        for n, p in zip(names, new_params):
            np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=0, atol=1e-6, err_msg=n)
            assert not torch.equal(p, dict(named)[n]), n
        assert int(new_opt.count) == int(tree["opt_state"][group]["count"]) + 1
