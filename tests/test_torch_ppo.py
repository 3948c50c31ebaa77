"""The port's PPO (carla_ppo_tpu_torch/training/ppo.py, ops/gae.py,
ops/running_stats.py) against the JAX package's, and the whole latent slice
(camera -> frozen VAE -> policy -> env) greedy, step for step.

Tolerances, all float32 on both sides:
- GAE and reward normalisation within 1e-5 (a 16-step recurrence);
- loss and its gradients within rel 1e-4 (matmuls summed in another order);
- parameters after a full update phase (2 epochs x 2 minibatches of Adam)
  within 1e-4, and the Adam step itself within 2% of the learning rate;
- the greedy latent slice: observations and rewards within 1e-3 per step
  for 8 steps (the golden env bound);
- greedy evaluate metrics within 1e-3.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.envs import lap_env
from carla_ppo_tpu.envs import track as track_mod
from carla_ppo_tpu.envs.types import EnvParams
from carla_ppo_tpu.models.policy import ActorCritic as JActorCritic
from carla_ppo_tpu.models.vae import ConvVAE as JConvVAE
from carla_ppo_tpu.ops import gae as jgae
from carla_ppo_tpu.ops import running_stats as jrs
from carla_ppo_tpu.training import ppo as jppo
from carla_ppo_tpu_torch.envs import lap_env as tenv
from carla_ppo_tpu_torch.models.policy import ActorCritic
from carla_ppo_tpu_torch.models.vae import VAE, encoded_conv_shape
from carla_ppo_tpu_torch.ops import gae as tgae
from carla_ppo_tpu_torch.ops import rasterizer_cuda as TRC
from carla_ppo_tpu_torch.ops import running_stats as trs
from carla_ppo_tpu_torch.training import ppo as tppo
from carla_ppo_tpu_torch.utils import convert
from carla_ppo_tpu_torch.utils.device import make_generator
from tests.test_torch_common import np_tree, port_params, port_state

T, B = 16, 8


def _rollout_arrays(seed=0):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    boot = rng.normal(size=(B,)).astype(np.float32)
    dones = (rng.uniform(size=(T, B)) < 0.1).astype(np.float32)
    return rewards, values, boot, dones


def _t(x):
    return torch.as_tensor(np.array(x))


def test_gae_matches():
    r, v, b, d = _rollout_arrays()
    want = np.asarray(jgae.compute_gae(r, v, b, d, 0.99, 0.95))
    got = tgae.compute_gae(_t(r), _t(v), _t(b), _t(d), 0.99, 0.95).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tgae.normalize_advantages(_t(want)).numpy(),
        np.asarray(jgae.normalize_advantages(jnp.asarray(want))), atol=1e-5, rtol=0,
    )


def test_reward_normalisation_matches():
    r, _, _, d = _rollout_arrays(1)
    ret0 = np.random.default_rng(2).normal(size=(B,)).astype(np.float32)
    jn, jm, jret = jrs.normalize_rewards(jrs.RunningMoments.create(), ret0, r, d, 0.99)
    tn, tm, tret = trs.normalize_rewards(trs.RunningMoments.create(), _t(ret0), _t(r), _t(d), 0.99)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), atol=1e-5, rtol=0)
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(tm, f).item(), float(getattr(jm, f)), rtol=1e-5)


def _policy_pair(obs_dim, seed=0):
    jm = JActorCritic()
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)))
    tm = ActorCritic(obs_dim)
    tm.load_state_dict(convert.actor_critic_state_dict(np_tree(params)), strict=False)
    return jm, params, tm


def _batch(obs_dim, n=64, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": np.clip(rng.normal(0.3, 0.6, size=(n, 2)), [-1, 0], [1, 1]).astype(np.float32),
        "log_probs": rng.normal(-2.0, 0.5, size=(n,)).astype(np.float32),
        "returns": rng.normal(size=(n,)).astype(np.float32),
        "advantages": rng.normal(size=(n,)).astype(np.float32),
    }


def _grad_close(got, want, rel=1e-4):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=rel)


def test_ppo_loss_and_gradients_match():
    obs_dim = 18
    jm, params, tm = _policy_pair(obs_dim)
    batch = _batch(obs_dim)
    config = jppo.PPOConfig()
    (jloss, jmet), jgrads = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(
        params, jm, {k: jnp.asarray(v) for k, v in batch.items()}, config
    )
    loss, met = tppo.ppo_loss(tm, {k: _t(v) for k, v in batch.items()}, tppo.PPOConfig())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-4, atol=1e-6)
    want = convert.actor_critic_state_dict(np_tree(jgrads))
    for name, p in tm.named_parameters():
        _grad_close(p.grad.numpy(), want[name].numpy())


@pytest.mark.isolated
def test_update_phase_matches():
    """One iteration's update phase on the JAX package's own trajectory:
    the port's ppo_update vs jppo.train_iteration from the same state,
    trajectory and minibatch permutations."""
    params_env = EnvParams(track=track_mod.make_lap_track(seed=0))
    config = jppo.PPOConfig(num_envs=B, horizon=T, num_epochs=2, num_minibatches=2,
                            learning_rate=3e-4, max_grad_norm=0.5, kl_target=0.05)
    obs_dim = 18
    jm = JActorCritic()
    jstate = jppo.create_train_state(jm, config, obs_dim, jax.random.PRNGKey(0))
    envs = jppo.init_env_batch(params_env, B, jax.random.PRNGKey(1))
    new_jstate, _, jmet = jppo.train_iteration(jstate, envs, params_env, jm, config)

    _, roll_key, perm_key = jax.random.split(jstate.rng, 3)
    _, traj, boot, _ = jppo.rollout(jm, jstate.params, envs, params_env, roll_key, T, config)
    perms = [_t(jax.random.permutation(k, B)).long() for k in jax.random.split(perm_key, 2)]

    tconf = tppo.PPOConfig(**{f.name: getattr(config, f.name) for f in dataclasses.fields(config)})
    tm = ActorCritic(obs_dim)
    tm.load_state_dict(convert.actor_critic_state_dict(np_tree(jstate.params)), strict=False)
    ts = tppo.create_train_state(tm, tconf, make_generator(0, "cpu"))
    ttraj = tppo.Trajectory(**{k: _t(v) for k, v in np_tree(traj).items()})
    met = tppo.ppo_update(ts, ttraj, _t(boot), tconf, perms=perms)

    before = convert.actor_critic_state_dict(np_tree(jstate.params))
    want = convert.actor_critic_state_dict(np_tree(new_jstate.params))
    for name, p in tm.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, want[name].numpy(), atol=1e-4, rtol=0)
        step_got = got - before[name].numpy()
        step_want = want[name].numpy() - before[name].numpy()
        np.testing.assert_allclose(step_got, step_want, atol=0.02 * config.learning_rate, rtol=0)
    assert int(ts.opt_state.count) == int(new_jstate.opt_state[1][0].count)
    for k in ("train_loss/loss", "train/approx_kl", "train/update_skipped"):
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-3, atol=1e-6)


def _latent_pair(params_env):
    """JAX and port (VAE, policy) with the same seeded weights; the VAE at
    the shipped de-prop seg VAE's widths (1 channel in, z 64)."""
    jvae = JConvVAE(source_shape=(80, 160, 1), target_shape=(80, 160, 1), z_dim=64)
    jvars = jvae.init(jax.random.PRNGKey(5), jnp.zeros((1, 80, 160, 1)), jax.random.PRNGKey(6), True)
    tvae = VAE(source_shape=(80, 160, 1), z_dim=64)
    tvae.load_state_dict(convert.vae_encoder_state_dict(np_tree(jvars), encoded_conv_shape((80, 160, 1))))
    jm, jparams, tm = _policy_pair(67, seed=7)
    return (jvae, jvars, jm, jparams), (tvae.eval(), tm)


def test_greedy_latent_slice_matches():
    """8 greedy steps of camera -> VAE -> policy -> env, both packages."""
    params_env = EnvParams(track=track_mod.make_lap_track(seed=0, props=True))
    (jvae, jvars, jm, jparams), (tvae, tm) = _latent_pair(params_env)
    config = jppo.PPOConfig(num_envs=4)
    jlat = jppo.LatentObs(vae_model=jvae)
    jobs_fn = jppo.make_obs_fn(jlat, jvars, config)
    tlat = tppo.LatentObs(vae_model=tvae)
    tobs_fn = tppo.make_obs_fn(tlat, tppo.PPOConfig(num_envs=4))

    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    js = jax.vmap(lambda k, c: lap_env.reset(params_env, k, True, c))(
        keys, jnp.asarray([0, 200, 400, 600], jnp.int32))
    tp, ts = port_params(params_env), port_state(js)
    step = jax.jit(jax.vmap(lambda s, a: lap_env.step(s, a, params_env)))
    jobs, tobs = jobs_fn(js, params_env), tobs_fn(ts, tp)
    for _ in range(8):
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-3, rtol=0)
        jmean = jm.apply(jparams, jobs)[0]
        with torch.no_grad():
            tmean = tm(tobs)[0]
        np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), atol=1e-3, rtol=0)
        js, jo = step(js, jmean)
        ts, to = tenv.step(ts, tmean, tp, obs_fn=None)
        np.testing.assert_allclose(to.reward.numpy(), np.asarray(jo.reward), atol=1e-3, rtol=0)
        jobs, tobs = jobs_fn(js, params_env), tobs_fn(ts, tp)
    assert tobs.shape == (4, 67)


def test_evaluate_matches(lap_params):
    """Greedy evaluate (vector obs): same metrics as the JAX package."""
    jm, jparams, tm = _policy_pair(18, seed=4)
    config = jppo.PPOConfig()
    want = jppo.evaluate(jparams, lap_params, jm, jax.random.PRNGKey(0), num_envs=3,
                         max_steps=40, config=config, chunk=16)
    got = tppo.evaluate(tm, port_params(lap_params), make_generator(0, "cpu"), num_envs=3,
                        max_steps=40, config=tppo.PPOConfig(), chunk=16)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-3, rtol=1e-4)


def test_latent_train_iteration_runs_on_cpu():
    """Two port iterations of the latent slice at a tiny size: finite
    losses, counters advanced, no kernel launched on the CPU path."""
    from carla_ppo_tpu_torch.envs import track as ttrack
    from carla_ppo_tpu_torch.envs.types import EnvParams as TParams

    g = make_generator(0, "cpu")
    tp = TParams(track=ttrack.make_lap_track(seed=0, props=True, device="cpu"))
    tvae = VAE(source_shape=(80, 160, 1), generator=g).eval()
    lat = tppo.LatentObs(vae_model=tvae)
    config = tppo.PPOConfig(num_envs=4, horizon=4, num_epochs=1, num_minibatches=2)
    ts = tppo.create_train_state(ActorCritic(lat.obs_dim, generator=g), config, g)
    envs = tppo.init_env_batch(tp, 4, g)
    before = dict(TRC.LAUNCHES)
    for _ in range(2):
        ts, envs, met = tppo.train_iteration(ts, envs, tp, config, latent_obs=lat)
        assert np.isfinite(met["train_loss/loss"].item())
    assert (ts.iteration, ts.train_step, ts.total_env_steps) == (2, 4, 32.0)
    assert TRC.LAUNCHES == before
    ev = tppo.evaluate(ts.model, tp, g, num_envs=2, max_steps=6, config=config, latent_obs=lat, chunk=3)
    assert np.isfinite(ev["eval/reward"].item())
