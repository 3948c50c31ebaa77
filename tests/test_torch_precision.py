"""The port's compute dtypes against the JAX package's: ActorCritic(dtype=)
and ConvVAE(dtype=), and the "mixed" recipe's bfloat16 behaviour policy.

Tolerances, stated before measuring. bfloat16 keeps 8 mantissa bits, and
flax rounds after each product and again after each bias add while a
matmul may accumulate in another order, so the two packages' bfloat16
paths agree only to a few bfloat16 ulps: action mean and value within 2e-2
absolute on unit-scale inputs, the latent z within 3e-2 absolute, the
behaviour policy's log-prob within 5e-2 (a sum of two squared z-scores).
float32 stays tight: within 1e-5 relative.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.models import vae_common as j_vae_common
from carla_ppo_tpu.models.policy import ActorCritic as JActorCritic
from carla_ppo_tpu_torch.models import vae_common
from carla_ppo_tpu_torch.models.policy import ActorCritic
from carla_ppo_tpu_torch.training import ppo
from carla_ppo_tpu_torch.utils import convert
from carla_ppo_tpu_torch.utils.device import make_generator
from tests.test_torch_common import REPO, np_tree

DEPROP = "from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data"
OBS_DIM = 67


def _models(jdtype, tdtype, seed=0):
    """A JAX ActorCritic with `jdtype` and the port's with `tdtype`, on the
    same float32 parameters (random init, widths of the shipped agents)."""
    jm = JActorCritic(dtype=jdtype)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS_DIM), jnp.float32))
    tm = ActorCritic(OBS_DIM, compute_dtype=tdtype)
    tm.load_state_dict(convert.actor_critic_state_dict(np_tree(params)), strict=False)
    return jm, params, tm


def _obs(n=64, seed=1):
    return np.random.default_rng(seed).standard_normal((n, OBS_DIM)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_policy_compute_dtype_matches(dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jm, params, tm = _models(jdt, tdt)
    obs = _obs()
    j_mean, j_std, j_value = (np.asarray(x) for x in jm.apply(params, jnp.asarray(obs)))
    with torch.no_grad():
        mean, std, value = tm(torch.from_numpy(obs))
    assert mean.dtype == std.dtype == value.dtype == torch.float32
    if dtype == "float32":
        for got, want in ((mean, j_mean), (std, j_std), (value, j_value)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(mean.numpy(), j_mean, atol=2e-2)
        np.testing.assert_allclose(value.numpy(), j_value, atol=2e-2)
        np.testing.assert_array_equal(std.numpy(), j_std)  # float32 parameter either way
        # bfloat16 is not float32: the comparison above is not vacuous
        f32 = ActorCritic(OBS_DIM)
        f32.load_state_dict(tm.state_dict())
        with torch.no_grad():
            assert not torch.equal(f32(torch.from_numpy(obs))[2], value)


def test_vae_bfloat16_encode_matches():
    """The shipped de-prop VAE (converted) encoding frames of random classes
    in bfloat16, against the JAX ConvVAE(dtype=bfloat16) on the orbax
    weights."""
    jvae, jvars = j_vae_common.load_vae(str(REPO / "vae" / "models" / DEPROP), dtype=jnp.bfloat16)
    vae = vae_common.load_vae(str(REPO / "models" / "torch" / "vae_models" / DEPROP),
                              dtype=torch.bfloat16, device="cpu")
    cls = np.random.default_rng(2).integers(0, 13, size=(4, 80, 160, 1))
    frames = (cls / 12.0).astype(np.float32)
    j_z = np.asarray(jvae.apply(jvars, jnp.asarray(frames), method=jvae.encode))
    with torch.no_grad():
        z = vae.encode(torch.from_numpy(frames))
    assert z.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), j_z, atol=3e-2)


def test_mixed_behaviour_policy_step_matches():
    """One rollout step of the "mixed" behaviour policy: the JAX package's
    ActorCritic(dtype=bfloat16).sample on the float32 params, against the
    port's with_compute_dtype(bfloat16) twin fed the same normal draw."""
    jm, params, tm = _models(jnp.float32, torch.float32)
    j_twin = JActorCritic(dtype=jnp.bfloat16)
    obs = _obs(32, seed=3)
    key = jax.random.PRNGKey(5)
    j_action, j_logp, j_value = (np.asarray(x) for x in j_twin.sample(params, jnp.asarray(obs), key))
    noise = np.array(jax.random.normal(key, (obs.shape[0], 2)))
    twin = tm.with_compute_dtype(torch.bfloat16)
    with torch.no_grad():
        action, logp, value = twin.sample(torch.from_numpy(obs), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(action.numpy(), j_action, atol=2e-2)
    np.testing.assert_allclose(value.numpy(), j_value, atol=2e-2)
    np.testing.assert_allclose(logp.numpy(), j_logp, atol=5e-2)
    # the twin shares the update model's tensors
    assert twin.pi.dense[0].weight is tm.pi.dense[0].weight
    assert tm.compute_dtype == torch.float32


def test_mixed_train_iteration_stores_behaviour_log_probs(monkeypatch):
    """train_iteration(rollout_model=twin) acts and stores log-probs with
    the bfloat16 twin and updates the float32 model (tiny lap run)."""
    from carla_ppo_tpu_torch.envs import track
    from carla_ppo_tpu_torch.envs.observations import vector_obs_dim
    from carla_ppo_tpu_torch.envs.types import EnvParams
    from carla_ppo_tpu_torch.models.policy import gaussian_log_prob

    params = EnvParams(track=track.make_lap_track(seed=0, device="cpu"))
    config = ppo.PPOConfig(horizon=4, num_envs=4, num_minibatches=2, num_epochs=1)
    model = ActorCritic(vector_obs_dim(), generator=make_generator(0, "cpu"))
    ts = ppo.create_train_state(model, config, make_generator(1, "cpu"))
    envs = ppo.init_env_batch(params, 4, ts.generator)
    twin = model.with_compute_dtype(torch.bfloat16)
    seen = {}
    real_rollout = ppo.rollout

    def spy(m, *args, **kwargs):
        out = real_rollout(m, *args, **kwargs)
        seen["model"], seen["traj"] = m, out[1]
        return out

    before = model.pi.dense[0].weight.clone()
    f32_ref = copy.deepcopy(model)  # the parameters the rollout acted with
    bf16_ref = f32_ref.with_compute_dtype(torch.bfloat16)
    monkeypatch.setattr(ppo, "rollout", spy)
    ts, envs, metrics = ppo.train_iteration(ts, envs, params, config, rollout_model=twin)
    assert seen["model"] is twin and ts.model is model
    traj = seen["traj"]
    with torch.no_grad():
        mean, std, _ = bf16_ref(traj.obs[0])
        f32_mean, _, _ = f32_ref(traj.obs[0])
    torch.testing.assert_close(traj.log_probs[0], gaussian_log_prob(traj.actions[0], mean, std))
    assert not torch.equal(traj.log_probs[0], gaussian_log_prob(traj.actions[0], f32_mean, std))
    assert not torch.equal(model.pi.dense[0].weight, before)
    assert np.isfinite(float(metrics["train_loss/loss"]))
