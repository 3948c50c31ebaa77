"""The port's models (carla_ppo_tpu_torch/models) against the JAX package's,
on weights carried across by carla_ppo_tpu_torch/utils/convert.py.

Tolerances: VAE latent z within 1e-4 (four float32 convolutions and a
6144-wide dense head, summed in another order); ActorCritic mean, std, value
and log-prob within 1e-5 (three float32 dense layers of width <= 500).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from carla_ppo_tpu.models.policy import ActorCritic as JActorCritic
from carla_ppo_tpu.models.policy import gaussian_log_prob as j_log_prob
from carla_ppo_tpu.models.vae import ConvVAE as JConvVAE
from carla_ppo_tpu_torch.models.policy import ActorCritic, gaussian_entropy, gaussian_log_prob
from carla_ppo_tpu_torch.models.vae import VAE, encoded_conv_shape
from carla_ppo_tpu_torch.models.vae_common import preprocess_frame
from carla_ppo_tpu_torch.utils import convert
from carla_ppo_tpu_torch.utils.device import make_generator
from tests.test_torch_common import np_tree


def _frames(depth, n=4, seed=0):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 13, size=(n, 80, 160, 1))
    return np.repeat(cls / 12.0, depth, axis=3).astype(np.float32)


def _ported_vae(jvars, depth):
    model = VAE(source_shape=(80, 160, depth), z_dim=64)
    sd = convert.vae_encoder_state_dict(np_tree(jvars), encoded_conv_shape((80, 160, depth)))
    model.load_state_dict(sd)
    return model.eval()


def test_vae_encode_matches():
    for depth in (1, 3):
        jm = JConvVAE(source_shape=(80, 160, depth), target_shape=(80, 160, 1), z_dim=64)
        x = _frames(depth)
        jvars = jm.init(jax.random.PRNGKey(depth), jnp.zeros((1, 80, 160, depth)),
                        jax.random.PRNGKey(1), True)
        want = np.asarray(jm.apply(jvars, jnp.asarray(x), method=jm.encode))
        with torch.no_grad():
            got = _ported_vae(jvars, depth).encode(torch.as_tensor(x)).numpy()
        assert got.shape == (4, 64)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_vae_encoded_shape():
    assert encoded_conv_shape((80, 160, 1)) == (3, 8, 256)


def _jax_policy(obs_dim, seed=0):
    jm = JActorCritic()
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)))
    tm = ActorCritic(obs_dim)
    missing, unexpected = tm.load_state_dict(convert.actor_critic_state_dict(np_tree(params)), strict=False)
    assert set(missing) == {"action_low", "action_high"} and not unexpected
    return jm, params, tm


def test_actor_critic_matches():
    obs_dim = 67
    jm, params, tm = _jax_policy(obs_dim)
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(16, obs_dim)).astype(np.float32)
    acts = np.clip(rng.normal(0.3, 0.5, size=(16, 2)), [-1, 0], [1, 1]).astype(np.float32)
    j_mean, j_std, j_val = (np.asarray(v) for v in jm.apply(params, jnp.asarray(obs)))
    with torch.no_grad():
        mean, std, val = tm(torch.as_tensor(obs))
        logp = gaussian_log_prob(torch.as_tensor(acts), mean, std)
    np.testing.assert_allclose(mean.numpy(), j_mean, atol=1e-5, rtol=0)
    np.testing.assert_allclose(std.numpy(), j_std, atol=1e-5, rtol=0)
    np.testing.assert_allclose(val.numpy(), j_val, atol=1e-5, rtol=0)
    want_logp = np.asarray(j_log_prob(jnp.asarray(acts), jnp.asarray(j_mean), jnp.asarray(j_std)))
    np.testing.assert_allclose(logp.numpy(), want_logp, atol=1e-5, rtol=0)
    # sample(): injected noise, clipped action, log-prob on the clipped action.
    noise = rng.normal(size=(16, 2)).astype(np.float32)
    with torch.no_grad():
        a, lp, v = tm.sample(torch.as_tensor(obs), noise=torch.as_tensor(noise))
    want_a = np.clip(j_mean + j_std * noise, [-1.0, 0.0], [1.0, 1.0])
    np.testing.assert_allclose(a.numpy(), want_a, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        lp.numpy(), np.asarray(j_log_prob(jnp.asarray(want_a), j_mean, j_std)), atol=1e-5, rtol=0
    )
    greedy, _, _ = tm.sample(torch.as_tensor(obs), greedy=True)
    np.testing.assert_allclose(greedy.detach().numpy(), j_mean, atol=1e-5, rtol=0)


def test_init_follows_flax_defaults():
    """lecun-normal kernels (truncated, std sqrt(1/fan_in)), zero biases,
    the mean head at variance scale 0.1, logstd = log(initial_std)."""
    tm = ActorCritic(67, generator=make_generator(0, "cpu"))
    w = tm.pi.dense[0].weight.detach()
    assert abs(float(w.std()) - (1.0 / 67) ** 0.5) < 0.01
    assert float(w.abs().max()) <= 2.0 * (1.0 / 67) ** 0.5 / 0.87962566103423978 + 1e-6
    assert float(tm.pi.dense[0].bias.detach().abs().max()) == 0.0
    assert abs(float(tm.action_mean.weight.detach().std()) - (0.1 / 300) ** 0.5) < 0.005
    np.testing.assert_allclose(tm.action_logstd.detach().numpy(), 0.0)
    np.testing.assert_allclose(gaussian_entropy(torch.ones(2)).item(), np.log(2 * np.pi) + 1.0, rtol=1e-6)
    # Same seed, same weights.
    tm2 = ActorCritic(67, generator=make_generator(0, "cpu"))
    assert torch.equal(tm.vf.dense[1].weight, tm2.vf.dense[1].weight)


def test_preprocess_frame():
    u8 = torch.tensor([[0, 255]], dtype=torch.uint8)
    np.testing.assert_allclose(preprocess_frame(u8).numpy(), [[0.0, 1.0]])
    f = torch.tensor([0.5], dtype=torch.float64)
    assert preprocess_frame(f).dtype == torch.float32
