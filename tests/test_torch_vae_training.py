"""The port's VAE (carla_ppo_tpu_torch/models/vae.py), its conversion
(utils/convert.vae_state_dict) and its trainer (training/vae_trainer.py)
against the JAX package's.

Tolerances:
- decoder logits, reconstructions and latent heads from converted
  flax-initialised params within 1e-5 absolute (float32 convolutions and
  dense layers summed in another order; the logits are ~1e-2 in size);
- the losses within 1e-4 relative (sums over 12,800 pixels);
- one training epoch (3 Adam steps of lr 1e-4 from the same params, the same
  batches and the same injected sampling noise): at least 99.99% of each
  tensor's elements within 2e-6 absolute of the JAX run_epoch's, and every
  element within 6e-4 (two steps' worth of lr for each of the 3 steps).
  Adam's m / sqrt(v) scales every gradient element to ~lr, so an element
  whose gradient is ~0 and rounds to the other sign in one package moves
  ~lr the other way; a few elements in a million do. The epoch's mean
  metrics within 1e-4 relative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.models import vae as jvae
from carla_ppo_tpu.training import vae_trainer as jtrainer
from carla_ppo_tpu.utils import datasets as jdatasets
from carla_ppo_tpu_torch.models import vae as tvae
from carla_ppo_tpu_torch.training import vae_trainer as ttrainer
from carla_ppo_tpu_torch.utils import convert
from carla_ppo_tpu_torch.utils import datasets as tdatasets
from tests.test_torch_common import np_tree

# (model_type, source depth, target depth)
VARIANTS = [("cnn", 3, 1), ("cnn", 3, 3), ("mlp", 3, 1)]


def _pair(model_type, src, tgt, seed=0):
    """(flax VAE, its initialised variables, the port's VAE with them)."""
    shape = (80, 160, src)
    jm = jvae.VAE(source_shape=shape, target_shape=(80, 160, tgt), z_dim=64, model_type=model_type)
    jv = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, *shape)), jax.random.PRNGKey(1), True)
    tm = tvae.VAE(source_shape=shape, target_shape=(80, 160, tgt), z_dim=64, model_type=model_type)
    tm.load_state_dict(convert.vae_state_dict(np_tree(jv), shape, model_type))
    return jm, jv, tm


def _frames(n, depth, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, 80, 160, depth)).astype(np.float32)


@pytest.mark.parametrize("model_type, src, tgt", VARIANTS)
def test_decoder_matches_flax(model_type, src, tgt):
    jm, jv, tm = _pair(model_type, src, tgt)
    x = _frames(3, src)
    j_logits, j_mean, j_ls = jm.apply(jv, jnp.asarray(x), None, False)
    z = np.random.default_rng(1).normal(size=(3, 64)).astype(np.float32)
    with torch.no_grad():
        logits, mean, logstd_sq = tm(torch.from_numpy(x), training=False)
        recon = tm.reconstruct(torch.from_numpy(x))
        gen = tm.generate_from_latent(torch.from_numpy(z))
    assert logits.shape == (3, 80 * 160 * tgt)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), rtol=0, atol=1e-5)
    np.testing.assert_allclose(logstd_sq.numpy(), np.asarray(j_ls), rtol=0, atol=1e-5)
    np.testing.assert_allclose(recon.numpy(), np.asarray(jm.apply(jv, jnp.asarray(x), method=jm.reconstruct)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(gen.numpy(), np.asarray(jm.apply(jv, jnp.asarray(z),
                                                                method=jm.generate_from_latent)),
                               rtol=0, atol=1e-5)
    assert recon.shape == (3, 80, 160, tgt)


def test_conversion_without_the_flip_fails(monkeypatch):
    """flax ConvTranspose applies its kernel unflipped; torch's transposed
    convolution flips it. A conversion that only permutes the axes gives
    logits far outside the parity tolerance."""
    jm, jv, _ = _pair("cnn", 3, 1)
    monkeypatch.setattr(convert, "conv_transpose_to_torch",
                        lambda k: convert._t(np.transpose(np.asarray(k), (2, 3, 0, 1))))
    tm = tvae.VAE(source_shape=(80, 160, 3), target_shape=(80, 160, 1), z_dim=64)
    tm.load_state_dict(convert.vae_state_dict(np_tree(jv), (80, 160, 3), "cnn"))
    x = _frames(2, 3)
    with torch.no_grad():
        logits, _, _ = tm(torch.from_numpy(x), training=False)
    want = np.asarray(jm.apply(jv, jnp.asarray(x), None, False)[0])
    assert np.abs(logits.numpy() - want).max() > 100 * 1e-5


@pytest.mark.parametrize("loss_type", ["bce", "bce_v2", "mse"])
@pytest.mark.parametrize("kl_tolerance", [0.0, 0.5])
def test_losses_match(loss_type, kl_tolerance):
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, size=(5, 12800)).astype(np.float32)
    targets = rng.uniform(size=(5, 80, 160, 1)).astype(np.float32)
    mean = rng.normal(size=(5, 64)).astype(np.float32) * 0.1
    logstd = rng.normal(size=(5, 64)).astype(np.float32) * 0.1
    j_loss, j_m = jvae.vae_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mean),
                                jnp.asarray(logstd), 1.5, kl_tolerance, 64, loss_type)
    t_loss, t_m = tvae.vae_loss(*(torch.from_numpy(a) for a in (logits, targets, mean, logstd)),
                                1.5, kl_tolerance, 64, loss_type)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4)
    for k in ("reconstruction_loss", "kl_loss", "loss"):
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-4, err_msg=k)
    if kl_tolerance > 0:  # the floor binds: these small latents have KL < 0.5 * 64
        assert float(t_m["kl_loss"]) == pytest.approx(kl_tolerance * 64)


@pytest.mark.parametrize("model_type", ["cnn", "mlp"])
def test_one_epoch_matches_jax(model_type):
    """run_epoch: the same batches (a numpy permutation) and the same
    sampling noise (the JAX run_epoch's per-batch draws, injected)."""
    jm, jv, tm = _pair(model_type, 3, 1, seed=3)
    config = jtrainer.VAETrainConfig(batch_size=4, model_type=model_type)
    tconfig = ttrainer.VAETrainConfig(batch_size=4, model_type=model_type)
    src = _frames(12, 3, seed=4)
    tgt = np.round(_frames(12, 1, seed=5) * 12) / 12
    perm = jtrainer._make_perm(12, 4, np.random.default_rng(0))
    rng = jax.random.PRNGKey(9)
    import optax

    j_vars, _, j_metrics = jtrainer.run_epoch(
        jv, optax.adam(config.learning_rate).init(jv), jnp.asarray(src), jnp.asarray(tgt),
        jnp.asarray(perm), rng, jm, config, True)
    keys = jax.random.split(rng, perm.shape[0])
    noise = np.stack([np.asarray(jax.random.normal(k, (4, 64))) for k in keys])
    opt = ttrainer.make_optimizer(tm, tconfig)
    t_metrics = ttrainer.run_epoch(tm, opt, torch.from_numpy(src), torch.from_numpy(tgt), perm,
                                   tconfig, noise=torch.from_numpy(noise), train=True)
    want = convert.vae_state_dict(np_tree(j_vars), (80, 160, 3), model_type)
    got = tm.state_dict()
    moved = 0
    for k, w in want.items():
        diff = np.abs(got[k].numpy() - w.numpy())
        assert (diff <= 2e-6).mean() >= 0.9999 and diff.max() <= 6e-4, (k, diff.max())
        moved += int((got[k] != convert.vae_state_dict(np_tree(jv), (80, 160, 3), model_type)[k]).any())
    assert moved == len(want)  # every tensor took the steps
    for k in ("loss", "reconstruction_loss", "kl_loss"):
        np.testing.assert_allclose(t_metrics[k], float(j_metrics[k]), rtol=1e-4, err_msg=k)


def test_early_stopping_matches_jax(monkeypatch):
    """Both trainers, fed one scripted val-loss sequence, stop at the same
    epoch and checkpoint the same best epochs."""
    losses = [5.0, 4.0, 4.5, 3.75, 4.0, 4.25, 4.5, 3.875, 5.0, 6.0]  # exact in float32
    config = dict(batch_size=2, epochs=50, early_stop_patience=4, model_type="mlp", z_dim=4)

    def scripted(runs):
        def fake(*args, **kwargs):
            train = kwargs.get("train", args[-1] if isinstance(args[-1], bool) else True)
            i = len(runs) // 2
            runs.append(train)
            m = {"loss": losses[i], "reconstruction_loss": losses[i], "kl_loss": 0.0}
            return m if len(args) < 9 else (args[0], args[1], {k: jnp.float32(v) for k, v in m.items()})
        return fake

    class Saves:
        def __init__(self):
            self.steps = []

        def save(self, step, _):
            self.steps.append(step)

    data = np.zeros((10, 4, 4, 1), np.float32)
    j_runs, t_runs, j_saves, t_saves = [], [], Saves(), Saves()
    monkeypatch.setattr(jtrainer, "run_epoch", scripted(j_runs))
    monkeypatch.setattr(ttrainer, "run_epoch", scripted(t_runs))
    jm = jtrainer.make_vae(jtrainer.VAETrainConfig(**config), (4, 4, 1))
    _, j_hist = jtrainer.train_vae(jm, data, data, data[:2], data[:2],
                                   jtrainer.VAETrainConfig(**config), checkpointer=j_saves)
    tm = ttrainer.make_vae(ttrainer.VAETrainConfig(**config), (4, 4, 1))
    _, t_hist = ttrainer.train_vae(tm, data, data, data[:2], data[:2],
                                   ttrainer.VAETrainConfig(**config), checkpointer=t_saves)
    assert t_hist == j_hist and len(t_hist["val_loss"]) == 8
    assert t_saves.steps == j_saves.steps == [0, 1, 3]


def test_permutations_and_split_match():
    """The numpy permutations and the train / val split are the JAX
    trainer's, index for index."""
    images = np.arange(37)[:, None].astype(np.float32)
    for seed in (0, 5):
        for a, b in zip(tdatasets.train_val_split(images, seed=seed),
                        jdatasets.train_val_split(images, seed=seed)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttrainer._make_perm(37, 5, np.random.default_rng(1)),
                                  jtrainer._make_perm(37, 5, np.random.default_rng(1)))
