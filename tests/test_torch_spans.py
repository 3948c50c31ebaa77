"""The program's spans in the latent and pixel PPO iterations, at a tiny
size on the CPU: each layer's span fires once per call of the function
that does the work, under its parent, and the real iteration entries take
the draws (`noise`, `perms`, `noises`) that their parts take, giving the
same result bit for bit.
"""

from __future__ import annotations

import copy
from collections import Counter

import pytest
import torch

from carla_ppo_tpu_torch.envs import track as ttrack
from carla_ppo_tpu_torch.envs.types import EnvParams
from carla_ppo_tpu_torch.models.pixel_policy import PixelActorCritic
from carla_ppo_tpu_torch.models.policy import ActorCritic
from carla_ppo_tpu_torch.models.vae import VAE
from carla_ppo_tpu_torch.training import pixels, ppo
from carla_ppo_tpu_torch.utils import profiling
from carla_ppo_tpu_torch.utils.device import make_generator

B, T, EPOCHS, MINIBATCHES = 4, 3, 2, 2
CAMERA = ("camera.prep_windows", "camera.ground_pass", "camera.prep_candidates", "camera.composite")


@pytest.fixture(scope="module")
def lap_params():
    return EnvParams(track=ttrack.make_lap_track(seed=0, props=True, device="cpu"))


def latent_setup(lap_params, seed=0):
    g = make_generator(seed, "cpu")
    torch.manual_seed(seed)
    latent = ppo.LatentObs(vae_model=VAE(source_shape=(80, 160, 1), z_dim=64).eval())
    config = ppo.PPOConfig(num_envs=B, horizon=T, num_epochs=EPOCHS, num_minibatches=MINIBATCHES)
    ts = ppo.create_train_state(ActorCritic(latent.obs_dim, generator=g), config, g)
    return ts, ppo.init_env_batch(lap_params, B, g), config, latent


def pixel_setup(lap_params, seed=0):
    g = make_generator(seed, "cpu")
    config = ppo.PPOConfig(num_envs=B, horizon=T, num_epochs=EPOCHS, num_minibatches=MINIBATCHES)
    ts = pixels.create_pixel_train_state(PixelActorCritic(generator=g), config, g)
    return ts, ppo.init_env_batch(lap_params, B, g), config, pixels.PixelConfig(deprop_aux=True)


def clone_state(ts, envs):
    """An independent copy of a train state (its model, moments and
    generators) and of an env batch."""
    twin = copy.deepcopy(ts)
    twin.generator = torch.Generator().set_state(ts.generator.get_state())
    return twin, copy.deepcopy(envs)


def draws(config, seed=1, z_dim=None):
    g = torch.Generator().manual_seed(seed)
    out = {"noise": torch.randn((config.horizon, config.num_envs, 2), generator=g),
           "perms": [torch.randperm(config.num_envs, generator=g) for _ in range(config.num_epochs)]}
    if z_dim is not None:
        rows = config.horizon * config.num_envs // config.num_minibatches
        out["noises"] = [torch.randn((rows, z_dim), generator=g) for _ in range(config.updates_per_iteration)]
    return out


def parents(rec):
    """Each record's name with its parent's name (None at the top)."""
    return Counter((r.name, rec.records[r.parent].name if r.parent >= 0 else None) for r in rec.records)


def test_latent_iteration_emits_each_layer_span(lap_params):
    ts, envs, config, latent = latent_setup(lap_params)
    with profiling.recording() as rec:
        ppo.train_iteration(ts, envs, lap_params, config, latent_obs=latent)
    updates = EPOCHS * MINIBATCHES
    assert parents(rec) == Counter({
        ("rollout", None): 1, ("policy.sample", "rollout"): T, ("env_step", "rollout"): T,
        ("vae.encode", "rollout"): T + 1, **{(c, "rollout"): T + 1 for c in CAMERA},
        ("update", None): 1, ("update.gae", "update"): 1, ("update.loss", "update"): updates,
        ("update.backward", "update"): updates, ("update.adam", "update"): updates})
    totals = rec.totals_by_name()
    assert 0 < totals["rollout"].host_self_ms < totals["rollout"].host_ms
    assert all(r.end_s >= r.start_s for r in rec.records)


def test_pixel_iteration_emits_each_layer_span(lap_params):
    ts, envs, config, pix = pixel_setup(lap_params)
    with profiling.recording() as rec:
        pixels.pixel_train_iteration(ts, envs, lap_params, config, pix)
    updates = EPOCHS * MINIBATCHES
    assert parents(rec) == Counter({
        ("rollout", None): 1, ("policy.sample", "rollout"): T, ("env_step", "rollout"): T,
        **{(c, "rollout"): T + 1 for c in CAMERA},
        ("update", None): 1, ("update.gae", "update"): 1, ("update.loss", "update"): updates,
        ("update.backward", "update"): updates, ("update.adam", "update"): updates})


def test_latent_train_iteration_takes_perms_bit_for_bit(lap_params):
    """train_iteration(perms=) equals rollout + update_from_rollout(perms=)
    from the same state: the same parameters, moments, metrics and envs."""
    ts, envs, config, latent = latent_setup(lap_params)
    ts2, envs2 = clone_state(ts, envs)
    perms = draws(config)["perms"]
    _, envs, metrics = ppo.train_iteration(ts, envs, lap_params, config, latent_obs=latent, perms=perms)
    envs2, traj, boot, episodic = ppo.rollout(ts2.model, envs2, lap_params, ts2.generator, config.horizon,
                                              config, latent_obs=latent)
    envs2, metrics2 = ppo.update_from_rollout(ts2, envs2, traj, boot, episodic, config, perms=perms)
    for (name, p), q in zip(ts.model.named_parameters(), ts2.model.parameters()):
        assert torch.equal(p, q), name
    for a, b in zip(ts.opt_state.mu + ts.opt_state.nu, ts2.opt_state.mu + ts2.opt_state.nu):
        assert torch.equal(a, b)
    assert metrics.keys() == metrics2.keys()
    for k in metrics:
        assert torch.equal(metrics[k], metrics2[k]), k
    assert torch.equal(envs.vehicle.pos, envs2.vehicle.pos)
    assert ts.iteration == ts2.iteration == 1


def test_rollout_takes_the_action_noise(lap_params):
    """rollout(noise=) acts on the given draws: zero noise acts on the
    clipped action mean, and the generator is left to the resets."""
    ts, envs, config, latent = latent_setup(lap_params)
    noise = torch.zeros((T, B, 2))
    _, traj, _, _ = ppo.rollout(ts.model, envs, lap_params, ts.generator, T, config,
                                latent_obs=latent, noise=noise)
    mean = ts.model(traj.obs.reshape(T * B, -1))[0].reshape(T, B, 2)
    low, high = ts.model.action_low, ts.model.action_high
    assert torch.equal(traj.actions, torch.minimum(torch.maximum(mean, low), high))


def test_pixel_train_iteration_takes_the_draws_bit_for_bit(lap_params):
    """pixel_train_iteration(noise=, perms=, noises=) equals pixel_rollout
    + pixel_update + the episodic reduction and counters with the same
    draws."""
    ts, envs, config, pix = pixel_setup(lap_params)
    ts2, envs2 = clone_state(ts, envs)
    d = draws(config, z_dim=ts.model.z_dim)
    _, envs, metrics = pixels.pixel_train_iteration(ts, envs, lap_params, config, pix, **d)
    envs2, traj, boot, episodic = pixels.pixel_rollout(ts2.model, envs2, lap_params, ts2.generator, config,
                                                       pix, noise=d["noise"])
    metrics2 = pixels.pixel_update(ts2, traj, boot, config, pix, perms=d["perms"], noises=d["noises"])
    episodic, env_steps = ppo.reduce_episodic(episodic, traj.rewards.numel(), None)
    ppo.finish_iteration(ts2, metrics2, episodic, config, env_steps)
    for (name, p), q in zip(ts.model.named_parameters(), ts2.model.parameters()):
        assert torch.equal(p, q), name
    assert metrics.keys() == metrics2.keys()
    for k in metrics:
        assert torch.equal(metrics[k], metrics2[k]), k
    assert torch.equal(envs.vehicle.pos, envs2.vehicle.pos)
