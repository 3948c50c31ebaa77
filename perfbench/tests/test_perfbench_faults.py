"""The rest of a run, with the look for a card skipped, at a tiny size on
the CPU: a sound program passes the deterministic numbers, and each fault
a cell can have, planted in the program underneath, makes `correct` false
through the number meant to catch it."""

import time

import pytest
import torch

from perfbench.harness.main import run_cell
from perfbench.harness.manifest import Cell
from perfbench.harness.spans import wrapped

LATENT = {"config": {"ppo": {"num_envs": 32, "horizon": 32, "num_minibatches": 2}}}
PIXEL = {"config": {"ppo": {"num_envs": 8, "horizon": 4, "num_minibatches": 1}}}


def run(cell, overrides, faults=None, seed=3_100_000_007):
    code, result = run_cell(cell, seed, 0.0, False, time.perf_counter(), device="cpu",
                            overrides=overrides, faults=faults)
    assert code == 0
    return result


def state_unchanged():
    """Every optimizer step returns the parameters and its state unchanged."""
    from carla_ppo_tpu_torch.training import ppo

    return wrapped([(ppo, "clip_and_adam", lambda real: lambda params, grads, state, *a, **k: (list(params), state))])


def half_batch(module, attr):
    """The loss of each minibatch taken over its first half only."""
    def factory(real):
        def loss(model, batch, *args, **kwargs):
            n = batch["actions"].shape[0] // 2
            batch = {k: (v[:n] if isinstance(v, torch.Tensor) else v) for k, v in batch.items()}
            args = tuple(a[:n] if isinstance(a, torch.Tensor) and a.ndim == 2 else a for a in args)
            return real(model, batch, *args, **kwargs)
        return loss
    return wrapped([(module, attr, factory)])


def latent_noise_halved():
    """The rollout's sampled actions drawn with half the noise."""
    from carla_ppo_tpu_torch.models.policy import ActorCritic

    def factory(real):
        def sample(self, obs, generator=None, greedy=False, noise=None):
            if noise is None and not greedy:
                noise = 0.5 * torch.randn((obs.shape[0], self.num_actions), generator=generator, device=obs.device)
            return real(self, obs, generator, greedy, noise)
        return sample
    return wrapped([(ActorCritic, "sample", factory)])


def pixel_noise_halved():
    from carla_ppo_tpu_torch.models.pixel_policy import PixelActorCritic

    def factory(real):
        def act(self, frames, meas, generator=None, greedy=False, noise=None):
            return real(self, frames, meas, generator, greedy, None if noise is None else 0.5 * noise)
        return act
    return wrapped([(PixelActorCritic, "act", factory)])


@pytest.mark.parametrize("cell,overrides,deterministic", [
    ("lap_latent_seg.train", LATENT, ("loss_gap", "grad_gap", "change_gap")),
    ("pixels_joint.train", PIXEL, ("first_grad_gap", "change_gap", "action_gap")),
])
def test_sound_program_passes_the_deterministic_numbers(cell, overrides, deterministic):
    checks = run(cell, overrides)["checks"]
    for name in deterministic:
        assert checks[name]["value"] <= checks[name]["limit"], (name, checks[name])


def _half_latent():
    from carla_ppo_tpu_torch.training import ppo
    return half_batch(ppo, "ppo_loss")


def _half_pixel():
    from carla_ppo_tpu_torch.training import pixels
    return half_batch(pixels, "pixel_loss")


@pytest.mark.parametrize("cell,overrides,fault,catches", [
    ("lap_latent_seg.train", LATENT, state_unchanged, "change_gap"),
    ("lap_latent_seg.train", LATENT, _half_latent, "loss_gap"),
    ("lap_latent_seg.train", LATENT, latent_noise_halved, "sample_gap"),
    ("pixels_joint.train", PIXEL, state_unchanged, "change_gap"),
    ("pixels_joint.train", PIXEL, _half_pixel, "first_grad_gap"),
    ("pixels_joint.train", PIXEL, pixel_noise_halved, "action_gap"),
], ids=["latent-state-unchanged", "latent-half-batch", "latent-action-altered", "pixel-state-unchanged",
        "pixel-half-batch", "pixel-action-altered"])
def test_fault_makes_correct_false(cell, overrides, fault, catches):
    result = run(cell, overrides, faults=fault())
    assert result["correct"] is False
    c = result["checks"][catches]
    assert c["value"] > c["limit"], (catches, c)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["lap_latent_seg.train", "pixels_joint.train"])
def test_control_is_not_correct_on_the_card(card, cell):
    """The reference in TF32, in the program's place, fails one of the
    cell's numbers (at a size a test run holds; perfbench/calibrate.py
    reads it at the cell's own size)."""
    from perfbench.harness.main import Context
    from perfbench.harness.spans import NoSpans

    c = Cell(cell)
    small = {"lap_latent_seg.train": {"config": {"ppo": {"num_envs": 256, "horizon": 32}}},
             "pixels_joint.train": {"config": {"ppo": {"num_envs": 128, "horizon": 16}}}}[cell]
    from perfbench.harness.main import deep_update
    ctx = Context(3_200_000_011, card, deep_update(c.config, small["config"]), c.traffic, NoSpans())
    readings = c.driver.stand_in_readings(ctx, "control")
    assert any(v > c.limits[k] for k, v in readings.items()), readings
