"""The port's checkpoints: the converted shipped weights (models/torch/)
against the pinned goldens, and the Checkpointer's contract.

JAX-free, so it also runs where the card is (`--noconftest`). The goldens
are tests/golden/checkpoint_goldens.json, made by the JAX package from the
orbax checkpoints on tests/checkpoint_goldens.py's synthetic inputs, which
are rebuilt here with numpy (the same ramp and linspace).

Tolerances, stated before measuring: agents' mean / std / value within
1e-5 relative (atol 1e-7, for the exact zeros and ones of a saturated
tanh), the pixel agents' too (their frame is the synthetic ramp, their
measurements tests/checkpoint_goldens.py's MEASUREMENTS); the VAEs' z_prefix and z_sum within 1e-4 absolute and 1e-4 relative
(four float32 convolutions and a 6144-wide head, summed in another order).
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from carla_ppo_tpu_torch.models import vae_common
from carla_ppo_tpu_torch.models.pixel_policy import PixelActorCritic
from carla_ppo_tpu_torch.models.policy import ActorCritic
from carla_ppo_tpu_torch.ops.running_stats import RunningMoments
from carla_ppo_tpu_torch.training import ppo
from carla_ppo_tpu_torch.utils.checkpoint import STATE_FILE, Checkpointer
from carla_ppo_tpu_torch.utils.device import make_generator

REPO = pathlib.Path(__file__).resolve().parent.parent
TORCH_MODELS = REPO / "models" / "torch"
GOLDENS = REPO / "tests" / "golden" / "checkpoint_goldens.json"
AGENTS = {  # golden key: converted directory
    "lap_agent": "lap_agent",
    "mixed_agent": "mixed_agent",
    "latent_agent": "latent_agent",
    "route_latent_agent": "route_latent",
    "rgb_latent_agent": "rgb_latent",
    "traffic_agent": "traffic_agent",
}
PIXEL_AGENTS = {"pixel_turnkey_agent": "pixel_turnkey"}  # golden key: converted directory
MEASUREMENTS = (0.1, 0.5, 5.0)  # steer, throttle, speed (tests/checkpoint_goldens.py)
VAES = {
    "seg_vae": "seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_data",
    "deprop_vae": "from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data",
    "rgb_deprop_vae": "seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data",
    "rgb_recon_vae": "rgb_bce_cnn_zdim64_beta1_kl_tolerance0.0_data",
}


def _goldens():
    with open(GOLDENS) as f:
        return json.load(f)


def synthetic_frame(shape) -> np.ndarray:
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.float32).reshape(1, *shape) % 13.0) / 12.0


def synthetic_vector_obs(dim: int) -> np.ndarray:
    return np.linspace(-1.0, 1.0, dim, dtype=np.float32)[None, :]


def load_agent(name: str) -> tuple[int, ActorCritic]:
    ck = Checkpointer(TORCH_MODELS / name / "checkpoints")
    step = ck.latest_step()
    tree = ck.read_tree(step)
    model = ActorCritic(tree["model"]["pi.dense.0.weight"].shape[1])
    model.load_state_dict(tree["model"])
    return step, model


@pytest.mark.parametrize("key", sorted(AGENTS))
def test_converted_agent_matches_golden(key):
    want = _goldens()[key]
    step, model = load_agent(AGENTS[key])
    assert step == want["step"]
    obs = torch.from_numpy(synthetic_vector_obs(model.pi.dense[0].in_features))
    with torch.no_grad():
        mean, std, value = model(obs)
    for got, exp in ((mean[0], want["mean"]), (std, want["std"]), (value[0], want["value"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp, np.float32), rtol=1e-5, atol=1e-7)


def pixel_golden_outputs(model: PixelActorCritic) -> tuple:
    """(mean [A], std [A], value) of a pixel agent on the goldens' inputs."""
    frame = torch.from_numpy(synthetic_frame(model.frame_shape))
    with torch.no_grad():
        mean, std, value = model.policy_value(frame, torch.tensor([MEASUREMENTS]))
    return mean[0].numpy(), std.numpy(), value[0].numpy()


@pytest.mark.parametrize("key", sorted(PIXEL_AGENTS))
def test_converted_pixel_agent_matches_golden(key):
    want = _goldens()[key]
    ck = Checkpointer(TORCH_MODELS / PIXEL_AGENTS[key] / "checkpoints")
    assert ck.latest_step() == want["step"]
    tree = ck.read_tree(want["step"])
    model = PixelActorCritic()
    model.load_state_dict(tree["model"])
    assert sum(p.numel() for p in model.parameters()) == 2_951_842
    for got, exp in zip(pixel_golden_outputs(model), (want["mean"], want["std"], want["value"])):
        np.testing.assert_allclose(got, np.asarray(exp, np.float32), rtol=1e-5, atol=1e-7)
    for group in ("policy", "encoder"):  # the two optimizer groups, each with its own count
        opt = tree["opt_state"][group]
        assert set(opt["mu"]) == set(opt["nu"]) and int(opt["count"]) > 0


@pytest.mark.parametrize("key", sorted(VAES))
def test_converted_vae_matches_golden(key):
    want = _goldens()[key]
    vae = vae_common.load_vae(str(TORCH_MODELS / "vae_models" / VAES[key]), device="cpu")
    assert vae.decoder is not None  # every converted VAE is whole
    with torch.no_grad():
        z = vae.encode(torch.from_numpy(synthetic_frame(vae.source_shape)))
        recon = vae.generate_from_latent(z)
    assert recon.shape == (1, *vae.target_shape) and bool(torch.isfinite(recon).all())
    np.testing.assert_allclose(z[0, :8].numpy(), want["z_prefix"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(z.sum()), want["z_sum"], rtol=1e-4, atol=1e-4)


def test_converted_train_state_restores_with_counters():
    """A converted agent restores onto a Trainer-style template: weights,
    the Adam count and the counters continue; the generator is the
    template's (the JAX key has no torch counterpart)."""
    template = ppo.create_train_state(ActorCritic(67, generator=make_generator(0, "cpu")),
                                      ppo.PPOConfig(), make_generator(0, "cpu"))
    restored = Checkpointer(TORCH_MODELS / "latent_agent" / "checkpoints").restore_latest(template)
    assert restored.iteration == 1450
    assert restored.train_step == 1450 * ppo.PPOConfig().updates_per_iteration
    assert int(restored.opt_state.count) == restored.train_step
    assert restored.total_env_steps == 1450 * 128 * 1024
    assert torch.equal(restored.generator.get_state(), template.generator.get_state())
    names = [n for n, _ in restored.model.named_parameters()]
    for name, m, v, p in zip(names, restored.opt_state.mu, restored.opt_state.nu,
                             restored.model.parameters()):
        assert m.shape == v.shape == p.shape, name
        assert bool((v >= 0).all()), name  # second moments
    assert not torch.equal(restored.model.pi.dense[0].weight, template.model.pi.dense[0].weight)


def _state(seed: int) -> ppo.TrainState:
    model = ActorCritic(7, pi_hidden_sizes=(8,), vf_hidden_sizes=(8,),
                        generator=make_generator(seed, "cpu"))
    ts = ppo.create_train_state(model, ppo.PPOConfig(), make_generator(seed, "cpu"))
    g = make_generator(seed + 100, "cpu")
    ts.opt_state = ppo.AdamState(
        count=torch.tensor(seed, dtype=torch.int32),
        mu=[torch.randn(p.shape, generator=g) for p in model.parameters()],
        nu=[torch.rand(p.shape, generator=g) for p in model.parameters()],
    )
    ts.iteration, ts.train_step, ts.total_env_steps, ts.episodes_done = seed, 12 * seed, 0.5 * seed, 3 * seed
    ts.reward_norm = RunningMoments(*(torch.tensor(v) for v in (0.25 * seed, 2.0, 7.0)))
    torch.randn(5, generator=ts.generator)  # move the stream off its seed
    return ts


def test_checkpointer_roundtrip_and_pruning(tmp_path):
    ck = Checkpointer(tmp_path / "ck", max_to_keep=5)
    assert ck.latest_step() is None and ck.restore_latest(_state(0)) is None
    for step in range(1, 8):
        ck.save(step, _state(step))
    assert ck.all_steps() == [3, 4, 5, 6, 7]
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "4", "5", "6", "7"]  # no temp dirs left
    assert all((tmp_path / "ck" / s / STATE_FILE).is_file() for s in ("3", "7"))

    saved = _state(7)
    template = _state(1)
    template_w = template.model.pi.dense[0].weight.clone()
    got = ck.restore_latest(template)
    assert (got.iteration, got.train_step, got.total_env_steps, got.episodes_done) == (7, 84, 3.5, 21)
    assert torch.equal(got.generator.get_state(), saved.generator.get_state())
    assert torch.equal(torch.randn(3, generator=got.generator), torch.randn(3, generator=saved.generator))
    for a, b in zip(got.model.parameters(), saved.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(got.opt_state.mu + got.opt_state.nu, saved.opt_state.mu + saved.opt_state.nu):
        assert torch.equal(a, b)
    assert int(got.opt_state.count) == 7 and got.opt_state.count.dtype == torch.int32
    assert float(got.reward_norm.mean) == 1.75 and float(got.reward_norm.count) == 7.0
    # the template is left as it was
    assert torch.equal(template.model.pi.dense[0].weight, template_w) and template.iteration == 1

    ck.save(5, _state(2))  # a step saved again replaces the old one
    assert ck.restore(5, template).iteration == 2


def test_tree_restore_checks_shapes(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(0, {"w": torch.zeros(3), "n": 4})
    got = ck.restore(0, {"w": torch.ones(3, dtype=torch.float64), "n": 0})
    assert got["n"] == 4 and torch.equal(got["w"], torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError):
        ck.restore(0, {"w": torch.ones(4), "n": 0})
    with pytest.raises(KeyError):
        ck.restore(0, {"w": torch.ones(3), "m": 0})


def test_load_vae_never_falls_back(tmp_path):
    """No checkpoint, no VAE: a missing or empty directory raises and is
    not created."""
    missing = tmp_path / "seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_data"
    with pytest.raises(FileNotFoundError):
        vae_common.load_vae(str(missing), device="cpu")
    assert not missing.exists()
    (missing / "checkpoints").mkdir(parents=True)
    with pytest.raises(FileNotFoundError):
        vae_common.load_vae(str(missing), device="cpu")


def test_parse_model_dir_names():
    assert vae_common.parse_model_dir(VAES["deprop_vae"]) == (64, "cnn", 1, 1)
    assert vae_common.parse_model_dir(VAES["seg_vae"]) == (64, "cnn", 1, 3)
    assert vae_common.parse_model_dir("from_seg_bce_mlp_zdim32_beta1_kl_tolerance0.0_data") == (
        32, "mlp", 3, 1)
    assert vae_common.model_dir_name("seg", "bce", "cnn", 64, 1.0, 0.0, source_depth=1) == VAES[
        "deprop_vae"].replace("_deprop", "")
    mlp = vae_common.build_vae(32, "mlp", 1, source_shape=(80, 160, 3))
    assert (mlp.model_type, mlp.source_shape, mlp.target_shape) == ("mlp", (80, 160, 3), (80, 160, 1))
    assert mlp.decode(torch.zeros(2, 32)).shape == (2, 80 * 160)


@pytest.mark.gpu
def test_checkpoint_generator_roundtrip_on_card(tmp_path):
    """A CUDA generator's state (a CPU ByteTensor) restores onto a CUDA
    generator; the weights land on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = ActorCritic(7, generator=make_generator(0, "cpu")).cuda()
    ts = ppo.create_train_state(model, ppo.PPOConfig(), make_generator(3, "cuda"))
    torch.randn(4, generator=ts.generator, device="cuda")
    ck = Checkpointer(tmp_path)
    ck.save(1, ts)
    got = ck.restore_latest(ts)
    assert got.generator.device.type == "cuda" and got.model.pi.dense[0].weight.is_cuda
    assert torch.equal(torch.randn(4, generator=got.generator, device="cuda"),
                       torch.randn(4, generator=ts.generator, device="cuda"))
