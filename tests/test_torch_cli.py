"""The port's CLIs (carla_ppo_tpu_torch/cli) against the JAX package's.

Flag parity: every flag of carla_ppo_tpu.cli.train, run_eval, train_vae,
collect_data, inspect_vae, inspect_agent and vae_plots exists in the port's
parser with the same destination, default, type (by name, or by what it
makes of the same strings) and choices (train_vae's --models_dir default differs on purpose). An env
batch that does not divide over the data-parallel ranks raises before
anything is written. Then tiny drives on the CPU: train -> resume -> run_eval; traffic and RGB
training; pixel training (warm start, de-prop target) -> run_eval --obs
pixels; collect_data -> train_vae -> load_vae.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pytest
import torch

from carla_ppo_tpu.cli import collect_data as j_collect_data
from carla_ppo_tpu.cli import inspect_agent as j_inspect_agent
from carla_ppo_tpu.cli import inspect_vae as j_inspect_vae
from carla_ppo_tpu.cli import run_eval as j_run_eval
from carla_ppo_tpu.cli import train as j_train
from carla_ppo_tpu.cli import train_vae as j_train_vae
from carla_ppo_tpu.cli import vae_plots as j_vae_plots
from carla_ppo_tpu.utils import datasets as j_datasets
from carla_ppo_tpu_torch.cli import (collect_data, inspect_agent, inspect_vae, run_eval, train,
                                     train_vae, vae_plots)
from carla_ppo_tpu_torch.models import vae_common
from carla_ppo_tpu_torch.training import loop
from carla_ppo_tpu_torch.training import ppo
from tests.test_torch_common import REPO

DEPROP = str(REPO / "models" / "torch" / "vae_models"
             / "from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data")
RGB_DEPROP = str(REPO / "models" / "torch" / "vae_models"
                 / "seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data")
# The port's own flags: the device everywhere, and train's memory policy.
PORT_ONLY = {"train": {"device", "policy"}, "run_eval": {"device", "eval_max_steps"},
             "train_vae": {"device"}, "collect_data": {"device"}, "inspect_vae": {"device"},
             "inspect_agent": {"device"}, "vae_plots": {"device"}}
# Defaults the port changes on purpose: its VAEs go beside its converted
# ones, not among the JAX package's orbax checkpoints in vae/models.
PORT_DEFAULTS = {("train_vae", "models_dir"): "models/torch/vae_models"}
TYPE_PROBES = ("0", "1", "0:3e-4,800:1e-4", "")


def _actions(parser: argparse.ArgumentParser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def _probe(f, text):
    try:
        return f(text)
    except ValueError:
        return ValueError


def _same_type(a, b) -> bool:
    """Same converter: by name, or for lambdas by their results."""
    if a is None or b is None:
        return a is b
    if a.__name__ != "<lambda>":
        return a.__name__ == b.__name__
    return [_probe(a, t) for t in TYPE_PROBES] == [_probe(b, t) for t in TYPE_PROBES]


class _Parsed(Exception):
    pass


def _jax_parser(module, monkeypatch) -> argparse.ArgumentParser:
    """The parser a JAX CLI builds inside main(): caught at parse_args."""
    if hasattr(module, "build_parser"):
        return module.build_parser()
    caught = []

    def catch(self, *args, **kwargs):
        caught.append(self)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed):
            module.main([])
    return caught[0]


@pytest.mark.parametrize("name", ["train", "run_eval", "train_vae", "collect_data", "inspect_vae",
                                  "inspect_agent", "vae_plots"])
def test_flag_parity(name, monkeypatch):
    jax_parser = _jax_parser({"train": j_train, "run_eval": j_run_eval, "train_vae": j_train_vae,
                              "collect_data": j_collect_data, "inspect_vae": j_inspect_vae,
                              "inspect_agent": j_inspect_agent, "vae_plots": j_vae_plots}[name],
                             monkeypatch)
    port_parser = {"train": train, "run_eval": run_eval, "train_vae": train_vae,
                   "collect_data": collect_data, "inspect_vae": inspect_vae,
                   "inspect_agent": inspect_agent, "vae_plots": vae_plots}[name].build_parser()
    want, got = _actions(jax_parser), _actions(port_parser)
    assert set(got) - set(want) == PORT_ONLY[name]
    for dest, a in want.items():
        b = got[dest]
        assert b.option_strings == a.option_strings, dest
        assert b.default == PORT_DEFAULTS.get((name, dest), a.default), dest
        assert _same_type(a.type, b.type), dest
        assert b.choices == a.choices, dest
        assert b.required == a.required, dest
        assert type(b) is type(a), dest
    assert got["device"].default == "cuda"


def test_train_defaults_build_the_jax_configs():
    """Parsed defaults give the JAX CLI's PPOConfig, and the policy dtype
    defaults to "mixed"."""
    args = vars(train.build_parser().parse_args(["--model_name", "x"]))
    assert args["policy_dtype"] == "mixed"
    j_config = j_train.ppo.PPOConfig()
    for f in ppo.PPOConfig.__dataclass_fields__:
        assert getattr(ppo.PPOConfig(), f) == getattr(j_config, f), f
    jax_fields = set(j_train.TrainerSettings.__dataclass_fields__)
    assert set(loop.TrainerSettings.__dataclass_fields__) - {"policy"} == jax_fields
    assert loop.TrainerSettings().policy == args["policy"] == "mlp"  # the port's own setting
    for f in jax_fields:
        assert getattr(loop.TrainerSettings(), f) == getattr(j_train.TrainerSettings(), f), f


@pytest.mark.parametrize("argv, error, match", [
    (["--num_devices", "2", "--num_envs", "1023"], ValueError, "not divisible"),
    (["--num_devices", "3"], ValueError, "not divisible"),
], ids=["argv1-A10", "argv2-A10"])  # argv0-A8 (--obs pixels) and argv3-A12 (--record_eval 1) run
# now: test_pixel_training_and_run_eval_on_cpu, test_torch_video.test_train_record_eval_writes_video
def test_unported_values_raise(argv, error, match, tmp_path, monkeypatch):
    """Values that cannot run raise before anything is written or spawned:
    an env batch that does not divide over the data-parallel ranks, with
    the JAX Trainer's ValueError."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error, match=match):
        train.main(["--model_name", "u", "--device", "cpu"] + argv)
    assert not os.path.exists("models")  # raised before anything was written


def test_run_eval_refusals(tmp_path, monkeypatch):
    """A model without a checkpoint exits before anything is written (videos
    run now: test_torch_video.test_run_eval_cli_writes_video)."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        run_eval.main(["--model_name", "nothing", "--device", "cpu", "--no_video"])
    assert not os.path.exists("models")


def test_train_resume_and_run_eval_on_cpu(tmp_path, monkeypatch, capsys):
    """cli.train (latent obs through the converted de-prop VAE, the default
    "mixed" dtype) for 2 iterations, again to 3 (it resumes), then
    cli.run_eval of the result. Evals are capped at 20 steps here."""
    monkeypatch.chdir(tmp_path)
    def capped(self, params):
        return ppo.evaluate(self.train_state.model, params, self._eval_generator,
                            num_envs=self.settings.eval_envs, max_steps=20, config=self.config,
                            latent_obs=self.latent_obs, chunk=20)

    monkeypatch.setattr(loop.Trainer, "_evaluate_on", capped)
    common = ["--model_name", "c", "--device", "cpu", "--vae_model", DEPROP, "--num_envs", "4",
              "--horizon", "4", "--num_minibatches", "2", "--num_epochs", "1",
              "--eval_interval", "1", "--eval_envs", "2"]
    train.main(common + ["--num_episodes", "2"])
    assert sorted(os.listdir("models/c/checkpoints"))  # a best checkpoint
    assert os.path.isfile("models/c/best_score.json")
    capsys.readouterr()
    train.main(common + ["--num_episodes", "3"])
    out = capsys.readouterr().out
    assert "Iteration 2 (step" in out and "Iteration 0 (step" not in out  # resumed at 2
    metrics = run_eval.main(["--model_name", "c", "--device", "cpu", "--vae_model", DEPROP,
                             "--num_envs", "2", "--no_video", "--checkpoint", "latest"])
    assert metrics["eval/episode_steps"] <= 20 and "eval/termination_reasons/4" in metrics


def _capped_evals(monkeypatch, steps=8):
    def capped(self, params):
        return ppo.evaluate(self.train_state.model, params, self._eval_generator,
                            num_envs=self.settings.eval_envs, max_steps=steps, config=self.config,
                            latent_obs=self.latent_obs, chunk=steps)

    monkeypatch.setattr(loop.Trainer, "_evaluate_on", capped)


@pytest.mark.parametrize("argv", [
    ["--num_npcs", "2", "--obs_fn", "vector_npc", "--reward_fn", "reward_traffic_add",
     "--npc_keep_lat", "-0.5", "--npc_keep_gain", "1.0"],
    ["--vae_source", "rgb", "--vae_model", RGB_DEPROP],
], ids=["traffic", "rgb"])
def test_traffic_and_rgb_training_run_on_cpu(argv, tmp_path, monkeypatch):
    """The settings that raised before this slice (NPC traffic with the
    radar observation, and latents of the RGB camera) train an iteration
    through cli.train; evals capped at 8 steps."""
    monkeypatch.chdir(tmp_path)
    _capped_evals(monkeypatch)
    t = {}
    real_init = loop.Trainer.__init__

    def keep(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        t["trainer"] = self

    monkeypatch.setattr(loop.Trainer, "__init__", keep)
    train.main(["--model_name", "x", "--device", "cpu", "--num_envs", "4", "--horizon", "4",
                "--num_minibatches", "2", "--num_epochs", "1", "--eval_interval", "1",
                "--eval_envs", "2", "--num_episodes", "1"] + argv)
    tr = t["trainer"]
    assert tr.iteration == 1 and os.path.isfile("models/x/best_score.json")
    if "--num_npcs" in argv:
        p = tr.env_params
        assert (p.num_npcs, p.npc_keep_lat, p.npc_keep_gain) == (2, -0.5, 1.0)
        assert p.terminate_on_collision and tr.train_state.model.pi.dense[0].in_features == 24
    else:
        assert tr.latent_obs.source == "rgb" and tr.latent_obs.vae_model.source_shape == (80, 160, 3)


def test_pixel_training_and_run_eval_on_cpu(tmp_path, monkeypatch, capsys):
    """--obs pixels with --vae_scale, --warm_start_vae and --deprop_aux
    reaches the Trainer: one iteration through cli.train (evals capped at 8
    steps), then cli.run_eval --obs pixels of the result."""
    from carla_ppo_tpu_torch.training import pixels

    monkeypatch.chdir(tmp_path)

    def capped(self, params):
        return pixels.evaluate(self.train_state.model, params, self._eval_generator,
                               num_envs=self.settings.eval_envs, max_steps=8, config=self.config,
                               pix=self.pix, chunk=8)

    monkeypatch.setattr(loop.Trainer, "_evaluate_on", capped)
    t = {}
    real_init = loop.Trainer.__init__

    def keep(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        t["trainer"] = self

    monkeypatch.setattr(loop.Trainer, "__init__", keep)
    train.main(["--model_name", "px", "--device", "cpu", "--obs", "pixels", "--deprop_aux", "1",
                "--vae_scale", "2e-4", "--warm_start_vae", DEPROP, "--num_envs", "4", "--horizon",
                "4", "--num_minibatches", "2", "--num_epochs", "1", "--eval_interval", "1",
                "--eval_envs", "2", "--num_episodes", "1"])
    tr = t["trainer"]
    assert tr.iteration == 1 and os.path.isfile("models/px/best_score.json")
    assert (tr.pix.vae_scale, tr.pix.deprop_aux) == (2e-4, True)
    assert "warm-started perception" in capsys.readouterr().out
    metrics = run_eval.main(["--model_name", "px", "--device", "cpu", "--obs", "pixels",
                             "--num_envs", "2", "--no_video", "--checkpoint", "latest"])
    assert t["trainer"].obs_mode == "pixels"
    assert metrics["eval/episode_steps"] <= 8 and np.isfinite(metrics["eval/reward"])


def test_collect_data_then_train_vae_on_cpu(tmp_path, monkeypatch):
    """collect_data (defaults, NPCs on, 6 pairs) writes PNG pairs that the
    JAX package's datasets.load_images reads; train_vae --epochs 1 on them
    writes a checkpoint that load_vae restores (and refuses to train into
    that directory again). (--manual runs now:
    test_torch_video.test_collect_data_manual_matches_jax.)"""
    monkeypatch.chdir(tmp_path)
    assert collect_data.main(["--output_dir", "data", "--num_images", "6", "--device", "cpu"]) == 6
    rgb = j_datasets.load_images("data/rgb", j_datasets.preprocess_rgb_frame)
    seg = j_datasets.load_images("data/segmentation", j_datasets.preprocess_seg_frame)
    assert rgb.shape == (6, 80, 160, 3) and seg.shape == (6, 80, 160, 1)
    classes = np.round(seg * 12)
    assert np.allclose(seg * 12, classes, atol=1e-5) and classes.max() <= 12 and len(np.unique(classes)) >= 4
    assert 0.0 <= rgb.min() and rgb.max() <= 1.0 and rgb.std() > 0.05
    history = train_vae.main(["--dataset", "data", "--epochs", "1", "--batch_size", "2",
                              "--device", "cpu"])
    assert len(history["val_loss"]) == 1 and np.isfinite(history["val_loss"][0])
    model_dir = "models/torch/vae_models/seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_data"
    vae = vae_common.load_vae(model_dir, device="cpu")
    assert vae.source_shape == (80, 160, 3) and vae.target_shape == (80, 160, 1)
    with torch.no_grad():
        assert vae.encode(torch.from_numpy(rgb)).shape == (6, 64)
    with pytest.raises(FileExistsError):
        train_vae.main(["--dataset", "data", "--epochs", "1", "--batch_size", "2", "--device", "cpu"])
