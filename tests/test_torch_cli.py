"""The port's CLIs (carla_ppo_tpu_torch/cli) against the JAX package's.

Flag parity: every flag of carla_ppo_tpu.cli.train and cli.run_eval exists
in the port's parser with the same destination, default, type (by name, or
by what it makes of the same strings) and choices. Values the port does not
run yet raise NotImplementedError naming their ROADMAP item. Then a tiny
train -> resume -> run_eval drive on the CPU.
"""

from __future__ import annotations

import argparse
import os

import pytest

from carla_ppo_tpu.cli import run_eval as j_run_eval
from carla_ppo_tpu.cli import train as j_train
from carla_ppo_tpu_torch.cli import run_eval, train
from carla_ppo_tpu_torch.training import loop
from carla_ppo_tpu_torch.training import ppo
from tests.test_torch_common import REPO

DEPROP = str(REPO / "models" / "torch" / "vae_models"
             / "from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data")
PORT_ONLY = {"train": {"device"}, "run_eval": {"device", "eval_max_steps"}}
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


@pytest.mark.parametrize("name", ["train", "run_eval"])
def test_flag_parity(name):
    jax_parser = {"train": j_train, "run_eval": j_run_eval}[name].build_parser()
    port_parser = {"train": train, "run_eval": run_eval}[name].build_parser()
    want, got = _actions(jax_parser), _actions(port_parser)
    assert set(got) - set(want) == PORT_ONLY[name]
    for dest, a in want.items():
        b = got[dest]
        assert b.option_strings == a.option_strings, dest
        assert b.default == a.default, dest
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
    assert set(loop.TrainerSettings.__dataclass_fields__) == jax_fields
    for f in jax_fields:
        assert getattr(loop.TrainerSettings(), f) == getattr(j_train.TrainerSettings(), f), f


@pytest.mark.parametrize("argv, item", [
    (["--obs", "pixels"], "A8"),
    (["--num_devices", "2"], "A10"),
    (["--num_devices", "0"], "A10"),
    (["--record_eval", "1"], "A12"),
    (["--num_npcs", "2"], "A9"),
    (["--obs_fn", "vector_npc"], "A9"),
    (["--vae_source", "rgb", "--vae_model", DEPROP], "A6"),
])
def test_unported_values_raise(argv, item, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        train.main(["--model_name", "u", "--device", "cpu"] + argv)
    assert not os.path.exists("models")  # raised before anything was written


def test_run_eval_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        run_eval.main(["--model_name", "nothing", "--device", "cpu"])
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
