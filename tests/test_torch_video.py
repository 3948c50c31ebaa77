"""Eval videos in the port: utils/video.VideoRecorder, training/eval_host
run_eval, the Trainer's record_eval_video / _predict_fn against the JAX
Trainer's, and the CLIs that record (cli.train --record_eval 1,
cli.run_eval without --no_video, cli.collect_data --manual); headless
pygame on the CPU.

Tolerances:
- the greedy action and value of _predict_fn within 1e-5 in each branch
  (vector, latent, pixels: the same float32 layers on the same
  observation, the latent one through the converted de-prop VAE);
- a 20-step run_eval's total reward within 1e-4, the same frame count;
- collect_data --manual: every saved seg frame equal to the JAX
  collector's on the same keys; the RGB frames carry each package's own
  texture noise (std 0.02), so their mean absolute difference stays below
  0.05.
"""

from __future__ import annotations

import os

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

import cv2
import numpy as np
import pytest

from carla_ppo_tpu.envs import gym_api as jgym
from carla_ppo_tpu.training import eval_host as j_eval_host
from carla_ppo_tpu.training import loop as j_loop
from carla_ppo_tpu.training import ppo as j_ppo
from carla_ppo_tpu_torch.envs import gym_api
from carla_ppo_tpu_torch.training import eval_host, loop, ppo
from carla_ppo_tpu_torch.utils import convert
from carla_ppo_tpu_torch.utils.video import VideoRecorder
from tests.test_torch_common import REPO, np_tree

VAE_NAME = "from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data"
JAX_VAE = str(REPO / "vae" / "models" / VAE_NAME)
TORCH_VAE = str(REPO / "models" / "torch" / "vae_models" / VAE_NAME)


def _frame_count(path) -> int:
    cap = cv2.VideoCapture(str(path))
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def test_video_recorder(tmp_path):
    path = str(tmp_path / "out.avi")
    rec = VideoRecorder(path, frame_size=(64, 96, 3), fps=30)
    for i in range(10):
        rec.add_frame(np.full((64, 96, 3), i * 20, np.uint8))
    rec.release()
    assert os.path.getsize(path) > 1000
    assert _frame_count(path) == 10


def test_video_recorder_refuses_a_writer_it_cannot_open(tmp_path, monkeypatch):
    """Where OpenCV has no MPEG encoder its writer does not open: the port
    raises instead of writing an empty file."""
    class Closed:
        def isOpened(self):
            return False

    monkeypatch.setattr(cv2, "VideoWriter", lambda *args, **kwargs: Closed())
    with pytest.raises(RuntimeError, match="MPEG"):
        VideoRecorder(str(tmp_path / "x.avi"), frame_size=(8, 8, 3))


def _trainers(obs, tmp_path):
    """(JAX Trainer, port Trainer) of `obs` with the JAX one's initial
    weights carried into the port's model."""
    common = dict(models_root=str(tmp_path), eval_interval=0, heldout_eval=0)
    if obs == "latent":
        jset = j_loop.TrainerSettings(model_name="j", vae_model=JAX_VAE, **common)
        tset = loop.TrainerSettings(model_name="t", vae_model=TORCH_VAE, **common)
    else:
        jset = j_loop.TrainerSettings(model_name="j", obs=obs, **common)
        tset = loop.TrainerSettings(model_name="t", obs=obs, **common)
    small = dict(num_envs=2, horizon=4, num_minibatches=1)
    jt = j_loop.Trainer(jset, j_ppo.PPOConfig(**small))
    tt = loop.Trainer(tset, ppo.PPOConfig(**small), device="cpu")
    tree = np_tree(jt.train_state.params)
    sd = (convert.pixel_actor_critic_state_dict(tree) if obs == "pixels"
          else convert.actor_critic_state_dict(tree))
    tt.train_state.model.load_state_dict(sd, strict=False)
    return jt, tt


@pytest.fixture(scope="module")
def envs():
    """One (JAX, port) pair of the Trainer's video env, shared by the
    module (a predict_fn reads only the env's state and params)."""
    kwargs = dict(obs_res=(160, 80), encode_state_fn="vector", action_smoothing=0.0)
    jenv, tenv = jgym.CarlaLapEnv(**kwargs), gym_api.CarlaLapEnv(device="cpu", **kwargs)
    yield jenv, tenv
    jenv.close()
    tenv.close()


@pytest.fixture(scope="module")
def vector_trainers(tmp_path_factory):
    jt, tt = _trainers("vector", tmp_path_factory.mktemp("vector"))
    yield jt, tt
    jt.close()
    tt.close()


@pytest.mark.parametrize("obs", ["vector", "latent", "pixels"])
def test_predict_fn_matches_jax(obs, envs, vector_trainers, tmp_path):
    """Each branch of _predict_fn on the same state (after 12 driven steps)."""
    jt, tt = vector_trainers if obs == "vector" else _trainers(obs, tmp_path)
    jenv, tenv = envs
    try:
        jenv.reset()
        tenv.reset()
        for _ in range(12):
            jenv.step(np.array([0.05, 0.9]))
            tenv.step(np.array([0.05, 0.9]))
        ja, jv = jt._predict_fn()(jenv)
        ta, tv = tt._predict_fn()(tenv)
        assert ta.shape == (2,) and isinstance(tv, float)
        np.testing.assert_allclose(ta, np.asarray(ja), atol=1e-5, rtol=0)
        assert abs(tv - float(jv)) <= 1e-5
    finally:
        if obs != "vector":
            jt.close()
            tt.close()


def test_run_eval_matches_jax(envs, vector_trainers, tmp_path):
    """A 20-step greedy episode of the same vector agent through both
    packages' run_eval, each recording its video."""
    (jenv, tenv), (jt, tt) = envs, vector_trainers
    jr = j_eval_host.run_eval(jenv, jt._predict_fn(), str(tmp_path / "j.avi"), max_steps=20)
    tr = eval_host.run_eval(tenv, tt._predict_fn(), str(tmp_path / "t.avi"), max_steps=20)
    assert abs(tr - jr) <= 1e-4
    assert _frame_count(tmp_path / "t.avi") == _frame_count(tmp_path / "j.avi") == 21


def _capped_evals(monkeypatch, steps=8):
    """The Trainer's metric pass capped at `steps` (evaluate runs whole
    chunks; a chunk of `steps` keeps it short)."""
    def capped(self, params):
        return ppo.evaluate(self.train_state.model, params, self._eval_generator,
                            num_envs=self.settings.eval_envs, max_steps=steps, config=self.config,
                            latent_obs=self.latent_obs, chunk=steps)

    monkeypatch.setattr(loop.Trainer, "_evaluate_on", capped)


def test_train_record_eval_writes_video(tmp_path, monkeypatch):
    """cli.train --record_eval 1 records videos/iteration0.avi after the
    first eval (the metric pass capped at 8 steps, the video at 20)."""
    from carla_ppo_tpu_torch.cli import train

    monkeypatch.chdir(tmp_path)
    _capped_evals(monkeypatch)
    real_record = loop.Trainer.record_eval_video
    monkeypatch.setattr(loop.Trainer, "record_eval_video",
                        lambda self, filename, max_steps=1500: real_record(self, filename, 20))
    train.main(["--model_name", "v", "--device", "cpu", "--num_envs", "4", "--horizon", "4",
                "--num_minibatches", "2", "--num_epochs", "1", "--eval_interval", "1",
                "--eval_envs", "2", "--num_episodes", "1", "--record_eval", "1"])
    video = tmp_path / "models" / "v" / "videos" / "iteration0.avi"
    assert video.is_file() and 2 <= _frame_count(video) <= 21


def test_run_eval_cli_writes_video(tmp_path, monkeypatch, capsys):
    """cli.run_eval without --no_video records models/<name>/videos/eval0.avi
    after the metric pass, of the converted latent agent (the metric pass
    capped at 8 steps, the episode at --max_steps 15)."""
    import shutil

    from carla_ppo_tpu_torch.cli import run_eval

    monkeypatch.chdir(tmp_path)
    _capped_evals(monkeypatch)
    shutil.copytree(REPO / "models" / "torch" / "latent_agent", tmp_path / "models" / "agent")
    run_eval.main(["--model_name", "agent", "--device", "cpu", "--vae_model", TORCH_VAE,
                   "--num_envs", "2", "--eval_max_steps", "8", "--max_steps", "15"])
    video = tmp_path / "models" / "agent" / "videos" / "eval0.avi"
    assert video.is_file() and _frame_count(video) == 16
    assert "episode 0: reward=" in capsys.readouterr().out


class _Keys:
    """pygame.key.get_pressed()'s answer for a set of pressed keys."""

    def __init__(self, down):
        self.down = down

    def __getitem__(self, key):
        return key in self.down


def test_collect_data_manual_matches_jax(tmp_path, monkeypatch):
    """--manual with scripted keys: W (throttle) throughout, SPACE on the
    first frame (recording starts), A for a few frames; every saved seg
    frame equals the JAX collector's."""
    import pygame

    from carla_ppo_tpu.cli import collect_data as j_collect
    from carla_ppo_tpu_torch.cli import collect_data
    from carla_ppo_tpu_torch.utils.png import read_png

    def scripted():
        frame = {"i": 0}

        def get_pressed():
            i = frame["i"]
            frame["i"] += 1
            down = {pygame.K_w} | ({pygame.K_SPACE} if i == 0 else set())
            return _Keys(down | ({pygame.K_a} if 3 <= i < 6 else set()))

        return get_pressed

    n = 6
    monkeypatch.setattr(pygame.key, "get_pressed", scripted())
    pygame.init()  # the JAX collector pumps events before its window exists
    j_collect.main(["--manual", "--output_dir", str(tmp_path / "j"), "--num_images", str(n)])
    monkeypatch.setattr(pygame.key, "get_pressed", scripted())
    saved = collect_data.main(["--manual", "--output_dir", str(tmp_path / "t"),
                               "--num_images", str(n), "--device", "cpu"])
    assert saved == n
    for i in range(n):
        t_seg = read_png(str(tmp_path / "t" / "segmentation" / f"{i}.png"))
        j_seg = read_png(str(tmp_path / "j" / "segmentation" / f"{i}.png"))
        np.testing.assert_array_equal(t_seg, j_seg)
        t_rgb = read_png(str(tmp_path / "t" / "rgb" / f"{i}.png")).astype(np.float32) / 255
        j_rgb = read_png(str(tmp_path / "j" / "rgb" / f"{i}.png")).astype(np.float32) / 255
        assert np.abs(t_rgb - j_rgb).mean() < 0.05
